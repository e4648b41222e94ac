"""Port parity: repro_torch.tune (plan artifact, candidate space, knapsack
planner, measurement, apply path, launch/tune.py) against the JAX reference's
repro.tune, on the same numpy-seeded layers converted into the port (CPU).

Mirrors every test of tests/test_tune.py: the port's plans, fingerprints,
candidate lists and capacity accounting must equal the reference's exactly
(integers and the analytic ``est_us`` floats alike); plan JSON crosses the
two packages both ways."""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.tune import plan as jplan  # noqa: E402
from repro.tune import planner as jplanner  # noqa: E402
from repro.tune import space as jspace  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core.prepared import WCANON_MAX_ENTRIES, prepare_linear  # noqa: E402
from repro_torch.tune import measure as measure_mod  # noqa: E402
from repro_torch.tune import plan as plan_mod  # noqa: E402
from repro_torch.tune import planner, space  # noqa: E402
from repro_torch.tune.plan import LayerPlan, ModelPlan, param_fingerprint  # noqa: E402


def _jlayer(f, k, *, bw=1, ba=3, p=None, mode="lut", kind="int", seed=0, stack=0):
    """The reference test's ``_layer``: a reference QuantizedLinear."""
    rng = np.random.default_rng(seed)
    spec = japi.LutLinearSpec(bw=bw, ba=ba, p=p, mode=mode, w_kind=kind, a_kind=kind)
    w = jnp.asarray(rng.normal(size=(k, f)).astype(np.float32))
    q = japi.quantize_linear(w, spec)
    if stack:
        q = jax.vmap(lambda w_: japi.quantize_linear(w_, spec))(
            jnp.asarray(rng.normal(size=(stack, k, f)).astype(np.float32))
        )
    return q


def _port(jtree):
    """A reference tree carried into the port (CPU tensors)."""
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _layer(*a, **kw):
    return _port(_jlayer(*a, **kw))


def _jtree():
    """The reference test's ``_tree``, as jax's tree ops hand it on (dict keys
    sorted, the order the leaves are walked and fingerprinted in)."""
    return jax.tree.map(lambda a: a, {
        "attn": {"wq": _jlayer(12, 16, seed=1), "wo": _jlayer(16, 12, seed=2)},
        "ffn": {"w_up": _jlayer(24, 16, seed=3)},
    })


def _cand_dicts(cands):
    return [dataclasses.asdict(c) for c in cands]


# --- plan.py ---------------------------------------------------------------


def _plans(mod):
    return mod.ModelPlan(
        fingerprint="abc",
        budget_bytes=123,
        layers={
            "a/b": mod.LayerPlan(mode="lut", p=3, wcanon=True, capacity_bytes=10,
                                 table_bytes=5, est_us=1.5, measured_us=2.5, stack=4),
            "c": mod.LayerPlan(mode="dequant", p=1, prepared=False),
        },
        total_bytes=15,
        table_bytes=5,
        meta=dict(n_hint=8),
    )


def test_model_plan_json_round_trip_both_ways(tmp_path):
    mp, jmp = _plans(plan_mod), _plans(jplan)
    s = mp.to_json()
    assert s == jmp.to_json()                        # the same artifact, byte for byte
    mp2 = ModelPlan.from_json(s)
    assert mp2.layers == mp.layers
    assert (mp2.fingerprint, mp2.budget_bytes, mp2.total_bytes,
            mp2.table_bytes, mp2.meta) == ("abc", 123, 15, 5, dict(n_hint=8))
    assert mp2.to_json() == s                        # fixed point
    # port -> reference and reference -> port, through files
    mp.save(tmp_path / "port.json")
    jmp.save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    from_port = jplan.ModelPlan.load(tmp_path / "port.json")
    from_ref = ModelPlan.load(tmp_path / "ref.json")
    assert from_port.to_json() == from_ref.to_json() == s
    assert {k: v.to_dict() for k, v in from_ref.layers.items()} == \
        {k: v.to_dict() for k, v in from_port.layers.items()}


def test_model_plan_refuses_newer_version():
    d = json.loads(ModelPlan(fingerprint="x", budget_bytes=1, layers={}).to_json())
    d["version"] = plan_mod.PLAN_VERSION + 1
    assert plan_mod.PLAN_VERSION == jplan.PLAN_VERSION
    with pytest.raises(ValueError, match="newer") as got:
        ModelPlan.from_json(json.dumps(d))
    with pytest.raises(ValueError, match="newer") as want:
        jplan.ModelPlan.from_json(json.dumps(d))
    assert str(got.value) == str(want.value)


def test_fingerprint_invalidates_on_shape_bits_and_family():
    jbase = {"a": _jlayer(8, 12), "b": _jlayer(6, 12)}
    base = _port(jbase)
    fp = param_fingerprint(base)
    assert fp == jplan.param_fingerprint(jbase)
    assert plan_mod.leaf_identities(base) == jplan.leaf_identities(jbase)
    # p / tile / mode-within-family are plan OUTPUTS: same fingerprint
    repl = {
        "a": dataclasses.replace(
            base["a"], spec=dataclasses.replace(base["a"].spec, mode="stream", p=5)),
        "b": base["b"],
    }
    assert param_fingerprint(repl) == fp
    # different shape, bitwidth, path or numerics family: different
    # fingerprint, equal to the reference's on the same edit
    edits = [
        {"a": _jlayer(9, 12), "b": jbase["b"]},
        {"a": _jlayer(8, 12, bw=2), "b": jbase["b"]},
        {"a2": jbase["a"], "b": jbase["b"]},
        {"a": _jlayer(8, 12, mode="dequant"), "b": jbase["b"]},
    ]
    for jt in edits:
        got = param_fingerprint(_port(jt))
        assert got != fp and got == jplan.param_fingerprint(jt)
    mp = planner.plan_model({"a": base["a"]}, lut_budget_bytes=1 << 20,
                            n_hint=2, measure=False, p_cap=3)
    with pytest.raises(ValueError, match="fingerprint"):
        planner.apply_plan({"a": _layer(8, 12, mode="dequant")}, mp)


def test_fingerprint_of_stacked_and_prepared_trees_matches_reference():
    jt = {"seg": [{"u": {"wq": _jlayer(8, 12, stack=3, seed=4), "wo": _jlayer(12, 8, seed=5)}}]}
    from repro.models.model import prepare_params as jprepare_params
    from repro_torch.models.model import prepare_params

    t = _port(jt)
    # jax's tree maps order dict keys, so the tree the port receives is the
    # reference's tree as any jax tree op returns it
    assert param_fingerprint(t) == jplan.param_fingerprint(jax.tree.map(np.asarray, jt))
    # a prepared tree keeps the raw tree's identity in both packages
    assert param_fingerprint(prepare_params(t, n_hint=4)) == \
        jplan.param_fingerprint(jprepare_params(jt, n_hint=4)) == param_fingerprint(t)


def test_calibration_digest_and_describe_drift_match_reference():
    jbase = {"a": _jlayer(8, 12), "b": _jlayer(6, 12, seed=1)}
    cal = dict(jbase)
    cal["a"] = dataclasses.replace(jbase["a"], ascale=jnp.float32(0.3125))
    cal["b"] = dataclasses.replace(jbase["b"], ascale=jnp.asarray([0.5, 0.75], jnp.float32))
    base_t, cal_t = _port(jbase), _port(cal)
    assert plan_mod.calibration_digests(cal_t) == jplan.calibration_digests(cal)
    assert plan_mod.calibration_digests(base_t) == {"a": None, "b": None}
    # a bf16 scale (how the card may hold it) digests as its f32 value
    bf = dataclasses.replace(cal_t["b"], ascale=cal_t["b"].ascale.to(torch.bfloat16))
    assert plan_mod.calibration_digest(bf) == jplan.calibration_digest(cal["b"])
    pairs = [
        (jbase, cal),
        (jbase, {"a": _jlayer(9, 12), "b": jbase["b"]}),
        (jbase, {"a": _jlayer(8, 12, bw=2, ba=4), "b": jbase["b"]}),
        (jbase, {"a": _jlayer(8, 12, mode="dequant"), "b": jbase["b"]}),
        (jbase, {"a": jbase["a"]}),
        ({"a": jbase["a"]}, jbase),
        (jbase, jbase),
    ]
    for old, new in pairs:
        want = jplan.describe_drift(old, new)
        assert plan_mod.describe_drift(_port(old), _port(new)) == want
    assert plan_mod.describe_drift(base_t, base_t) == []
    assert len(jplan.describe_drift(jbase, cal)) == 2


def test_leaf_walk_covers_nesting_and_order():
    jt = {"x": [{"q": _jlayer(4, 6)}, {"q": _jlayer(5, 6)}], "y": _jlayer(6, 6)}
    paths = [p for p, _ in plan_mod.quantized_leaf_items(_port(jt))]
    assert paths == ["x/0/q", "x/1/q", "y"] == [p for p, _ in jplan.quantized_leaf_items(jt)]


# --- space.py: exact capacity accounting -----------------------------------


@pytest.mark.parametrize(
    "mode,p,wcanon",
    [("dequant", 1, False), ("lut", 2, False), ("lut", 3, True),
     ("lut", 4, True), ("stream", 3, False), ("pallas", 1, False)],
)
def test_candidate_capacity_matches_prepared_bytes(mode, p, wcanon):
    f, k = 10, 17                                   # ragged K: pad path
    q = _layer(f, k, p=p, mode=mode)
    want = space.prepared_capacity_bytes(f, k, q.spec, p, wcanon=wcanon)
    pl = prepare_linear(q, n_hint=4, wcanon_max_entries=WCANON_MAX_ENTRIES if wcanon else 0)
    assert want == pl.prepared_bytes
    jq = _jlayer(f, k, p=p, mode=mode)
    assert want == jspace.prepared_capacity_bytes(f, k, jq.spec, p, wcanon=wcanon)


def test_candidate_capacity_matches_prepared_bytes_stacked():
    from repro_torch.models.model import _prepare_leaf

    stack = 3
    q = _layer(8, 12, p=3, mode="lut", stack=stack)
    pl = _prepare_leaf(q, n_hint=4)
    want = space.prepared_capacity_bytes(8, 12, q.spec, 3, wcanon=True, stack=stack)
    assert want == pl.prepared_bytes
    # Stacked stream leaves build no host one-hot.
    qs = _layer(8, 12, p=3, mode="stream", stack=stack)
    pls = _prepare_leaf(qs, n_hint=4)
    assert space.prepared_capacity_bytes(8, 12, qs.spec, 3, stack=stack) == pls.prepared_bytes


def test_stream_onehot_feasibility_reflected_in_capacity():
    f, k, p = 6, 12, 3
    q = _layer(f, k, p=p, mode="stream")
    pl = prepare_linear(q, n_hint=4)
    assert pl.onehot is not None                   # small layer: one-hot built
    got = space.prepared_capacity_bytes(f, k, q.spec, p)
    assert got == pl.prepared_bytes
    g = space.group_count(k, p)
    pack = tapi._lut_pack_cache(1, 3, p, "int", "int")
    assert got == f * g * 4 + f * g * pack.n_rows * 4


def test_table_bytes_match_built_pack():
    from repro_torch.core import luts

    for bw, ba, p in [(1, 3, 4), (2, 2, 3), (4, 4, 2)]:
        pack = luts.build_lut_pack(bw, ba, p)
        got = space.table_bytes_for(bw, ba, p, "int", "int")
        assert got == pack.total_bytes == jspace.table_bytes_for(bw, ba, p, "int", "int")
    assert space.table_bytes_for(2, 3, 2, "fp", "fp") == jspace.table_bytes_for(2, 3, 2, "fp", "fp")


def test_layer_candidates_families():
    cands = space.layer_candidates(8, 16, n_hint=4, base_spec=tapi.LutLinearSpec(bw=1, ba=3, mode="lut"))
    assert cands[0].capacity_bytes == 0 and not cands[0].prepared
    assert {c.mode for c in cands} == {"lut", "stream"}
    assert all(not c.servable for c in cands if c.mode == "stream")
    assert len({c.p for c in cands}) > 2
    dc = space.layer_candidates(8, 16, n_hint=4, base_spec=tapi.LutLinearSpec(bw=2, ba=4, mode="dequant"))
    assert {c.mode for c in dc} == {"dequant"}
    assert sorted(c.prepared for c in dc) == [False, True]
    fp = space.layer_candidates(
        8, 16, n_hint=4,
        base_spec=tapi.LutLinearSpec(bw=2, ba=3, p=2, mode="lut", w_kind="fp", a_kind="fp"),
    )
    assert len(fp) == 1 and fp[0].mode == "lut" and fp[0].p == 2


_SPECS = [
    dict(bw=1, ba=3, mode="lut"),
    dict(bw=1, ba=3, p=2, mode="stream"),
    dict(bw=2, ba=2, mode="lut"),
    dict(bw=4, ba=4, mode="lut"),
    dict(bw=2, ba=4, mode="dequant"),
    dict(bw=4, ba=4, mode="pallas"),
    dict(bw=2, ba=3, p=2, mode="lut", w_kind="fp", a_kind="fp"),
    dict(bw=2, ba=3, p=2, mode="stream", w_kind="fp", a_kind="fp"),
]


@pytest.mark.parametrize("servable_only", [False, True])
@pytest.mark.parametrize("stack", [1, 40])
@pytest.mark.parametrize("spec", _SPECS, ids=lambda d: "-".join(map(str, d.values())))
def test_layer_candidates_match_reference(spec, stack, servable_only):
    """Field by field, in the same order, est_us exactly: every mode,
    stacked and unstacked, with and without the stream candidates, at unit
    shapes, a ragged K and stablelm-12b's wk."""
    for f, k, n in [(8, 16, 4), (10, 17, 2), (1280, 5120, 4)]:
        kw = dict(n_hint=n, stack=stack, servable_only=servable_only)
        got = space.layer_candidates(f, k, base_spec=tapi.LutLinearSpec(**spec), **kw)
        want = jspace.layer_candidates(f, k, base_spec=japi.LutLinearSpec(**spec), **kw)
        assert _cand_dicts(got) == _cand_dicts(want)


@pytest.mark.parametrize("p_cap", [None, 3])
def test_layer_candidates_with_stream_traffic_match_reference(p_cap):
    """The stream candidates priced from the concrete layer's plan-only
    traffic stats (q and x given)."""
    jq = _jlayer(24, 40, seed=6)
    q = _port(jq)
    x = measure_mod.sample_activations(40, 4, seed=0, device="cpu")
    jx = np.asarray(x)
    kw = dict(n_hint=4, p_cap=p_cap)
    got = space.layer_candidates(24, 40, base_spec=q.spec, q=q, x=x, **kw)
    want = jspace.layer_candidates(24, 40, base_spec=jq.spec, q=jq, x=jx, **kw)
    assert _cand_dicts(got) == _cand_dicts(want)
    assert any(c.mode == "stream" for c in got)


# --- planner.py ------------------------------------------------------------


def _tree():
    return _port(_jtree())


def test_planner_respects_budget_and_degrades():
    tree, jt = _tree(), _jtree()
    sizes, times = [], []
    for budget in (0, 4_000, 40_000, 4_000_000):
        mp = planner.plan_model(tree, lut_budget_bytes=budget, n_hint=4, measure=False, p_cap=5)
        jmp = jplanner.plan_model(jt, lut_budget_bytes=budget, n_hint=4, measure=False, p_cap=5)
        assert mp.to_json() == jmp.to_json()
        assert mp.total_bytes <= budget or mp.meta["over_budget"]
        sizes.append(mp.total_bytes)
        times.append(sum(lp.est_us * lp.stack for lp in mp.layers.values()))
    assert times == sorted(times, reverse=True)
    assert all(not lp.prepared for lp in planner.plan_model(
        tree, lut_budget_bytes=0, n_hint=4, measure=False).layers.values())
    assert sizes[-1] >= sizes[0]


def test_planner_shared_tables_counted_once():
    tree = _tree()
    mp = planner.plan_model(tree, lut_budget_bytes=4_000_000, n_hint=4, measure=False, p_cap=5)
    packs = {(lp.mode, lp.p) for lp in mp.layers.values() if lp.mode in ("lut", "stream")}
    want = sum(space.table_bytes_for(1, 3, p, "int", "int") for _, p in packs)
    assert mp.table_bytes == want
    assert mp.total_bytes == want + sum(lp.capacity_bytes for lp in mp.layers.values())


def test_planner_refuses_prepared_tree_and_empty():
    with pytest.raises(ValueError, match="no QuantizedLinear"):
        planner.plan_model({"w": torch.zeros((3, 3))}, lut_budget_bytes=1)
    prepared = {"a": prepare_linear(_layer(6, 8), n_hint=2)}
    with pytest.raises(ValueError, match="raw quantized tree"):
        planner.plan_model(prepared, lut_budget_bytes=1)


def test_apply_plan_fingerprint_and_coverage():
    tree = _tree()
    mp = planner.plan_model(tree, lut_budget_bytes=40_000, n_hint=4, measure=False, p_cap=4)
    with pytest.raises(ValueError, match="fingerprint"):
        planner.apply_plan({"attn": {"wq": _layer(13, 16)}}, mp)
    mp_missing = dataclasses.replace(
        mp, layers={k: v for k, v in mp.layers.items() if k != "ffn/w_up"})
    with pytest.raises(KeyError, match="ffn/w_up"):
        planner.apply_plan(tree, mp_missing)
    with pytest.raises(ValueError, match="raw quantized tree"):
        planner.apply_plan(planner.apply_plan(tree, mp), mp)


def test_apply_plan_and_verify_capacity_match_reference():
    tree, jt = _tree(), _jtree()
    mp = planner.plan_model(tree, lut_budget_bytes=40_000, n_hint=4, measure=False, p_cap=4)
    jmp = jplanner.plan_model(jt, lut_budget_bytes=40_000, n_hint=4, measure=False, p_cap=4)
    assert mp.to_json() == jmp.to_json()
    applied = planner.apply_plan(tree, mp)
    actual = planner.verify_capacity(applied, mp)
    assert set(actual) == set(mp.layers)
    assert actual == jplanner.verify_capacity(jplanner.apply_plan(jt, jmp), jmp)
    # the reference's plan, loaded in the port, prepares the same tree
    cross = planner.apply_plan(tree, ModelPlan.from_json(jmp.to_json()))
    assert planner.verify_capacity(cross, mp) == actual
    bad = dataclasses.replace(mp)
    k0 = next(iter(bad.layers))
    bad.layers = dict(bad.layers)
    bad.layers[k0] = dataclasses.replace(
        bad.layers[k0], capacity_bytes=bad.layers[k0].capacity_bytes + 1)
    with pytest.raises(AssertionError, match="prepared bytes"):
        planner.verify_capacity(applied, bad)


def test_measure_cache_hits():
    q = _layer(8, 12)
    x = measure_mod.sample_activations(12, 4, device="cpu")
    assert x.device.type == "cpu" and x.dtype == torch.float32
    from repro.tune import measure as jmeasure

    np.testing.assert_array_equal(x.numpy(), np.asarray(jmeasure.sample_activations(12, 4)))
    meas = measure_mod.Measurer(iters=1, warmup=1, cache={})
    c = space.Candidate(mode="lut", p=2)
    a = meas.measure(q, x, c)
    b = meas.measure(q, x, c)
    assert a == b and meas.hits == 1 and meas.misses == 1 and a > 0
    meas.measure(q, x, space.Candidate(mode="lut", p=3))
    assert meas.misses == 2
    assert measure_mod.measure_key(8, 12, 4, q.spec, c) == \
        jmeasure.measure_key(8, 12, 4, _jlayer(8, 12).spec, jspace.Candidate(mode="lut", p=2))


def test_measured_plan_records_its_measurements():
    tree = _tree()
    meas = measure_mod.Measurer(iters=1, warmup=0, cache={})
    mp = planner.plan_model(tree, lut_budget_bytes=40_000, n_hint=2, measure=True,
                            p_cap=3, measurer=meas, measure_n=4)
    assert mp.meta["measured"] and mp.meta["measure_cache_misses"] == meas.misses > 0
    assert all(lp.measured_us is not None and lp.measured_us > 0 for lp in mp.layers.values())
    planner.verify_capacity(planner.apply_plan(tree, mp), mp)


def test_model_prepare_with_plan_matches_specwise_prepare():
    """Model.prepare(plan=...) == rewriting specs by hand then preparing."""
    from repro_torch.models.model import _prepare_leaf, prepare_params

    tree = _tree()
    mp = planner.plan_model(tree, lut_budget_bytes=4_000_000, n_hint=4, measure=False, p_cap=4)
    via_plan = prepare_params(tree, plan=mp)
    by_hand = dict(plan_mod.quantized_leaf_items(tree))
    for path, leaf in plan_mod.quantized_leaf_items(via_plan):
        lp = mp.layers[path]
        assert leaf.spec.mode == lp.mode and leaf.spec.p == lp.p
        if lp.prepared:
            assert leaf.prepared_bytes == lp.capacity_bytes
            q = by_hand[path]
            want = _prepare_leaf(dataclasses.replace(q, spec=dataclasses.replace(q.spec, p=lp.p)),
                                 n_hint=4, wcanon_max_entries=WCANON_MAX_ENTRIES if lp.wcanon else 0)
            assert torch.equal(leaf.wpk, want.wpk) and leaf.p == want.p
            assert (leaf.wcanon is None) == (want.wcanon is None)


# --- full width, analytic: stablelm-12b's seven stacked leaves -------------

_D, _FF, _H, _HKV, _HD, _L = 5120, 13824, 32, 8, 160, 40
# (K, F) per projection, keys in the order of both packages' model trees
_FULL = {"attn": {"wk": (_D, _HKV * _HD), "wo": (_H * _HD, _D), "wq": (_D, _H * _HD),
                  "wv": (_D, _HKV * _HD)},
         "ffn": {"w_down": (_FF, _D), "w_gate": (_D, _FF), "w_up": (_D, _FF)}}


def _full_width(mod, zeros):
    """stablelm-12b's quantized projections at W1A3 lut, 40 stacked units,
    with zero-stride codes and scales (nothing allocated)."""
    spec = mod.LutLinearSpec(bw=1, ba=3, p=4, mode="lut")
    return {"segments": [{"s0_D": {
        g: {n: mod.QuantizedLinear(codes=zeros((_L, f, k // 8), "u8"), scale=zeros((_L, f), "f4"),
                                   bias=None, spec=spec, k=k) for n, (k, f) in d.items()}
        for g, d in _FULL.items()}}]}


@pytest.fixture(scope="module")
def full_width_trees():
    jt = _full_width(japi, lambda s, d: np.broadcast_to(
        np.zeros((), np.uint8 if d == "u8" else np.float32), s))
    tt = _full_width(tapi, lambda s, d: torch.zeros(
        (), dtype=torch.uint8 if d == "u8" else torch.float32).expand(*s))
    return jt, tt


# budget GiB -> ({projection: (p, prepared)}, total_bytes, table_bytes), or None
# where only the equality with the reference is asserted
_FULL_PLANS = {
    16: ({"wq": (5, True), "wk": (5, True), "wv": (5, True), "wo": (5, True),
          "w_down": (5, True), "w_up": (7, True), "w_gate": (7, True)}, 7_601_487_360, 1_113_600),
    7: None,
    4: ({"wq": (8, True), "wk": (5, True), "wv": (6, True), "wo": (8, True),
         "w_up": (8, True), "w_gate": (8, True), "w_down": (1, False)}, 4_276_499_986, 12_154_386),
}


@pytest.mark.parametrize("gib", sorted(_FULL_PLANS))
def test_full_width_analytic_plan_matches_reference(full_width_trees, gib):
    jt, tt = full_width_trees
    assert param_fingerprint(tt) == jplan.param_fingerprint(jt)
    kw = dict(lut_budget_bytes=gib << 30, n_hint=4, measure=False)
    mp, jmp = planner.plan_model(tt, **kw), jplanner.plan_model(jt, **kw)
    assert mp.to_json() == jmp.to_json()             # meta included
    assert mp.meta["measure_cache_hits"] == mp.meta["measure_cache_misses"] == 0
    want = _FULL_PLANS[gib]
    if want is not None:
        layers, total, tables = want
        got = {path.rsplit("/", 1)[-1]: (lp.p, lp.prepared) for path, lp in mp.layers.items()}
        assert got == layers and (mp.total_bytes, mp.table_bytes) == (total, tables)
        assert all(lp.mode == "lut" and not lp.wcanon and lp.stack == _L
                   for lp in mp.layers.values())


# --- launch/tune.py ----------------------------------------------------------


def test_launch_tune_writes_a_plan_the_reference_loads(tmp_path, capsys):
    from repro.configs import get_config as jget_config
    from repro.models.model import build_model as jbuild
    from repro_torch.launch import tune as launch_tune

    out = tmp_path / "plan.json"
    plan = launch_tune.main(["--smoke", "--analytic", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "planned" in text and f"wrote {out}" in text
    loaded = jplan.ModelPlan.load(out)
    jm = jbuild(jget_config("stablelm-12b", smoke=True))
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), japi.LutLinearSpec(bw=1, ba=3, mode="lut"))
    assert loaded.fingerprint == jplan.param_fingerprint(jq) == plan.fingerprint
    # the reference, planning its own smoke tree, compiles the same plan
    jmp = jplanner.plan_model(jq, lut_budget_bytes=4 * 1024 * 1024, n_hint=2, measure=False)
    assert jmp.to_json() == loaded.to_json() == plan.to_json()
    assert isinstance(loaded.layers["segments/0/s0_D/attn/wq"], jplan.LayerPlan)
    assert isinstance(plan.layers["segments/0/s0_D/attn/wq"], LayerPlan)
