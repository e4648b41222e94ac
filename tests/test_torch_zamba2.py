"""Port parity: zamba2-7b (Mamba2 "M" units and "S" units carrying the shared
attention + FFN block) against the JAX reference on numpy-seeded inputs at
its smoke widths (7 layers: 2 x "MMS" + "M"; the shared block applied twice
a forward), f32 unless stated (CPU).

The forward within 1e-4 x max |logit| of the reference's, raw, W4A4
"dequant" and "pallas", and prepared (prepared == raw bit for bit); prefill +
decode against the forward (the mirror of tests/test_serving.py's
``test_prefill_decode_matches_forward[zamba2-7b]``); ServeEngine's tokens,
admissions, host syncs and bucket counts equal the reference's under every
driver (W4A4 "dequant"); calibrated W1A3 "lut": the frozen scales at rtol 2**-21 (2**-19 on
the SSM out_proj leaves, ROADMAP Queue 3 item 3; the shared block's leaves
take the max over their applications) and the tokens; the
reference's trees carried across by convert; ``init_quantized`` quantizes
the shared block; the launchers refuse plans, prepared checkpoints and the
request log over a recurrent tree."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.core.calibrate import calibrate_tree as jcalibrate_tree  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve.serving import Request as JRequest  # noqa: E402
from repro.serve.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import LutLinearSpec, PreparedLinear, QuantizedLinear  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.serving import Request, ServeEngine  # noqa: E402

ARCH = "zamba2-7b"
TOL = 1e-4            # the models' logits, relative to max |logit|
LUT = dict(bw=1, ba=3, p=2, mode="lut")
SHARED = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "ffn/w_gate", "ffn/w_up", "ffn/w_down")


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _toks(cfg, shape, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jraw = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jraw, tm


@pytest.fixture(scope="module")
def pallas_ref(models):
    """The reference's raw W4A4 pallas tree and its logits (its prepared
    tree gives the same: the reference's prepare/apply contract)."""
    jcfg, jm, jraw, _tm = models
    jq = jm.quantize(jraw, JSpec(bw=4, ba=4, mode="pallas"))
    return jq, np.asarray(jm.forward(jq, jnp.asarray(_toks(jcfg, (2, 9))))[0])


@pytest.mark.parametrize("kind", ["raw", "dequant", "pallas", "prepared"])
def test_forward_matches_reference(models, pallas_ref, kind):
    """Logits against the reference's; a prepared tree equals its raw tree
    bit for bit in the port."""
    jcfg, jm, jraw, tm = models
    toks = _toks(jcfg, (2, 9))
    if kind in ("pallas", "prepared"):
        jtree, jl = pallas_ref
    else:
        jtree = jraw if kind == "raw" else jm.quantize(jraw, JSpec(bw=4, ba=4, mode="dequant"))
        jl = jm.forward(jtree, jnp.asarray(toks))[0]
    ttree = params_from_numpy(_np(jtree), device="cpu")
    tl, _ = tm.forward(ttree, torch.from_numpy(toks))
    assert tl.shape == (2, 9, jcfg.vocab_size)
    if kind == "prepared":
        raw_logits = tl
        ttree = tm.prepare(ttree, n_hint=2)
        assert isinstance(ttree["shared_attn"]["attn"]["wq"], PreparedLinear)
        tl, _ = tm.forward(ttree, torch.from_numpy(toks))
        assert torch.equal(tl, raw_logits)
    _close(tl, jl)


def test_prefill_decode_matches_forward(models):
    """As tests/test_serving.py::test_prefill_decode_matches_forward for
    zamba2-7b (B = 2, S = 10, a 5-token prefill, the cache over 16 slots),
    each step also held to the reference's forward, within 1e-4 x max
    |logit| (the reference asserts 3e-2 in bf16)."""
    jcfg, jm, jraw, tm = models
    tp = params_from_numpy(_np(jraw), device="cpu")
    B, S, PRE = 2, 10, 5
    toks = _toks(jcfg, (B, S), seed=1)
    jfull = np.asarray(jm.forward(jraw, jnp.asarray(toks))[0])
    tfull, _ = tm.forward(tp, torch.from_numpy(toks))
    _close(tfull, jfull)
    caches = tm.init_cache(B, 16, torch.float32, device="cpu")
    pf, caches = tm.prefill(tp, torch.from_numpy(toks[:, :PRE]), caches)
    assert pf.shape == (B, 1, jcfg.vocab_size)
    _close(pf[:, 0], tfull[:, PRE - 1].numpy())
    for t in range(PRE, S):
        lg, caches = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), caches, t)
        _close(lg[:, 0], tfull[:, t].numpy())
        _close(lg[:, 0], jfull[:, t])


def test_cache_layout_follows_the_reference(models):
    """An "M" cache is the Mamba2 state, an "S" cache that state and the
    shared attention's K/V, stacked over the units; the state leaves are
    f32 whatever the cache dtype (the reference's state is f32 after its
    first update), the K/V in the cache dtype."""
    jcfg, jm, _jraw, tm = models
    jc = _np(jm.init_cache(2, 16, jnp.float32))
    tc = tm.init_cache(2, 16, torch.bfloat16, device="cpu")
    assert jax.tree.map(np.shape, jc) == tree.tree_map(lambda t: tuple(t.shape), tc)
    s = tc[0]["s2_S"]
    assert set(s) == {"mamba", "attn"} and s["mamba"]["ssd"].dtype == torch.float32
    assert s["attn"]["k"].dtype == torch.bfloat16 and tc[1]["s0_M"]["conv"].dtype == torch.float32


@pytest.fixture(scope="module")
def served_pair(models):
    """W4A4 "dequant", prepared in both packages (the reference's "pallas"
    runs its kernel in interpret mode: slow to serve; the port's pallas
    path is held to it by test_forward_matches_reference)."""
    jcfg, jm, jraw, tm = models
    jq = jm.quantize(jraw, JSpec(bw=4, ba=4, mode="dequant"))
    return jcfg, jm, jm.prepare(jq, n_hint=2), tm, tm.prepare(params_from_numpy(_np(jq),
                                                                                  device="cpu"))


def _ragged(cfg, seed, lens, budgets):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for n, m in zip(lens, budgets)]


@pytest.mark.parametrize("decode", ["scan", "chunked", "loop"])
def test_serve_matches_reference_under_every_driver(served_pair, decode):
    """Ragged prompts: the pads go through the recurrence in both packages
    (nothing masks them), so each driver is held to the reference's same
    driver: tokens, admissions, host syncs and bucket counts."""
    jcfg, jm, jp, tm, tp = served_pair
    reqs = _ragged(jcfg, 3, (3, 7, 5, 6, 2), (4, 6, 3, 5, 2))
    jreqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    jeng = JServeEngine(jm, jp, batch=2, max_seq=32, decode=decode)
    teng = ServeEngine(tm, tp, batch=2, max_seq=32, decode=decode, device="cpu")
    got = teng.generate(reqs)
    assert got == jeng.generate(jreqs)
    assert [len(o) for o in got] == [4, 6, 3, 5, 2]
    assert teng.admissions == jeng.admissions
    assert teng.host_syncs == jeng.host_syncs
    assert teng.bucket_counts == jeng.bucket_counts


def test_scan_equals_loop_where_each_wave_is_led_by_a_bucket(served_pair):
    """Where every wave's longest prompt is a bucket, every driver pads each
    row alike, so the recurrent state sees the same pads: scan == chunked ==
    loop."""
    jcfg, _jm, _jp, tm, tp = served_pair
    same = _ragged(jcfg, 0, (8, 5, 16, 11), (4, 4, 3, 3))
    outs = [ServeEngine(tm, tp, batch=2, max_seq=32, decode=d, device="cpu").generate(same)
            for d in ("scan", "chunked", "loop")]
    assert outs[0] == outs[1] == outs[2] and [len(o) for o in outs[0]] == [4, 4, 3, 3]


@pytest.fixture(scope="module")
def lut_pair(models):
    jcfg, jm, jraw, tm = models
    jq = jm.quantize(jraw, JSpec(**LUT))
    cal = np.random.default_rng(7).integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jcal = jcalibrate_tree(lambda probed: jm.forward(probed, jnp.asarray(cal))[0], jq)
    tq = params_from_numpy(_np(jq), device="cpu")
    return jcfg, jm, jcal, tm, tq, cal


def test_calibrated_lut_scales_and_tokens_match_reference(lut_pair, monkeypatch):
    """The frozen scales leaf by leaf at rtol 2**-21 (ROADMAP Queue 3 item
    2); each shared-block leaf is applied once per "S" unit and freezes the
    max of those scales, as the reference does; logits and served tokens."""
    from repro.tune.plan import quantized_leaf_items as jitems
    from repro_torch.tune.plan import quantized_leaf_items as titems

    jcfg, jm, jcal, tm, tq, cal = lut_pair
    tp = tm.prepare(tq, calibrate=cal, n_hint=2)
    js = {p: leaf.ascale for p, leaf in jitems(jcal) if leaf.ascale is not None}
    ts = {p: leaf.ascale for p, leaf in titems(tp) if leaf.ascale is not None}
    assert sorted(js) == sorted(ts) and {f"shared_attn/{s}" for s in SHARED} <= set(ts)
    for path, want in js.items():
        # An out_proj reads the recurrence's output, which XLA's f32 exp and
        # log1p (the softplus, the decay) and its sum order put up to 8.3
        # ulp from the port's (ROADMAP Queue 3 item 3); every other leaf
        # is held at rtol 2**-21 (Queue 3 item 2).
        rtol = 2**-19 if path.endswith("ssm/out_proj") else 2**-21
        np.testing.assert_allclose(ts[path].numpy(), np.asarray(want), rtol=rtol, atol=0,
                                   err_msg=path)
    # the shared leaves' records: one per application, the max frozen
    counts = {}
    probe_apply = tcal.probe_apply

    def counting(probe, x):
        counts[probe.path] = counts.get(probe.path, 0) + 1
        return probe_apply(probe, x)

    monkeypatch.setattr(layers, "probe_apply", counting)
    tcal.capture_scales(lambda probed: tm.forward(probed, torch.from_numpy(cal))[0], tq)
    n_s = sum(pat.count("S") * n for pat, n in transformer.segments(jcfg))
    assert n_s == 2 and all(counts[f"shared_attn/{s}"] == n_s for s in SHARED)
    toks = _toks(jcfg, (2, 7))
    _close(tm.forward(tp, torch.from_numpy(toks))[0], jm.forward(jcal, jnp.asarray(toks))[0])
    reqs = _ragged(jcfg, 5, (6, 6, 6, 6), (6, 2, 4, 2))
    jreqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    want = JServeEngine(jm, jcal, batch=2, max_seq=32, decode="scan").generate(jreqs)
    assert ServeEngine(tm, tp, batch=2, max_seq=32, decode="scan", device="cpu").generate(
        reqs) == want


@pytest.mark.parametrize("kind", ["raw", "quantized", "prepared", "calibrated"])
def test_convert_carries_zamba2_trees(models, lut_pair, kind):
    jcfg, jm, jraw, _tm = models
    jtree = {"raw": lambda: jraw,
             "quantized": lambda: jm.quantize(jraw, JSpec(bw=4, ba=4, mode="pallas")),
             "prepared": lambda: jm.prepare(jm.quantize(jraw, JSpec(bw=4, ba=4, mode="dequant")),
                                            n_hint=2),
             "calibrated": lambda: lut_pair[2]}[kind]()
    ttree = params_from_numpy(_np(jtree), device="cpu")
    unit = ttree["segments"][0]["s0_M"]["ssm"]
    assert {"in_proj", "out_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip"} == set(unit)
    for name in ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip"):
        np.testing.assert_array_equal(
            unit[name].numpy(), np.asarray(jtree["segments"][0]["s0_M"]["ssm"][name]))
    leaf_type = {"raw": dict, "quantized": QuantizedLinear, "prepared": PreparedLinear,
                 "calibrated": QuantizedLinear}[kind]
    assert isinstance(unit["in_proj"], leaf_type)
    assert isinstance(ttree["shared_attn"]["ffn"]["w_down"], leaf_type)
    if kind != "raw":
        sq, jq = ttree["shared_attn"]["attn"]["wq"], jtree["shared_attn"]["attn"]["wq"]
        np.testing.assert_array_equal(sq.codes.numpy(), np.asarray(jq.codes))
        assert (sq.ascale is None) == (kind != "calibrated")
        if kind == "calibrated":
            np.testing.assert_array_equal(sq.ascale.numpy(), np.asarray(jq.ascale))
    else:
        assert jax.tree.map(np.shape, _np(jtree)) == jax.tree.map(
            np.shape, tree.tree_map(lambda t: t.numpy(), ttree))


def test_init_quantized_quantizes_the_shared_block():
    _jcfg, tcfg = _cfgs()
    m = tmodel.build_model(tcfg)
    qp = m.init_quantized(LutLinearSpec(bw=4, mode="pallas"), seed=0, device="cpu")
    shared = qp["shared_attn"]
    for s in SHARED:
        a, b = s.split("/")
        leaf = shared[a][b]
        assert isinstance(leaf, QuantizedLinear) and leaf.codes.ndim == 2   # one copy
    assert isinstance(shared["attn_norm"]["g"], torch.Tensor)
    in_proj = qp["segments"][0]["s0_M"]["ssm"]["in_proj"]
    assert isinstance(in_proj, QuantizedLinear) and in_proj.codes.shape[0] == 2
    assert isinstance(qp["segments"][0]["s0_M"]["ssm"]["conv_w"], torch.Tensor)
    toks = torch.from_numpy(_toks(tcfg, (2, 5)))
    lg, _ = m.forward(m.prepare(qp, n_hint=2), toks)
    assert bool(torch.isfinite(lg).all())


def test_check_supported_admits_zamba2():
    transformer.check_supported(get_config(ARCH, smoke=True))
    transformer.check_supported(get_config(ARCH))
    assert transformer.segments(get_config(ARCH)) == [("MMMMMS", 13), ("MMM", 1)]


@pytest.mark.parametrize("case", ["--prepared-ckpt", "--request-log", "--autotune", "--plan",
                                  "tune"])
def test_launchers_refuse_what_is_not_ported_for_recurrent_trees(case, tmp_path, capsys):
    """Plans and the autotuner, prepared checkpoints and the request log over
    a tree with recurrent units, once refused by the launchers, run now on
    zamba2-7b's smoke tree (``tests/_torch_launch.py``; parity with the
    reference: ``tests/test_torch_plans_families.py``)."""
    from _torch_launch import run_case

    run_case(ARCH, case, tmp_path, capsys)


@pytest.mark.parametrize("mode", ["pallas", "lut"])
def test_launch_serve_runs_zamba2(mode, capsys):
    from repro_torch.launch import serve as lserve

    extra = ["--calibrate", "16"] if mode == "lut" else []
    outs = lserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mode", mode,
                        "--requests", "3", "--max-new", "4", *extra])
    assert [len(o) for o in outs] == [4, 4, 4]
    assert "host syncs" in capsys.readouterr().out
