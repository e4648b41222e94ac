"""Port parity: repro_torch.models.moe and the MoE model trees against the JAX
reference (repro.models.moe, repro.models.model) on numpy-seeded inputs at the
smoke widths of deepseek-v2-lite-16b (MLA attention, 64 -> 8 experts top-2,
2 shared) and llama4-maverick-400b-a17b (GQA, "FD" units, 8 experts top-1,
1 shared) (CPU).

Routing ids exactly (a planted tie too), gates and the aux loss within 1e-6;
moe_apply at the published capacity (slots dropped) and dropless within
1e-4 x max |y|; expert-stack codes and scales bit for bit; maybe_dequant on
raw and prepared leaves bit for bit; the models' logits in f32 (W4A4
"pallas", calibrated W1A3 "lut") within 1e-4 x max |logit|, the frozen scales
leaf by leaf, served tokens, host syncs and admissions equal to the
reference's, and the reference's trees carried across by convert."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.core.calibrate import calibrate_tree as jcalibrate_tree  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve.serving import Request as JRequest  # noqa: E402
from repro.serve.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import LutLinearSpec, PreparedLinear, QuantizedLinear  # noqa: E402
from repro_torch.dist import AxisMesh, ShardCtx  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.serving import Request, ServeEngine  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"]
TOL_ROUTE = 1e-6     # gates and aux: f32 softmax sums in another order
TOL = 1e-4           # moe_apply and the models' logits, relative to max |value|
LUT = dict(bw=1, ba=3, p=2, mode="lut")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of this module on one torch thread (its smoke shapes
    gain nothing from more, and the test workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, dtype="float32", **moe_kw):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe_kw))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _moe_pair(arch, seed=0, **moe_kw):
    jcfg, tcfg = _cfgs(arch, **moe_kw)
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_numpy(_np(jp), device="cpu")


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape + (cfg.d_model,)).astype(np.float32)


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    jcfg, tcfg, jp, tp = _moe_pair(arch)
    xt = _x(jcfg, (37,))
    jg, je, ja = jmoe._route(jnp.asarray(xt), jp["router"]["w"], jcfg)
    tg, te, ta = tmoe._route(torch.from_numpy(xt), tp["router"]["w"], tcfg)
    assert te.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=TOL_ROUTE)
    np.testing.assert_allclose(float(ta), float(ja), rtol=TOL_ROUTE, atol=0)


def test_route_tie_takes_the_lower_expert_id():
    """Two equal router columns give equal probabilities: the lower expert id
    comes first, as jax.lax.top_k orders them (torch.topk does not promise
    it)."""
    jcfg, tcfg, jp, _tp = _moe_pair("deepseek-v2-lite-16b")
    w = np.asarray(jp["router"]["w"]).copy()
    xt = _x(jcfg, (16,), seed=4)
    best = (xt @ w).argmax(-1)
    # plant a twin of each token's best column at a lower and a higher index
    w[:, 5] = w[:, 2] = w[:, 6]
    xt_tie = xt.copy()
    jg, je, _ = jmoe._route(jnp.asarray(xt_tie), jnp.asarray(w), jcfg)
    tg, te, _ = tmoe._route(torch.from_numpy(xt_tie), torch.from_numpy(w), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xt_tie) @ jnp.asarray(w), axis=-1))
    tied = np.isclose(probs[:, 2], probs[:, 5], rtol=0, atol=0)
    picked = np.asarray(je)
    # where the tied pair is the top choice, the lower id (2) is taken first
    top_tie = tied & (probs[:, 2] == probs.max(-1))
    assert top_tie.any(), (best, probs.argmax(-1))
    assert (picked[top_tie, 0] == 2).all() and (picked[top_tie, 1] == 5).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity", ["published", "dropless"])
def test_moe_apply_matches_reference(arch, capacity):
    kw = {} if capacity == "published" else dict(capacity_factor=64.0)
    jcfg, tcfg, jp, tp = _moe_pair(arch, **kw)
    x = _x(jcfg, (3, 11))
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    # at the published capacity factor some slot is dropped (the case that
    # the combine's masking must get right); dropless none
    t, k, n_e = 33, jcfg.moe.top_k, jcfg.moe.n_experts
    cap = max(int(t * k / n_e * jcfg.moe.capacity_factor), 4)
    _g, eidx, _a = tmoe._route(torch.from_numpy(x.reshape(t, -1)), tp["router"]["w"], tcfg)
    load = np.bincount(eidx.numpy().ravel(), minlength=n_e)
    assert (load.max() > cap) == (capacity == "published"), (load, cap)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL_ROUTE, atol=0)


def test_moe_layer_is_deterministic_and_refuses_a_mesh():
    _jcfg, tcfg, _jp, tp = _moe_pair("deepseek-v2-lite-16b")
    x = torch.from_numpy(_x(tcfg, (4, 9)))
    a, _ = tmoe.moe_apply(tp, x, tcfg)
    b, _ = tmoe.moe_apply(tp, x, tcfg)
    assert torch.equal(a, b)

    # Under a mesh the sharded branches run, under autograd too
    # (tests/test_torch_sharded.py); what a mesh refuses is execution without
    # process groups, with or without grad.
    ctx = ShardCtx(AxisMesh((1, 2), ("data", "model")))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmoe.moe_apply(tp, x.clone().requires_grad_(), tcfg, ctx)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmoe.moe_apply(tp, x, tcfg, ctx)


# ---------------------------------------------------------------------------
# expert stacks: quantize, prepare, maybe_dequant
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def quantized(request):
    jcfg, tcfg = _cfgs(request.param)
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jraw = jm.init(jax.random.PRNGKey(0))
    traw = params_from_numpy(_np(jraw), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jraw=jraw, traw=traw)


def _moe_of(params):
    return params["segments"][-1]["s1_D" if "s1_D" in params["segments"][-1] else "s0_D"]["moe"]


@pytest.mark.parametrize("mode", ["pallas", "lut"])
def test_expert_stacks_quantize_and_prepare_like_reference(quantized, mode):
    spec = dict(bw=4, ba=4, mode="pallas") if mode == "pallas" else LUT
    jq = quantized["jm"].quantize(quantized["jraw"], JSpec(**spec))
    tq = quantized["tm"].quantize(quantized["traw"], LutLinearSpec(**spec))
    jmoe_q, tmoe_q = _moe_of(jq), _moe_of(tq)
    assert not isinstance(tmoe_q["router"], QuantizedLinear)        # the router stays dense
    assert isinstance(tmoe_q["shared"]["w_up"], QuantizedLinear)     # shared: a plain FFN
    for name in ("w_gate", "w_up", "w_down"):
        jl, tl = jmoe_q[name], tmoe_q[name]
        assert isinstance(tl, QuantizedLinear) and tl.codes.ndim == 4   # [units, E, F, KB]
        np.testing.assert_array_equal(tl.codes.numpy(), np.asarray(jl.codes))
        np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
        assert tl.k == jl.k
    if mode != "lut":
        return      # the lut leaves carry wpk and the capped wcanon: prepare those
    jp, tp = jmodel.prepare_params(jq, n_hint=4), tmodel.prepare_params(tq, n_hint=4)
    for name in ("w_gate", "w_up", "w_down"):
        jl, tl = _moe_of(jp)[name], _moe_of(tp)[name]
        assert isinstance(tl, PreparedLinear) and tl.p == jl.p
        for field in ("wcodes", "wpk", "wcanon"):
            jf, tf = getattr(jl, field), getattr(tl, field)
            assert (tf is None) == (jf is None), field
            if tf is not None:
                np.testing.assert_array_equal(tf.numpy(), np.asarray(jf), field)


@pytest.mark.parametrize("mode", ["dequant", "pallas"])
def test_maybe_dequant_equals_reference_on_raw_and_prepared_leaves(quantized, mode):
    """Both reference branches: the prepared dequant-mode leaf decodes from
    its cached ``wcodes``, every other leaf through ``dequantize_weights``;
    raw and prepared decode to the same bits."""
    spec = dict(bw=4, ba=4, mode=mode)
    jq = quantized["jm"].quantize(quantized["jraw"], JSpec(**spec))
    jp = jmodel.prepare_params(jq, n_hint=4)
    tq, tp = params_from_numpy(_np(jq), device="cpu"), params_from_numpy(_np(jp), device="cpu")
    for name in ("w_gate", "w_down"):
        want = np.asarray(jmodel.maybe_dequant(_moe_of(jq)[name], jnp.float32))
        raw = tmodel.maybe_dequant(_moe_of(tq)[name], torch.float32)
        prep = tmodel.maybe_dequant(_moe_of(tp)[name], torch.float32)
        assert (_moe_of(tp)[name].wcodes is not None) == (mode == "dequant")
        np.testing.assert_array_equal(raw.numpy(), want)
        np.testing.assert_array_equal(prep.numpy(), want)
        bf = tmodel.maybe_dequant(_moe_of(tp)[name], torch.bfloat16)
        want_bf = np.asarray(jmodel.maybe_dequant(_moe_of(jp)[name], jnp.bfloat16))
        np.testing.assert_array_equal(bf.float().numpy(), want_bf.astype(np.float32))
    dense = _moe_of(quantized["traw"])["w_up"]
    assert tmodel.maybe_dequant(dense) is dense                     # a raw stack passes


@pytest.mark.parametrize("matrices", [1, 3])
@pytest.mark.parametrize("mode", ["dequant", "pallas"])
def test_bounded_expert_decode_equals_whole_decode_and_reference(quantized, mode, matrices,
                                                                  monkeypatch):
    """``maybe_dequant`` decodes a stack a few matrices at a time (here
    ``DECODE_CHUNK_BYTES`` set to one matrix's f32 bytes, or three with a
    shorter last chunk): bit-equal, in the same layout, to the whole-stack
    formula ``decode_weight(p).to(dtype)`` and to the reference's
    ``maybe_dequant``, on raw and prepared leaves, in f32 and bf16."""
    spec = dict(bw=4, ba=4, mode=mode)
    jq = quantized["jm"].quantize(quantized["jraw"], JSpec(**spec))
    jp = jmodel.prepare_params(jq, n_hint=4)
    tq, tp = params_from_numpy(_np(jq), device="cpu"), params_from_numpy(_np(jp), device="cpu")
    cfg = quantized["tcfg"]
    assert cfg.moe.n_experts % 3
    monkeypatch.setattr(tmodel, "DECODE_CHUNK_BYTES",
                        matrices * 4 * cfg.d_model * cfg.moe.d_ff_expert)
    for name in ("w_gate", "w_up", "w_down"):
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            want = np.asarray(jmodel.maybe_dequant(_moe_of(jp)[name], jdt)).astype(np.float32)
            for leaf in (_moe_of(tq)[name], _moe_of(tp)[name]):
                got, whole = tmodel.maybe_dequant(leaf, dt), tlayers.decode_weight(leaf).to(dt)
                assert got.dtype == dt and torch.equal(got, whole)
                assert got.shape == whole.shape and got.stride() == whole.stride()
                np.testing.assert_array_equal(got.float().numpy(), want)


def test_moe_apply_holds_one_decoded_stack_at_a_time(quantized, monkeypatch):
    """``moe_apply`` decodes ``w_gate``, ``w_up`` and ``w_down`` in turn, each
    just before its ``torch.bmm``, and drops each before the next is
    decoded: a call never holds two decoded stacks.  Decoded a matrix at a
    time, the output is that of the same call on the stacks decoded
    beforehand."""
    import weakref

    cfg = quantized["tcfg"]
    tq = quantized["tm"].quantize(quantized["traw"], LutLinearSpec(bw=4, ba=4, mode="pallas"))
    layer = tree.index(_moe_of(tq), 0)
    x = torch.from_numpy(_x(cfg, (2, 5)))
    decoded = dict(layer, **{n: tmodel.maybe_dequant(layer[n], x.dtype)
                             for n in ("w_gate", "w_up", "w_down")})
    y_whole, aux_whole = tmoe.moe_apply(decoded, x, cfg)
    refs, alive, real = [], [], tmodel.maybe_dequant

    def spy(p, dtype=torch.bfloat16):
        alive.append([r() is not None for r in refs])
        out = real(p, dtype)
        refs.append(weakref.ref(out))
        return out

    monkeypatch.setattr(tmodel, "maybe_dequant", spy)
    monkeypatch.setattr(tmodel, "DECODE_CHUNK_BYTES", 1)
    y, aux = tmoe.moe_apply(layer, x, cfg)
    assert alive == [[], [False], [False, False]]
    assert torch.equal(y, y_whole) and torch.equal(aux, aux_whole)


@pytest.mark.parametrize("mode", ["pallas", "lut"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_quantized_is_quantize_of_init(arch, mode):
    """Each expert is drawn and quantized before the next is drawn, with
    ``init``'s draws: ``init_quantized(seed)`` is ``quantize(init(seed))`` bit
    for bit, leaf for leaf."""
    spec = LutLinearSpec(**(LUT if mode == "lut" else dict(bw=4, ba=4, mode="pallas")))
    tm = tmodel.build_model(get_config(arch, smoke=True))
    got, want = tm.init_quantized(spec, 0, device="cpu"), tm.quantize(tm.init(0, device="cpu"),
                                                                       spec)
    same = []
    tree.tree_map(lambda a, b: same.append(a.dtype == b.dtype and torch.equal(a, b)), got, want)
    assert same and all(same)
    assert _layout(got) == _layout(want)


def _layout(node, path=""):
    """``[(path, shape, dtype name)]`` of every array of a port or reference
    tree, in walk order (a quantized leaf's codes and scale)."""
    if hasattr(node, "codes"):
        return [(f"{path}/{f}", tuple(getattr(node, f).shape),
                 str(getattr(node, f).dtype).replace("torch.", "")) for f in ("codes", "scale")]
    if isinstance(node, dict):
        return [x for k in node for x in _layout(node[k], f"{path}/{k}")]
    if isinstance(node, (list, tuple)):
        return [x for i, v in enumerate(node) for x in _layout(v, f"{path}/{i}")]
    if node is None:
        return []
    return [(path, tuple(node.shape), str(node.dtype).replace("torch.", ""))]


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_at_a_time_init_has_the_reference_launchers_tree(arch):
    """The expert-at-a-time ``init_quantized`` tree has the shapes and dtypes
    of the reference launcher's ``Model.quantize(Model.init(key))``, walks
    its quantized leaves in the same order and carries its fingerprint."""
    from test_torch_plans_families import SPEC, _launcher_tree

    from repro.tune.plan import param_fingerprint as jfingerprint
    from repro.tune.plan import quantized_leaf_items as jleaf_items
    from repro_torch.tune.plan import param_fingerprint, quantized_leaf_items

    _jm, jq = _launcher_tree(arch)
    tq = tmodel.build_model(dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
                            ).init_quantized(LutLinearSpec(**SPEC), device="cpu")
    assert sorted(_layout(tq)) == sorted(_layout(jq))
    assert [p for p, _ in quantized_leaf_items(tq)] == [p for p, _ in jleaf_items(jq)]
    assert param_fingerprint(tq) == jfingerprint(jq)


@pytest.mark.parametrize("kind", ["raw", "quantized", "prepared"])
def test_convert_carries_moe_trees(quantized, kind):
    jtree = quantized["jraw"]
    if kind != "raw":
        jtree = quantized["jm"].quantize(jtree, JSpec(bw=4, ba=4, mode="pallas"))
    if kind == "prepared":
        jtree = jmodel.prepare_params(jtree, n_hint=4)
    ttree = params_from_numpy(_np(jtree), device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(np.shape(a)), _np(jtree))
    tshapes = tree.tree_map(lambda t: tuple(t.shape), ttree)

    def keys(node):
        if isinstance(node, dict):
            return {k: keys(v) for k, v in node.items()}
        if isinstance(node, list):
            return [keys(v) for v in node]
        if isinstance(node, (np.ndarray, torch.Tensor)):
            return "array"
        return type(node).__name__

    assert keys(ttree) == keys(_np(jtree))
    m = _moe_of(ttree)
    assert {"router", "shared", "w_gate", "w_up", "w_down"} <= set(m)
    if quantized["jcfg"].attn_kind == "mla":
        assert "kv_norm" in ttree["segments"][0]["s0_F"]["attn"]
    if kind == "raw":
        assert tshapes == jshapes
    else:
        for name in ("w_gate", "w_up", "w_down"):
            assert tuple(m[name].codes.shape) == tuple(np.shape(_moe_of(jtree)[name].codes))


# ---------------------------------------------------------------------------
# whole models: logits, calibration, serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def pallas_pair(request):
    """The reference's raw W4A4 pallas tree (the reference cannot run a
    prepared MLA tree: test_torch_mla.py) and the port's prepared one."""
    jcfg, tcfg = _cfgs(request.param)
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=4, ba=4, mode="pallas"))
    tp = tm.prepare(params_from_numpy(_np(jq), device="cpu"), n_hint=4)
    return jcfg, jm, jq, tm, tp


def _toks(cfg, shape, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _recording(monkeypatch, module, seen):
    """Wrap ``module._route`` so that each call's expert ids land in ``seen``
    (the reference's through an ordered callback: its units run under
    ``lax.scan``)."""
    route = module._route

    def wrapped(*args):
        out = route(*args)
        if isinstance(out[1], torch.Tensor):
            seen.append(out[1].numpy())
        else:
            jax.debug.callback(lambda e: seen.append(np.asarray(e)), out[1], ordered=True)
        return out

    monkeypatch.setattr(module, "_route", wrapped)


def test_pallas_logits_and_expert_ids_match_reference(pallas_pair, monkeypatch):
    jcfg, jm, jq, tm, tp = pallas_pair
    toks = _toks(jcfg, (2, 9))
    tseen, jseen = [], []
    _recording(monkeypatch, tmoe, tseen)
    _recording(monkeypatch, jmoe, jseen)
    jl = jax.block_until_ready(jm.forward(jq, jnp.asarray(toks))[0])
    jax.effects_barrier()
    tl, _ = tm.forward(tp, torch.from_numpy(toks))
    _close(tl, jl)
    assert len(tseen) == len(jseen) == jcfg.n_moe_layers()
    for te, je in zip(tseen, jseen):
        np.testing.assert_array_equal(te, je)


def test_prefill_decode_matches_forward(pallas_pair):
    """As tests/test_serving.py::test_prefill_decode_matches_forward, on a
    dropless copy (at the published capacity a row's output depends on the
    call's token count), each step also held to the reference's forward."""
    jcfg, _jm, jq, _tm, _tp = pallas_pair
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=64.0))
    tcfg = dataclasses.replace(_tm.cfg, moe=dataclasses.replace(_tm.cfg.moe, capacity_factor=64.0))
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    tp = tm.prepare(params_from_numpy(_np(jq), device="cpu"), n_hint=2)
    B, S, PRE = 2, 10, 5
    toks = _toks(jcfg, (B, S), seed=1)
    jfull = np.asarray(jm.forward(jq, jnp.asarray(toks))[0])
    tfull, _ = tm.forward(tp, torch.from_numpy(toks))
    _close(tfull, jfull)
    caches = tm.init_cache(B, 16, torch.float32, device="cpu")
    pf, caches = tm.prefill(tp, torch.from_numpy(toks[:, :PRE]), caches)
    _close(pf[:, 0], tfull[:, PRE - 1].numpy())
    for t in range(PRE, S):
        lg, caches = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), caches, t)
        _close(lg[:, 0], tfull[:, t].numpy())
        _close(lg[:, 0], jfull[:, t])


def _ragged(cfg, seed, lens, budgets):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for n, m in zip(lens, budgets)]


def _serve_against_reference(jm, jtree, tm, ttree, reqs):
    jreqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    jeng = JServeEngine(jm, jtree, batch=2, max_seq=32, decode="scan")
    want = jeng.generate(jreqs)
    teng = ServeEngine(tm, ttree, batch=2, max_seq=32, decode="scan", device="cpu")
    got = teng.generate(reqs)
    assert got == want
    assert teng.admissions == jeng.admissions
    assert teng.host_syncs == jeng.host_syncs
    assert teng.bucket_counts == jeng.bucket_counts
    return got


def test_pallas_serve_matches_reference(pallas_pair):
    """Ragged prompts at the published capacity: the same rows share each
    call in both packages, so the same slots are dropped."""
    jcfg, jm, jq, tm, tp = pallas_pair
    reqs = _ragged(jcfg, 3, (3, 9, 5, 12, 6), (4, 6, 3, 5, 2))
    got = _serve_against_reference(jm, jq, tm, tp, reqs)
    # prompts at the bucket boundary: the loop driver prefills the same rows
    same = _ragged(jcfg, 0, (8, 8, 8), (4, 6, 3))
    scan = ServeEngine(tm, tp, batch=2, max_seq=32, decode="scan", device="cpu")
    loop = ServeEngine(tm, tp, batch=2, max_seq=32, decode="loop", device="cpu")
    chunked = ServeEngine(tm, tp, batch=2, max_seq=32, decode="chunked", device="cpu")
    o_scan = scan.generate(same)
    assert loop.generate(same) == o_scan and [len(o) for o in o_scan] == [4, 6, 3]
    assert chunked.generate(same) == o_scan
    assert [len(o) for o in got] == [4, 6, 3, 5, 2]


@pytest.fixture(scope="module", params=ARCHS)
def lut_pair(request):
    """Calibrated W1A3 lut: the reference's raw calibrated tree (its prepared
    MLA tree does not run) and the port's calibrated, prepared one."""
    jcfg, tcfg = _cfgs(request.param)
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(**LUT))
    cal = np.random.default_rng(7).integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jcal = jcalibrate_tree(lambda probed: jm.forward(probed, jnp.asarray(cal))[0], jq)
    tp = tm.prepare(params_from_numpy(_np(jq), device="cpu"), calibrate=cal, n_hint=2)
    return jcfg, jm, jcal, tm, tp


def _scales(params, items):
    return {path: leaf.ascale for path, leaf in items(params) if leaf.ascale is not None}


def test_calibrated_lut_scales_logits_and_serve_match_reference(lut_pair):
    from repro.tune.plan import quantized_leaf_items as jitems
    from repro_torch.tune.plan import quantized_leaf_items as titems

    jcfg, jm, jcal, tm, tp = lut_pair
    js, ts = _scales(jcal, jitems), _scales(tp, titems)
    # expert stacks and MLA's absorbed W_kup / W_vup consume no activation scale
    assert sorted(js) == sorted(ts) and js
    assert not any(p.endswith(("w_kup", "w_vup")) or "/moe/w_" in p for p in ts)
    for path, want in js.items():
        np.testing.assert_allclose(ts[path].numpy(), np.asarray(want), rtol=2**-21, atol=0,
                                   err_msg=path)
    toks = _toks(jcfg, (2, 7))
    jl = jm.forward(jcal, jnp.asarray(toks))[0]
    tl, _ = tm.forward(tp, torch.from_numpy(toks))
    _close(tl, jl)
    reqs = _ragged(jcfg, 5, (6, 6, 6, 6), (6, 2, 4, 2))
    _serve_against_reference(jm, jcal, tm, tp, reqs)
    # prompts at the bucket boundary: the loop driver prefills the same rows
    same = _ragged(jcfg, 0, (8, 8, 8), (4, 6, 3))
    scan = ServeEngine(tm, tp, batch=2, max_seq=32, decode="scan", device="cpu")
    loop = ServeEngine(tm, tp, batch=2, max_seq=32, decode="loop", device="cpu")
    assert loop.generate(same) == scan.generate(same)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_calibrated_scales_equal_reference(arch):
    """In bfloat16 the frozen scales equal the reference's bit for bit."""
    from repro.tune.plan import quantized_leaf_items as jitems
    from repro_torch.tune.plan import quantized_leaf_items as titems

    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(**LUT))
    cal = np.random.default_rng(7).integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jcal = jcalibrate_tree(lambda probed: jm.forward(probed, jnp.asarray(cal))[0], jq)
    tp = tm.prepare(params_from_numpy(_np(jq), device="cpu"), calibrate=cal, n_hint=2)
    js, ts = _scales(jcal, jitems), _scales(tp, titems)
    assert sorted(js) == sorted(ts) and js
    for path, want in js.items():
        np.testing.assert_array_equal(ts[path].numpy(), np.asarray(want), path)


def test_check_supported_admits_moe_and_mla():
    for arch in ARCHS:
        transformer.check_supported(get_config(arch, smoke=True))
        transformer.check_supported(get_config(arch))


@pytest.mark.parametrize("case", ["--prepared-ckpt", "--request-log", "--autotune", "tune"])
def test_launchers_refuse_what_is_not_ported_for_moe_trees(case, tmp_path, capsys):
    """Plans, prepared checkpoints and live ops of an MoE or MLA tree, once
    refused by the launchers, run now: each flag serves both MoE configs'
    smoke trees on the CPU (``tests/_torch_launch.py``; parity with the
    reference: ``tests/test_torch_plans_families.py``)."""
    from _torch_launch import run_case

    for arch in ARCHS:
        run_case(arch, case, tmp_path / arch, capsys)
