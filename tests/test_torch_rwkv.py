"""Port parity: rwkv6-3b (RWKV6 "Finch" "R" units: repro_torch.models.rwkv)
against the JAX reference on numpy-seeded inputs at its smoke widths (3
layers, d_model 64, 8 heads of 8), f32 unless stated (CPU).

The block: ``rwkv_time_mix`` / ``rwkv_channel_mix`` from a zero state and
onto a carried one, at S = 1, S = 10 and S = 256 (the reference's
checkpointed ``chunked_scan`` branch), outputs and state within 1e-4 x max
|value|; with a bf16 state the port rounds it to bf16 after every call, as
the reference does.  The model: the forward within 1e-4 x max |logit| over
raw, W4A4 "dequant" / "pallas", W1A3 "lut" and prepared trees (prepared ==
raw bit for bit); prefill + decode against the forward; ServeEngine's
tokens, admissions, host syncs and bucket counts equal the reference's per
driver (W4A4 "dequant"); calibrated W1A3 "lut": the frozen scales at rtol
2**-21 and the tokens; the reference's trees carried across by convert; the
launchers over rwkv6-3b."""

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
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.serve.serving import Request as JRequest  # noqa: E402
from repro.serve.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import LutLinearSpec, PreparedLinear, QuantizedLinear  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.serving import Request, ServeEngine  # noqa: E402

ARCH = "rwkv6-3b"
TOL = 1e-4            # f32: the same sums in another order, relative to max |value|
LUT = dict(bw=1, ba=3, p=2, mode="lut")
B = 2
DENSE = ("mu", "mix_a", "mix_b", "w0", "w_a", "w_b", "u", "ln_g", "ln_b")
PROJ = {"time_mix": ("wr", "wk", "wv", "wg", "wo"), "channel_mix": ("wk", "wv", "wr")}
# The reference's mixes, each compiled whole once per shape (eager, XLA
# compiles op by op: slower at these sizes); jit keeps the branch taken.
jtime_mix = jax.jit(jrwkv.rwkv_time_mix, static_argnums=2)
jchannel_mix = jax.jit(jrwkv.rwkv_channel_mix, static_argnums=2)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _toks(cfg, shape, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _x(cfg, seq, seed):
    return np.random.default_rng(seed).normal(size=(B, seq, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """One unit's time mix and channel mix from the reference, with mu, w0,
    u and the group norm's ln_g / ln_b drawn away from their init values
    (0.5, -0.6, ones and zeros would hide a wrong index or broadcast) and
    the LoRA matrices scaled up so the mixes move; carried across by
    convert."""
    jcfg, tcfg = _cfgs()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    d = jcfg.d_model
    jt = _np(jrwkv.rwkv_time_init(jcfg, k1))
    jt.update(mu=rng.uniform(0, 1, jt["mu"].shape).astype(np.float32),
              mix_a=jt["mix_a"] * 30, mix_b=jt["mix_b"] * 30, w_a=jt["w_a"] * 30,
              w0=rng.normal(-0.6, 0.5, d).astype(np.float32),
              u=rng.normal(0, 0.5, jt["u"].shape).astype(np.float32),
              ln_g=rng.normal(1, 0.2, d).astype(np.float32),
              ln_b=rng.normal(0, 0.2, d).astype(np.float32))
    jc = _np(jrwkv.rwkv_channel_init(jcfg, k2))
    jc.update(mu_k=rng.uniform(0, 1, d).astype(np.float32),
              mu_r=rng.uniform(0, 1, d).astype(np.float32))
    return (jcfg, tcfg, jt, jc, params_from_numpy(jt, device="cpu"),
            params_from_numpy(jc, device="cpu"))


def _carried(cfg, seed):
    j0 = jrwkv.init_rwkv_state(cfg, B, jnp.float32)
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 0.5, v.shape).astype(np.float32) for k, v in j0.items()}


def _tstate(cfg, values=None, dtype=torch.float32):
    st = trwkv.init_rwkv_state(cfg, B, dtype, device="cpu")
    for k, v in (values or {}).items():
        st[k].copy_(torch.from_numpy(v))
    return st


@pytest.mark.parametrize("seq", [1, 10, 256])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_time_and_channel_mix_match_reference(block, seq, carried):
    """Both mixes at S = 1, 10 and 256 (the reference's chunked scan), from
    no state or onto a carried nonzero one; the outputs and every state
    leaf after the call, written into the port's tensors in place."""
    jcfg, tcfg, jt, jc, tt, tc = block
    x = _x(jcfg, seq, seq)
    vals = _carried(jcfg, 4) if carried else None
    jst = {k: jnp.asarray(v) for k, v in vals.items()} if carried else None
    tst = _tstate(tcfg, vals) if carried else None
    held = dict(tst) if carried else None
    jy, jst = jtime_mix(jt, jnp.asarray(x), jcfg, jst)
    ty, back = trwkv.rwkv_time_mix(tt, torch.from_numpy(x), tcfg, tst)
    _close(ty, jy)
    jy2, jst = jchannel_mix(jc, jnp.asarray(x), jcfg, jst)
    ty2, back = trwkv.rwkv_channel_mix(tc, torch.from_numpy(x), tcfg, back)
    _close(ty2, jy2)
    if not carried:
        assert jst is None and back is None
        return
    assert back is tst and all(tst[k] is held[k] for k in held)       # written in place
    for k in ("s", "x_prev_t", "x_prev_c"):
        _close(tst[k], jst[k])
    np.testing.assert_array_equal(tst["x_prev_t"].numpy(), x[:, -1])  # the normed input's row


def test_prefill_equals_prefill_then_decode_in_the_port(block):
    """The recurrence's one step function: a prefill of S tokens and a
    prefill of S - 3 followed by 3 decode steps give the same outputs and
    state within the f32 tolerance."""
    _jcfg, tcfg, _jt, _jc, tt, _tc = block
    seq = 11
    x = torch.from_numpy(_x(tcfg, seq, 6))
    whole, split = _tstate(tcfg), _tstate(tcfg)
    y_whole, _ = trwkv.rwkv_time_mix(tt, x, tcfg, whole)
    ys = [trwkv.rwkv_time_mix(tt, x[:, : seq - 3], tcfg, split)[0]]
    ys += [trwkv.rwkv_time_mix(tt, x[:, t : t + 1], tcfg, split)[0] for t in range(seq - 3, seq)]
    _close(torch.cat(ys, dim=1), y_whole.numpy())
    for k in ("s", "x_prev_t"):
        _close(split[k], whole[k].numpy())


def test_state_dtype_follows_the_cache_as_in_the_reference(block):
    """With a bf16 state the reference rounds ``s`` and both ``x_prev`` rows
    to bf16 after every call (f32 activations): the port's bf16 state is
    bf16 and its outputs over a prefill and 4 decode steps follow the
    reference's within 1e-4 x max |y|, where an f32 state does not."""
    jcfg, tcfg, jt, jc, tt, tc = block
    x = _x(jcfg, 14, 8)
    vals = _carried(jcfg, 9)

    def ref():
        st = {k: jnp.asarray(v, jnp.bfloat16) for k, v in vals.items()}
        ys = []
        for sl in (slice(0, 10),) + tuple(slice(t, t + 1) for t in range(10, 14)):
            y, st = jtime_mix(jt, jnp.asarray(x[:, sl]), jcfg, st)
            y2, st = jchannel_mix(jc, jnp.asarray(x[:, sl]), jcfg, st)
            ys.append(np.asarray(y) + np.asarray(y2))
        return np.concatenate(ys, axis=1), st

    def port(dtype):
        st = _tstate(tcfg, {k: np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
                            for k, v in vals.items()}, dtype)
        ys = []
        for sl in (slice(0, 10),) + tuple(slice(t, t + 1) for t in range(10, 14)):
            xs = torch.from_numpy(x[:, sl])
            y, _ = trwkv.rwkv_time_mix(tt, xs, tcfg, st)
            y2, _ = trwkv.rwkv_channel_mix(tc, xs, tcfg, st)
            ys.append((y + y2).numpy())
        return np.concatenate(ys, axis=1), st

    jy, jst = ref()
    ty, tst = port(torch.bfloat16)
    assert {k: str(v.dtype) for k, v in jst.items()} == {k: "bfloat16" for k in vals}
    assert all(v.dtype == torch.bfloat16 for v in tst.values())
    _close(ty, jy)
    for k in vals:
        want = np.asarray(jst[k], np.float32)
        got = tst[k].float().numpy()
        # equal bf16 values but where the f32 values straddle a rounding point
        assert np.mean(got == want) > 0.99
        _close(got, want, tol=2.0**-8)
    fy, _ = port(torch.float32)
    assert np.abs(fy - jy).max() > TOL * np.abs(jy).max()


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    return jcfg, jm, jm.init(jax.random.PRNGKey(0)), tm


@pytest.fixture(scope="module")
def pallas_ref(models):
    """The reference's raw W4A4 pallas tree and its logits (its prepared
    tree gives the same: the reference's prepare/apply contract)."""
    jcfg, jm, jraw, _tm = models
    jq = jm.quantize(jraw, JSpec(bw=4, ba=4, mode="pallas"))
    return jq, np.asarray(jm.forward(jq, jnp.asarray(_toks(jcfg, (2, 9))))[0])


@pytest.mark.parametrize("kind", ["raw", "dequant", "pallas", "lut", "prepared"])
def test_forward_matches_reference(models, pallas_ref, kind):
    """Logits against the reference's over its raw tree and its W4A4
    dequant / pallas and W1A3 lut trees; a prepared tree (W4A4 pallas)
    equals its raw tree bit for bit in the port."""
    jcfg, jm, jraw, tm = models
    toks = _toks(jcfg, (2, 9))
    if kind in ("pallas", "prepared"):
        jtree, jl = pallas_ref
    else:
        spec = {"raw": None, "dequant": JSpec(bw=4, ba=4, mode="dequant"),
                "lut": JSpec(**LUT)}[kind]
        jtree = jraw if spec is None else jm.quantize(jraw, spec)
        jl = jm.forward(jtree, jnp.asarray(toks))[0]
    ttree = params_from_numpy(_np(jtree), device="cpu")
    tl, _ = tm.forward(ttree, torch.from_numpy(toks))
    assert tl.shape == (2, 9, jcfg.vocab_size)
    if kind == "prepared":
        raw_logits = tl
        ttree = tm.prepare(ttree, n_hint=2)
        assert isinstance(ttree["segments"][0]["s0_R"]["time_mix"]["wr"], PreparedLinear)
        tl, _ = tm.forward(ttree, torch.from_numpy(toks))
        assert torch.equal(tl, raw_logits)
    _close(tl, jl)


def test_prefill_decode_matches_forward(models):
    """As tests/test_serving.py::test_prefill_decode_matches_forward for
    rwkv6-3b (B = 2, S = 10, a 5-token prefill, the cache over 16 slots),
    each step also held to the reference's forward, within 1e-4 x max
    |logit| (the reference asserts 3e-2)."""
    jcfg, jm, jraw, tm = models
    tp = params_from_numpy(_np(jraw), device="cpu")
    S, PRE = 10, 5
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


def test_smoke_quantized_forward():
    """As tests/test_models_smoke.py::test_smoke_quantized_forward for
    rwkv6-3b: W4A4 dequant logits are finite, the packed tree is smaller
    than the dense one, and only the 8 projections of a layer quantize."""
    _jcfg, tcfg = _cfgs()
    m = tmodel.build_model(tcfg)
    params = m.init(0, device="cpu")
    qparams = m.quantize(params, LutLinearSpec(bw=4, ba=4, mode="dequant"))
    lg, _ = m.forward(qparams, torch.from_numpy(_toks(tcfg, (2, 7))))
    assert bool(torch.isfinite(lg).all())
    nbytes = lambda t: sum(x.numel() * x.element_size() for x in tree.tensors(t))  # noqa: E731
    assert nbytes(qparams) < nbytes(params)
    unit = qparams["segments"][0]["s0_R"]
    for mix, names in PROJ.items():
        assert all(isinstance(unit[mix][n], QuantizedLinear) for n in names)
    assert all(isinstance(unit["time_mix"][n], torch.Tensor) for n in DENSE)


def test_cache_layout_follows_the_reference(models):
    """An "R" cache is the RWKV6 state stacked over the units, in the cache
    dtype (the reference's too), the same size at any max_seq."""
    _jcfg, jm, _jraw, tm = models
    jc = _np(jm.init_cache(2, 16, jnp.bfloat16))
    tc = tm.init_cache(2, 16, torch.bfloat16, device="cpu")
    assert jax.tree.map(np.shape, jc) == tree.tree_map(lambda t: tuple(t.shape), tc)
    assert list(tc[0]["s0_R"]) == sorted(tc[0]["s0_R"])
    assert all(t.dtype == torch.bfloat16 for t in tree.tensors(tc))
    big = tm.init_cache(2, 4096, torch.bfloat16, device="cpu")
    assert tree.tree_map(lambda t: tuple(t.shape), big) == tree.tree_map(
        lambda t: tuple(t.shape), tc)


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
    """Ragged prompts (5, 8, 3, ...): the pads go through the token shift and
    the recurrence in both packages (nothing masks them), so each driver is
    held to the reference's same driver: tokens, admissions, host syncs and
    bucket counts."""
    jcfg, jm, jp, tm, tp = served_pair
    reqs = _ragged(jcfg, 3, (5, 8, 3, 6, 2), (4, 6, 3, 5, 2))
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


def test_calibrated_lut_scales_and_tokens_match_reference(lut_pair):
    """The frozen scales leaf by leaf (one per quantized leaf: wr / wk / wv /
    wg read five different ddlerp mixes, so their maxima differ), then the
    logits and the served tokens."""
    from repro.tune.plan import quantized_leaf_items as jitems
    from repro_torch.tune.plan import quantized_leaf_items as titems

    jcfg, jm, jcal, tm, tq, cal = lut_pair
    tp = tm.prepare(tq, calibrate=cal, n_hint=2)
    js = {p: leaf.ascale for p, leaf in jitems(jcal) if leaf.ascale is not None}
    ts = {p: leaf.ascale for p, leaf in titems(tp) if leaf.ascale is not None}
    assert sorted(js) == sorted(ts) and len(ts) == 8
    for path, want in js.items():
        # f32 sums in another order (ROADMAP Queue 3 item 2)
        np.testing.assert_allclose(ts[path].numpy(), np.asarray(want), rtol=2**-21, atol=0,
                                   err_msg=path)
    mixes = ts["segments/0/s0_R/time_mix/wr"], ts["segments/0/s0_R/time_mix/wk"]
    assert not torch.equal(*mixes)
    toks = _toks(jcfg, (2, 7))
    _close(tm.forward(tp, torch.from_numpy(toks))[0], jm.forward(jcal, jnp.asarray(toks))[0])
    reqs = _ragged(jcfg, 5, (6, 6, 6, 6), (6, 2, 4, 2))
    jreqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    want = JServeEngine(jm, jcal, batch=2, max_seq=32, decode="scan").generate(jreqs)
    assert ServeEngine(tm, tp, batch=2, max_seq=32, decode="scan", device="cpu").generate(
        reqs) == want


@pytest.mark.parametrize("kind", ["raw", "quantized", "prepared", "calibrated"])
def test_convert_carries_rwkv_trees(models, lut_pair, kind):
    jcfg, jm, jraw, _tm = models
    jtree = {"raw": lambda: jraw,
             "quantized": lambda: jm.quantize(jraw, JSpec(bw=4, ba=4, mode="pallas")),
             "prepared": lambda: jm.prepare(jm.quantize(jraw, JSpec(bw=4, ba=4, mode="dequant")),
                                            n_hint=2),
             "calibrated": lambda: lut_pair[2]}[kind]()
    ttree = params_from_numpy(_np(jtree), device="cpu")
    unit, junit = ttree["segments"][0]["s0_R"], jtree["segments"][0]["s0_R"]
    assert set(unit) == {"tm_norm", "time_mix", "cm_norm", "channel_mix"}
    assert set(unit["time_mix"]) == set(DENSE) | set(PROJ["time_mix"])
    for name in DENSE:
        np.testing.assert_array_equal(unit["time_mix"][name].numpy(),
                                      np.asarray(junit["time_mix"][name]))
    leaf_type = {"raw": dict, "quantized": QuantizedLinear, "prepared": PreparedLinear,
                 "calibrated": QuantizedLinear}[kind]
    for mix, names in PROJ.items():
        assert all(isinstance(unit[mix][n], leaf_type) for n in names)
    if kind != "raw":
        leaf, jleaf = unit["channel_mix"]["wk"], junit["channel_mix"]["wk"]
        np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(jleaf.codes))
        assert (leaf.ascale is None) == (kind != "calibrated")
        if kind == "calibrated":
            np.testing.assert_array_equal(leaf.ascale.numpy(), np.asarray(jleaf.ascale))
    else:
        assert jax.tree.map(np.shape, _np(jtree)) == jax.tree.map(
            np.shape, tree.tree_map(lambda t: t.numpy(), ttree))


def test_init_quantized_keeps_the_lora_and_decay_dense():
    """``init_quantized`` quantizes the 8 projections of each unit as it
    draws it; the LoRA mixes, mu, w0, u and the group norm stay dense f32."""
    _jcfg, tcfg = _cfgs()
    m = tmodel.build_model(tcfg)
    qp = m.init_quantized(LutLinearSpec(bw=4, mode="pallas"), seed=0, device="cpu")
    unit = qp["segments"][0]["s0_R"]
    for mix, names in PROJ.items():
        for n in names:
            assert isinstance(unit[mix][n], QuantizedLinear)
            assert unit[mix][n].codes.shape[0] == tcfg.n_layers
    for n in DENSE:
        assert unit["time_mix"][n].dtype == torch.float32
        assert unit["time_mix"][n].shape[0] == tcfg.n_layers
    lg, _ = m.forward(m.prepare(qp, n_hint=2), torch.from_numpy(_toks(tcfg, (2, 5))))
    assert bool(torch.isfinite(lg).all())


def test_check_supported_admits_rwkv6_only_with_r_units():
    transformer.check_supported(get_config(ARCH, smoke=True))
    transformer.check_supported(get_config(ARCH))
    assert transformer.segments(get_config(ARCH)) == [("R", 32)]
    mixed = dataclasses.replace(get_config("stablelm-12b", smoke=True), attn_kind="none")
    with pytest.raises(NotImplementedError, match="not ported"):
        transformer.check_supported(mixed)


@pytest.mark.parametrize("case", ["--prepared-ckpt", "--plan"])
def test_launch_serve_refuses_plans_and_checkpoints_for_rwkv(case, tmp_path, capsys):
    """Once refused, a plan and a prepared checkpoint of rwkv6-3b's smoke
    tree serve through the launcher now (``tests/_torch_launch.py``)."""
    from _torch_launch import run_case

    run_case(ARCH, case, tmp_path, capsys)


@pytest.mark.parametrize("mode", ["pallas", "lut"])
def test_launch_serve_runs_rwkv(mode, capsys):
    from repro_torch.launch import serve as lserve

    extra = ["--calibrate", "16"] if mode == "lut" else []
    outs = lserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mode", mode,
                        "--requests", "3", "--max-new", "4", *extra])
    assert [len(o) for o in outs] == [4, 4, 4]
    assert "host syncs" in capsys.readouterr().out
