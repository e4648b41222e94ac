"""Port parity: whisper-large-v3 (the encoder-decoder path: ``prefix_embeds``,
the ``"E"`` encoder units, ``"C"`` decoder units with cross attention and
their ``ck`` / ``cv`` caches, sinusoidal positions) against the JAX reference
on numpy-seeded inputs at its smoke widths (2 + 2 layers, d_model 64, 4
heads of 16, 24 frames), f32 unless stated (CPU).

The pieces: ``sinusoidal_positions`` bit for bit, ``sinusoid_at`` at rtol
2**-21; ``cross_kv`` / ``cross_attention`` raw and prepared (W4A4) and the
encoder (``attn_impl`` "xla" and "flash", the kernel's plain version here)
within 1e-4 / 2e-4 x max |y|.  The model: the forward with frames, and the
transcription path (prefill with frames, then decode steps over the cached
cross keys and values) against the reference's same calls and the port's
own forward, within 1e-4 x max |logit|; the reference's dtype rules (the
encoder runs in the frames' dtype; cross K/V are rounded to the cache's
dtype before they are read); ServeEngine (no frames: a zero cross cache, as
the reference serves) per driver: tokens, admissions, host syncs and bucket
counts; calibrated W1A3 "lut" with frames in bf16: the frozen scales bit
for bit and the tokens (in f32, up to the first code that an ulp flips);
calibration without frames raising in both packages; the
reference's trees carried across by convert; the launcher.  The reference's
calls run under ``jax.jit``."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.core.calibrate import calibrate_tree as jcalibrate_tree  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve.serving import Request as JRequest  # noqa: E402
from repro.serve.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import LutLinearSpec, PreparedLinear, QuantizedLinear  # noqa: E402
from repro_torch.core.calibrate import calibrate_tree  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.serving import Request, ServeEngine  # noqa: E402

ARCH = "whisper-large-v3"
TOL = 1e-4            # f32: the same sums in another order, relative to max |value|
TOL_ENC_FLASH = 2e-4  # the encoder under attn_impl="flash" (the reference's attention tolerance)
W4 = dict(bw=4, ba=4, mode="pallas")
LUT = dict(bw=1, ba=3, p=2, mode="lut")
B = 2
ATTN = ("wq", "wk", "wv", "wo")

# The reference's calls, each compiled whole once per shape and tree.
jforward = jax.jit(lambda cfg, params, toks, pe: jtransformer.forward(
    params, cfg, toks, prefix_embeds=pe)[0], static_argnums=0)
jencode = jax.jit(lambda cfg, params, frames: jtransformer.encode(params, cfg, frames),
                  static_argnums=0)
jprefill = jax.jit(lambda cfg, params, toks, caches, pe: jtransformer.forward(
    params, cfg, toks, caches=caches, pos=jnp.int32(0), prefix_embeds=pe, is_prefill=True,
    last_token_only=True)[:2], static_argnums=0)
jdecode = jax.jit(lambda cfg, params, tok, caches, pos: jtransformer.forward(
    params, cfg, tok, caches=caches, pos=pos)[:2], static_argnums=0)


def _cfgs(dtype="float32", **kw):
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype, **kw)
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


def _frames(cfg, seed=5):
    """Stub frontend embeddings [B, frontend_seq, frontend_dim], f32 (the
    reference's own input dtype)."""
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# Sinusoidal positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,d", [(24, 64), (1500, 1280)])
def test_sinusoidal_positions_bit_equal(seq, d):
    """The encoder's table: numpy float64 rounded once to f32 in both."""
    np.testing.assert_array_equal(tlayers.sinusoidal_positions(seq, d).numpy(),
                                  np.asarray(jlayers.sinusoidal_positions(seq, d)))


@pytest.mark.parametrize("d", [64, 1280])
def test_sinusoid_at_within_ulps(d):
    """The decoder's embeddings at positions -7 .. 447 (left pads included;
    448 is whisper's decoder context), against the reference's under jit:
    f32 ``pow``, ``sin`` and ``cos`` whose last bits differ between XLA and
    torch (ROADMAP Queue 3)."""
    pos = np.arange(-7, 448, dtype=np.int32).reshape(5, 91)
    want = np.asarray(jax.jit(jlayers.sinusoid_at, static_argnums=1)(jnp.asarray(pos), d))
    got = tlayers.sinusoid_at(torch.from_numpy(pos), d).numpy()
    assert got.dtype == np.float32 and got.shape == (5, 91, d)
    np.testing.assert_allclose(got, want, rtol=2.0**-21, atol=0)


# ---------------------------------------------------------------------------
# Cross attention and the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["raw", "prepared"])
def test_cross_kv_and_cross_attention_match_reference(kind):
    """One cross block, W4A4 ``pallas`` (raw leaves, or prepared in both
    packages): ``cross_kv`` over an encoder output [B, 24, d] and
    ``cross_attention`` of 5 queries over its keys and values."""
    jcfg, tcfg = _cfgs()
    jp = jmodel.quantize_model({"cross": jattn.gqa_init(jcfg, jax.random.PRNGKey(3))}, jcfg,
                               JSpec(**W4))
    if kind == "prepared":
        jp = jmodel.prepare_params(jp, n_hint=B)
    jp = _np(jp)
    tp = params_from_numpy(jp, device="cpu")["cross"]
    leaf = PreparedLinear if kind == "prepared" else QuantizedLinear
    assert all(isinstance(tp[n], leaf) for n in ATTN)
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((B, jcfg.frontend_seq, jcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 5, jcfg.d_model)).astype(np.float32)

    @jax.jit
    def ref(p, enc_, x_):
        k, v = jattn.cross_kv(p, enc_, cfg=jcfg)
        return k, v, jattn.cross_attention(p, x_, cfg=jcfg, enc_k=k, enc_v=v)

    jk, jv, jy = ref(jp["cross"], jnp.asarray(enc), jnp.asarray(x))
    tk, tv = tattn.cross_kv(tp, torch.from_numpy(enc), cfg=tcfg)
    assert tk.shape == (B, jcfg.frontend_seq, jcfg.n_kv_heads, jcfg.hd)
    _close(tk, jk)
    _close(tv, jv)
    ty = tattn.cross_attention(tp, torch.from_numpy(x), cfg=tcfg, enc_k=tk, enc_v=tv)
    assert ty.shape == (B, 5, jcfg.d_model)
    _close(ty, jy)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    return jcfg, jm, jm.init(jax.random.PRNGKey(0)), tm


@pytest.fixture(scope="module")
def pallas_pair(models):
    """The reference's W4A4 pallas tree (raw leaves) and the port's copy."""
    jcfg, jm, jraw, _tm = models
    jq = jm.quantize(jraw, JSpec(**W4))
    return jq, params_from_numpy(_np(jq), device="cpu")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_encode_matches_reference(models, pallas_pair, impl):
    """The encoder over f32 frames, W4A4 ``pallas``: the reference under its
    own "xla" attention; the port under "xla" and under "flash" (the
    ``flash_attention`` kernel's plain version on the CPU, ``causal=False``)."""
    jcfg, _jm, _jraw, _tm = models
    jq, tq = pallas_pair
    frames = _frames(jcfg)
    want = jencode(jcfg, jq, jnp.asarray(frames))
    _jc, tcfg = _cfgs(attn_impl=impl)
    got = transformer.encode(tq, tcfg, torch.from_numpy(frames))
    assert got.shape == (B, jcfg.frontend_seq, jcfg.d_model) and got.dtype == torch.float32
    _close(got, want, tol=TOL_ENC_FLASH if impl == "flash" else TOL)


@pytest.mark.parametrize("kind", ["raw", "pallas", "prepared"])
def test_forward_matches_reference(models, pallas_pair, kind):
    """Logits of the forward with frames against the reference's over its
    raw tree and its W4A4 pallas tree; a prepared tree (W4A4 pallas) equals
    its raw tree bit for bit in the port."""
    jcfg, jm, jraw, tm = models
    toks, frames = _toks(jcfg, (B, 9)), _frames(jcfg)
    if kind == "raw":
        jtree, ttree = jraw, params_from_numpy(_np(jraw), device="cpu")
    else:
        jtree, ttree = pallas_pair
    jl = jforward(jcfg, jtree, jnp.asarray(toks), jnp.asarray(frames))
    tl, _ = tm.forward(ttree, torch.from_numpy(toks), prefix_embeds=torch.from_numpy(frames))
    assert tl.shape == (B, 9, jcfg.vocab_size)
    if kind == "prepared":
        tp = tm.prepare(ttree, n_hint=B)
        assert isinstance(tp["encoder"]["s0_E"]["attn"]["wq"], PreparedLinear)
        assert isinstance(tp["segments"][0]["s0_C"]["cross"]["wk"], PreparedLinear)
        pl, _ = tm.forward(tp, torch.from_numpy(toks), prefix_embeds=torch.from_numpy(frames))
        assert torch.equal(pl, tl)
    _close(tl, jl)


def test_prefill_decode_matches_reference_and_forward(models, pallas_pair):
    """The transcription path, as tests/test_serving.py::
    test_prefill_decode_matches_forward runs it for whisper (B = 2, S = 10,
    a 5-token prefill with the frames, the caches over 16 slots, then decode
    steps without frames over the cached cross keys and values), W4A4
    pallas: the prefill and each step against the reference's same calls
    and against the port's own forward, within 1e-4 x max |logit| (the
    reference asserts 3e-2)."""
    jcfg, jm, _jraw, tm = models
    jq, tq = pallas_pair
    S, PRE = 10, 5
    toks, frames = _toks(jcfg, (B, S), seed=1), _frames(jcfg, 7)
    pe = torch.from_numpy(frames)
    tfull, _ = tm.forward(tq, torch.from_numpy(toks), prefix_embeds=pe)
    jcaches = jm.init_cache(B, 16, jnp.float32)
    jpf, jcaches = jprefill(jcfg, jq, jnp.asarray(toks[:, :PRE]), jcaches, jnp.asarray(frames))
    caches = tm.init_cache(B, 16, torch.float32, device="cpu")
    held = caches[0]["s0_C"]["ck"]
    pf, caches = tm.prefill(tq, torch.from_numpy(toks[:, :PRE]), caches, prefix_embeds=pe)
    assert pf.shape == (B, 1, jcfg.vocab_size)
    assert caches[0]["s0_C"]["ck"] is held                           # written in place
    _close(pf, jpf)
    _close(pf[:, 0], tfull[:, PRE - 1].numpy())
    _close(caches[0]["s0_C"]["ck"], jcaches[0]["s0_C"]["ck"])
    for t in range(PRE, S):
        jlg, jcaches = jdecode(jcfg, jq, jnp.asarray(toks[:, t : t + 1]), jcaches, jnp.int32(t))
        lg, caches = tm.decode_step(tq, torch.from_numpy(toks[:, t : t + 1]), caches, t)
        _close(lg, jlg)
        _close(lg[:, 0], tfull[:, t].numpy())


def test_cache_layout_follows_the_reference(models):
    """A "C" cache: self K/V over max_seq and cross K/V over the encoder's
    frames, stacked over the units, in the cache dtype."""
    jcfg, jm, _jraw, tm = models
    jc = _np(jm.init_cache(B, 16, jnp.bfloat16))
    tc = tm.init_cache(B, 16, torch.bfloat16, device="cpu")
    assert jax.tree.map(np.shape, jc) == tree.tree_map(lambda t: tuple(t.shape), tc)
    assert sorted(tc[0]["s0_C"]) == ["ck", "cv", "k", "v"]
    assert tuple(tc[0]["s0_C"]["ck"].shape) == (jcfg.n_layers, B, jcfg.frontend_seq,
                                                 jcfg.n_kv_heads, jcfg.hd)
    assert all(t.dtype == torch.bfloat16 for t in tree.tensors(tc))


# ---------------------------------------------------------------------------
# The reference's dtype rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames_dtype", ["float32", "bfloat16"])
def test_encoder_runs_in_the_frames_dtype(frames_dtype):
    """Under a bf16 config the reference's ``encode`` does not cast the
    frames, so f32 frames run the whole encoder in f32 and bf16 frames in
    bf16; the port's output has the reference's dtype, and in f32 its
    values (raw tree) within 1e-4 x max |y|."""
    jcfg, tcfg = _cfgs("bfloat16")
    jraw = jmodel.build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(_np(jraw), device="cpu")
    frames = _frames(jcfg)
    jdt = jnp.float32 if frames_dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if frames_dtype == "float32" else torch.bfloat16
    want = jencode(jcfg, jraw, jnp.asarray(frames, jdt))
    got = transformer.encode(tp, tcfg, torch.from_numpy(frames).to(tdt))
    assert str(want.dtype) == frames_dtype and got.dtype == tdt
    if frames_dtype == "float32":
        _close(got, want)


def test_cross_kv_rounded_to_the_cache_dtype_before_it_is_read(models):
    """With a cache, the reference casts ``cross_kv``'s output to the cache's
    dtype before cross attention reads it; without a cache it does not.
    With bf16 ``ck`` / ``cv`` (f32 self K/V, f32 model) the prefill's logits
    therefore leave the cache-free forward's by more than 1e-4 x max |logit|
    in both packages, by the same amount, and the port's bf16 cross cache
    holds the reference's values."""
    jcfg, jm, jraw, tm = models
    tp = params_from_numpy(_np(jraw), device="cpu")
    toks, frames = _toks(jcfg, (B, 6), seed=3), _frames(jcfg, 9)
    jc = jm.init_cache(B, 16, jnp.float32)
    jc[0]["s0_C"] = dict(jc[0]["s0_C"], ck=jc[0]["s0_C"]["ck"].astype(jnp.bfloat16),
                         cv=jc[0]["s0_C"]["cv"].astype(jnp.bfloat16))
    jpf, jc = jprefill(jcfg, jraw, jnp.asarray(toks), jc, jnp.asarray(frames))
    jfull = np.asarray(jforward(jcfg, jraw, jnp.asarray(toks), jnp.asarray(frames)))[:, -1:]
    tc = tm.init_cache(B, 16, torch.float32, device="cpu")
    tc[0]["s0_C"]["ck"] = tc[0]["s0_C"]["ck"].to(torch.bfloat16)
    tc[0]["s0_C"]["cv"] = tc[0]["s0_C"]["cv"].to(torch.bfloat16)
    pe = torch.from_numpy(frames)
    pf, tc = tm.prefill(tp, torch.from_numpy(toks), tc, prefix_embeds=pe)
    full, _ = tm.forward(tp, torch.from_numpy(toks), prefix_embeds=pe)
    _close(pf, jpf)
    _close(full[:, -1:], jfull)
    jgap = np.asarray(jpf) - jfull
    tgap = (pf - full[:, -1:]).numpy()
    scale = np.abs(jfull).max()
    assert np.abs(jgap).max() > TOL * scale and np.abs(tgap).max() > TOL * scale
    np.testing.assert_allclose(tgap, jgap, rtol=0, atol=TOL * scale)
    assert tc[0]["s0_C"]["ck"].dtype == torch.bfloat16
    got = tc[0]["s0_C"]["ck"].float().numpy()
    want = np.asarray(jc[0]["s0_C"]["ck"], np.float32)
    assert np.mean(got == want) > 0.99      # equal bf16 values, but at rounding points
    _close(got, want, tol=2.0**-8)


# ---------------------------------------------------------------------------
# Serving (no frames: a zero cross cache, as the reference serves)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_pair(models):
    """W4A4 "dequant", prepared in both packages (the reference's "pallas"
    runs its kernel in interpret mode: slow to serve; the port's pallas
    path is held to it by test_forward_matches_reference)."""
    jcfg, jm, jraw, tm = models
    jq = jm.quantize(jraw, JSpec(bw=4, ba=4, mode="dequant"))
    return jcfg, jm, jm.prepare(jq, n_hint=B), tm, tm.prepare(
        params_from_numpy(_np(jq), device="cpu"))


def _ragged(cfg, seed, lens, budgets):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for n, m in zip(lens, budgets)]


def _jreqs(reqs):
    return [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]


@pytest.mark.parametrize("decode", ["scan", "chunked", "loop"])
def test_serve_matches_reference_under_every_driver(served_pair, decode):
    """The reference's ServeEngine passes no frames and serves against zero
    cross caches (its Request has no prefix_embeds): on prompts of 5 / 8 / 3
    tokens (and two more), each driver's tokens, admissions, host syncs and
    bucket counts equal the reference's same driver."""
    jcfg, jm, jp, tm, tp = served_pair
    reqs = _ragged(jcfg, 3, (5, 8, 3, 6, 2), (4, 6, 3, 5, 2))
    jeng = JServeEngine(jm, jp, batch=2, max_seq=32, decode=decode)
    teng = ServeEngine(tm, tp, batch=2, max_seq=32, decode=decode, device="cpu")
    got = teng.generate(reqs)
    assert got == jeng.generate(_jreqs(reqs))
    assert [len(o) for o in got] == [4, 6, 3, 5, 2]
    assert teng.admissions == jeng.admissions
    assert teng.host_syncs == jeng.host_syncs
    assert teng.bucket_counts == jeng.bucket_counts


def test_serve_cross_block_adds_nothing_over_a_zero_cross_cache(served_pair):
    """Over zero ``ck`` / ``cv`` the cross attention's output is zero (``wo``
    has no bias), so the served logits are those of the same tree with the
    cross block's ``wo`` zeroed: the encoder and the cross ``wk`` / ``wv``
    never run."""
    jcfg, _jm, _jp, tm, tp = served_pair
    toks = torch.from_numpy(_toks(jcfg, (B, 7), seed=4))
    caches = tm.init_cache(B, 16, torch.float32, device="cpu")
    lg, _ = tm.prefill(tp, toks, caches)
    h = torch.zeros((B, 7, jcfg.d_model))
    y = tattn.cross_attention(tree.index(tp["segments"][0]["s0_C"]["cross"], 0), h, cfg=tm.cfg,
                              enc_k=caches[0]["s0_C"]["ck"][0], enc_v=caches[0]["s0_C"]["cv"][0])
    assert torch.equal(y, torch.zeros_like(y))
    assert bool(torch.isfinite(lg).all())
    assert not caches[0]["s0_C"]["ck"].any() and caches[0]["s0_C"]["k"].any()


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def _calibrated(jcfg, jm, jq, tm, frames):
    """``jq`` calibrated with ``frames`` in both packages by the reference's
    own ``calibrate_tree`` and the port's, each with a closure that passes
    the frames (``Model.prepare(calibrate=tokens)`` cannot: no frames);
    returns the reference's tree, the port's copy of ``jq`` and its
    calibrated tree."""
    cal = np.random.default_rng(7).integers(1, jcfg.vocab_size, (B, 8)).astype(np.int32)
    frames = jnp.asarray(frames)
    jcal = jcalibrate_tree(lambda probed: jm.forward(probed, jnp.asarray(cal),
                                                     prefix_embeds=frames)[0], jq)
    tq = params_from_numpy(_np(jq), device="cpu")
    pe = _port_frames(frames)
    tcal = calibrate_tree(lambda probed: tm.forward(probed, torch.from_numpy(cal),
                                                    prefix_embeds=pe)[0], tq)
    return jcal, tq, tcal, cal


def _port_frames(frames):
    """The port's copy of the reference's frames, in their dtype."""
    dt = torch.bfloat16 if frames.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(frames, np.float32)).to(dt)


def _scales(jtree, ttree):
    from repro.tune.plan import quantized_leaf_items as jitems
    from repro_torch.tune.plan import quantized_leaf_items as titems

    js = {p: np.asarray(leaf.ascale) for p, leaf in jitems(jtree) if leaf.ascale is not None}
    ts = {p: leaf.ascale.numpy() for p, leaf in titems(ttree) if leaf.ascale is not None}
    assert sorted(js) == sorted(ts) and len(ts) == 6 + 10
    assert "encoder/s0_E/ffn/w_up" in ts and "segments/0/s0_C/cross/wk" in ts
    return js, ts


@pytest.fixture(scope="module")
def lut_pair():
    """W1A3 lut in bf16 (the served dtype) with bf16 frames, the encoder in
    bf16 too, calibrated with frames in both packages."""
    jcfg, tcfg = _cfgs("bfloat16")
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(**LUT))
    jcal, tq, tcal, cal = _calibrated(jcfg, jm, jq, tm, jnp.asarray(_frames(jcfg, 8), jnp.bfloat16))
    return jcfg, jm, jq, jcal, tm, tq, tcal, cal


def test_calibrated_lut_scales_and_tokens_match_reference(lut_pair):
    """The frozen scales leaf by leaf (the encoder's and the cross
    ``wk`` / ``wv``, which read the encoder output, among them) equal the
    reference's bit for bit in bf16, then the transcription path's logits
    with frames within 1e-4 x max |logit| and the served tokens equal."""
    jcfg, jm, _jq, jcal, tm, _tq, tcal, _cal = lut_pair
    tp = tm.prepare(tcal, n_hint=B)
    js, ts = _scales(jcal, tp)
    for path, want in js.items():
        np.testing.assert_array_equal(ts[path], want, err_msg=path)
    toks = _toks(jcfg, (B, 7))
    frames = jnp.asarray(_frames(jcfg, 10), jnp.bfloat16)
    _close(tm.forward(tp, torch.from_numpy(toks), prefix_embeds=_port_frames(frames))[0],
           jforward(jcfg, jcal, jnp.asarray(toks), frames))
    reqs = _ragged(jcfg, 5, (6, 6, 6, 6), (6, 2, 4, 2))
    want = JServeEngine(jm, jcal, batch=2, max_seq=32, decode="scan").generate(_jreqs(reqs))
    assert ServeEngine(tm, tp, batch=2, max_seq=32, decode="scan", device="cpu").generate(
        reqs) == want


def test_f32_lut_scales_match_reference_upstream_of_the_first_code_flip(models):
    """In f32 the two packages' activations differ by ulps (the layernorm's
    f32 mean, XLA's GELU), and the 3-bit quantizer turns an ulp at a code
    boundary into another code (ROADMAP Queue 3): with these frames the
    second encoder unit's ``w_down`` input flips one, and every scale
    downstream of it moves.  Upstream of it the scales agree at rtol
    2**-21: every leaf of the first encoder unit, and the second unit's
    attention."""
    jcfg, jm, jraw, tm = models
    jq = jm.quantize(jraw, JSpec(**LUT))
    jcal, _tq, tcal, _cal = _calibrated(jcfg, jm, jq, tm, _frames(jcfg, 8))
    js, ts = _scales(jcal, tcal)
    upstream = [p for p in js if p.startswith("encoder/")]
    assert len(upstream) == 6
    for path in upstream:
        n = 2 if "/attn/" in path else 1
        np.testing.assert_allclose(ts[path][:n], js[path][:n], rtol=2**-21, atol=0, err_msg=path)


def test_calibration_without_frames_raises_in_both_packages(lut_pair):
    """``Model.prepare(calibrate=tokens)`` runs a forward without frames and
    without a cache: the reference raises ``TypeError`` at ``cache["ck"]``
    (ROADMAP Queue 3, reference defect 5), and so does the port."""
    _jcfg, jm, jq, _jcal, tm, tq, _tcal, cal = lut_pair
    with pytest.raises(TypeError, match="not subscriptable"):
        jm.prepare(jq, calibrate=cal)
    with pytest.raises(TypeError, match="no cross keys and values"):
        tm.prepare(tq, calibrate=cal)


# ---------------------------------------------------------------------------
# Trees, init, config support, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["raw", "quantized", "prepared", "calibrated"])
def test_convert_carries_whisper_trees(models, lut_pair, kind):
    jcfg, jm, jraw, _tm = models
    jtree = {"raw": lambda: jraw,
             "quantized": lambda: jm.quantize(jraw, JSpec(**W4)),
             "prepared": lambda: jm.prepare(jm.quantize(jraw, JSpec(bw=4, ba=4, mode="dequant")),
                                            n_hint=B),
             "calibrated": lambda: lut_pair[3]}[kind]()
    ttree = params_from_numpy(_np(jtree), device="cpu")
    assert sorted(ttree) == ["embed", "enc_final_norm", "encoder", "final_norm",
                             "frontend_proj", "lm_head", "segments"]
    assert sorted(ttree["segments"][0]["s0_C"]) == ["attn", "attn_norm", "cross", "cross_norm",
                                                    "ffn", "ffn_norm"]
    np.testing.assert_array_equal(ttree["frontend_proj"]["w"].numpy(),
                                  np.asarray(jtree["frontend_proj"]["w"]))
    leaf_type = {"raw": dict, "quantized": QuantizedLinear, "prepared": PreparedLinear,
                 "calibrated": QuantizedLinear}[kind]
    enc, cross = ttree["encoder"]["s0_E"], ttree["segments"][0]["s0_C"]["cross"]
    assert all(isinstance(enc["attn"][n], leaf_type) for n in ATTN)
    assert all(isinstance(cross[n], leaf_type) for n in ATTN)
    if kind != "raw":
        leaf, jleaf = cross["wk"], jtree["segments"][0]["s0_C"]["cross"]["wk"]
        np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(jleaf.codes))
        np.testing.assert_array_equal(leaf.bias.numpy(), np.asarray(jleaf.bias))
        assert (leaf.ascale is None) == (kind != "calibrated")
        assert leaf.codes.shape[0] == jcfg.n_layers
        assert enc["ffn"]["w_up"].codes.shape[0] == jcfg.encoder_layers
    else:
        assert jax.tree.map(np.shape, _np(jtree)) == jax.tree.map(
            np.shape, tree.tree_map(lambda t: t.numpy(), ttree))


def test_init_quantized_quantizes_the_encoder_and_keeps_the_frontend_dense():
    """``init_quantized`` quantizes every encoder unit as it draws it (no f32
    encoder stack is held); the stub frontend's projection, the embedding and
    the LM head stay dense f32; a prepared tree serves the transcription
    path."""
    _jcfg, tcfg = _cfgs()
    m = tmodel.build_model(tcfg)
    qp = m.init_quantized(LutLinearSpec(**W4), seed=0, device="cpu")
    enc = qp["encoder"]["s0_E"]
    for sub, names in (("attn", ATTN), ("ffn", ("w_up", "w_down"))):
        for n in names:
            assert isinstance(enc[sub][n], QuantizedLinear)
            assert enc[sub][n].codes.shape[0] == tcfg.encoder_layers
    assert isinstance(qp["frontend_proj"]["w"], torch.Tensor)
    assert qp["frontend_proj"]["w"].shape == (tcfg.frontend_dim, tcfg.d_model)
    pp = m.prepare(qp, n_hint=B)
    caches = m.init_cache(B, 16, torch.bfloat16, device="cpu")
    frames = torch.from_numpy(_frames(tcfg)).to(torch.bfloat16)
    lg, caches = m.prefill(pp, torch.from_numpy(_toks(tcfg, (B, 4))), caches, prefix_embeds=frames)
    lg2, _ = m.decode_step(pp, torch.argmax(lg, -1).int(), caches, 4)
    assert bool(torch.isfinite(lg).all() and torch.isfinite(lg2).all())
    assert caches[0]["s0_C"]["ck"].any()


def test_check_supported_admits_whisper_and_refuses_a_frontend_without_encoder():
    """whisper's frontend feeds an encoder; a frontend without one (the VLM
    branch, internvl2-1b) was refused until its slice and is admitted now
    (tests/test_torch_vlm.py holds it to the reference)."""
    transformer.check_supported(get_config(ARCH, smoke=True))
    transformer.check_supported(get_config(ARCH))
    assert transformer.segments(get_config(ARCH)) == [("C", 32)]
    assert transformer.unported_for_plans(get_config(ARCH)) == "an encoder-decoder tree"
    vlm = get_config("internvl2-1b", smoke=True)
    assert vlm.frontend == "vision" and not vlm.is_encdec
    transformer.check_supported(vlm)


def test_prefix_embeds_prepended_to_the_tokens_raise():
    """The VLM branch (internvl2-1b's patches prepended to the tokens), once
    refused, runs now: over the reference's tree the logits cover the
    patches' positions and the tokens', and a decoder-only forward without
    patches still runs the tokens alone (parity: tests/test_torch_vlm.py)."""
    jcfg = jget_config("internvl2-1b", smoke=True)
    tp = params_from_numpy(_np(jmodel.build_model(jcfg).init(jax.random.PRNGKey(0))),
                           device="cpu")
    tm = tmodel.build_model(get_config("internvl2-1b", smoke=True))
    patches = torch.zeros((B, jcfg.frontend_seq, jcfg.frontend_dim))
    toks = torch.zeros((B, 4), dtype=torch.int32)
    lg, _ = tm.forward(tp, toks, prefix_embeds=patches)
    assert lg.shape == (B, jcfg.frontend_seq + 4, jcfg.vocab_size)
    assert bool(torch.isfinite(lg).all())
    assert tm.forward(tp, toks)[0].shape == (B, 4, jcfg.vocab_size)


@pytest.mark.parametrize("argv,what", [
    (["--prepared-ckpt", "unused"], "encoder-decoder tree"),
    (["--plan", "unused.json"], "encoder-decoder tree"),
    (["--autotune", "16"], "encoder-decoder tree"),
    (["--request-log", "unused.jsonl"], "encoder-decoder tree"),
    (["--mode", "lut", "--calibrate", "16"], "calibrate"),
])
def test_launch_serve_refuses_encdec_flags(argv, what):
    from repro_torch.launch import serve as lserve

    with pytest.raises(SystemExit, match=what):
        lserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", *argv])


def test_launch_serve_runs_whisper(capsys):
    from repro_torch.launch import serve as lserve

    outs = lserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mode", "pallas",
                        "--requests", "3", "--max-new", "4"])
    assert [len(o) for o in outs] == [4, 4, 4]
    assert "host syncs" in capsys.readouterr().out
