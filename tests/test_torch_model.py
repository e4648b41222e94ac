"""Port parity: the dense GQA decoder of repro_torch against the JAX reference
on stablelm-12b smoke (f32, W4A4, mode="pallas", prepared), on gemma2-2b
smoke's cache-free forward through attn_impl="flash", and on the reference's
§Perf cache features (the ring-window cache, the int8 KV cache, bf16-operand
attention, the serve profile: mirrors of tests/test_perf_features.py), on
weights converted from the reference (CPU)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import LutLinearSpec, PreparedLinear  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("stablelm-12b", smoke=True), dtype="float32")
    tcfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.prepare(jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=4, ba=4, mode="pallas")))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, tm, tp


def test_converted_tree_shapes(pair):
    jcfg, _jm, jp, _tm, tp = pair
    leaf = tp["segments"][0]["s0_D"]["attn"]["wq"]
    assert isinstance(leaf, PreparedLinear)
    jleaf = jp["segments"][0]["s0_D"]["attn"]["wq"]
    assert tuple(leaf.codes.shape) == tuple(jleaf.codes.shape)       # [n_units, F, KB]
    assert leaf.p == jleaf.p and leaf.k == jleaf.k
    assert tp["embed"].shape == (jcfg.vocab_size, jcfg.d_model)


def test_prefill_and_decode_logits_match_reference(pair):
    jcfg, jm, jp, tm, tp = pair
    rng = np.random.default_rng(1)
    B, S, T = 2, 10, 16
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 3)).astype(np.int32)
    jc = jm.init_cache(B, T, dtype=jnp.float32)
    tc = tm.init_cache(B, T, torch.float32, device="cpu")
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :S]), tc)
    assert tl.shape == (B, 1, jcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc[0]["s0_D"]["k"].numpy(), np.asarray(jc[0]["s0_D"]["k"]),
                               rtol=TOL, atol=TOL)
    for t in range(S, S + 3):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t : t + 1]), jc, jnp.int32(t))
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), tc, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    # per-slot [B] write offsets (continuous batching) == the scalar offset
    pos = np.array([S + 3, S + 3], np.int32)
    nxt = toks[:, -1:]
    jl2, _ = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
    tl2, _ = tm.decode_step(tp, torch.from_numpy(nxt), tc, torch.from_numpy(pos))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=TOL, atol=TOL)


def test_left_padded_prompt_matches_unpadded(pair):
    """A bucketed, left-padded prompt prefills and decodes to the same logits
    as the unpadded one (pad keys are don't-cares, positions are logical)."""
    jcfg, _jm, _jp, tm, tp = pair
    rng = np.random.default_rng(2)
    plen, bucket, T = 5, 8, 16
    prompt = rng.integers(1, jcfg.vocab_size, plen).astype(np.int32)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, bucket - plen :] = prompt
    pad = torch.tensor([bucket - plen], dtype=torch.int32)
    lu, cu = tm.prefill(tp, torch.from_numpy(prompt[None]), tm.init_cache(1, T, torch.float32, device="cpu"))
    lp, cp = tm.prefill(tp, torch.from_numpy(padded), tm.init_cache(1, T, torch.float32, device="cpu"),
                        pad_len=pad)
    np.testing.assert_allclose(lp.numpy(), lu.numpy(), rtol=1e-5, atol=1e-5)
    tok = torch.argmax(lu[:, -1:], dim=-1)
    for i in range(3):
        du, cu = tm.decode_step(tp, tok, cu, plen + i)
        dp, cp = tm.decode_step(tp, tok, cp, bucket + i, pad_len=pad)
        np.testing.assert_allclose(dp.numpy(), du.numpy(), rtol=1e-5, atol=1e-5)
        tok = torch.argmax(du[:, -1:], dim=-1)


def test_unported_families_raise():
    """Every config of the repo is ported (internvl2-1b's VLM branch was the
    last, tests/test_torch_vlm.py); a unit kind outside ``PORTED_UNITS``
    still raises."""
    for arch in ("internvl2-1b",):
        transformer.check_supported(get_config(arch, smoke=True))
    cfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), layer_pattern="DX")
    with pytest.raises(NotImplementedError, match="not ported"):
        transformer.check_supported(cfg)


@pytest.mark.parametrize("smoke", [True, False])
def test_whisper_passes_check_supported(smoke):
    """The encoder-decoder path is ported (tests/test_torch_whisper.py)."""
    cfg = get_config("whisper-large-v3", smoke=smoke)
    transformer.check_supported(cfg)
    assert cfg.is_encdec and cfg.frontend == "audio" and cfg.rope_kind == "none"


def test_init_quantized_builds_stacked_leaves():
    cfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), dtype="float32")
    m = build_model(cfg)
    qp = m.init_quantized(LutLinearSpec(bw=4, mode="pallas"), seed=0, device="cpu")
    leaf = qp["segments"][0]["s0_D"]["ffn"]["w_down"]
    assert tuple(leaf.codes.shape) == (cfg.n_layers, cfg.d_model, cfg.d_ff // 2)
    pp = m.prepare(qp, n_hint=4)
    assert isinstance(pp["segments"][0]["s0_D"]["ffn"]["w_down"], PreparedLinear)
    logits, _ = m.forward(pp, torch.zeros((1, 4), dtype=torch.int32))
    assert logits.shape == (1, 4, cfg.vocab_size) and torch.isfinite(logits).all()


@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_bf16_activation_bit_equal_to_reference(kind):
    """Op by op in bf16, as jax.nn.silu / jax.nn.gelu compute.  Inputs: every
    finite bf16 value with 1e-30 < |x| < 80 (outside it XLA's CPU flushes
    subnormal results to zero)."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.int16)
    x = torch.from_numpy(bits).view(torch.bfloat16)
    a = x.float().abs()
    x = x[torch.isfinite(a) & (a > 1e-30) & (a < 80)]
    want = np.asarray(jlayers.activation(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                         kind).astype(jnp.float32))
    got = tlayers.activation(x, kind)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    x32 = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 4
    np.testing.assert_allclose(tlayers.activation(torch.from_numpy(x32), kind).numpy(),
                               np.asarray(jlayers.activation(jnp.asarray(x32), kind)),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# gemma2-2b smoke (4 layers = 2 x "LG", window 8, attention softcap 50, final
# softcap 30, GeGLU, tied embeddings) through attn_impl="flash": the
# cache-free forward, f32, on weights converted from the reference.
# ---------------------------------------------------------------------------


def _gemma_cfgs(**kw):
    jcfg = dataclasses.replace(jget_config("gemma2-2b", smoke=True), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config("gemma2-2b", smoke=True), dtype="float32", **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def gemma():
    jcfg, tcfg = _gemma_cfgs(attn_impl="flash")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    return jcfg, jm, jp, tm, toks


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("tree", ["dense", "pallas_prepared"])
def test_gemma2_flash_forward_matches_reference(gemma, tree):
    jcfg, jm, jp, tm, toks = gemma
    if tree == "pallas_prepared":
        jp = jm.prepare(jm.quantize(jp, JSpec(bw=4, ba=4, mode="pallas")))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    want = jm.forward(jp, jnp.asarray(toks))[0]
    got, caches = tm.forward(tp, torch.from_numpy(toks))
    assert caches is None and got.shape == (2, 20, jcfg.vocab_size)
    _logits_close(got, want)
    xla = build_model(dataclasses.replace(tm.cfg, attn_impl="xla"))
    _logits_close(xla.forward(tp, torch.from_numpy(toks))[0], got.numpy())


def test_gemma2_return_hidden_matches_reference(gemma):
    jcfg, jm, jp, tm, toks = gemma
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    want = jm.forward(jp, jnp.asarray(toks), return_hidden=True)[0]
    got, _ = tm.forward(tp, torch.from_numpy(toks), return_hidden=True)
    assert got.shape == (2, 20, jcfg.d_model) and got.dtype == torch.float32
    _logits_close(got, want)
    # the head over the hidden states is the forward's logits
    _logits_close(transformer.lm_head(tp, tm.cfg, got), jm.forward(jp, jnp.asarray(toks))[0])


def test_gemma2_lut_calibration_through_flash_matches_reference(gemma):
    """Model.prepare(calibrate=) runs its forward through flash; the frozen
    scales equal the reference's up to f32 rounding (flash's f32 sums run in
    another order on each side)."""
    from repro.tune.plan import quantized_leaf_items as jitems
    from repro_torch.tune.plan import quantized_leaf_items as titems

    jcfg, jm, jp, tm, _toks = gemma
    jq = jm.quantize(jp, JSpec(bw=1, ba=3, p=2, mode="lut"))
    cal = np.random.default_rng(7).integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jl = dict(jitems(jm.prepare(jq, calibrate=jnp.asarray(cal))))
    tl = dict(titems(tm.prepare(params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu"),
                                calibrate=cal)))
    assert sorted(jl) == sorted(tl) and len(tl) == 14      # 7 projections x ("L", "G")
    for path, lj in jl.items():
        want = np.asarray(lj.ascale)
        assert tl[path].ascale.shape == want.shape == (2,), path
        np.testing.assert_allclose(tl[path].ascale.numpy(), want, rtol=2**-21, atol=0)


# ---------------------------------------------------------------------------
# stablelm-12b's head dim, 160 (the tensor-core route pads it to 192 columns
# on the card), at a narrow width: 2 layers, d 320, 2 / 1 heads, through
# attn_impl="flash", f32, on trees converted from the reference.
# ---------------------------------------------------------------------------


def _hd160_cfgs():
    kw = dict(n_layers=2, d_model=320, n_heads=2, n_kv_heads=1, head_dim=160, d_ff=640,
              dtype="float32", attn_impl="flash")
    jcfg = dataclasses.replace(jget_config("stablelm-12b", smoke=True), **kw)
    tcfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg) and tcfg.hd == 160
    return jcfg, tcfg


@pytest.mark.parametrize("tree", ["dense", "pallas_prepared"])
def test_stablelm_head_dim_160_flash_forward_matches_reference(tree):
    jcfg, tcfg = _hd160_cfgs()
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if tree == "pallas_prepared":
        jp = jm.prepare(jm.quantize(jp, JSpec(bw=4, ba=4, mode="pallas")))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want = jm.forward(jp, jnp.asarray(toks))[0]
    got, caches = tm.forward(tp, torch.from_numpy(toks))
    assert caches is None and got.shape == (2, 24, jcfg.vocab_size)
    _logits_close(got, want)


# ---------------------------------------------------------------------------
# The §Perf cache features: mirrors of tests/test_perf_features.py, each
# also held against the reference's logits on the same converted tree
# ---------------------------------------------------------------------------

TOL_INT8 = 1e-3   # int8 KV cache, relative to max |logit|: a K/V value whose f32
                   # bits differ between the packages may round to the next code


def _pair_cfgs(arch, **kw):
    """The smoke config in both packages, in f32 (in bf16 the packages differ
    in the last bits: ROADMAP Queue 3)."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _profiled_cfgs(arch, tp=2):
    from repro.models.profiles import apply_perf_profile as japply
    from repro_torch.models.profiles import apply_perf_profile as tapply

    jbase, tbase = _pair_cfgs(arch)
    jcfg, tcfg = japply(jbase, "serve", tp=tp), tapply(tbase, "serve", tp=tp)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _decode_pair(jcfg, tcfg, seed=0, max_seq=32, prefix=6, total=14):
    """The reference's ``_decode_logits`` (prefill ``prefix`` tokens, then
    teacher-forced decode steps to ``total``) in both packages on the
    reference's seed-``seed`` weights: (reference logits, port logits)."""
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, total)).astype(np.int32)
    jc = jm.init_cache(2, max_seq, dtype=jnp.float32)
    tc = tm.init_cache(2, max_seq, torch.float32, device="cpu")
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :prefix]), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :prefix]), tc)
    jout, tout = [jl[:, 0]], [tl[:, 0]]
    for t in range(prefix, total):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t : t + 1]), jc, jnp.int32(t))
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), tc, t)
        jout.append(jl[:, 0])
        tout.append(tl[:, 0])
    return np.asarray(jnp.stack(jout, axis=1)), torch.stack(tout, dim=1).numpy()


def _close_to_reference(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _nbytes(caches):
    sizes = []
    tree.tree_map(lambda t: sizes.append(t.numel() * t.element_size()), caches)
    return sum(sizes)


@pytest.fixture(scope="module")
def gemma_base_logits():
    return _decode_pair(*_pair_cfgs("gemma2-2b"))


def test_ring_window_cache_matches_full_cache(gemma_base_logits):
    """gemma2 local layers (window 8, 14 positions): ring decode == full
    decode within the reference's 3e-3; each == the reference's logits."""
    j_full, t_full = gemma_base_logits
    j_ring, t_ring = _decode_pair(*_pair_cfgs("gemma2-2b", ring_window_cache=True))
    np.testing.assert_allclose(t_ring, t_full, rtol=3e-3, atol=3e-3)
    _close_to_reference(t_full, j_full, TOL)
    _close_to_reference(t_ring, j_ring, TOL)


def test_ring_cache_is_smaller():
    _j, base = _pair_cfgs("gemma2-2b")
    ring = dataclasses.replace(base, ring_window_cache=True)
    cb = build_model(base).init_cache(2, 32, torch.float32, device="cpu")
    cr = build_model(ring).init_cache(2, 32, torch.float32, device="cpu")
    assert _nbytes(cr) < _nbytes(cb)
    assert tuple(cr[0]["s0_L"]["k"].shape) == (2, 2, base.window, base.n_kv_heads, base.hd)
    assert tuple(cr[0]["s1_G"]["k"].shape) == (2, 2, 32, base.n_kv_heads, base.hd)


def test_int8_kv_cache_close_to_fp():
    j_fp, t_fp = _decode_pair(*_pair_cfgs("chatglm3-6b"))
    j_q8, t_q8 = _decode_pair(*_pair_cfgs("chatglm3-6b", kv_cache_int8=True))
    assert _rel(t_q8, t_fp) < 0.05
    _close_to_reference(t_fp, j_fp, TOL)
    _close_to_reference(t_q8, j_q8, TOL_INT8)
    _j, base = _pair_cfgs("chatglm3-6b")
    cb = build_model(base).init_cache(2, 32, torch.bfloat16, device="cpu")
    c8 = build_model(dataclasses.replace(base, kv_cache_int8=True)).init_cache(
        2, 32, torch.bfloat16, device="cpu")
    assert _nbytes(c8) < 0.8 * _nbytes(cb)
    leaf = c8[0]["s0_D"]
    assert sorted(leaf) == ["k", "k_s", "v", "v_s"]
    assert leaf["k"].dtype == torch.int8 and leaf["k_s"].dtype == torch.float32
    assert tuple(leaf["k_s"].shape) == tuple(leaf["k"].shape[:-1])


def test_bf16_attend_close_to_f32(gemma_base_logits):
    j_base, t_base = gemma_base_logits
    j_bf, t_bf = _decode_pair(*_pair_cfgs("gemma2-2b", attend_bf16=True))
    assert _rel(t_bf, t_base) < 0.05
    _close_to_reference(t_bf, j_bf, TOL)


def test_serve_profile_preserves_decode_semantics(gemma_base_logits):
    """The serve profile at max_seq 32 > window 8: ring local caches (f32),
    int8 global caches, bf16-operand attention."""
    j_base, t_base = gemma_base_logits
    jcfg, tcfg = _profiled_cfgs("gemma2-2b")
    assert tcfg.ring_window_cache and tcfg.kv_cache_int8 and tcfg.attend_bf16
    assert tcfg.gqa_prefill_headshard            # n_heads 4 % tp 2: set, a no-op on one card
    j_prof, t_prof = _decode_pair(jcfg, tcfg)
    assert _rel(t_prof, t_base) < 0.06
    _close_to_reference(t_prof, j_prof, TOL_INT8)
    caches = build_model(tcfg).init_cache(2, 32, torch.float32, device="cpu")[0]
    assert sorted(caches["s0_L"]) == ["k", "v"] and caches["s0_L"]["k"].shape[2] == 8
    assert sorted(caches["s1_G"]) == ["k", "k_s", "v", "v_s"]


@pytest.mark.parametrize("profile", [True, False])
def test_int8_cache_no_longer_than_window_is_refused(profile):
    """An int8 "L" cache that is no longer than the window would take the
    ring branch, where the reference writes int8 codes without a scale and
    drops k_s / v_s; the port refuses it rather than run another function."""
    cfg = (_profiled_cfgs("gemma2-2b")[1] if profile else
           dataclasses.replace(get_config("gemma2-2b", smoke=True), kv_cache_int8=True))
    m = build_model(cfg)
    for max_seq in (4, cfg.window):
        with pytest.raises(NotImplementedError, match="max_seq > window"):
            m.init_cache(2, max_seq, torch.float32, device="cpu")
    m.init_cache(2, cfg.window + 1, torch.float32, device="cpu")
    # the flag alone is no longer refused
    transformer.check_supported(dataclasses.replace(cfg, attend_bf16=True))


def test_stablelm_serve_profile_matches_reference():
    """stablelm-12b smoke under the profile: int8 "D" caches, bf16 attend."""
    jcfg, tcfg = _profiled_cfgs("stablelm-12b")
    assert tcfg.kv_cache_int8 and tcfg.attend_bf16 and not tcfg.ring_window_cache
    j_prof, t_prof = _decode_pair(jcfg, tcfg)
    _close_to_reference(t_prof, j_prof, TOL_INT8)
