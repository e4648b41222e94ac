"""Port parity: the dense GQA decoder of repro_torch against the JAX reference
on stablelm-12b smoke (f32, W4A4, mode="pallas", prepared) and on gemma2-2b
smoke's cache-free forward through attn_impl="flash", on weights converted
from the reference (CPU)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
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
    for arch in ("zamba2-7b", "deepseek-v2-lite-16b", "rwkv6-3b", "whisper-large-v3"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11|not ported"):
            transformer.check_supported(get_config(arch, smoke=True))


def test_attend_bf16_is_refused():
    """The port's attention computes in f32; a config asking for the
    reference's bf16 operands is refused rather than run as another function."""
    cfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), attend_bf16=True)
    with pytest.raises(NotImplementedError, match="attend_bf16"):
        transformer.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="attend_bf16"):
        build_model(cfg).init_quantized(LutLinearSpec(bw=4, mode="pallas"), seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="attend_bf16"):
        build_model(cfg).init_cache(1, 8, torch.float32, device="cpu")
    transformer.check_supported(dataclasses.replace(cfg, attend_bf16=False))


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
