"""Port parity: multi-head latent attention (repro_torch.models.attention.
mla_attention and its latent cache) against the JAX reference's on one
deepseek-v2-lite-16b smoke layer with numpy-seeded weights and inputs (CPU):
no cache, prefill + decode steps with left pads and per-slot write offsets,
``attend_bf16``, and the chunked prefill at S = 4608, each within 2e-4 x max
|y|.  Then a prepared MLA tree against its raw tree, bit for bit, in every
mode; the reference raises ``TypeError`` on the same prepared tree
(ROADMAP, reference caveats)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import PreparedLinear  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TOL = 2e-4           # one MLA layer in f32 (bf16 operands: f32 sums of exact
                     # products), relative to max |y|


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32", **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _layer(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jp = jattn.mla_init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


class _F32Dots:
    """``jax.numpy`` with one change: an ``einsum`` asked for f32 results
    (``preferred_element_type``) takes its operands in f32.  XLA's CPU
    runtime has no bf16 x bf16 -> f32 dot ("Unsupported element type for
    DotThunk::Execute"), so the reference's ``attend_bf16`` MLA branch does
    not run on the CPU as it stands (ROADMAP, reference caveats).  The
    products of bf16 values are exact in f32, so this computes the branch's
    function: the same products, summed in f32."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *operands, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32) for o in operands]
        return jnp.einsum(spec, *operands, **kw)


def _reference_mla(monkeypatch, bf16):
    if bf16:
        monkeypatch.setattr(jattn, "jnp", _F32Dots())
    return jattn.mla_attention


def _positions(b, s, start=0, pad=None):
    pos = np.arange(s)[None].repeat(b, 0) + start
    if pad is not None:
        pos = pos - pad[:, None]
    return pos.astype(np.int32)


@pytest.mark.parametrize("bf16", [False, True])
def test_mla_no_cache_matches_reference(bf16, monkeypatch):
    jcfg, tcfg, jp, tp = _layer(attend_bf16=bf16)
    x, pos = _x(jcfg, 2, 13), _positions(2, 13)
    jmla = _reference_mla(monkeypatch, bf16)
    jy, jc = jmla(jp, jnp.asarray(x), cfg=jcfg, positions=jnp.asarray(pos))
    ty, tc = tattn.mla_attention(tp, torch.from_numpy(x), cfg=tcfg, positions=torch.from_numpy(pos))
    assert jc is None and tc is None and ty.dtype == torch.float32
    _close(ty, jy)
    if bf16:   # and it is another function than the f32 branch
        f32, _ = tattn.mla_attention(tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
                                     cfg=dataclasses.replace(tcfg, attend_bf16=False))
        assert (f32 - ty).abs().max().item() > 10 * TOL * np.abs(np.asarray(jy)).max()


@pytest.mark.parametrize("bf16", [False, True])
def test_mla_padded_prefill_and_decode_match_reference(bf16, monkeypatch):
    """A left-padded prefill into the latent cache, then decode steps at
    per-slot [B] offsets (the continuous driver) and at a scalar offset."""
    jcfg, tcfg, jp, tp = _layer(attend_bf16=bf16)
    m, b, s, smax = jcfg.mla, 2, 7, 16
    pad = np.array([3, 0], np.int32)
    x = _x(jcfg, b, s)
    jcache = {"ckv": jnp.zeros((b, smax, m.kv_lora_rank)), "krope": jnp.zeros((b, smax, m.qk_rope_dim))}
    tcache = {"ckv": torch.zeros((b, smax, m.kv_lora_rank)), "krope": torch.zeros((b, smax, m.qk_rope_dim))}
    pos = _positions(b, s, pad=pad)
    kw_t = dict(cfg=tcfg, pad_len=torch.from_numpy(pad))
    ref = _reference_mla(monkeypatch, bf16)
    jmla = lambda p, x_, q, c, w: ref(p, x_, cfg=jcfg, positions=q, cache=c, pos=w,  # noqa: E731
                                      pad_len=jnp.asarray(pad))
    jy, jcache = jmla(jp, jnp.asarray(x), jnp.asarray(pos), jcache, 0)
    ty, tcache = tattn.mla_attention(tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
                                     cache=tcache, pos=0, **kw_t)
    _close(ty, jy)
    for name in ("ckv", "krope"):
        _close(tcache[name], jcache[name])
    for t in range(3):
        xt = _x(jcfg, b, 1, seed=10 + t)
        off = np.array([s + t, s + t], np.int32)
        step_pos = (off - pad)[:, None]
        jpos_w = jnp.asarray(off) if t % 2 == 0 else s + t
        tpos_w = torch.from_numpy(off) if t % 2 == 0 else s + t
        jy, jcache = jmla(jp, jnp.asarray(xt), jnp.asarray(step_pos), jcache, jpos_w)
        ty, tcache = tattn.mla_attention(tp, torch.from_numpy(xt),
                                         positions=torch.from_numpy(step_pos),
                                         cache=tcache, pos=tpos_w, **kw_t)
        _close(ty, jy)
    _close(tcache["ckv"], jcache["ckv"])


def test_mla_chunked_prefill_matches_reference_and_unchunked(monkeypatch):
    """S = 4608 > 4096 and a multiple of 512: the query-chunked branch, on
    one row, against the reference and against the port's own unchunked
    latent attention."""
    jcfg, tcfg, jp, tp = _layer()
    s = 4608
    x, pos = _x(jcfg, 1, s), _positions(1, s)
    jy, _ = jax.jit(lambda p, x_, q: jattn.mla_attention(p, x_, cfg=jcfg, positions=q))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    ty, _ = tattn.mla_attention(tp, torch.from_numpy(x), cfg=tcfg, positions=torch.from_numpy(pos))
    _close(ty, jy)
    chunks = []
    attend = tattn._latent_attend
    monkeypatch.setattr(tattn, "_latent_attend", lambda *a: chunks.append(a[0].shape[1]) or attend(*a))
    tattn.mla_attention(tp, torch.from_numpy(x[:, :64]), cfg=tcfg,
                        positions=torch.from_numpy(pos[:, :64]))
    assert chunks == [64]
    chunks.clear()
    monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", s)          # unchunked at this S
    whole, _ = tattn.mla_attention(tp, torch.from_numpy(x), cfg=tcfg,
                                   positions=torch.from_numpy(pos))
    assert chunks == [s]
    _close(ty, whole.numpy())


def test_dense_weight_decodes_every_leaf_kind():
    """``_dense_weight``: the dense matrix of a raw dict, a QuantizedLinear
    (equal to the reference's) and a PreparedLinear of each mode (equal to
    its raw leaf, bit for bit)."""
    jcfg, _tcfg, jp, tp = _layer()
    assert tattn._dense_weight(tp["w_kup"]) is tp["w_kup"]["w"]
    for mode in ("dequant", "pallas", "lut"):
        jq = jmodel.quantize_model({"attn": jp}, jcfg, JSpec(bw=4, ba=4, mode=mode))["attn"]
        want = np.asarray(jattn._dense_weight(jq["w_vup"]))
        tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
        tprep = tmodel.prepare_params(tq, n_hint=4)
        assert isinstance(tprep["w_vup"], PreparedLinear)
        np.testing.assert_array_equal(tattn._dense_weight(tq["w_vup"]).numpy(), want)
        np.testing.assert_array_equal(tattn._dense_weight(tprep["w_vup"]).numpy(), want)


@pytest.mark.parametrize("mode", ["dequant", "pallas", "lut"])
def test_prepared_mla_tree_equals_raw_tree_bit_for_bit(mode):
    """The reference's contract, prepared == raw, on an MLA tree: the port
    meets it in every mode (lut calibrated); the reference's forward raises
    ``TypeError: 'PreparedLinear' object is not subscriptable`` on the same
    prepared tree, because its ``_dense_weight`` decodes only a
    ``QuantizedLinear`` (src/repro/models/attention.py:376-387)."""
    jcfg, tcfg = _cfgs()
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    spec = dict(bw=1, ba=3, p=2, mode="lut") if mode == "lut" else dict(bw=4, ba=4, mode=mode)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(**spec))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    with pytest.raises(TypeError, match="'PreparedLinear' object is not subscriptable"):
        jm.forward(jmodel.prepare_params(jq, n_hint=4), jnp.asarray(toks))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    if mode == "lut":
        from repro_torch.core.calibrate import calibrate_tree

        tq = calibrate_tree(lambda probed: tm.forward(probed, torch.from_numpy(toks))[0], tq)
    tp = tmodel.prepare_params(tq, n_hint=4)
    assert isinstance(tp["segments"][1]["s0_D"]["attn"]["w_kup"], PreparedLinear)
    raw, _ = tm.forward(tq, torch.from_numpy(toks))
    prep, _ = tm.forward(tp, torch.from_numpy(toks))
    assert torch.equal(raw, prep)
    jl = jm.forward(jq if mode != "lut" else _jcalibrated(jm, jq, toks), jnp.asarray(toks))[0]
    _close(prep, jl, 1e-4)


def _jcalibrated(jm, jq, toks):
    from repro.core.calibrate import calibrate_tree

    return calibrate_tree(lambda probed: jm.forward(probed, jnp.asarray(toks))[0], jq)
