"""Port parity: the flash_attention entry point of repro_torch (its plain
version on the CPU) against the reference's Pallas kernel (interpret mode),
and the CUDA kernel against its plain version on the card.

JAX is imported inside the parity tests only, so the card test runs where
JAX is absent: ``python -m pytest -q --noconftest -m cuda
tests/test_torch_flash_attention.py`` (the suite's conftest imports JAX)."""

import math
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL_F32 = 2e-4          # the reference's own sweep tolerance (tests/test_kernels.py)
TOL_BF16 = 2.0**-7      # one bf16 rounding of outputs of magnitude <= 1, and of the inputs' casts
TOL_BF16_ROW = 2.0**-7  # bf16, each row against the plain version in f32, relative to the
                        # row's max |out|: the output's rounding (at most 2^-8 of each
                        # element) and P's rounding to bf16 before P @ V
Q_SCALE = 16.0          # q scaled so that the scores reach the softcap (std 16 before the cap)

# (B, S, H, Hkv, hd), T (None: T = S), kwargs: the reference's sweep
# (tests/test_kernels.py::test_flash_attention_sweep), then T != S.
SWEEP = [
    ((2, 256, 4, 2, 64), None, {}),
    ((1, 384, 8, 8, 32), None, dict(window=128)),
    ((2, 128, 4, 1, 64), None, dict(softcap=30.0)),
    ((1, 200, 2, 2, 64), None, {}),                  # ragged S
    ((1, 256, 4, 4, 64), None, dict(causal=False)),
    ((1, 130, 2, 2, 64), None, dict(window=32)),
    ((1, 96, 4, 2, 64), 160, dict(window=48, softcap=50.0)),   # T > S, ragged T
]


def _qkv(shape, t, seed_key):
    b, s, h, hkv, hd = shape
    t = s if t is None else t
    rng = np.random.default_rng(zlib.crc32(repr(seed_key).encode()))
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, hd)).astype(np.float32)
    return q, k, v


def _kw(kw):
    return dict(causal=kw.get("causal", True), window=kw.get("window"), softcap=kw.get("softcap"))


def _row_err(got, want32):
    """Worst over rows (b, s, h) of max |got - want32| / max |want32|."""
    g, w = got.float(), want32.float()
    return ((g - w).abs().amax(-1) / w.abs().amax(-1)).max().item()


def _p_bf16_attention(q, k, v, *, causal, window, softcap):
    """The tensor-core route's rounding in plain torch: f32 scores, P =
    exp(s - max s) rounded to bf16 before P @ V, the sum of the unrounded P,
    the output rounded to bf16."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, hkv, h // hkv, hd)
    sc = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) / math.sqrt(hd)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    qpos, kpos = torch.arange(s)[:, None], torch.arange(t)[None, :]
    keep = kpos <= qpos if causal else torch.ones((s, t), dtype=torch.bool)
    if window is not None:
        keep = keep & (kpos > qpos - window)
    p = torch.exp(torch.where(keep, sc, -1e30) - sc.masked_fill(~keep, -1e30).amax(-1, True))
    o = torch.einsum("bgrst,btgd->bsgrd", p.bfloat16().float(), v.float())
    o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, s, h, hd).bfloat16()


@pytest.mark.parametrize("shape,t,kw", SWEEP)
def test_plain_flash_attention_matches_reference_kernel(shape, t, kw):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_attention as jflash

    q, k, v = _qkv(shape, t, (shape, t, sorted(kw.items())))
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               **_kw(kw))
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32, atol=TOL_F32)


def test_plain_flash_attention_bf16_matches_reference_kernel():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_attention as jflash

    shape, kw = (1, 160, 4, 2, 32), dict(window=64, softcap=50.0)
    q, k, v = _qkv(shape, None, "bf16")
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, **kw).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, **_kw(kw))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL_BF16 * np.abs(want).max())


def test_flash_attention_entry_point_routes_by_device():
    q = torch.zeros((1, 4, 2, 16))
    out = tops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.flash_attention(q.to("meta"), q[:, :, :1].to("meta"), q[:, :, :1].to("meta"))


def test_flash_attention_kernel_refuses_cpu_tensors():
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, q, q)


def test_flash_attention_route_table():
    """The kernel a call takes is fixed by dtype and head dim alone: bf16 at
    hd 64/128/256 on the tensor cores, every other (dtype, hd) on the CUDA
    cores; head dims neither kernel takes are refused."""
    from repro_torch.kernels import flash_attention as fa

    for hd in fa.HEAD_DIMS:
        assert fa.route(torch.float32, hd) == "cuda_core"
        assert fa.route(torch.bfloat16, hd) == ("tc" if hd in (64, 128, 256) else "cuda_core")
    assert fa.TC_HEAD_DIMS == (64, 128, 256)
    for dtype, hd in ((torch.bfloat16, 48), (torch.float32, 512), (torch.float16, 64)):
        with pytest.raises(ValueError, match="head dims"):
            fa.route(dtype, hd)


# (fault, q scale): what a kernel computes with in place of the right options
# (None: the right ones), and the scale of q.
ROW_CHECK_CASES = [
    (None, 1.0),
    (None, Q_SCALE),
    ("softcap left out", Q_SCALE),
    ("window one block wider", 1.0),
    ("window one block narrower", 1.0),
]


@pytest.mark.parametrize("fault,q_scale", ROW_CHECK_CASES)
def test_bf16_row_check_accepts_p_rounding_and_rejects_planted_faults(fault, q_scale):
    """The per-row bf16 check of the card tests and ``chip_smoke.py``: P and
    the output rounded to bf16 as the tensor-core route rounds them stay
    within TOL_BF16_ROW of the plain version in f32, and a kernel that left
    out the softcap (scores scaled up to reach it) or put the window one key
    block (64) off does not."""
    shape, kw = (1, 512, 4, 2, 64), dict(window=128, softcap=30.0)
    q, k, v = _qkv(shape, None, ("row check", shape))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tq = tq * q_scale
    want32 = tref.flash_attention_ref(tq.float(), tk.float(), tv.float(), **_kw(kw))
    bad = {None: kw, "softcap left out": dict(kw, softcap=None),
           "window one block wider": dict(kw, window=kw["window"] + 64),
           "window one block narrower": dict(kw, window=kw["window"] - 64)}[fault]
    got = _p_bf16_attention(tq, tk, tv, **_kw(bad))
    err = _row_err(got, want32)
    if fault is None:
        assert err <= TOL_BF16_ROW, err
        assert _row_err(want32.bfloat16(), want32) <= 2.0**-8      # the output's rounding
        whole = (got.float() - want32.bfloat16().float()).abs().max().item()
        assert whole <= TOL_BF16 * want32.bfloat16().float().abs().max().item()
    else:
        assert err > TOL_BF16_ROW, (fault, err)


# gemma2-like bf16 shapes (GQA 8/4, hd 256, softcap 50), local (window 256,
# ragged S) and global: the tensor-core route at a small S; then both with q
# scaled so that the scores reach the softcap.  (shape, T, kwargs, q scale)
GEMMA2_LIKE = [
    ((1, 1000, 8, 4, 256), None, dict(window=256, softcap=50.0), 1.0),
    ((1, 1024, 8, 4, 256), None, dict(softcap=50.0), 1.0),
    ((1, 1000, 8, 4, 256), None, dict(window=256, softcap=50.0), Q_SCALE),
    ((1, 1024, 8, 4, 256), None, dict(softcap=50.0), Q_SCALE),
]


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    cases = SWEEP + [((1, 300, 8, 4, 256), None, dict(window=100, softcap=50.0)),
                     ((1, 200, 4, 1, 160), None, {}),
                     ((2, 70, 4, 2, 16), 90, dict(causal=False, window=30))]
    cases += [((1, 130, 4, 2, 128), None, dict(window=64, softcap=30.0)),
              ((2, 70, 4, 2, 128), 90, dict(causal=False, window=30)),
              ((4, 1500, 20, 20, 64), None, dict(causal=False))]   # whisper's encoder
    for shape, t, kw in cases:
        q, k, v = _qkv(shape, t, (shape, t, sorted(kw.items())))
        for dt, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            tq, tk, tv = (torch.from_numpy(a).to(dev, dt) for a in (q, k, v))
            before, before_tc = fa.launches, fa.launches_tc
            got = tops.flash_attention(tq, tk, tv, **_kw(kw))
            assert fa.launches == before + 1
            assert fa.launches_tc == before_tc + (fa.route(dt, shape[4]) == "tc")
            want = tref.flash_attention_ref(tq, tk, tv, **_kw(kw))
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * max(want.float().abs().max().item(), 1.0), (shape, kw, dt, err)
            if dt == torch.bfloat16:
                want32 = tref.flash_attention_ref(tq.float(), tk.float(), tv.float(), **_kw(kw))
                row = _row_err(got, want32)
                assert row <= TOL_BF16_ROW, (shape, kw, row)


@pytest.mark.cuda
def test_cuda_flash_attention_takes_a_strided_head_dim():
    """The ``lut`` mode's projections return a transposed view, so q, k and v
    reach the kernel with a strided head dim: the entry point lays them out
    first and gives the contiguous inputs' bits, on both routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v = _qkv((2, 96, 4, 2, 64), None, "strided")
    for dt in (torch.float32, torch.bfloat16):
        tq, tk, tv = (torch.from_numpy(a).to(dev, dt) for a in (q, k, v))
        strided = [t.transpose(0, 3).contiguous().transpose(0, 3) for t in (tq, tk, tv)]
        assert all(t.stride(3) != 1 for t in strided)
        got = tops.flash_attention(*strided, causal=False)
        assert torch.equal(got, tops.flash_attention(tq, tk, tv, causal=False)), dt


@pytest.mark.cuda
def test_cuda_tensor_core_flash_attention_gemma2_like_and_deterministic():
    """bf16 at gemma2-like shapes through the tensor-core route, with q as
    drawn and scaled until the scores reach the softcap: within TOL_BF16 of
    max |out| of the plain version, each row within TOL_BF16_ROW of its max
    |out| of the plain version in f32, and two launches on the same inputs
    give the same bits (one CTA per output tile, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    for shape, t, kw, q_scale in GEMMA2_LIKE:
        q, k, v = _qkv(shape, t, (shape, t, sorted(kw.items())))
        tq, tk, tv = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, k, v))
        tq = tq * q_scale
        assert fa.route(tq.dtype, shape[4]) == "tc"
        before, before_tc = fa.launches, fa.launches_tc
        got = tops.flash_attention(tq, tk, tv, **_kw(kw))
        again = tops.flash_attention(tq, tk, tv, **_kw(kw))
        assert (fa.launches, fa.launches_tc) == (before + 2, before_tc + 2)
        want = tref.flash_attention_ref(tq, tk, tv, **_kw(kw))
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL_BF16 * want.float().abs().max().item(), (shape, kw, q_scale, err)
        row = _row_err(got, tref.flash_attention_ref(tq.float(), tk.float(), tv.float(),
                                                     **_kw(kw)))
        assert row <= TOL_BF16_ROW, (shape, kw, q_scale, row)
        assert torch.equal(got, again), (shape, kw, q_scale)
