"""Port parity: the flash_attention entry point of repro_torch (its plain
version on the CPU) against the reference's Pallas kernel (interpret mode),
and the CUDA kernel against its plain version on the card.

JAX is imported inside the parity tests only, so the card test runs where
JAX is absent: ``python -m pytest -q --noconftest -m cuda
tests/test_torch_flash_attention.py`` (the suite's conftest imports JAX)."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL_F32 = 2e-4          # the reference's own sweep tolerance (tests/test_kernels.py)
TOL_BF16 = 2.0**-7      # one bf16 rounding of outputs of magnitude <= 1, and of the inputs' casts

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


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    cases = SWEEP + [((1, 300, 8, 4, 256), None, dict(window=100, softcap=50.0)),
                     ((1, 200, 4, 1, 160), None, {}),
                     ((2, 70, 4, 2, 16), 90, dict(causal=False, window=30))]
    for shape, t, kw in cases:
        q, k, v = _qkv(shape, t, (shape, t, sorted(kw.items())))
        for dt, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            tq, tk, tv = (torch.from_numpy(a).to(dev, dt) for a in (q, k, v))
            before = fa.launches
            got = tops.flash_attention(tq, tk, tv, **_kw(kw))
            assert fa.launches == before + 1
            want = tref.flash_attention_ref(tq, tk, tv, **_kw(kw))
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * max(want.float().abs().max().item(), 1.0), (shape, kw, dt, err)
