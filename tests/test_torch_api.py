"""Port parity: apply_linear / apply_prepared of repro_torch on layers
converted from the JAX reference, against the reference (CPU)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.core import prepared as jprepared  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import prepared as tprepared  # noqa: E402


def _layer(mode, bw, kind, k=96, f=40, bias=False, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, f)).astype(np.float32)
    b = rng.normal(size=(f,)).astype(np.float32) if bias else None
    qj = japi.quantize_linear(jnp.asarray(w), japi.LutLinearSpec(bw=bw, ba=4, mode=mode, w_kind=kind),
                              bias=None if b is None else jnp.asarray(b))
    x = rng.normal(size=(2, 3, k)).astype(np.float32)
    return qj, x


@pytest.mark.parametrize("mode", ["dequant", "pallas"])
@pytest.mark.parametrize("bw,kind", [(1, "int"), (2, "int"), (4, "int"), (8, "int"), (4, "fp")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_reference(mode, bw, kind, dtype):
    qj, x = _layer(mode, bw, kind, k=67 if bw == 1 else 96, bias=(bw == 2))
    pj = jprepared.prepare_linear(qj)
    qt = params_from_numpy(jax.tree.map(np.asarray, qj), device="cpu")
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    assert isinstance(qt, tapi.QuantizedLinear) and isinstance(pt, tprepared.PreparedLinear)
    assert pt.p == pj.p and qt.spec == tapi.LutLinearSpec(bw=bw, ba=4, mode=mode, w_kind=kind)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    want = np.asarray(japi.apply_linear(qj, xj).astype(jnp.float32))
    y_raw = tapi.apply_linear(qt, xt)
    y_prep = tapi.apply_linear(pt, xt)
    assert y_raw.dtype == xt.dtype and y_raw.shape == (2, 3, qj.f)
    np.testing.assert_allclose(y_raw.float().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        y_prep.float().numpy(), np.asarray(japi.apply_linear(pj, xj).astype(jnp.float32)),
        rtol=tol, atol=tol)
    # raw == prepared, bit for bit, within the port
    assert torch.equal(y_raw, y_prep)


def test_prepare_keeps_only_what_the_mode_reads():
    qj, _ = _layer("pallas", 4, "int")
    qt = params_from_numpy(jax.tree.map(np.asarray, qj), device="cpu")
    pt = tapi.prepare_linear(qt)
    assert pt.wcodes is None and pt.wpk is None and pt.wcanon is None
    assert pt.codes is qt.codes and pt.prepared_bytes == 0
    qd = tapi.quantize_linear(torch.zeros(8, 4), tapi.LutLinearSpec(bw=2, mode="dequant"))
    pd = tapi.prepare_linear(qd)
    assert pd.wcodes.shape == (4, 8) and pd.wcodes.dtype == torch.uint8
    with pytest.raises(ValueError, match="single layers"):
        tapi.prepare_linear(tapi.QuantizedLinear(
            codes=qd.codes[None], scale=qd.scale[None], bias=None, spec=qd.spec, k=qd.k))


def test_device_default_is_cuda_and_raises_without_it():
    from repro_torch import devices

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        devices.resolve()
    with pytest.raises(RuntimeError):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    assert devices.resolve("cpu").type == "cpu"
