"""Port parity: apply_linear / apply_prepared of repro_torch on layers
converted from the JAX reference, against the reference (CPU)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.core import prepared as jprepared  # noqa: E402
from repro.core import quantize as jquant  # noqa: E402
from repro_torch import tree  # noqa: E402
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


# ---------------------------------------------------------------------------
# The int-LUT modes: lut and stream
# ---------------------------------------------------------------------------

# (bw, ba, p, F, K, B); p=None exercises the perf-model p* selection every
# LUT path must agree on.  Ragged K (not a multiple of p) in most draws.
LUT_CASES = [(1, 3, 2, 7, 13, 3), (1, 3, 4, 5, 18, 2), (2, 2, 3, 10, 7, 5),
             (4, 4, 2, 3, 9, 1), (1, 1, 5, 6, 11, 4), (2, 3, None, 4, 16, 3)]


def _lut_quantized(bw, ba, p, mode, kind, w, bias):
    spec = japi.LutLinearSpec(bw=bw, ba=ba, p=p, mode=mode, w_kind=kind, a_kind=kind)
    return japi.quantize_linear(jnp.asarray(w), spec, bias=jnp.asarray(bias))


@pytest.mark.parametrize("case", LUT_CASES)
@pytest.mark.parametrize("kind", ["int", "fp"])
def test_four_modes_raw_equals_prepared_and_lut_equals_stream(case, kind):
    """The reference's property suite, through the port: raw == prepared bit
    for bit in all four modes, lut == stream (int grids: bit for bit), and
    the lut/stream outputs equal the reference's."""
    bw, ba, p, f, k, b = case
    if kind == "fp":
        bw, ba = max(bw, 2), max(ba, 2)          # the 1-bit fp grid is degenerate
    rng = np.random.default_rng(sum(case[:2]) * 100 + f * 10 + k + (kind == "fp"))
    w = rng.normal(size=(k, f)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    x = rng.normal(size=(b, k)).astype(np.float32)
    per_mode = {}
    for mode in ("dequant", "lut", "stream", "pallas"):
        if mode == "pallas" and kind == "fp":
            continue
        qj = _lut_quantized(bw, ba, p, mode, kind, w, bias)
        pj = jprepared.prepare_linear(qj, n_hint=b)
        qt = params_from_numpy(jax.tree.map(np.asarray, qj), device="cpu")
        pt = tprepared.prepare_linear(qt, n_hint=b)
        assert pt.p == pj.p
        xt = torch.from_numpy(x)
        y_raw, y_prep = tapi.apply_linear(qt, xt), tapi.apply_linear(pt, xt)
        assert torch.equal(y_raw, y_prep), (mode, kind)
        per_mode[mode] = y_raw
        if mode in ("lut", "stream"):
            # the reference with the activation scale its jitted programs
            # pick (amax * f32(1/gmax), as the port's dynamic quantizer);
            # int grids: the int32 sums are equal and the f32 rescale is the
            # same two products; fp grids sum in float (f32 rounding)
            aspec = qj.spec.aspec()
            ascale = jax.jit(lambda a: jquant.quantize(a.T, aspec)[1])(jnp.asarray(x))
            want = np.asarray(japi.apply_linear(
                jprepared.prepare_linear(qj, n_hint=b, ascale=ascale), jnp.asarray(x)))
            tol = 0 if kind == "int" else 1e-5
            np.testing.assert_allclose(y_raw.numpy(), want, rtol=tol, atol=tol)
            # the prepared products themselves equal the reference's
            pjt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
            assert torch.equal(pt.wpk, pjt.wpk) and pt.wpk.dtype == torch.int32
            assert (pt.wcanon is None) == (pjt.wcanon is None)
            if pt.wcanon is not None:
                assert torch.equal(pt.wcanon, pjt.wcanon)
            assert (pt.onehot is None) == (pjt.onehot is None)
            if pt.onehot is not None:
                assert np.array_equal(pt.onehot, pjt.onehot)
    if kind == "int":
        assert torch.equal(per_mode["lut"], per_mode["stream"])
    else:
        np.testing.assert_allclose(per_mode["lut"], per_mode["stream"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cfg", [(1, 3, 2), (2, 2, 3), (4, 4, 2), (2, 3, None)])
@pytest.mark.parametrize("mode", ["lut", "stream"])
def test_frozen_calibration_bit_identical_and_batch_invariant(cfg, mode):
    """Frozen == dynamic on the calibration batch, a row subset reproduces
    the full-batch rows, and the frozen scale equals the reference's."""
    bw, ba, p = cfg
    rng = np.random.default_rng(bw * 10 + ba)
    w = rng.normal(size=(11, 6)).astype(np.float32)
    x = rng.normal(size=(5, 11)).astype(np.float32)
    qj = japi.quantize_linear(jnp.asarray(w), japi.LutLinearSpec(bw=bw, ba=ba, mode=mode, p=p))
    qt = params_from_numpy(jax.tree.map(np.asarray, qj), device="cpu")
    xt = torch.from_numpy(x)
    frozen = tprepared.prepare_linear(qt, calibration=xt)
    dyn = tprepared.prepare_linear(qt)
    # the reference's frozen scale as its jitted programs compute it (the
    # port's activation quantizer; eager JAX divides by gmax, XLA under jit
    # multiplies by its f32 reciprocal)
    aspec = japi.LutLinearSpec(bw=bw, ba=ba, mode=mode, p=p).aspec()
    ascale = jax.jit(lambda a: jquant.quantize(a.T, aspec)[1])(jnp.asarray(x))
    fj = jprepared.prepare_linear(qj, ascale=ascale)
    assert frozen.ascale.item() == float(np.asarray(fj.ascale))
    y_frozen = tapi.apply_linear(frozen, xt)
    assert torch.equal(y_frozen, tapi.apply_linear(dyn, xt))
    rows = torch.from_numpy(rng.permutation(5)[:2])
    assert torch.equal(tapi.apply_linear(frozen, xt[rows]), y_frozen[rows])
    np.testing.assert_array_equal(
        y_frozen.numpy(), np.asarray(japi.apply_linear(fj, jnp.asarray(x))))


@pytest.mark.parametrize("mode", ["dequant", "lut", "stream", "pallas"])
def test_stream_stats_for_matches_reference(mode):
    """Executed and plan-only stats of raw and prepared layers, any mode,
    equal the reference's field for field."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(10, 6)).astype(np.float32)
    x = rng.normal(size=(4, 10)).astype(np.float32)
    qj = japi.quantize_linear(jnp.asarray(w), japi.LutLinearSpec(bw=1, ba=3, p=3, mode=mode,
                                                                 tile_n=2))
    pj = jprepared.prepare_linear(qj)
    qt = params_from_numpy(jax.tree.map(np.asarray, qj), device="cpu")
    pt = tprepared.prepare_linear(qt)
    want = dataclasses.asdict(japi.stream_stats_for(qj, jnp.asarray(x)))
    for leaf in (qt, pt):
        for plan_only in (False, True):
            got = tapi.stream_stats_for(leaf, torch.from_numpy(x), plan_only=plan_only)
            assert dataclasses.asdict(got) == want, (type(leaf).__name__, plan_only)
    assert dataclasses.asdict(japi.stream_stats_for(pj, jnp.asarray(x), plan_only=True)) == want


def test_wcanon_cap_and_stacked_prepare_match_reference():
    """The wcanon entry cap: above it apply reads the shared reordering LUT
    through wpk (same bits); a stacked leaf divides the cap over the stack and
    builds no host one-hot, as the reference's vmapped prepare does."""
    from repro.models.model import prepare_params as jprepare_params
    from repro_torch.models.model import prepare_params as tprepare_params

    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 12, 8)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(2, 12)).astype(np.float32))
    for mode in ("lut", "stream"):
        spec = japi.LutLinearSpec(bw=1, ba=3, p=3, mode=mode)
        qj = jax.vmap(lambda w_: japi.quantize_linear(w_, spec))(jnp.asarray(w))
        for cap in (10**9, 3 * 8 * 4 * 6 - 1):
            pj = jprepare_params({"l": qj}, wcanon_max_entries=cap)["l"]
            qt = params_from_numpy(jax.tree.map(np.asarray, {"l": qj}), device="cpu")
            pt = tprepare_params(qt, wcanon_max_entries=cap)["l"]
            pjt = params_from_numpy(jax.tree.map(np.asarray, {"l": pj}), device="cpu")["l"]
            assert torch.equal(pt.wpk, pjt.wpk) and pt.wpk.shape == (3, 8, 4)
            assert (pt.wcanon is None) == (pjt.wcanon is None)
            assert pt.onehot is None and pjt.onehot is None
            for u in range(3):
                y = tapi.apply_linear(tree.index(pt, u), x)
                assert torch.equal(y, tapi.apply_linear(tree.index(qt["l"], u), x))
    q0 = dataclasses.replace(tree.index(qt["l"], 0), spec=tapi.LutLinearSpec(bw=1, ba=3, p=3,
                                                                          mode="lut"))
    assert tprepared.prepare_linear(q0, wcanon_max_entries=8 * 4 * 6).wcanon.shape == (8, 4, 6)
    assert tprepared.prepare_linear(q0, wcanon_max_entries=8 * 4 * 6 - 1).wcanon is None
