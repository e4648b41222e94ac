"""Port parity: core numerics of repro_torch against the JAX reference on the
same numpy-seeded inputs (CPU)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import prepared as jprepared  # noqa: E402
from repro.core import quantize as jquant  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import luts as tluts  # noqa: E402
from repro_torch.core import packing as tpacking  # noqa: E402
from repro_torch.core import prepared as tprepared  # noqa: E402
from repro_torch.core import quantize as tquant  # noqa: E402

GRIDS = [(1, "int"), (2, "int"), (4, "int"), (8, "int"), (2, "fp"), (4, "fp"), (8, "fp")]


@pytest.mark.parametrize("bits,kind", GRIDS)
@pytest.mark.parametrize("axis", [None, 1])
def test_quantize_bit_identical(bits, kind, axis):
    rng = np.random.default_rng(bits * 10 + (axis or 0))
    x = rng.normal(size=(37, 23)).astype(np.float32)
    # exact .5 ties on the scaled grid: both sides must round half-to-even
    x[0, :4] = [0.5, 1.5, 2.5, -2.5]
    spec_j = jquant.QuantSpec(bits, kind, axis=axis)
    spec_t = tquant.QuantSpec(bits, kind, axis=axis)
    np.testing.assert_array_equal(spec_t.grid(), spec_j.grid())
    # the weight quantizer against the eager reference (quantize_linear runs
    # eagerly there: a true division by gmax) ...
    cj, sj = jquant.quantize(jnp.asarray(x), spec_j)
    ct, st = tquant.quantize(torch.from_numpy(x), spec_t)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # ... the activation quantizer against the jitted one (the serve and
    # calibration forwards run under jit: XLA multiplies by f32(1/gmax))
    cj, sj = jax.jit(lambda a: jquant.quantize(a, spec_j))(jnp.asarray(x))
    ct, st = tquant.quantize_activation(torch.from_numpy(x), spec_t)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # the frozen-scale override
    frozen = np.float32(0.37)
    cj2, _ = jquant.quantize(jnp.asarray(x), spec_j, scale=jnp.float32(frozen))
    ct2, _ = tquant.quantize(torch.from_numpy(x), spec_t, scale=torch.tensor(frozen))
    np.testing.assert_array_equal(ct2.numpy(), np.asarray(cj2))


def test_quantize_rounds_half_to_even():
    spec = tquant.QuantSpec(4, "int", axis=None)
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 7.0])
    codes, scale = tquant.quantize(x, spec, scale=torch.tensor(1.0))
    off = 8
    assert (codes - off).tolist() == [0, 2, 2, 0, -2, 7]
    assert tquant.zero_code(spec.grid()) == jquant.zero_code(spec.grid())


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_unpack_bits_equal(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2**bits, (5, 48)).astype(np.int32)
    pj = np.asarray(jpacking.pack_bits(jnp.asarray(codes), bits))
    pt = tpacking.pack_bits(torch.from_numpy(codes), bits)
    assert pt.dtype == torch.uint8
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(tpacking.unpack_bits(pt, bits).numpy(),
                                  np.asarray(jpacking.unpack_bits(jnp.asarray(pj), bits)))
    with pytest.raises(ValueError):
        tpacking.pack_bits(torch.from_numpy(codes[:, :47]), bits) if bits < 8 else \
            tpacking.codes_per_byte(3)


def test_pack_index_int32_guard():
    codes = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tpacking.pack_index(codes, 4)
    c = np.random.default_rng(0).integers(0, 4, (6, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tpacking.pack_index(torch.from_numpy(c), 2).numpy(),
        np.asarray(jpacking.pack_index(jnp.asarray(c), 2)),
    )


@pytest.mark.parametrize("bw,kind", GRIDS)
@pytest.mark.parametrize("k", [64, 67])      # 67: K not a multiple of cpb
def test_quantize_linear_codes_equal(bw, kind, k):
    rng = np.random.default_rng(bw * 100 + k)
    w = rng.normal(size=(k, 24)).astype(np.float32)
    qj = japi.quantize_linear(jnp.asarray(w), japi.LutLinearSpec(bw=bw, w_kind=kind))
    qt = tapi.quantize_linear(torch.from_numpy(w), tapi.LutLinearSpec(bw=bw, w_kind=kind))
    np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(qj.codes))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    assert qt.k == qj.k and qt.f == qj.f
    np.testing.assert_array_equal(tapi.dequantize_weights(qt).numpy(),
                                  np.asarray(japi.dequantize_weights(qj)))


def test_prepared_p_equals_reference_on_fig13_shapes():
    shapes = [(3072, 768, 128), (192, 768, 128), (768, 768, 128)]
    for bw in (1, 2, 4):
        for m, k, n in shapes:
            w = np.zeros((k, m), np.float32)
            w[0, :] = 1.0
            qj0 = japi.quantize_linear(jnp.asarray(w), japi.LutLinearSpec(bw=bw))
            qt0 = tapi.quantize_linear(torch.from_numpy(w), tapi.LutLinearSpec(bw=bw))
            for ba in {1: (3, 4), 2: (2,), 4: (4,)}[bw]:
                # p depends on the shapes and the spec only: re-spec one
                # quantized layer.  The reference plans p alike in every mode
                # (its pallas prepare skips the unpack and compiles nothing).
                qj = dataclasses.replace(qj0, spec=japi.LutLinearSpec(bw=bw, ba=ba, mode="pallas"))
                pj = jprepared.prepare_linear(qj, n_hint=n)
                assert japi.plan_p(m, k, n, qj.spec) == pj.p
                for mode in ("dequant", "pallas"):
                    qt = dataclasses.replace(qt0, spec=tapi.LutLinearSpec(bw=bw, ba=ba, mode=mode))
                    assert tprepared.prepare_linear(qt, n_hint=n).p == pj.p
                    assert tapi.plan_p(m, k, n, qt.spec) == pj.p


def test_lut_builders_copy_matches_reference():
    from repro.core import luts as jluts

    for bw, ba, p in [(1, 3, 3), (2, 2, 4), (4, 4, 2)]:
        a, b = tluts.build_lut_pack(bw, ba, p), jluts.build_lut_pack(bw, ba, p)
        assert a.canonical.dtype == b.canonical.dtype
        np.testing.assert_array_equal(a.canonical, b.canonical)
        np.testing.assert_array_equal(a.reordering, b.reordering)
        assert tluts.max_p_canonical(bw, ba, 36_000_000) == jluts.max_p_canonical(bw, ba, 36_000_000)


def test_unported_modes_raise():
    """Every mode of the reference is ported now: lut and stream run, raw and
    prepared, and only a mode the reference does not know raises."""
    w = torch.zeros((8, 4))
    for mode in ("lut", "stream"):
        q = tapi.quantize_linear(w, tapi.LutLinearSpec(bw=2, mode=mode))
        y = tapi.apply_linear(q, torch.ones((1, 8)))
        assert torch.equal(y, tapi.apply_linear(tprepared.prepare_linear(q), torch.ones((1, 8))))
    q = tapi.quantize_linear(w, tapi.LutLinearSpec(bw=2, mode="bogus"))
    with pytest.raises(ValueError, match="unknown mode"):
        tapi.apply_linear(q, torch.ones((1, 8)))
    with pytest.raises(ValueError, match="unknown mode"):
        tapi.apply_linear(tprepared.prepare_linear(q), torch.ones((1, 8)))
