"""Port parity: the kernel entry points of repro_torch (the packed-code GEMM
and the canonical-LUT slice-streaming GEMM) against the reference's Pallas
kernels (interpret mode) and jnp oracles; the CUDA kernels themselves
against their plain versions on the card; and the port's import isolation
from JAX.

JAX is imported inside the parity tests only, so the card tests run where
JAX is absent: ``python -m pytest -q --noconftest -m cuda
tests/test_torch_kernels.py`` (the suite's conftest imports JAX)."""

import functools
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


@pytest.fixture(scope="module")
def ref_pkg():
    """The JAX reference's modules: (jnp, repro.core.api, kernels.ops, kernels.ref)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import api as japi
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, japi, jops, jref


def _case(bw, shape, seed_key):
    b, k, f = shape
    rng = np.random.default_rng(zlib.crc32(repr(seed_key).encode()))
    w = rng.normal(size=(k, f)).astype(np.float32)
    x = rng.normal(size=(b, k)).astype(np.float32)
    return w, x


@pytest.mark.parametrize("bw", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(1, 32, 16), (4, 64, 48), (10, 129, 200), (3, 256, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lut_dequant_gemm_vs_reference(bw, shape, dtype, ref_pkg):
    jnp, japi, jops, jref = ref_pkg
    w, x = _case(bw, shape, (bw, shape))
    qj = japi.quantize_linear(jnp.asarray(w), japi.LutLinearSpec(bw=bw, ba=4))
    qt = tapi.quantize_linear(torch.from_numpy(w), tapi.LutLinearSpec(bw=bw, ba=4))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    y_kernel = np.asarray(jops.lut_dequant_gemm(xj, qj.codes, qj.scale, bw=bw, k=qj.k))
    y_oracle = np.asarray(jref.lut_dequant_gemm_ref(
        xj.astype(jnp.float32), qj.codes, qj.scale, bw=bw, k=qj.k, grid=qj.spec.wspec().grid()))
    y = tops.lut_dequant_gemm(xt, qt.codes, qt.scale, bw=bw, k=qt.k)
    assert y.dtype == torch.float32 and y.shape == (shape[0], shape[2])
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(y.numpy(), y_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(y.numpy(), y_oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("bw,kind", [(1, "int"), (2, "fp"), (4, "fp")])
def test_lut_dequant_gemm_ragged_k_and_grids(bw, kind, ref_pkg):
    """K not a multiple of cpb: the padded codes past K contribute nothing
    (a 1-bit grid has no zero value)."""
    jnp, japi, jops, _ = ref_pkg
    w, x = _case(bw, (5, 67, 30), (bw, kind))
    qj = japi.quantize_linear(jnp.asarray(w), japi.LutLinearSpec(bw=bw, w_kind=kind))
    qt = tapi.quantize_linear(torch.from_numpy(w), tapi.LutLinearSpec(bw=bw, w_kind=kind))
    want = np.asarray(jops.lut_dequant_gemm(jnp.asarray(x), qj.codes, qj.scale, bw=bw,
                                            k=qj.k, grid_kind=kind))
    got = tops.lut_dequant_gemm(torch.from_numpy(x), qt.codes, qt.scale, bw=bw, k=qt.k,
                                grid_kind=kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the plain version equals the dense product on the decoded weight
    dense = x @ tapi.dequantize_weights(qt).numpy()
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_version_only():
    w, x = _case(4, (3, 40, 8), "cpu")
    qt = tapi.quantize_linear(torch.from_numpy(w), tapi.LutLinearSpec(bw=4))
    from repro_torch.kernels import lut_dequant_gemm as dq

    before = dq.launches
    y = tops.lut_dequant_gemm(torch.from_numpy(x), qt.codes, qt.scale, bw=4, k=qt.k)
    want = tref.lut_dequant_gemm_ref(torch.from_numpy(x), qt.codes, qt.scale, bw=4,
                                     k=qt.k, grid=qt.spec.wspec().grid())
    assert torch.equal(y, want)
    assert dq.launches == before          # nothing was launched
    with pytest.raises(ValueError, match="CUDA"):
        dq.lut_dequant_gemm(torch.from_numpy(x), qt.codes, qt.scale, bw=4, k=qt.k,
                            grid_values=qt.spec.wspec().grid())


MAIN_PATH_K = (2048, 2304, 5120, 9216, 13824)   # every projection's K on both bf16 paths


def test_lut_dequant_gemm_route_table():
    """The route is fixed by x's dtype, the code width, the grid and K, and
    never by B: bf16 x on a grid exact in bf16 (int, uint) with TMA-addressable
    rows takes the tensor cores; f32 x, the fp grid and other K the CUDA
    cores."""
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels import lut_dequant_gemm as dq

    for bw in (1, 2, 4, 8):
        for kind in ("int", "uint"):
            g = QuantSpec(bw, kind).grid()
            assert dq.bf16_exact(g), (bw, kind)
            for k in MAIN_PATH_K:
                assert dq.route(torch.bfloat16, bw, g, k) == "tc", (bw, kind, k)
                assert dq.route(torch.float32, bw, g, k) == "cuda_core", (bw, kind, k)
            # K whose x rows (2K bytes) or code rows (ceil(K/cpb) bytes) are
            # not whole multiples of 16 bytes: TMA cannot address them.
            for k in (1001, 1000 if bw <= 4 else 1004, 32 * (8 // bw) + 8):
                assert dq.route(torch.bfloat16, bw, g, k) == "cuda_core", (bw, kind, k)
            assert dq.route(torch.bfloat16, bw, g, 1056) == ("tc" if bw >= 4 else "cuda_core")
        g = QuantSpec(bw, "fp").grid()
        if bw == 1:
            assert np.array_equal(g, [0.0, 0.0]) and dq.bf16_exact(g)   # degenerate: {0, 0}
        else:
            assert not dq.bf16_exact(g), bw
            for k in MAIN_PATH_K:
                assert dq.route(torch.bfloat16, bw, g, k) == "cuda_core", (bw, k)
    with pytest.raises(ValueError, match="bw"):
        dq.route(torch.bfloat16, 3, np.arange(8.0), 2048)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dq.route(torch.float16, 4, QuantSpec(4, "int").grid(), 2048)


def test_lut_dequant_gemm_split_never_follows_b():
    """The K slices of a layer depend on F, K and the SM count only; the x
    rows per CTA and the CTAs per tile may follow B (they change no row's f32
    operations), and a split layer keeps N <= 128."""
    from repro_torch.kernels import lut_dequant_gemm as dq

    shapes = [(5120, 5120), (1280, 5120), (13824, 5120), (5120, 13824), (2048, 2304),
              (1024, 2304), (2304, 2048), (9216, 2304), (2304, 9216), (300, 1056)]
    for f, k in shapes:
        s = dq.split_k(f, k, 4, 132)
        assert 1 <= s <= dq.MAX_SPLIT and s <= -(-k // 64) // 8 or s == 1
        for b in (1, 4, 8, 9, 37, 64, 65, 128, 129, 512, 2048, 8192):
            n, s_b, ctas = dq.tile_plan(b, f, k, 4, 132)
            assert s_b == s and ctas in (1, s) and n >= min(b, n)
            assert n in (8, 64, 128, 256) and (s == 1 or n <= 128)
    # stablelm-12b: wk/wv (10 tiles of 128 rows) split in 4, w_up/w_gate not;
    # decode runs one CTA per slice, gemma2-2b's B = 8192 one CTA per tile.
    assert dq.tile_plan(4, 1280, 5120, 4, 132) == (8, 4, 4)
    assert dq.tile_plan(4, 13824, 5120, 4, 132) == (8, 1, 1)
    assert dq.tile_plan(8192, 2048, 2304, 4, 132) == (128, 4, 1)
    assert dq.tile_plan(512, 13824, 5120, 4, 132) == (256, 1, 1)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import lut_dequant_gemm as dq

    dev = torch.device("cuda")
    for bw, kind in [(1, "int"), (2, "int"), (4, "int"), (8, "int"), (4, "uint"), (4, "fp")]:
        # (37, 1056, 300): a K the tensor cores take at bw 4 and 8, with a
        # tail of 32 inside its last K chunk of 64; (5, 1056, 301): split in
        # 2 K slices, one CTA each, summed element by element (F % 4 != 0).
        for shape in [(1, 32, 16), (10, 129, 200), (37, 1000, 300), (37, 1056, 300),
                      (5, 1056, 301)]:
            w, x = _case(bw, shape, (bw, kind, shape))
            qt = tapi.quantize_linear(torch.from_numpy(w).to(dev),
                                      tapi.LutLinearSpec(bw=bw, w_kind=kind))
            grid = qt.spec.wspec().grid()
            for dt in (torch.float32, torch.bfloat16):
                xt = torch.from_numpy(x).to(dev, dt)
                which = dq.route(dt, bw, grid, qt.k)
                before, before_tc = dq.launches, dq.launches_tc
                y = tops.lut_dequant_gemm(xt, qt.codes, qt.scale, bw=bw, k=qt.k, grid_kind=kind)
                assert dq.launches == before + 1
                assert dq.launches_tc == before_tc + (which == "tc"), (bw, kind, shape, dt)
                want = tref.lut_dequant_gemm_ref(xt, qt.codes, qt.scale, bw=bw, k=qt.k,
                                                 grid=grid)
                torch.cuda.synchronize()
                err = ((y - want).abs().max() / want.abs().max()).item()
                assert err <= 1e-4, (bw, kind, shape, dt, which, err)
                again = tops.lut_dequant_gemm(xt, qt.codes, qt.scale, bw=bw, k=qt.k,
                                              grid_kind=kind)
                assert torch.equal(again, y), (bw, kind, shape, dt, which)   # repeats bit-equal
                rows = [tops.lut_dequant_gemm(xt[i : i + 1].contiguous(), qt.codes, qt.scale,
                                              bw=bw, k=qt.k, grid_kind=kind)[0]
                        for i in range(shape[0])]
                assert torch.equal(torch.stack(rows), y)     # per-row invariance
    assert dq.route(torch.bfloat16, 4, tops._grid(4, "int"), 1056) == "tc"


@pytest.mark.cuda
@pytest.mark.parametrize("f", [5120, 1280])
def test_cuda_tensor_core_rows_invariant_across_b(f):
    """A fixed set of rows, computed inside batches of B = 1, 4, 37, 512 and
    2048 at a full-width K (5120, bf16 x, W4), is bit-equal across all of
    them on the tensor-core route; F = 1280 is a split layer (4 K slices:
    one CTA each at small B, one CTA for all at B = 2048)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import lut_dequant_gemm as dq

    dev = torch.device("cuda")
    k = 5120
    w, x = _case(4, (2048, k, f), ("rows", f))
    qt = tapi.quantize_linear(torch.from_numpy(w).to(dev), tapi.LutLinearSpec(bw=4))
    xt = torch.from_numpy(x).to(dev, torch.bfloat16)
    fixed = xt[-4:]
    before = dq.launches_tc
    want = tops.lut_dequant_gemm(fixed, qt.codes, qt.scale, bw=4, k=k)
    assert torch.equal(tops.lut_dequant_gemm(fixed[:1], qt.codes, qt.scale, bw=4, k=k),
                       want[:1])
    for b in (37, 512, 2048):
        y = tops.lut_dequant_gemm(xt[-b:], qt.codes, qt.scale, bw=4, k=k)
        assert torch.equal(y[-4:], want), b
    assert dq.launches_tc == before + 5
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert {dq.tile_plan(b, f, k, 4, n_sm)[1] for b in (1, 4, 37, 512, 2048)} == {
        dq.split_k(f, k, 4, n_sm)}


def _stream_case(bw, ba, p, m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**bw, (m, k)).astype(np.int32),
            rng.integers(0, 2**ba, (k, n)).astype(np.int32))


@pytest.mark.parametrize("bw,ba,p", [(1, 3, 3), (1, 3, 4), (2, 2, 4), (4, 4, 2), (1, 1, 5)])
def test_lut_stream_gemm_full_vs_reference(bw, ba, p, ref_pkg):
    """Ragged K (3p + 1): the pad correction is exact; atol = 0."""
    jnp, _japi, jops, _jref = ref_pkg
    from repro.core import engine as jengine
    from repro.core import luts as jluts
    from repro_torch.core import luts as tluts

    jp, tp = jluts.build_lut_pack(bw, ba, p), tluts.build_lut_pack(bw, ba, p)
    wc, ac = _stream_case(bw, ba, p, 16, 3 * p + 1, 6, (bw, ba, p))
    want = np.asarray(jops.lut_stream_gemm_full(jnp.asarray(wc), jnp.asarray(ac), jp))
    got = tops.lut_stream_gemm_full(torch.from_numpy(wc), torch.from_numpy(ac), tp)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    oracle = np.asarray(jengine.canonical_lut_gemm(jnp.asarray(wc), jnp.asarray(ac), jp))
    np.testing.assert_allclose(got.numpy(), oracle.astype(np.float32), rtol=0, atol=0)


@pytest.mark.parametrize("nt", [1, 3, 4, 6, 16])
def test_lut_stream_gemm_tile_widths_vs_reference(nt, ref_pkg):
    """The reference kernel at N-tile widths of 1, non-divisors of N, N and
    > N against the port's entry point at the same ``nt``."""
    jnp, _japi, jops, _jref = ref_pkg
    from repro.core import luts as jluts
    from repro_torch.core import luts as tluts

    jp, tp = jluts.build_lut_pack(1, 3, 4), tluts.build_lut_pack(1, 3, 4)
    wc, ac = _stream_case(1, 3, 4, 8, 13, 6, nt)
    want = np.asarray(jops.lut_stream_gemm_full(jnp.asarray(wc), jnp.asarray(ac), jp, nt=nt))
    got = tops.lut_stream_gemm_full(torch.from_numpy(wc), torch.from_numpy(ac), tp, nt=nt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_lut_stream_gemm_ref_oracle_consistency(ref_pkg):
    """The plain version == the reference's oracle == the engine, on the
    same prepared indices, bit for bit."""
    jnp, _japi, _jops, jref = ref_pkg
    from repro.core import engine as jengine
    from repro.core import luts as jluts
    from repro.core import packing as jpacking
    from repro_torch.core import engine as tengine
    from repro_torch.core import luts as tluts
    from repro_torch.core import packing as tpacking

    bw, ba, p = 2, 2, 3
    jp, tp = jluts.build_lut_pack(bw, ba, p), tluts.build_lut_pack(bw, ba, p)
    m, k, n = 8, 9, 5
    wc, ac = _stream_case(bw, ba, p, m, k, n, 3)
    ij = jengine.canonicalize_activations(jnp.asarray(ac), jp)
    it = tengine.canonicalize_activations(torch.from_numpy(ac), tp)
    wpj = jpacking.pack_index(jnp.asarray(wc).reshape(m, k // p, p), bw)
    wpt = tpacking.pack_index(torch.from_numpy(wc).reshape(m, k // p, p), bw)
    want = np.asarray(jref.lut_stream_gemm_ref(
        wpj, ij.msrank, ij.permid, jnp.asarray(jp.canonical.astype(np.int32)),
        jnp.asarray(jp.reordering.astype(np.int32))))
    canon, reorder = tengine.device_tables(tp, "cpu")
    out = tref.lut_stream_gemm_ref(wpt, it.msrank, it.permid, canon, reorder)
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), want)
    assert np.array_equal(out.numpy(), np.asarray(
        jengine.canonical_lut_gemm(jnp.asarray(wc), jnp.asarray(ac), jp)))


def test_lut_stream_cpu_tensor_takes_plain_version_only():
    from repro_torch.core import engine as tengine
    from repro_torch.core import luts as tluts
    from repro_torch.kernels import lut_stream_gemm as ss

    pack = tluts.build_lut_pack(1, 3, 4)
    wc, ac = _stream_case(1, 3, 4, 5, 10, 3, 0)
    wt, at = torch.from_numpy(wc), torch.from_numpy(ac)
    before = ss.launches
    y = tops.lut_stream_gemm_full(wt, at, pack)
    prep = tengine.prepare_stream_weights(wt, pack)
    o_canon = tengine.canonical_lut_gemm(wt, at, pack)
    o_stream, _ = tengine.streamed_lut_gemm(None, at, pack, prep=prep)
    assert torch.equal(y, o_canon.float()) and torch.equal(o_canon, o_stream)
    assert ss.launches == before          # nothing was launched
    canon, reorder = tengine.device_tables(pack, "cpu")
    idx = tengine.canonicalize_activations(at, pack)
    with pytest.raises(ValueError, match="CUDA"):
        ss.lut_stream_gemm(prep.wpk, idx.msrank, idx.permid, canon, reorder)
    with pytest.raises(ValueError, match="int32"):
        tops.lut_stream_gemm_full(wt, at, tluts.build_lut_pack(2, 3, 3, w_kind="fp",
                                                               a_kind="fp"))
    assert [ss.column_tile(n) for n in (1, 4, 5, 8, 9, 512)] == [4, 4, 8, 8, 16, 16]
    assert ss.column_tile(512, nt=3) == 4


# The route of every pack the tests and chip_smoke.py run: the int8 tensor cores
# take integer packs whose canonical entries fit s8 (b_o == 1) and R <= 32, the
# lookup kernel those with 32 < R <= 256.
ROUTES = [((1, 3, 3), "int", "tc"), ((1, 3, 4), "int", "tc"), ((1, 1, 5), "int", "tc"),
          ((1, 4, 2), "int", "tc"), ((1, 3, 1), "int", "tc"),
          ((2, 2, 4), "int", "lookup"), ((4, 4, 2), "int", "lookup"),
          ((1, 8, 2), "int", "cuda_core"), ((2, 3, 2), "fp", "cuda_core"),
          ((4, 4, 1), "int", "tc"), ((1, 3, 5), "int", "tc"), ((1, 3, 6), "int", "lookup"),
          ((1, 3, 7), "int", "lookup"), ((1, 3, 8), "int", "lookup"),
          ((2, 3, 3), "int", "lookup"), ((1, 2, 6), "int", "lookup"),
          ((2, 2, 5), "int", "cuda_core")]


@pytest.mark.parametrize("cfg,kind,want", ROUTES)
def test_lut_stream_gemm_route_table(cfg, kind, want):
    """W1A3 p=4 (the serve pack, R = 16) and p=5, the phase-6 packs (1,3,3)
    and (1,1,5) take the tensor cores, and so does W4A4 p=1 (R = 16, |entry|
    <= 49); the packs with 32 < R <= 256 and s8 entries, among them a plan's
    W1A3 p = 6-8 and (2,2,4), (4,4,2) (R = 256, |entry| <= 98), take the
    lookup route; R = 1024 ((2,2,5)), b_o = 2 ((1,8,2): |entry| up to
    2 * 1 * 127) and float packs stay on the CUDA cores."""
    from repro_torch.core import luts as tluts
    from repro_torch.kernels import lut_stream_gemm as ss

    pack = tluts.build_lut_pack(*cfg, w_kind=kind, a_kind=kind)
    assert ss.route(pack) == want
    s8 = pack.bo == 1 and kind == "int"
    assert (s8 and pack.n_rows <= 32) == (want == "tc")
    assert (s8 and 32 < pack.n_rows <= 256) == (want == "lookup")


def test_lut_stream_tc_split_never_below_one_chunk_a_slice():
    from repro_torch.kernels import lut_stream_gemm as ss

    # stablelm-12b at W1A3 p=4 (R = 16): decode splits the layers whose tiles
    # leave SMs idle; prefill splits where fewer, shorter waves pay for the
    # partial sums (80 tiles in 3 slices: 2 waves of a third of the work).
    assert ss.tc_split(1280, 1280, 16, 4, 132) == (8, 8)        # wk / wv: 10 tiles
    assert ss.tc_split(5120, 1280, 16, 4, 132) == (8, 3)        # wq / wo: 40 tiles
    assert ss.tc_split(13824, 1280, 16, 4, 132) == (8, 1)       # w_up: 108 tiles
    assert ss.tc_split(5120, 3456, 16, 512, 132) == (256, 3)    # w_down prefill: 80 tiles
    assert ss.tc_split(5120, 1280, 16, 512, 132) == (256, 3)    # wq / wo prefill
    assert ss.tc_split(13824, 1280, 16, 512, 132) == (256, 1)   # w_up prefill: 216 tiles
    assert ss.tc_split(1280, 1280, 16, 512, 132) == (256, 6)
    assert ss.tc_split(16, 4, 16, 6, 132) == (8, 1)             # one chunk: no split
    for m, g, r, n in [(300, 26, 16, 4), (1000, 84, 8, 37), (4096, 206, 32, 129)]:
        n_tile, s = ss.tc_split(m, g, r, n, 132)
        assert 1 <= s <= max(1, -(-(g * r) // 128) // 4) and n_tile >= min(n, 256)
    assert ss.composed_pitch(4, 16) == 64 and ss.composed_pitch(5, 8) == 48


@pytest.mark.parametrize("bw,ba,p", [(1, 3, 3), (1, 3, 4), (1, 1, 5), (1, 4, 2), (1, 3, 1)])
@pytest.mark.parametrize("k", [1, 13, 4 * 9 + 3])
def test_composed_onehot_chain_vs_reference(bw, ba, p, k, ref_pkg):
    """The tensor-core route's two steps in their plain forms, compose (B from
    msrank / permid) then the one-hot product, equal the plain version and
    the reference's Pallas kernel (interpret mode) bit for bit, ragged K
    included."""
    jnp, _japi, _jops, _jref = ref_pkg
    from repro.kernels.lut_stream_gemm import lut_stream_gemm as jkernel
    from repro_torch.core import engine as tengine
    from repro_torch.core import luts as tluts
    from repro_torch.core import packing as tpacking

    pack = tluts.build_lut_pack(bw, ba, p)
    m, n = 11, 7
    wc, ac = _stream_case(bw, ba, p, m, k, n, (bw, ba, p, k))
    wt, at, _ = tengine._pad_groups(torch.from_numpy(wc), torch.from_numpy(ac), p, pack.wgrid,
                                    pack.agrid)
    wpk = tpacking.pack_index(wt.reshape(m, -1, p), bw)
    idx = tengine.canonicalize_activations(at, pack)
    canon, reorder = tengine.device_tables(pack, "cpu")
    b = tref.lut_compose_ref(idx.msrank, idx.permid, canon, reorder)
    g = wpk.shape[1]
    assert b.dtype == torch.int8 and b.shape == (n, g * pack.n_rows)
    got = tref.lut_onehot_gemm_ref(wpk, b, r=pack.n_rows)
    plain = tref.lut_stream_gemm_ref(wpk, idx.msrank, idx.permid, canon, reorder)
    want = np.asarray(jkernel(jnp.asarray(wpk.numpy()), jnp.asarray(idx.msrank.numpy()),
                              jnp.asarray(idx.permid.numpy()), jnp.asarray(canon.numpy()),
                              jnp.asarray(reorder.numpy()), r=pack.n_rows, nt=4,
                              interpret=True))
    assert got.dtype == torch.int32 and torch.equal(got, plain)
    assert np.array_equal(got.numpy(), want)
    # B as the one-hot contraction's operand: onehot(wpk) @ B^T in int64
    onehot = torch.zeros((m, g, pack.n_rows), dtype=torch.int64)
    onehot.scatter_(2, wpk[:, :, None].long(), 1)
    assert torch.equal(onehot.reshape(m, -1) @ b.T.long(), got.long())


LOOKUP_PACKS = [(1, 3, 6), (1, 3, 7), (1, 3, 8), (2, 3, 3), (4, 4, 2)]


@functools.lru_cache(maxsize=None)
def _pack(bw, ba, p):
    from repro_torch.core import luts as tluts

    return tluts.build_lut_pack(bw, ba, p)


@pytest.mark.parametrize("bw,ba,p", LOOKUP_PACKS)
@pytest.mark.parametrize("n", [1, 4, 6, 17])
def test_lookup_chain_vs_reference(bw, ba, p, n, ref_pkg):
    """The lookup route's two steps in their plain forms, the tiled compose
    (slices [ceil(N/NT), G, R, NT], entries + 128, from the transposed byte
    tables) then the lookup sum, equal the plain version, the reference's
    oracle and its Pallas kernel (interpret mode) bit for bit: M <= 64, K not
    a multiple of p (the exact pad correction), N across every column tile
    (4, 8, 16) and ragged tiles."""
    jnp, _japi, _jops, jref = ref_pkg
    from repro.kernels.lut_stream_gemm import lut_stream_gemm as jkernel
    from repro_torch.core import engine as tengine
    from repro_torch.core import packing as tpacking
    from repro_torch.kernels import lut_stream_gemm as ss

    pack = _pack(bw, ba, p)
    assert ss.route(pack) == "lookup"
    m, k = 13 * p - 1, 3 * p + 2
    m = min(m, 64)
    wc, ac = _stream_case(bw, ba, p, m, k, n, (bw, ba, p, n, 18))
    wt, at, corr = tengine._pad_groups(torch.from_numpy(wc), torch.from_numpy(ac), p,
                                       pack.wgrid, pack.agrid)
    wpk = tpacking.pack_index(wt.reshape(m, -1, p), bw)
    idx = tengine.canonicalize_activations(at, pack)
    canon, reorder = tengine.device_tables(pack, "cpu")
    ct, rt = tengine.device_byte_tables(pack, "cpu")
    nt = ss.lookup_tile(n)
    slices = tref.lut_compose_lookup_ref(idx.msrank, idx.permid, ct, rt, nt=nt)
    g, r = wpk.shape[1], pack.n_rows
    assert slices.dtype == torch.uint8 and slices.shape == (-(-n // nt), g, r, nt)
    assert bool((slices[-1, :, :, n - (slices.shape[0] - 1) * nt:] == 128).all())   # past N
    got = tref.lut_lookup_gemm_ref(wpk, slices, n=n)
    plain = tref.lut_stream_gemm_ref(wpk, idx.msrank, idx.permid, canon, reorder)
    assert got.dtype == torch.int32 and torch.equal(got, plain)
    args = [jnp.asarray(a.numpy()) for a in (wpk, idx.msrank, idx.permid, canon, reorder)]
    assert np.array_equal(got.numpy(), np.asarray(jkernel(*args, r=r, nt=4, interpret=True)))
    assert np.array_equal(got.numpy(), np.asarray(jref.lut_stream_gemm_ref(*args)))
    full = tops.lut_stream_gemm_full(torch.from_numpy(wc), torch.from_numpy(ac), pack)
    assert torch.equal(full, (got - corr).float())


@pytest.mark.parametrize("bw,ba,p", LOOKUP_PACKS + [(2, 2, 4), (1, 2, 6)])
def test_lookup_byte_tables_are_the_pack_transposed(bw, ba, p):
    """The lookup route's tables, made once per pack and device beside the
    int32 ones: canonical [C, R] int8 and reordering [P!, R] uint8, the
    pack's own tables transposed, entry for entry."""
    from repro_torch.core import engine as tengine

    pack = _pack(bw, ba, p)
    ct, rt = tengine.device_byte_tables(pack, "cpu")
    assert ct.dtype == torch.int8 and rt.dtype == torch.uint8
    assert ct.shape == (pack.n_canonical_cols, pack.n_rows)
    assert rt.shape == (pack.reordering.shape[1], pack.n_rows)
    assert np.array_equal(ct.numpy(), pack.canonical.T)
    assert np.array_equal(rt.numpy().astype(np.int64), pack.reordering.T.astype(np.int64))
    assert tengine.device_byte_tables(pack, "cpu")[0] is ct        # made once
    for other in ((4, 4, 3), (2, 2, 5)):                  # b_o = 2; R = 1024
        with pytest.raises(ValueError, match="byte tables"):
            tengine.device_byte_tables(_pack(*other), "cpu")


def _lane_sum(u, flush):
    """The lookup kernel's accumulation of biased entries u [G, 4] (u8, the
    4 columns of one 32-bit word) in numpy: bytes 0 and 2 and bytes 1 and 3
    as 16-bit lanes of two uint32 words, two groups a step (one three-input
    add), flushed into int32 every ``flush`` groups; 128 per group comes off
    at the end."""
    words = [int(a) | int(b) << 8 | int(c) << 16 | int(d) << 24 for a, b, c, d in u]
    even = [(w & 0xFF) | ((w >> 16) & 0xFF) << 16 for w in words]
    odd = [((w >> 8) & 0xFF) | (w >> 24) << 16 for w in words]
    acc = np.zeros(4, dtype=np.int64)
    pe = po = 0
    for g0 in range(0, len(words), 2):
        pe = (pe + sum(even[g0:g0 + 2])) & 0xFFFFFFFF          # 32-bit registers wrap
        po = (po + sum(odd[g0:g0 + 2])) & 0xFFFFFFFF
        if (g0 + 2) % flush == 0 or g0 + 2 >= len(words):
            acc += [pe & 0xFFFF, po & 0xFFFF, pe >> 16, po >> 16]
            pe = po = 0
    return (acc - 128 * len(words)).astype(np.int32)


@pytest.mark.parametrize("fill", [0, 255, "random"])
def test_lookup_lane_accumulation_is_exact(fill):
    """At the extreme biased entries (all 0: every entry -128; all 255: every
    entry 127) and at random ones, over G = 3 x the flush period + 1 groups,
    the kernel's 16-bit-lane accumulation equals the int32 sum; one group more
    a period (257 x 255 > 65535) would overflow a lane at 255."""
    from repro_torch.kernels import lut_stream_gemm as ss

    flush = ss.LOOKUP_FLUSH
    assert flush % 8 == 0 and 255 * (flush + 1) <= 0xFFFF
    g = 3 * flush + 1
    rng = np.random.default_rng(18)
    u = rng.integers(0, 256, (g, 4)) if fill == "random" else np.full((g, 4), fill)
    u = u.astype(np.uint8)
    want = (u.astype(np.int64) - 128).sum(axis=0).astype(np.int32)
    assert np.array_equal(_lane_sum(u, flush), want)
    if fill == 255:
        assert not np.array_equal(_lane_sum(u, flush + 2), want)


def test_lookup_split_and_tile():
    """The lookup kernel's column tile follows N (4, 8, 16), and its K slices
    fill the SMs at decode, leave a full prefill alone, split where waves
    would idle, and never leave a slice empty."""
    from repro_torch.kernels import lut_stream_gemm as ss

    assert [ss.lookup_tile(n) for n in (1, 4, 5, 8, 9, 512)] == [4, 4, 8, 8, 16, 16]
    # stablelm-12b at W1A3 p = 7 (G = 732): w_up / wk at decode, then prefill
    assert ss.lookup_split(13824, 732, 4, 132) == 9            # 14 row tiles x 9 = 126 CTAs
    assert ss.lookup_split(1280, 732, 4, 132) == 46            # 92 stages, 2 a slice
    assert ss.lookup_split(13824, 732, 512, 132) == 1          # 448 tiles: 3.4 waves
    assert ss.lookup_split(5120, 732, 512, 132) == 4           # 160 tiles: 2 waves -> 5 of 4x
    assert ss.lookup_split(1280, 732, 512, 132) == 2
    assert ss.lookup_split(16, 3, 6, 132) == 1                 # one stage
    for m, g, n in [(300, 26, 4), (1000, 84, 37), (4096, 206, 129), (5120, 1975, 4)]:
        s = ss.lookup_split(m, g, n, 132)
        chunks = -(-g // 8)
        per = -(-chunks // s)
        assert 1 <= s and (s - 1) * per * 8 < g                  # no empty slice


@pytest.mark.parametrize("bw,ba,p", [(bw, ba, p) for bw in (1, 2) for ba in (1, 2, 3, 4)
                                     for p in (1, 2, 3, 4, 5) if bw * p <= 8])
def test_int8_range_of_every_bo1_pack(bw, ba, p):
    """Every pack with b_o == 1 stores its canonical entries in int8, which
    the tensor-core route's s8 operand holds exactly; its reordering values
    (< R) fit the byte the compose kernel stages them in."""
    from repro_torch.core import luts as tluts

    pack = tluts.build_lut_pack(bw, ba, p)
    ext = int(np.max(np.abs(pack.canonical.astype(np.int64))))
    assert ext <= p * int(np.max(np.abs(pack.wgrid))) * int(np.max(np.abs(pack.agrid)))
    if pack.bo == 1:
        assert pack.canonical.dtype == np.int8 and -128 <= pack.canonical.min()
        assert pack.canonical.max() <= 127
        assert int(pack.reordering.max()) < pack.n_rows <= 256
    else:
        assert ext >= 128


def test_lut_stream_canonicalize_wrappers_take_cuda_only():
    from repro_torch.core import engine as tengine
    from repro_torch.core import luts as tluts
    from repro_torch.kernels import lut_stream_gemm as ss

    pack = tluts.build_lut_pack(1, 3, 4)
    _, ac = _stream_case(1, 3, 4, 1, 12, 3, 1)
    at = torch.from_numpy(ac)
    before = ss.launches_canon
    idx = tengine.canonicalize_activations(at, pack)
    assert idx.composed is None and ss.launches_canon == before     # the plain chain ran
    canon, reorder = tengine.device_tables(pack, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ss.canonicalize(at, tengine.device_binom(pack, "cpu"), p=4, pad_code=0)
    with pytest.raises(ValueError, match="CUDA"):
        ss.compose(idx.msrank, idx.permid, canon, reorder, p=4)
    assert tengine.device_binom(pack, "cpu").shape == (8 + 4, 4 + 1)
    lpack = _pack(1, 3, 6)
    lidx = tengine.canonicalize_activations(at, lpack)
    assert lidx.composed is None                                     # the plain chain ran
    with pytest.raises(ValueError, match="CUDA"):
        ss.compose_lookup(lidx.msrank, lidx.permid, *tengine.device_byte_tables(lpack, "cpu"),
                          p=6)
    assert ss.launches_canon == before


@pytest.mark.cuda
def test_cuda_lut_stream_gemm_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.core import engine as tengine
    from repro_torch.core import luts as tluts
    from repro_torch.kernels import lut_stream_gemm as ss

    dev = torch.device("cuda")
    # R = 8, 16, 256, 256, 32, then 4 and 2 (their one-hot decodes differ)
    for bw, ba, p in [(1, 3, 3), (1, 3, 4), (2, 2, 4), (4, 4, 2), (1, 1, 5), (1, 4, 2), (1, 3, 1)]:
        pack = tluts.build_lut_pack(bw, ba, p)
        tc = ss.route(pack) == "tc"
        canon, reorder = tengine.device_tables(pack, dev)
        for m, k, n in [(16, 3 * p + 1, 6), (300, 101, 4), (1000, 250, 37)]:
            wc, ac = _stream_case(bw, ba, p, m, k, n, (bw, ba, p, m, k, n))
            wt, at = torch.from_numpy(wc).to(dev), torch.from_numpy(ac).to(dev)
            want = tops.lut_stream_gemm_full(wt.cpu(), at.cpu(), pack)
            for nt in (1, 3, 6, 16):
                before = (ss.launches, ss.launches_tc, ss.launches_canon)
                got = tops.lut_stream_gemm_full(wt, at, pack, nt=nt)
                assert (ss.launches, ss.launches_tc, ss.launches_canon) == \
                    (before[0] + 1, before[1] + tc, before[2] + 1)
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), want), (bw, ba, p, m, k, n, nt)
            # the engine routes through the kernels too, raw and prepared:
            # one canonicalize and one GEMM launch each
            before = (ss.launches, ss.launches_canon)
            o = tengine.canonical_lut_gemm(wt, at, pack)
            prep = tengine.prepare_stream_weights(wt, pack)
            o_s, _ = tengine.streamed_lut_gemm(None, at, pack, prep=prep)
            assert (ss.launches, ss.launches_canon) == (before[0] + 2, before[1] + 2)
            assert torch.equal(o.cpu().float(), want) and torch.equal(o_s, o)
            idx = tengine.canonicalize_activations(at, pack)
            plain_idx = tengine.canonicalize_activations_plain(at, pack)
            assert torch.equal(idx.msrank, plain_idx.msrank)
            assert torch.equal(idx.permid, plain_idx.permid)
            plain = tref.lut_stream_gemm_ref(prep.wpk, idx.msrank, idx.permid, canon, reorder)
            for kw in ({}, {"pack": pack}):           # the CUDA cores, then the pack's route
                assert torch.equal(ss.lut_stream_gemm(prep.wpk, idx.msrank, idx.permid, canon,
                                                      reorder, **kw), plain), (bw, ba, p, kw)
            if tc:
                g = idx.msrank.shape[0]
                want_b = tref.lut_compose_ref(idx.msrank, idx.permid, canon, reorder)
                assert torch.equal(idx.composed[:, : g * pack.n_rows], want_b)
                b = ss.compose(idx.msrank, idx.permid, canon, reorder, p=p)
                assert torch.equal(b[:, : g * pack.n_rows], want_b)


@pytest.mark.cuda
def test_cuda_lut_stream_lookup_matches_plain_version():
    """The lookup route (lut_stream_lookup_sm90.cu) on every pack it takes
    here, at ragged shapes across its column tiles (N = 1 .. 129), K slices
    (decode splits summed in atomics) and both wpacked paths (TMA where G % 4
    == 0, cp.async of 8 or 4 bytes else): each call's counters checked, the
    GEMM bit-equal to the plain version and to the plain lookup sum, and
    lut_canon's two lookup modes (canonicalize + compose, compose from given
    indices) bit-equal to the plain tiled compose."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.core import engine as tengine
    from repro_torch.kernels import lut_stream_gemm as ss

    dev = torch.device("cuda")
    for bw, ba, p in LOOKUP_PACKS + [(2, 2, 4), (1, 2, 6)]:
        pack = _pack(bw, ba, p)
        assert ss.route(pack) == "lookup"
        canon, reorder = tengine.device_tables(pack, dev)
        ct, rt = tengine.device_byte_tables(pack, dev)
        for m, k, n in [(16, 3 * p + 1, 6), (8, 13, 1), (300, 101, 4), (1000, 250, 37),
                        (2100, 8 * p * 4, 9), (1100, 8 * p * 4 + 2 * p, 129), (5000, 64 * p, 4)]:
            wc, ac = _stream_case(bw, ba, p, m, k, n, (bw, ba, p, m, k, n))
            wt, at = torch.from_numpy(wc).to(dev), torch.from_numpy(ac).to(dev)
            want = tops.lut_stream_gemm_full(wt.cpu(), at.cpu(), pack)
            before = (ss.launches, ss.launches_tc, ss.launches_lookup, ss.launches_canon)
            got = tops.lut_stream_gemm_full(wt, at, pack)
            assert (ss.launches, ss.launches_tc, ss.launches_lookup, ss.launches_canon) == \
                (before[0] + 1, before[1], before[2] + 1, before[3] + 1)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (bw, ba, p, m, k, n)
            idx = tengine.canonicalize_activations(at, pack)
            wpk = tengine.prepare_stream_weights(wt, pack).wpk
            plain = tref.lut_stream_gemm_ref(wpk, idx.msrank, idx.permid, canon, reorder)
            slices = tref.lut_compose_lookup_ref(idx.msrank, idx.permid, ct, rt,
                                                 nt=ss.lookup_tile(n))
            assert torch.equal(idx.composed, slices), (bw, ba, p, m, k, n)
            assert torch.equal(ss.compose_lookup(idx.msrank, idx.permid, ct, rt, p=p), slices)
            assert torch.equal(tref.lut_lookup_gemm_ref(wpk, slices, n=n), plain)
            for kw in ({"pack": pack}, {"pack": pack, "composed": idx.composed}):
                out = ss.lut_stream_gemm(wpk, idx.msrank, idx.permid, canon, reorder, **kw)
                assert torch.equal(out, plain), (bw, ba, p, m, k, n, sorted(kw))
            with pytest.raises(ValueError, match="composed"):
                ss.lut_stream_gemm(wpk, idx.msrank, idx.permid, canon, reorder, pack=pack,
                                   composed=idx.composed[:, :-1])


@pytest.mark.cuda
def test_cuda_canonicalize_kernel_matches_plain_version():
    """All 8^4 groups of A3 p=4 (ties included), and the five phase-6 packs on
    ragged K in both code layouts (the quantizer's transposed view and a
    contiguous [K, N]): msrank / permid bit-equal to the plain chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import itertools

    from repro_torch.core import engine as tengine
    from repro_torch.core import luts as tluts

    dev = torch.device("cuda")
    pack = tluts.build_lut_pack(1, 3, 4)
    allg = np.array(list(itertools.product(range(8), repeat=4)), dtype=np.int32)   # [4096, 4]
    for codes in (torch.from_numpy(allg.T.copy()), torch.from_numpy(allg).T):
        idx = tengine.canonicalize_activations(codes.to(dev), pack)
        want = tengine.canonicalize_activations(codes, pack)
        assert torch.equal(idx.msrank.cpu(), want.msrank)
        assert torch.equal(idx.permid.cpu(), want.permid)
    for bw, ba, p in [(1, 3, 3), (1, 3, 4), (2, 2, 4), (4, 4, 2), (1, 1, 5)]:
        pack = tluts.build_lut_pack(bw, ba, p)
        for k, n in [(3 * p + 1, 6), (101, 4), (250, 37), (1030, 129)]:
            _, ac = _stream_case(bw, ba, p, 1, k, n, (bw, ba, p, k, n))
            for at in (torch.from_numpy(ac), torch.from_numpy(ac.T.copy()).T):
                want = tengine.canonicalize_activations(at, pack)
                got = tengine.canonicalize_activations(at.to(dev), pack)
                assert torch.equal(got.msrank.cpu(), want.msrank), (bw, ba, p, k, n)
                assert torch.equal(got.permid.cpu(), want.permid), (bw, ba, p, k, n)


def test_port_imports_no_jax_and_no_reference():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith("jax.") or n == "repro"
                     or n.startswith("repro."))
        assert not bad, bad
        live_ops = {"repro_torch.ckpt.checkpoint", "repro_torch.serve.request_log",
                    "repro_torch.serve.ops", "repro_torch.ft.supervisor",
                    "repro_torch.ft.chaos", "repro_torch.launch.serve",
                    "repro_torch.obs.trace", "repro_torch.obs.metrics",
                    "repro_torch.obs.export", "repro_torch.dist.sharding",
                    "repro_torch.dist.collectives", "repro_torch.dist.pipeline",
                    "repro_torch.dist.runtime", "repro_torch.launch.mesh",
                    "repro_torch.launch.dryrun", "repro_torch.launch.roofline"}
        assert live_ops <= set(sys.modules), sorted(live_ops - set(sys.modules))
        from repro_torch.kernels import build
        assert not build._loaded            # importing built / loaded nothing
        import torch.distributed as dist
        assert not dist.is_initialized()    # importing opened no process group
        print("ok", len([n for n in sys.modules if n.startswith("repro_torch")]))
        """
    )
    import os
    import pathlib

    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _grad_inputs(dev):
    """One small call's inputs to each of the three entries, float inputs
    requiring grad (``lut_stream_gemm``'s codes as float values)."""
    w, x = _case(4, (3, 32, 16), "grad")
    q = tapi.quantize_linear(torch.from_numpy(w), tapi.LutLinearSpec(bw=4))
    rng = np.random.default_rng(3)
    qkv = [torch.from_numpy(rng.normal(size=shp).astype(np.float32)).to(dev).requires_grad_()
           for shp in ((1, 8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16))]
    codes = [torch.from_numpy(rng.integers(0, 2, shp).astype(np.float32)).to(dev)
             .requires_grad_() for shp in ((4, 12), (12, 3))]
    return {
        "lut_dequant_gemm": lambda: tops.lut_dequant_gemm(
            torch.from_numpy(x).to(dev).requires_grad_(), q.codes.to(dev), q.scale.to(dev),
            bw=4, k=q.k),
        "flash_attention": lambda: tops.flash_attention(*qkv),
        "lut_stream_gemm": lambda: tops.lut_stream_gemm_full(
            *codes, tapi._lut_pack_cache(1, 1, 3, "int", "int")),
    }


def test_cpu_plain_versions_stay_differentiable():
    """On the CPU the entries run the plain versions, torch ops with a
    gradient: the grad refusal is for CUDA inputs only."""
    calls = _grad_inputs(torch.device("cpu"))
    for name in ("lut_dequant_gemm", "flash_attention"):
        out = calls[name]()
        assert out.grad_fn is not None, name
        out.sum().backward()


@pytest.mark.cuda
def test_cuda_entries_refuse_inputs_that_require_grad():
    """A CUDA input that requires grad, with grad enabled: each of the three
    entries raises before launching (the kernels have no backward, as the
    reference's Pallas kernels have none under ``jax.grad``); under
    ``torch.no_grad()`` the same call launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    calls = _grad_inputs(torch.device("cuda"))
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    with torch.no_grad():
        assert calls["lut_dequant_gemm"]().grad_fn is None
        assert calls["flash_attention"]().grad_fn is None


def _csrc_copy(tmp_path, monkeypatch):
    """A copy of the kernels' csrc directory that build.py reads instead."""
    import shutil

    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    return build, csrc


def test_build_sources_name_every_csrc_file():
    """build.SOURCES, which chip_smoke.py builds, lists every CUDA source of
    csrc/, so the smoke run builds (and checks) each of them."""
    from repro_torch.kernels import build

    assert len(set(build.SOURCES)) == len(build.SOURCES)
    assert set(build.SOURCES) == {f.stem for f in build.CSRC.glob("*.cu")}


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    build, csrc = _csrc_copy(tmp_path, monkeypatch)
    name = "flash_attention_sm90"
    assert [h.name for h in build.local_headers(csrc / f"{name}.cu")] == ["hopper.cuh"]
    before = build.digest(name)
    assert build.digest(name) == before                      # a pure function of the files
    other = build.digest("flash_attention")                  # includes no csrc header
    hdr = csrc / "hopper.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert build.digest(name) != before                      # an edited header rebuilds
    assert build.digest("flash_attention") == other          # and only what includes it

