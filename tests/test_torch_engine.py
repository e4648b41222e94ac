"""Port parity: the int-LUT engines of repro_torch (multiset ranking,
canonicalization, the packed / canonical / streamed engines, the stream
planner and the UPMEM cost model) against the JAX reference on the CPU, bit
for bit.  Inputs are numpy, drawn from a seed, and go through both packages."""

import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro import hw as jhw  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import luts as jluts  # noqa: E402
from repro.core import multiset as jmultiset  # noqa: E402
from repro.core import pim_cost as jpim  # noqa: E402
from repro.core import stream_plan as jplan  # noqa: E402
from repro_torch import hw as thw  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import luts as tluts  # noqa: E402
from repro_torch.core import multiset as tmultiset  # noqa: E402
from repro_torch.core import pim_cost as tpim  # noqa: E402
from repro_torch.core import stream_plan as tplan  # noqa: E402

# (bw, ba, p), including ties-heavy 1-bit activations and R = 256 packs.
PACKS = [(1, 3, 3), (1, 3, 4), (2, 2, 4), (4, 4, 2), (1, 1, 5), (1, 4, 2)]


def _packs(bw, ba, p, **kw):
    return jluts.build_lut_pack(bw, ba, p, **kw), tluts.build_lut_pack(bw, ba, p, **kw)


def _codes(bw, ba, m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**bw, (m, k)).astype(np.int32),
            rng.integers(0, 2**ba, (k, n)).astype(np.int32))


def _eq(t, j):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    b = np.asarray(j)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("v,p", [(8, 4), (2, 5), (16, 2), (4, 3), (8, 1)])
def test_multiset_torch_half_matches_reference(v, p):
    rng = np.random.default_rng(v * 10 + p)
    codes = rng.integers(0, v, (5, 7, p)).astype(np.int32)   # many ties at v=2
    sj, pj = jmultiset.canonicalize(jnp.asarray(codes))
    st, pt = tmultiset.canonicalize(torch.from_numpy(codes))
    assert _eq(st, sj) and _eq(pt.to(torch.int32), pj)
    rank = tmultiset.multiset_rank(st, v)
    assert rank.dtype == torch.int32 and _eq(rank, jmultiset.multiset_rank(sj, v))
    pid = tmultiset.perm_id(pt)
    assert pid.dtype == torch.int32 and _eq(pid, jmultiset.perm_id(pj))
    # the host twins agree with the device half
    assert _eq(rank, tmultiset.multiset_rank_np(codes[np.arange(5)[:, None, None],
                                                      np.arange(7)[None, :, None],
                                                      pt.numpy()], v))
    with pytest.raises(ValueError, match="int32"):
        tmultiset.multiset_rank(torch.zeros((1, 6), dtype=torch.int32), 256)


@pytest.mark.parametrize("bw,ba,p", PACKS)
@pytest.mark.parametrize("k", [1, 7, 12])
def test_canonicalize_activations_matches_reference(bw, ba, p, k):
    jp, tp = _packs(bw, ba, p)
    _, ac = _codes(bw, ba, 1, k, 6, (bw, ba, p, k))
    ij = jengine.canonicalize_activations(jnp.asarray(ac), jp)
    it = tengine.canonicalize_activations(torch.from_numpy(ac), tp)
    assert it.msrank.dtype == torch.int32 and it.permid.dtype == torch.int32
    assert _eq(it.msrank, ij.msrank) and _eq(it.permid, ij.permid)
    nj = jengine.canonicalize_activations_np(ac, jp)
    nt = tengine.canonicalize_activations_np(ac, tp)
    assert _eq(nt.msrank, nj.msrank) and _eq(nt.permid, nj.permid)
    assert nt.msrank.dtype == nj.msrank.dtype and nt.permid.dtype == nj.permid.dtype


def _network(ac, pack):
    """The canonicalize kernel's arithmetic in its plain form (a sorting
    network on the keys code * p + i)."""
    from repro_torch.core.quantize import zero_code
    from repro_torch.kernels import ref as tref

    return tref.lut_canon_ref(torch.from_numpy(ac), torch.from_numpy(pack.binom.astype(np.int32)),
                              p=pack.p, pad_code=zero_code(pack.agrid))


def test_sorting_network_canonicalization_on_every_a3_p4_group():
    """All 8^4 = 4096 groups of A3 p=4, ties included: the sorting-network
    form gives the reference's msrank and permid."""
    import itertools

    jp, tp = _packs(1, 3, 4)
    allg = np.array(list(itertools.product(range(8), repeat=4)), dtype=np.int32).T   # [4, 4096]
    ij = jengine.canonicalize_activations(jnp.asarray(allg), jp)
    ms, pid = _network(allg, tp)
    assert ms.dtype == torch.int32 and _eq(ms, ij.msrank) and _eq(pid, ij.permid)
    assert len(np.unique(np.asarray(ij.msrank))) == tp.n_canonical_cols       # every multiset
    assert len(np.unique(np.asarray(ij.permid))) == math.factorial(4)         # every permutation


@pytest.mark.parametrize("bw,ba,p", PACKS[:5])
@pytest.mark.parametrize("k,n", [(1, 3), (13, 7), (41, 9)])
def test_sorting_network_canonicalization_matches_reference(bw, ba, p, k, n):
    """The phase-6 packs on ragged K (a partial last group padded with the
    zero code), ties frequent at ba = 1, 2."""
    jp, tp = _packs(bw, ba, p)
    _, ac = _codes(bw, ba, 1, k, n, (bw, ba, p, k, n, 7))
    ij = jengine.canonicalize_activations(jnp.asarray(ac), jp)
    ms, pid = _network(ac, tp)
    assert _eq(ms, ij.msrank) and _eq(pid, ij.permid)
    it = tengine.canonicalize_activations(torch.from_numpy(ac), tp)
    assert torch.equal(ms, it.msrank) and torch.equal(pid, it.permid) and it.composed is None


@pytest.mark.parametrize("bw,ba,p", PACKS)
@pytest.mark.parametrize("m,k,n", [(9, 13, 5), (2, 3, 1)])
def test_every_engine_matches_reference(bw, ba, p, m, k, n):
    """packed / canonical (raw, wpacked=, wcanon_table=) / streamed (tiled,
    prepared, seed loop) int32 outputs == the reference's, bit for bit, with
    StreamStats equal field for field and the plan-only stats equal to the
    executed ones — ragged K included (the exact pad correction)."""
    jp, tp = _packs(bw, ba, p, with_packed=True)
    wc, ac = _codes(bw, ba, m, k, n, (bw, ba, p, m, k, n))
    wj, aj = jnp.asarray(wc), jnp.asarray(ac)
    wt, at = torch.from_numpy(wc), torch.from_numpy(ac)
    want = np.asarray(jengine.quantized_matmul_ref(wj, aj, jp.wgrid, jp.agrid))
    assert _eq(tengine.quantized_matmul_ref(wt, at, tp.wgrid, tp.agrid), want)

    sj = jengine.prepare_stream_weights(wc, jp)
    st = tengine.prepare_stream_weights(wt, tp)
    assert _eq(st.wpk, sj.wpk) and st.wpk.dtype == torch.int32
    assert (st.onehot is None) == (sj.onehot is None)
    if sj.onehot is not None:
        assert np.array_equal(st.onehot, sj.onehot)
    assert (st.m, st.g, st.r, st.pad, st.corr) == (sj.m, sj.g, sj.r, sj.pad, sj.corr)
    wpk_j = jnp.asarray(sj.wpk)
    wcanon_j = jnp.asarray(jp.reordering.astype(np.int32))[wpk_j]
    wcanon_t = torch.from_numpy(tp.reordering.astype(np.int32))[st.wpk.long()]

    outs = {
        "packed": (tengine.packed_lut_gemm(wt, at, tp), jengine.packed_lut_gemm(wj, aj, jp)),
        "packed/widx": (tengine.packed_lut_gemm(None, at, tp, widx=st.wpk),
                        jengine.packed_lut_gemm(None, aj, jp, widx=wpk_j)),
        "canonical": (tengine.canonical_lut_gemm(wt, at, tp),
                      jengine.canonical_lut_gemm(wj, aj, jp)),
        "canonical/wpacked": (tengine.canonical_lut_gemm(None, at, tp, wpacked=st.wpk),
                              jengine.canonical_lut_gemm(None, aj, jp, wpacked=wpk_j)),
        "canonical/wcanon": (tengine.canonical_lut_gemm(None, at, tp, wcanon_table=wcanon_t),
                             jengine.canonical_lut_gemm(None, aj, jp, wcanon_table=wcanon_j)),
    }
    for name, (got, ref) in outs.items():
        assert got.dtype == torch.int32 and _eq(got, ref) and _eq(got, want), name

    for kw in ({}, {"tile_n": 2}, {"buffer_bytes": 64}):
        ot, s_t = tengine.streamed_lut_gemm(wt, at, tp, **kw)
        oj, s_j = jengine.streamed_lut_gemm(wj, aj, jp, **kw)
        op, s_p = tengine.streamed_lut_gemm(None, at, tp, prep=st, **kw)
        assert ot.dtype == torch.int32 and _eq(ot, oj) and _eq(op, oj), kw
        assert dataclasses.asdict(s_t) == dataclasses.asdict(s_j) == dataclasses.asdict(s_p)
        plan_only = tengine.stream_plan_stats(m, at, tp, **kw)
        assert dataclasses.asdict(plan_only) == dataclasses.asdict(s_t)
    ol, s_l = tengine.streamed_lut_gemm_looped(wt, at, tp, k_slices=3)
    olj, s_lj = jengine.streamed_lut_gemm_looped(wj, aj, jp, k_slices=3)
    assert _eq(ol, olj) and _eq(ol, want)
    assert dataclasses.asdict(s_l) == dataclasses.asdict(s_lj)


@pytest.mark.parametrize("kind", ["int", "fp"])
def test_float_grid_engines_match_reference(kind):
    """fp value grids keep the plain gathers and the host engine (float
    accumulation; the kernel takes only integer packs)."""
    jp, tp = _packs(2, 3, 3, w_kind=kind, a_kind=kind)
    wc, ac = _codes(2, 3, 5, 10, 4, len(kind))
    ref = tp.wgrid[wc] @ tp.agrid[ac]
    yc = tengine.canonical_lut_gemm(torch.from_numpy(wc), torch.from_numpy(ac), tp)
    ys, _ = tengine.streamed_lut_gemm(torch.from_numpy(wc), torch.from_numpy(ac), tp)
    yj = np.asarray(jengine.canonical_lut_gemm(jnp.asarray(wc), jnp.asarray(ac), jp))
    assert yc.dtype == (torch.float32 if kind == "fp" else torch.int32)
    # float sums may associate differently from XLA's: f32 rounding only
    np.testing.assert_allclose(yc.numpy(), yj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(yc.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ys.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile_n,buffer_bytes", [(None, None), (1, None), (3, None),
                                                 (None, 48), (None, 4096)])
def test_plan_stream_tiles_match_reference(tile_n, buffer_bytes):
    rng = np.random.default_rng(11)
    msr = rng.integers(0, 6, (9, 10)).astype(np.int64)
    pid = rng.integers(0, 4, (9, 10)).astype(np.int32)
    kw = dict(tile_n=tile_n, buffer_bytes=buffer_bytes,
              slice_bytes=16 if buffer_bytes else None)
    pt, pj = tplan.plan_stream(msr, pid, **kw), jplan.plan_stream(msr, pid, **kw)
    assert (pt.g, pt.n, pt.tile_n, len(pt.tiles)) == (pj.g, pj.n, pj.tile_n, len(pj.tiles))
    for a, b in zip(pt.tiles, pj.tiles):
        assert (a.n0, a.n1) == (b.n0, b.n1)
        for f in ("slice_ms", "slice_pid", "slot"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert tplan.max_unique_slices(msr, pid, 4) == jplan.max_unique_slices(msr, pid, 4)
    if buffer_bytes:
        assert tplan.auto_tile_n(msr, pid, buffer_bytes=buffer_bytes, slice_bytes=16) == \
            jplan.auto_tile_n(msr, pid, buffer_bytes=buffer_bytes, slice_bytes=16)


@pytest.mark.parametrize("bw,ba", [(1, 3), (1, 4), (2, 2), (4, 4)])
def test_pim_cost_times_equal_reference(bw, ba):
    """The copied UPMEM cost model gives the same floats, exactly."""
    for m, k, n in [(128, 128, 32), (768, 768, 128), (3072, 768, 128), (5120, 13824, 4)]:
        st, sj = tpim.GemmShape(m, k, n), jpim.GemmShape(m, k, n)
        for name in jpim.METHODS:
            assert tpim.METHODS[name](st, bw, ba) == jpim.METHODS[name](sj, bw, ba), name
        assert dataclasses.asdict(tpim.localut_plan(st, bw, ba)) == \
            dataclasses.asdict(jpim.localut_plan(sj, bw, ba))
        for p in (1, 2, 4):
            assert tpim.localut_time_at_p(st, bw, ba, p) == jpim.localut_time_at_p(sj, bw, ba, p)
            assert tpim.dram_bank_lut_time(st, bw, ba, p) == jpim.dram_bank_lut_time(sj, bw, ba, p)
            assert tpim.buffer_lut_time(st, bw, ba, p) == jpim.buffer_lut_time(sj, bw, ba, p)
    for method in jpim.METHODS:
        assert tpim.model_time(method, 40, 5120, 13824, 128, bw, ba) == \
            jpim.model_time(method, 40, 5120, 13824, 128, bw, ba)
    small = dataclasses.replace(thw.UPMEM, buffer_capacity=32 << 10)
    small_j = dataclasses.replace(jhw.UPMEM, buffer_capacity=32 << 10)
    s = (768, 768, 128)
    assert tpim.op_lc_time(tpim.GemmShape(*s), bw, ba, small) == \
        jpim.op_lc_time(jpim.GemmShape(*s), bw, ba, small_j)
    assert not math.isnan(tpim.localut_time(tpim.GemmShape(*s), bw, ba))
