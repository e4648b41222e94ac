"""Functional LoCaLUT GEMM engines — *exact* lookup-table matrix multiply
(port of ``repro.core.engine``).

These implement the paper's execution flows with bit-exact semantics (the LUT
path produces the identical int32 result as the quantized matmul oracle):

* :func:`packed_lut_gemm`     — operation-packed LUT (§III-A, baseline "OP")
* :func:`canonical_lut_gemm`  — + LUT canonicalization + reordering LUT
                                 (§IV-A/B, "OP+LC+RC")
* :func:`streamed_lut_gemm`   — + LUT slice streaming dataflow (§IV-C,
                                 "LoCaLUT"), tiled + deduplicated via
                                 :mod:`repro_torch.core.stream_plan`; also
                                 returns simulated DRAM→buffer traffic
                                 statistics consumed by the UPMEM cost model.
* :func:`streamed_lut_gemm_looped` — the seed per-slice Python loop, kept as
                                 an independent equivalence oracle.

Where the int32 sum is computed:

* On a **CUDA** tensor with an integer LUT pack, :func:`canonical_lut_gemm`
  (raw, ``wpacked=`` and ``wcanon_table=`` entries) and
  :func:`streamed_lut_gemm` take the sum from the hand-written
  ``lut_stream_gemm`` kernel (:mod:`repro_torch.kernels.lut_stream_gemm`) —
  the same function, the same bits, without the ``[M, G, N]`` gather the
  plain form materialises (36 GB at one stablelm-12b ``w_up`` prefill) —
  and :func:`canonicalize_activations` from the canonicalize kernel beside
  it, which also composes the operand of the tensor-core or lookup route:
  two launches per projection.  The stream engine's :class:`StreamStats`
  then come from the same planner through :func:`stream_plan_stats`.
* On a **CPU** tensor the engines run the reference's plain forms: torch
  gathers for :func:`canonical_lut_gemm` / :func:`packed_lut_gemm`, the
  stable argsort of :func:`canonicalize_activations_plain`, and the host
  numpy dataflow for the streamed engines.
* Float-grid packs (which the kernel, accumulating in int32, does not take)
  keep the plain forms on either device.

All engines also take *precomputed weight products* (the prepare/apply split
of :mod:`repro_torch.core.prepared`).  GEMM convention matches the paper:
``O[M,N] = W[M,K] · A[K,N]`` with ``W`` codes from a ``bw``-bit grid and
``A`` codes from a ``ba``-bit grid.  ``K`` is grouped into ``G = ceil(K/p)``
packs; a partial final group is padded with fixed codes and corrected exactly
(the pad contribution is the same scalar for every output element).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import multiset, packing, stream_plan
from repro_torch.core.luts import LutPack
from repro_torch.core.quantize import zero_code


def _np(a) -> np.ndarray:
    """Host numpy view of a tensor or array (a CPU tensor is not copied)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _int_pack(pack: LutPack) -> bool:
    return pack.canonical.dtype.kind in "iu"


def pad_info(k: int, p: int, wgrid, agrid):
    """The single source of truth for partial-group padding: pad length, the
    fixed (weight, activation) pad codes, and the exact scalar correction
    ``pad * wgrid[cw] * agrid[ca]``.

    The correction is computed in the grids' own dtype: integer grids yield a
    Python int (bit-exact paths), float grids (fp4/fp8 packs) a Python float.
    """
    pad = (-k) % p
    wg, ag = np.asarray(wgrid), np.asarray(agrid)
    cw, ca = zero_code(wg), zero_code(ag)
    corr = (pad * wg[cw] * ag[ca]).item() if pad else 0
    return pad, cw, ca, corr


def _pad_groups(wcodes: torch.Tensor, acodes: torch.Tensor, p: int, wgrid, agrid):
    """Pad K to a multiple of p with fixed codes on both operands; returns the
    padded tensors plus the exact scalar correction (see :func:`pad_info`)."""
    pad, cw, ca, corr = pad_info(wcodes.shape[1], p, wgrid, agrid)
    if pad == 0:
        return wcodes, acodes, 0
    wcodes = torch.nn.functional.pad(wcodes, (0, pad), value=cw)
    acodes = torch.nn.functional.pad(acodes, (0, 0, 0, pad), value=ca)
    return wcodes, acodes, corr


def quantized_matmul_ref(wcodes, acodes, wgrid, agrid) -> torch.Tensor:
    """Oracle: dequantize codes to integer values and matmul in int32 (CPU)."""
    wv = torch.as_tensor(np.asarray(wgrid).astype(np.int32))[wcodes.long()]
    av = torch.as_tensor(np.asarray(agrid).astype(np.int32))[acodes.long()]
    return wv @ av


def _pad_acodes(acodes: torch.Tensor, p: int, wgrid, agrid):
    """Weight-stationary twin of :func:`_pad_groups`: the weight products are
    already padded/packed at prepare time, so only the activation side is
    padded here.  The correction depends only on the pad *length* and the
    fixed pad codes (:func:`pad_info`), never on the actual weights."""
    pad, _, ca, corr = pad_info(acodes.shape[0], p, wgrid, agrid)
    if pad == 0:
        return acodes, 0
    return torch.nn.functional.pad(acodes, (0, 0, 0, pad), value=ca), corr


def packed_lut_gemm(
    wcodes: Optional[torch.Tensor],
    acodes: torch.Tensor,
    pack: LutPack,
    *,
    widx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Operation-packed LUT GEMM (baseline OP): one lookup per p MACs.

    ``widx`` ([M, G], from padded weight codes) skips the per-call weight
    padding + packing — the prepare/apply split's weight-stationary path.
    """
    if pack.packed is None:
        raise ValueError("LutPack built without the operation-packed LUT")
    p = pack.p
    if widx is None:
        wcodes, acodes, corr = _pad_groups(wcodes, acodes, p, pack.wgrid, pack.agrid)
        m, k = wcodes.shape
        widx = packing.pack_index(wcodes.reshape(m, k // p, p), pack.bw)   # [M,G]
    else:
        acodes, corr = _pad_acodes(acodes, p, pack.wgrid, pack.agrid)
    n = acodes.shape[1]
    g = acodes.shape[0] // p
    aidx = packing.pack_index(acodes.reshape(g, p, n).permute(0, 2, 1), pack.ba)   # [G,N]
    lut = torch.as_tensor(pack.packed.astype(np.int32), device=acodes.device)
    vals = lut[widx[:, :, None].long(), aidx[None, :, :].long()]                   # [M,G,N]
    return vals.sum(dim=1, dtype=torch.int32) - corr


@dataclasses.dataclass
class CanonIndices:
    """Runtime canonicalization products (computed host-side in the paper's
    flow, §IV-A step 1: quantize → sort → pack → ship to PIM)."""

    msrank: object   # [G, N] canonical-LUT column ids
    permid: object   # [G, N] reordering-LUT column ids
    corr: int
    # The composed LUT slices the pack's lut_stream_gemm route reads
    # (kernels/lut_stream_gemm.py::canonicalize): [N, pitch] int8 on the
    # tensor-core route, [ceil(N/NT), G, R, NT] uint8 on the lookup route;
    # None elsewhere.
    composed: Optional[torch.Tensor] = None


def canonicalize_activations(acodes: torch.Tensor, pack: LutPack) -> CanonIndices:
    """[K, N] activation codes -> int32 ``[G, N]`` canonical-LUT column ids
    (multiset ranks) and reordering-LUT column ids (Lehmer codes), on the
    codes' device; a partial last group is padded with the zero code.

    On a CUDA tensor one launch of the canonicalize kernel computes both, and
    for a pack on the tensor-core or lookup route of ``lut_stream_gemm`` also
    the composed operand that route reads (``composed``); elsewhere the plain
    torch chain (:func:`canonicalize_activations_plain`) runs."""
    if acodes.device.type == "cuda":
        from repro_torch.kernels import lut_stream_gemm as _ss

        p, v = pack.p, 1 << pack.ba
        if int(pack.binom[v + p - 1, p]) >= 2**31:
            raise ValueError("multiset rank does not fit int32; use streaming tiles")
        which = _ss.route(pack)
        ms, pid, b = _ss.canonicalize(
            acodes.to(torch.int32), device_binom(pack, acodes.device), p=p,
            pad_code=zero_code(pack.agrid),
            tables=device_tables(pack, acodes.device) if which == "tc" else None,
            byte_tables=device_byte_tables(pack, acodes.device) if which == "lookup" else None,
        )
        return CanonIndices(msrank=ms, permid=pid, corr=0, composed=b)
    return canonicalize_activations_plain(acodes, pack)


def canonicalize_activations_plain(acodes: torch.Tensor, pack: LutPack) -> CanonIndices:
    """The plain torch form of :func:`canonicalize_activations` on any device:
    pad, stable argsort, gather, multiset rank, Lehmer id."""
    p, v = pack.p, 1 << pack.ba
    k, n = acodes.shape
    pad = (-k) % p
    if pad:
        ca = zero_code(pack.agrid)
        acodes = torch.nn.functional.pad(acodes, (0, 0, 0, pad), value=ca)
    g = acodes.shape[0] // p
    groups = acodes.reshape(g, p, n).permute(0, 2, 1)                      # [G,N,p]
    sorted_a, perm = multiset.canonicalize(groups)
    msr = multiset.multiset_rank(sorted_a, v, table=pack.binom)            # [G,N]
    pid = multiset.perm_id(perm)                                           # [G,N]
    return CanonIndices(msrank=msr, permid=pid, corr=0)


def canonicalize_activations_np(acodes: np.ndarray, pack: LutPack) -> CanonIndices:
    """Host-side numpy twin of :func:`canonicalize_activations` (the streamed
    engine simulates the host→PIM dataflow in numpy)."""
    p, v = pack.p, 1 << pack.ba
    a = _np(acodes)
    k, n = a.shape
    pad = (-k) % p
    if pad:
        a = np.pad(a, ((0, pad), (0, 0)), constant_values=zero_code(pack.agrid))
    g = a.shape[0] // p
    groups = a.reshape(g, p, n).transpose(0, 2, 1)                         # [G,N,p]
    perm = np.argsort(groups, axis=-1, kind="stable")
    sorted_a = np.take_along_axis(groups, perm, axis=-1)
    msr = multiset.multiset_rank_np(sorted_a, v).astype(np.int64)          # [G,N]
    pid = multiset.perm_id_np_batch(perm)                                  # [G,N]
    return CanonIndices(msrank=msr, permid=pid, corr=0)


# (id(pack), device) -> (pack, canonical, reordering, binom, byte tables).  The
# entry holds the pack itself, so its id cannot be reused while the entry exists.
_TABLES: dict = {}


def _byte_tables(pack: LutPack, device) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """The transposed byte copies the lookup route composes from, for a pack
    whose entries fit s8 and whose weight index fits a byte; else None."""
    if not (_int_pack(pack) and pack.bo == 1 and pack.n_rows <= 256):
        return None
    return (torch.as_tensor(np.ascontiguousarray(pack.canonical.T, np.int8), device=device),
            torch.as_tensor(np.ascontiguousarray(pack.reordering.T, np.uint8), device=device))


def _device_entry(pack: LutPack, device) -> tuple:
    key = (id(pack), torch.device(device))
    hit = _TABLES.get(key)
    if hit is None:
        hit = _TABLES[key] = (
            pack,
            torch.as_tensor(np.ascontiguousarray(pack.canonical, np.int32), device=key[1]),
            torch.as_tensor(np.ascontiguousarray(pack.reordering, np.int32), device=key[1]),
            torch.as_tensor(np.ascontiguousarray(pack.binom, np.int32), device=key[1]),
            _byte_tables(pack, key[1]),
        )
    return hit


def device_tables(pack: LutPack, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack's canonical ``[R, C]`` and reordering ``[R, P!]`` LUTs as
    int32 on ``device``, uploaded once per pack and device (a serve step
    copies nothing from the host)."""
    hit = _device_entry(pack, device)
    return hit[1], hit[2]


def device_byte_tables(pack: LutPack, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack's tables transposed to bytes on ``device``, canonical ``[C,
    R]`` int8 and reordering ``[P!, R]`` uint8, made once per pack and device
    beside :func:`device_tables`: the lookup route of ``lut_stream_gemm``
    composes a (g, n) slice from two contiguous R-byte rows of them.  Raises
    for a pack whose entries or weight index do not fit a byte."""
    hit = _device_entry(pack, device)[4]
    if hit is None:
        raise ValueError(f"the ({pack.bw},{pack.ba},{pack.p}) pack has no byte tables: its "
                         f"entries need {pack.bo} bytes and R = {pack.n_rows}")
    return hit


def device_binom(pack: LutPack, device) -> torch.Tensor:
    """The pack's binomial table ``[v + p, p + 1]`` as int32 on ``device``,
    uploaded once per pack and device (values of every rank that fits int32
    fit too)."""
    return _device_entry(pack, device)[3]


def _kernel_sum(wpacked: torch.Tensor, idx: CanonIndices, pack: LutPack, *,
                nt=None) -> torch.Tensor:
    """The int32 ``[M, N]`` canonical-LUT sum from the Hopper kernel, on the
    pack's route; the tensor-core and lookup routes read ``idx.composed``
    where the canonicalize kernel built it."""
    from repro_torch.kernels import lut_stream_gemm as _ss

    canon, reorder = device_tables(pack, wpacked.device)
    return _ss.lut_stream_gemm(
        wpacked.to(torch.int32).contiguous(), idx.msrank.contiguous(),
        idx.permid.contiguous(), canon, reorder, nt=nt, pack=pack, composed=idx.composed,
    )


def canonical_lut_gemm(
    wcodes: Optional[torch.Tensor],
    acodes: torch.Tensor,
    pack: LutPack,
    idx: Optional[CanonIndices] = None,
    *,
    wpacked: Optional[torch.Tensor] = None,
    wcanon_table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Canonical LUT + reordering LUT GEMM (OP+LC+RC).

    Weight-stationary fast paths (prepare/apply split): ``wpacked`` ([M, G],
    packed group indices of the padded weight codes) skips the per-call pad +
    ``pack_index``; ``wcanon_table`` ([M, G, p!], ``reorder[wpacked]``)
    additionally folds the reordering-LUT lookup into a weight-static table.
    All three entry points are bit-identical.

    On a CUDA tensor an integer pack's sum comes from the ``lut_stream_gemm``
    kernel, which reads ``wpacked`` (the ``wcanon_table`` entry then needs
    ``wpacked`` too); a CPU tensor, or a float pack, takes the plain gathers.
    """
    p = pack.p
    kernel = acodes.is_cuda and _int_pack(pack)
    if wpacked is None and wcanon_table is None:
        wcodes, acodes, corr = _pad_groups(wcodes, acodes, p, pack.wgrid, pack.agrid)
        m, k = wcodes.shape
        wpacked = packing.pack_index(wcodes.reshape(m, k // p, p), pack.bw)   # [M,G]
    elif kernel:
        # The canonicalize kernel pads the partial last group itself.
        corr = pad_info(acodes.shape[0], p, pack.wgrid, pack.agrid)[3]
    else:
        acodes, corr = _pad_acodes(acodes, p, pack.wgrid, pack.agrid)
    if idx is None:
        idx = canonicalize_activations(acodes, pack)
    if kernel:
        if wpacked is None:
            raise ValueError("on a CUDA tensor the lut_stream_gemm kernel reads wpacked; "
                             "pass wpacked= beside wcanon_table=")
        out = _kernel_sum(wpacked, idx, pack)
        return out - corr if corr else out
    if acodes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"canonical_lut_gemm runs on cuda or cpu, got {acodes.device}")
    canon = torch.as_tensor(pack.canonical, device=acodes.device)
    permid = idx.permid.long()
    if wcanon_table is not None:
        # step 3 pre-resolved at prepare time: gather the canonical weight
        # code straight out of the weight-static table at this perm id.
        m = wcanon_table.shape[0]
        wcanon = torch.gather(wcanon_table, 2, permid[None].expand(m, -1, -1))   # [M,G,N]
    else:
        reorder = torch.as_tensor(pack.reordering.astype(np.int32), device=acodes.device)
        # step 3 (paper Fig. 5): reordering-LUT lookup -> canonical weight code
        wcanon = reorder[wpacked[:, :, None].long(), permid[None, :, :]]          # [M,G,N]
    # step 4-5: canonical-LUT lookup + accumulate.  Integer packs accumulate
    # in int32 (bit-exact); float packs stay in their own dtype.
    acc = torch.int32 if _int_pack(pack) else canon.dtype
    vals = canon[wcanon.long(), idx.msrank[None, :, :].long()]                    # [M,G,N]
    return vals.sum(dim=1, dtype=acc) - corr


@dataclasses.dataclass
class StreamStats:
    """Simulated DRAM→buffer traffic of the slice-streaming dataflow.

    ``slices_streamed`` counts *deduplicated* (canonical, reordering) column
    pairs: within a tile each distinct pair is streamed once and every
    further address hitting it is a ``buffer_hits`` entry.  ``flat_slices``
    is the undeduplicated (group, column) address count — what the seed
    dataflow streamed and what the paper's Eq. 2 first term models.
    """

    slices_streamed: int = 0          # deduped canonical+reordering pairs
    flat_slices: int = 0              # undeduped (g, n) addresses
    buffer_hits: int = 0              # addresses served from the buffer
    stream_batches: int = 0           # DMA batches of <= k_slices pairs
    tiles: int = 0                    # activation-column tiles walked
    canonical_bytes: int = 0
    reordering_bytes: int = 0
    lookups: int = 0                  # canonical-LUT lookups (== reorder lookups)
    slice_reuse: float = 0.0          # lookups per streamed slice (>= M)

    @property
    def streamed_bytes(self) -> int:
        return self.canonical_bytes + self.reordering_bytes

    @property
    def dedup_ratio(self) -> float:
        """slices_streamed / flat_slices in (0, 1]."""
        return self.slices_streamed / max(self.flat_slices, 1)


@dataclasses.dataclass
class StreamWeights:
    """Weight-stationary products of the streamed engine.

    ``wpk`` is an int32 tensor on the weights' device (the kernel reads it
    there; the host engine views it as numpy); ``onehot`` stays a host array.
    """

    wpk: torch.Tensor             # [M, G] int32 packed group indices (padded K)
    onehot: Optional[np.ndarray]  # [M, G*R] f32 one-hot (None -> gather path)
    m: int
    g: int
    r: int
    pad: int                      # K padding columns applied
    corr: float                   # exact scalar pad correction


def stream_onehot_feasible(m: int, g: int, pack: LutPack) -> bool:
    """Whether :func:`prepare_stream_weights` will build the one-hot BLAS
    matrix for an ``[m, g*p]`` weight: the contraction is exact iff every f32
    partial sum stays below 2^24, and huge R x G one-hots stop paying off."""
    wg, ag = np.asarray(pack.wgrid), np.asarray(pack.agrid)
    bound = g * pack.p * float(np.max(np.abs(wg))) * float(np.max(np.abs(ag)))
    return _int_pack(pack) and g > 0 and bound < 2.0**24 and m * g * pack.n_rows <= 32_000_000


def prepare_stream_weights(wcodes, pack: LutPack) -> StreamWeights:
    """Pad + pack the weight codes ``[M, K]`` (a tensor or an array) and build
    the exact one-hot contraction matrix (when feasible,
    :func:`stream_onehot_feasible`) — everything the streamed engine needs
    from the weights.  ``wpk`` lands on the codes' device (CPU for numpy)."""
    p = pack.p
    device = wcodes.device if isinstance(wcodes, torch.Tensor) else torch.device("cpu")
    wc = _np(wcodes)
    wg, ag = np.asarray(pack.wgrid), np.asarray(pack.agrid)
    pad, cw, _, corr = pad_info(wc.shape[1], p, wg, ag)
    if pad:
        wc = np.pad(wc, ((0, 0), (0, pad)), constant_values=cw)
    m = wc.shape[0]
    g = wc.shape[1] // p
    wpk = packing.pack_index_np(wc.reshape(m, g, p), pack.bw).astype(np.int32)
    r = pack.n_rows
    onehot = None
    if stream_onehot_feasible(m, g, pack):
        buf = np.zeros(m * g * r, dtype=np.float32)
        buf[np.arange(m * g, dtype=np.int64) * r + wpk.ravel()] = 1.0
        onehot = buf.reshape(m, g * r)                             # [M, G*R]
    return StreamWeights(
        wpk=torch.from_numpy(wpk).to(device), onehot=onehot, m=m, g=g, r=r, pad=pad, corr=corr
    )


def _slice_bytes(pack: LutPack) -> int:
    """DRAM bytes of one streamed (canonical, reordering) column pair."""
    return pack.n_rows * (pack.canonical.dtype.itemsize + pack.reordering.dtype.itemsize)


def _tile_stats(stats: StreamStats, tile, m: int, pack: LutPack, k_slices: int):
    """Accrue one tile's traffic counters — the single accounting shared by
    the executed engine and the plan-only path, so they cannot drift."""
    s = tile.n_slices
    r = pack.n_rows
    stats.slices_streamed += s
    stats.buffer_hits += tile.buffer_hits
    stats.stream_batches += -(-s // k_slices)
    stats.canonical_bytes += s * r * pack.canonical.dtype.itemsize
    stats.reordering_bytes += s * r * pack.reordering.dtype.itemsize
    stats.lookups += m * tile.flat_slices


def _finish_stats(stats: StreamStats, plan) -> StreamStats:
    stats.flat_slices = plan.flat_slices
    stats.tiles = len(plan.tiles)
    stats.slice_reuse = stats.lookups / max(stats.slices_streamed, 1)
    return stats


def streamed_lut_gemm(
    wcodes: Optional[torch.Tensor],
    acodes: torch.Tensor,
    pack: LutPack,
    *,
    k_slices: int = 2,
    tile_n: Optional[int] = None,
    buffer_bytes: Optional[int] = None,
    prep: Optional[StreamWeights] = None,
) -> tuple[torch.Tensor, StreamStats]:
    """Tiled, deduplicated LUT slice streaming (§IV-C): LUT-stationary dataflow.

    Per ``tile_n``-wide activation tile the :mod:`repro_torch.core.stream_plan`
    planner computes the *unique* slice-pair set; each pair is streamed once,
    the reordering lookup is folded into the canonical gather at the slice
    level, and all M weight rows gather from the composed buffer (paper
    Fig. 7 reuse).  Numerically identical to :func:`canonical_lut_gemm`;
    additionally reports the traffic the real device would see, which
    :mod:`repro_torch.core.pim_cost` converts to time.  ``k_slices`` sets the
    DMA batch size used for ``stream_batches`` accounting (paper Fig. 13's k).

    On a CUDA tensor with an integer pack the product comes from the
    ``lut_stream_gemm`` kernel and the stats from :func:`stream_plan_stats`
    (the same planner and counters; one host copy of the activation codes).
    Otherwise the host numpy dataflow runs, as in the reference.

    Weight-stationary path: pass ``prep`` (:func:`prepare_stream_weights`) to
    skip every per-call weight product (``wcodes`` may then be ``None``).
    """
    if k_slices < 1:
        raise ValueError(f"k_slices must be >= 1, got {k_slices}")
    p = pack.p
    if prep is None:
        prep = prepare_stream_weights(wcodes, pack)
    if prep.g * p - prep.pad != acodes.shape[0]:
        raise ValueError(
            f"prepared weights cover K={prep.g * p - prep.pad}, "
            f"activations have K={acodes.shape[0]}"
        )
    device = acodes.device if isinstance(acodes, torch.Tensor) else torch.device("cpu")
    if device.type == "cuda" and _int_pack(pack):
        out = _kernel_sum(prep.wpk, canonicalize_activations(acodes, pack), pack)
        if prep.corr:
            out = out - prep.corr
        stats = stream_plan_stats(prep.m, acodes, pack, k_slices=k_slices, tile_n=tile_n,
                                  buffer_bytes=buffer_bytes)
        return out, stats
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"streamed_lut_gemm runs on cuda or cpu, got {device}")
    ac = _np(acodes)
    if prep.pad:
        ca = zero_code(np.asarray(pack.agrid))
        ac = np.pad(ac, ((0, prep.pad), (0, 0)), constant_values=ca)
    corr = prep.corr
    idx = canonicalize_activations_np(ac, pack)
    m, g, r = prep.m, prep.g, prep.r
    n = ac.shape[1]
    wpk = _np(prep.wpk)
    onehot = prep.onehot
    use_matmul = onehot is not None
    reorder = pack.reordering
    canon = pack.canonical
    int_pack = _int_pack(pack)
    acc_dtype = np.int64 if int_pack else np.float64

    plan = stream_plan.plan_stream(
        idx.msrank, idx.permid, tile_n=tile_n,
        buffer_bytes=buffer_bytes, slice_bytes=_slice_bytes(pack),
    )

    out = np.empty((m, n), dtype=acc_dtype)
    stats = StreamStats()

    for tile in plan.tiles:
        # --- stream: load each distinct canonical + reordering column once -
        rbuf = reorder[:, tile.slice_pid]                          # [R, S]
        cbuf = canon[:, tile.slice_ms]                             # [R, S]
        # --- compose: fold the reordering lookup into the canonical gather
        # index *per slice* (R*S work instead of M*G*NT):
        #   composed[r, s] = canon[reorder[r, pid_s], ms_s]
        composed = np.take_along_axis(cbuf, rbuf.astype(np.int64), axis=0)
        # --- reuse: all M weight rows hit the composed buffer --------------
        if use_matmul:
            # Exact one-hot contraction on BLAS: out[m, nl] = sum_g
            # composed[wpk[m, g], slot[g, nl]].
            c2 = composed[:, tile.slot]                            # [R, G, NT]
            c2 = c2.transpose(1, 0, 2).astype(np.float32).reshape(g * r, -1)
            out[:, tile.n0 : tile.n1] = onehot @ c2
        else:
            vals = composed[wpk[:, :, None], tile.slot[None, :, :]]  # [M,G,NT]
            out[:, tile.n0 : tile.n1] = vals.sum(axis=1, dtype=acc_dtype)
        _tile_stats(stats, tile, m, pack, k_slices)
    _finish_stats(stats, plan)
    out_dtype = np.int32 if int_pack else np.float32
    return torch.from_numpy((out - corr).astype(out_dtype)).to(device), stats


def stream_plan_stats(
    m: int,
    acodes,
    pack: LutPack,
    *,
    k_slices: int = 2,
    tile_n: Optional[int] = None,
    buffer_bytes: Optional[int] = None,
) -> StreamStats:
    """Traffic stats of the streamed dataflow WITHOUT executing the GEMM.

    Canonicalize the activations, run the
    :func:`repro_torch.core.stream_plan.plan_stream` planner, and derive every
    :class:`StreamStats` field from the tile schedule and ``m`` (the weight
    row count).  Field-for-field identical to the stats
    :func:`streamed_lut_gemm` returns for the same inputs.
    """
    if k_slices < 1:
        raise ValueError(f"k_slices must be >= 1, got {k_slices}")
    idx = canonicalize_activations_np(_np(acodes), pack)
    plan = stream_plan.plan_stream(
        idx.msrank, idx.permid, tile_n=tile_n,
        buffer_bytes=buffer_bytes, slice_bytes=_slice_bytes(pack),
    )
    stats = StreamStats()
    for tile in plan.tiles:
        _tile_stats(stats, tile, m, pack, k_slices)
    return _finish_stats(stats, plan)


def streamed_lut_gemm_looped(
    wcodes: torch.Tensor,
    acodes: torch.Tensor,
    pack: LutPack,
    *,
    k_slices: int = 2,
) -> tuple[torch.Tensor, StreamStats]:
    """Seed implementation of §IV-C: flat (g, n) walk, one Python iteration
    per slice, no deduplication.  Kept as an independent equivalence oracle
    (CPU)."""
    p = pack.p
    wcodes, acodes, corr = _pad_groups(wcodes, acodes, p, pack.wgrid, pack.agrid)
    idx = canonicalize_activations(acodes, pack)
    m, k = wcodes.shape
    n = acodes.shape[1]
    g = k // p
    wpacked = packing.pack_index(wcodes.reshape(m, g, p), pack.bw)        # [M,G]
    reorder = pack.reordering.astype(np.int32)
    canon = pack.canonical
    msr = _np(idx.msrank)                                                 # [G,N]
    pid = _np(idx.permid)
    wpk = _np(wpacked)

    out = np.zeros((m, n), dtype=np.int64)
    stats = StreamStats()
    r = pack.n_rows
    rbytes = pack.reordering.dtype.itemsize
    cbytes = pack.canonical.dtype.itemsize

    # Flatten the (g, n) slice space and stream k_slices at a time.
    flat = [(gi, ni) for ni in range(n) for gi in range(g)]
    for start in range(0, len(flat), k_slices):
        chunk = flat[start : start + k_slices]
        # --- stream: load the addressed canonical + reordering columns ----
        canon_slices = {}
        reorder_slices = {}
        for gi, ni in chunk:
            canon_slices[(gi, ni)] = canon[:, msr[gi, ni]]        # [R]
            reorder_slices[(gi, ni)] = reorder[:, pid[gi, ni]]    # [R]
        stats.slices_streamed += len(chunk)
        stats.stream_batches += 1
        stats.canonical_bytes += len(chunk) * r * cbytes
        stats.reordering_bytes += len(chunk) * r * rbytes
        # --- reuse: all M weight rows hit the buffered slices --------------
        for gi, ni in chunk:
            wcanon = reorder_slices[(gi, ni)][wpk[:, gi]]          # [M]
            out[:, ni] += canon_slices[(gi, ni)][wcanon].astype(np.int64)
            stats.lookups += m
    stats.flat_slices = g * n
    stats.tiles = 1
    stats.slice_reuse = stats.lookups / max(stats.slices_streamed, 1)
    return torch.from_numpy((out - corr).astype(np.int32)), stats
