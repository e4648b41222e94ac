"""Stream planner for the tiled, deduplicated LUT slice-streaming dataflow.

Copy of ``repro.core.stream_plan`` (numpy only).

The paper's §IV-C dataflow streams, for every (K-group, activation-column)
address, the canonical-LUT column ``msrank[g, n]`` and the reordering-LUT
column ``permid[g, n]`` from the DRAM bank into the local buffer, then reuses
the buffered pair across all M weight rows.  The seed implementation walked
the flat ``(g, n)`` address space and streamed every address — even when the
same (canonical, reordering) column pair had just been fetched for another
address of the same tile.  pLUTo/ReducedLUT-style systems win precisely by
exploiting that duplication, and real activations duplicate heavily: with
``C(2^ba + p - 1, p)`` distinct multisets, a tile of ``G x NT`` addresses
collides as soon as ``G * NT`` approaches the multiset count.

:func:`plan_stream` tiles the activation columns into ``NT``-wide tiles and
computes, **fully vectorized** (one :func:`np.unique` per tile — no Python
per-slice loop), the *unique* slice-pair set of each tile plus the inverse
``slot`` map every engine needs to gather from the streamed buffer:

    slice_ms[slot[g, nl]]  == msrank[g, n0 + nl]
    slice_pid[slot[g, nl]] == permid[g, n0 + nl]

Each distinct pair is streamed once per tile; every further address that
resolves to the same pair is a *buffer hit*.  :class:`repro_torch.core.engine.StreamStats`
reports both the deduplicated traffic and the seed's flat count so the
capacity/cost models can quantify the reuse.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Streaming schedule for one tile of ``NT`` activation columns."""

    n0: int                  # first activation column of the tile
    n1: int                  # one past the last column
    slice_ms: np.ndarray     # [S] unique canonical-LUT column ids
    slice_pid: np.ndarray    # [S] matching reordering-LUT column ids
    slot: np.ndarray         # [G, n1-n0] address -> index into slice_ms/pid

    @property
    def n_slices(self) -> int:
        """Distinct (canonical, reordering) column pairs streamed."""
        return int(self.slice_ms.shape[0])

    @property
    def flat_slices(self) -> int:
        """Addresses in the tile == slices the seed dataflow would stream."""
        return int(self.slot.size)

    @property
    def buffer_hits(self) -> int:
        return self.flat_slices - self.n_slices


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Tiled streaming schedule over the whole [G, N] address space."""

    g: int
    n: int
    tile_n: int
    tiles: tuple[TilePlan, ...]

    @property
    def unique_slices(self) -> int:
        return sum(t.n_slices for t in self.tiles)

    @property
    def flat_slices(self) -> int:
        return self.g * self.n

    @property
    def buffer_hits(self) -> int:
        return self.flat_slices - self.unique_slices

    @property
    def dedup_ratio(self) -> float:
        """unique/flat in (0, 1]; 1.0 means no intra-tile duplication."""
        return self.unique_slices / max(self.flat_slices, 1)


def _pair_key(msr: np.ndarray, pid: np.ndarray) -> tuple[np.ndarray, np.int64]:
    """Collision-free int64 key per (canonical, reordering) pair."""
    stride = np.int64(pid.max()) + 1 if pid.size else np.int64(1)
    return msr.astype(np.int64) * stride + pid, stride


def max_unique_slices(msrank: np.ndarray, permid: np.ndarray, tile_n: int) -> int:
    """Largest per-tile unique (canonical, reordering) pair count at ``tile_n``
    — the buffer occupancy the streaming dataflow needs for that tile width."""
    msr = np.asarray(msrank)
    pid = np.asarray(permid)
    g, n = msr.shape
    key, _ = _pair_key(msr, pid)
    worst = 0
    for n0 in range(0, n, tile_n):
        worst = max(worst, int(np.unique(key[:, n0 : n0 + tile_n]).size))
    return worst


def auto_tile_n(
    msrank: np.ndarray,
    permid: np.ndarray,
    *,
    buffer_bytes: int,
    slice_bytes: int,
) -> int:
    """Widest tile whose per-tile unique-slice set fits a buffer budget.

    A streamed tile must hold its whole deduplicated slice set resident
    (``slice_bytes`` = canonical + reordering column bytes per pair, i.e.
    ``R * (bo + reorder_itemsize)``).  Candidates are N itself and powers of
    two below it, widest first; returns 1 if even single-column tiles exceed
    the budget (the device would then have to stream within a column).
    """
    if buffer_bytes < 1 or slice_bytes < 1:
        raise ValueError(f"buffer_bytes/slice_bytes must be >= 1, got "
                         f"{buffer_bytes}/{slice_bytes}")
    msr = np.asarray(msrank)
    n = msr.shape[1] if msr.ndim == 2 else 0
    if n <= 1:
        return 1
    cands = [n] + [1 << i for i in range(n.bit_length() - 1, -1, -1) if (1 << i) < n]
    budget_slices = buffer_bytes // slice_bytes
    # One key build for the whole search; bail out of a candidate at the
    # first overflowing tile (this sits on the stream-mode per-GEMM path).
    key, _ = _pair_key(msr, np.asarray(permid))
    for tn in cands:
        if all(
            np.unique(key[:, n0 : n0 + tn]).size <= budget_slices
            for n0 in range(0, n, tn)
        ):
            return tn
    return 1


def plan_stream(
    msrank: np.ndarray,
    permid: np.ndarray,
    *,
    tile_n: int | None = None,
    buffer_bytes: int | None = None,
    slice_bytes: int | None = None,
) -> StreamPlan:
    """Compute the deduplicated streaming schedule.

    ``msrank``/``permid``: [G, N] int arrays of canonical/reordering LUT
    column ids (from :func:`repro_torch.core.engine.canonicalize_activations`).
    ``tile_n``: activation columns per tile; ``None`` = one tile spanning all
    N (maximal reuse — the buffer is assumed to hold the tile's unique set),
    unless ``buffer_bytes`` (+ ``slice_bytes``, the DRAM bytes of one
    canonical+reordering column pair) is given, in which case the widest tile
    whose unique-slice set fits the budget is auto-selected
    (:func:`auto_tile_n`).  Values > N are clamped; values < 1 raise.
    """
    msr = np.asarray(msrank)
    pid = np.asarray(permid)
    if msr.shape != pid.shape or msr.ndim != 2:
        raise ValueError(f"msrank/permid must share a [G, N] shape, got "
                         f"{msr.shape} vs {pid.shape}")
    g, n = msr.shape
    if tile_n is None and buffer_bytes is not None:
        if slice_bytes is None:
            raise ValueError("buffer_bytes needs slice_bytes to size the tile")
        tile_n = auto_tile_n(
            msr, pid, buffer_bytes=buffer_bytes, slice_bytes=slice_bytes
        )
    if tile_n is None:
        tn = max(n, 1)
    else:
        if tile_n < 1:
            raise ValueError(f"tile_n must be >= 1, got {tile_n}")
        tn = min(tile_n, max(n, 1))
    # Collision-free pair key: pid < stride by construction.
    keys, _ = _pair_key(msr, pid)
    tiles = []
    for n0 in range(0, n, tn):
        n1 = min(n0 + tn, n)
        ms_t = msr[:, n0:n1].reshape(-1)
        pid_t = pid[:, n0:n1].reshape(-1)
        key = keys[:, n0:n1].reshape(-1)
        _, first, inv = np.unique(key, return_index=True, return_inverse=True)
        tiles.append(
            TilePlan(
                n0=n0,
                n1=n1,
                slice_ms=np.ascontiguousarray(ms_t[first]),
                slice_pid=np.ascontiguousarray(pid_t[first]),
                slot=inv.reshape(g, n1 - n0).astype(np.int32),
            )
        )
    return StreamPlan(g=g, n=n, tile_n=tn, tiles=tuple(tiles))
