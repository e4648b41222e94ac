"""LUT builders: operation-packed LUT, canonical LUT, reordering LUT.

Copy of ``repro.core.luts`` (numpy only).

All builders run host-side in numpy (the paper builds LUTs on the host at
initialization and broadcasts them to the banks, §V-A).  Sizes follow the
paper exactly:

* operation-packed LUT   (§III-A): ``2^(bw*p)`` rows × ``2^(ba*p)`` cols
* canonical LUT          (§IV-A):  ``2^(bw*p)`` rows × ``C(2^ba+p-1, p)`` cols
* reordering LUT         (§IV-B):  ``2^(bw*p)`` rows × ``p!`` cols

Entries of the two value LUTs are integer partial dot products stored in the
smallest signed type that can hold ``p * max|w| * max|a|`` (``b_o`` in the
paper); the reordering LUT stores packed weight codes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import multiset, packing
from repro_torch.core.quantize import QuantSpec


def auto_bo(bw: int, ba: int, p: int, wgrid: np.ndarray, agrid: np.ndarray) -> int:
    """Bytes per LUT entry (paper's ``b_o``): smallest signed int holding the
    extreme packed partial product."""
    m = p * float(np.max(np.abs(wgrid))) * float(np.max(np.abs(agrid)))
    for bo, lim in ((1, 2**7), (2, 2**15), (4, 2**31)):
        if m < lim:
            return bo
    return 8


def _entry_dtype(bo: int) -> np.dtype:
    return {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[bo]


@dataclasses.dataclass(frozen=True)
class LutPack:
    """Everything a LoCaLUT engine needs for one (bw, ba, p) configuration."""

    bw: int
    ba: int
    p: int
    wgrid: np.ndarray            # [2^bw] weight value grid
    agrid: np.ndarray            # [2^ba] activation value grid
    canonical: np.ndarray        # [2^(bw p), n_multisets] partial products
    reordering: np.ndarray       # [2^(bw p), p!] packed canonical weight codes
    binom: np.ndarray            # binomial table for runtime ranking
    packed: Optional[np.ndarray] = None  # [2^(bw p), 2^(ba p)] (small cfgs only)

    @property
    def n_rows(self) -> int:
        return 1 << (self.bw * self.p)

    @property
    def n_canonical_cols(self) -> int:
        return self.canonical.shape[1]

    @property
    def bo(self) -> int:
        return self.canonical.dtype.itemsize

    # --- capacity accounting (paper Fig. 6) -------------------------------
    @property
    def canonical_bytes(self) -> int:
        return self.canonical.size * self.canonical.dtype.itemsize

    @property
    def reordering_bytes(self) -> int:
        return self.reordering.size * self.reordering.dtype.itemsize

    @property
    def total_bytes(self) -> int:
        return self.canonical_bytes + self.reordering_bytes


def packed_lut_cols(ba: int, p: int) -> int:
    return 1 << (ba * p)


def packed_lut_bytes(bw: int, ba: int, p: int, bo: int) -> int:
    """Operation-packed LUT capacity (paper §III-A): bo * 2^((bw+ba)p)."""
    return bo * (1 << (bw * p)) * (1 << (ba * p))


def canonical_lut_bytes(bw: int, ba: int, p: int, bo: int) -> int:
    return bo * (1 << (bw * p)) * multiset.n_multisets(1 << ba, p)


def reordering_lut_bytes(bw: int, p: int) -> int:
    code_bytes = 1 if bw * p <= 8 else (2 if bw * p <= 16 else 4)
    return code_bytes * (1 << (bw * p)) * math.factorial(p)


def build_packed_lut(
    bw: int, ba: int, p: int, wgrid: np.ndarray, agrid: np.ndarray
) -> np.ndarray:
    """Operation-packed LUT (§III-A).  Guarded: only for small (bw+ba)*p."""
    if (bw + ba) * p > 22:
        raise ValueError(
            f"packed LUT with {(bw+ba)*p} index bits is too large to materialize "
            "— this is exactly the blow-up canonicalization exists to avoid"
        )
    wvecs = wgrid[packing.all_code_vectors(bw, p)].astype(np.int64)  # [R, p]
    avecs = agrid[packing.all_code_vectors(ba, p)].astype(np.int64)  # [C, p]
    lut = wvecs @ avecs.T
    bo = auto_bo(bw, ba, p, wgrid, agrid)
    return lut.astype(_entry_dtype(bo))


def build_canonical_lut(
    bw: int, ba: int, p: int, wgrid: np.ndarray, agrid: np.ndarray
) -> np.ndarray:
    """Canonical LUT (§IV-A): one column per activation *multiset*."""
    wvecs = wgrid[packing.all_code_vectors(bw, p)].astype(np.int64)  # [R, p]
    msets = multiset.all_multisets(1 << ba, p)                       # [C, p]
    avecs = agrid[msets].astype(np.int64)                            # [C, p]
    lut = wvecs @ avecs.T
    bo = auto_bo(bw, ba, p, wgrid, agrid)
    return lut.astype(_entry_dtype(bo))


def build_reordering_lut(bw: int, p: int) -> np.ndarray:
    """Reordering LUT (§IV-B): entry[wcode, perm_id] = pack(w[perm]).

    ``perm`` is the stable argsort of the activation group, i.e.
    ``sorted_a = a[perm]``; the canonical weight vector is ``w[perm]``.
    """
    codes = packing.all_code_vectors(bw, p)          # [R, p]
    perms = multiset.all_permutations(p)             # [p!, p]
    # out[r, q] = pack(codes[r, perms[q]])
    reordered = codes[:, perms]                      # [R, p!, p]
    packed = packing.pack_index_np(reordered, bw)    # [R, p!]
    dtype = np.uint8 if bw * p <= 8 else (np.uint16 if bw * p <= 16 else np.uint32)
    return packed.astype(dtype)


def build_lut_pack(
    bw: int,
    ba: int,
    p: int,
    *,
    w_kind: str = "int",
    a_kind: str = "int",
    with_packed: bool = False,
) -> LutPack:
    wgrid = QuantSpec(bw, w_kind).grid()
    agrid = QuantSpec(ba, a_kind).grid()
    if wgrid.dtype.kind == "f" or agrid.dtype.kind == "f":
        # Float grids: keep float32 entries; bo accounting uses 4 bytes.
        wvecs = wgrid[packing.all_code_vectors(bw, p)].astype(np.float64)
        msets = multiset.all_multisets(1 << ba, p)
        avecs = agrid[msets].astype(np.float64)
        canonical = (wvecs @ avecs.T).astype(np.float32)
    else:
        canonical = build_canonical_lut(bw, ba, p, wgrid, agrid)
    reordering = build_reordering_lut(bw, p)
    binom = multiset.binom_table((1 << ba) + p - 1, p)
    packed = (
        build_packed_lut(bw, ba, p, wgrid, agrid)
        if with_packed and wgrid.dtype.kind != "f"
        else None
    )
    return LutPack(
        bw=bw, ba=ba, p=p, wgrid=wgrid, agrid=agrid,
        canonical=canonical, reordering=reordering, binom=binom, packed=packed,
    )


# ---------------------------------------------------------------------------
# Capacity-driven packing-degree limits (paper §V-A)
# ---------------------------------------------------------------------------


def max_p_packed(bw: int, ba: int, budget_bytes: int, p_cap: int = 12) -> int:
    """Largest p whose *operation-packed* LUT fits the budget."""
    best = 0
    for p in range(1, p_cap + 1):
        bo = auto_bo(bw, ba, p, QuantSpec(bw).grid(), QuantSpec(ba).grid())
        if packed_lut_bytes(bw, ba, p, bo) <= budget_bytes:
            best = p
    return best


def max_p_canonical(bw: int, ba: int, budget_bytes: int, p_cap: int = 12) -> int:
    """Largest p whose canonical + reordering LUTs fit the budget."""
    best = 0
    for p in range(1, p_cap + 1):
        bo = auto_bo(bw, ba, p, QuantSpec(bw).grid(), QuantSpec(ba).grid())
        total = canonical_lut_bytes(bw, ba, p, bo) + reordering_lut_bytes(bw, p)
        if total <= budget_bytes:
            best = p
    return best
