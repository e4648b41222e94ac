"""Canonicalization math: multiset ranking and permutation (Lehmer) ids.

Port of ``repro.core.multiset``: the numpy half (LUT builders, perf model,
the host-side streamed engine) and the torch half (the on-device
canonicalization of the ``lut``/``stream`` engines).

LUT canonicalization (paper §IV-A) stores one LUT column per *multiset* of
activation codes instead of one per *sequence*: ``C(2^ba + p - 1, p)`` columns
instead of ``2^(ba*p)`` (paper Eq. 1).  Runtime access therefore needs:

* the *multiset rank* of the sorted activation group  -> canonical-LUT column,
* the *permutation id* of the sort                    -> reordering-LUT column.

Ranking uses the classic bijection between non-decreasing length-``p``
sequences over ``V`` symbols and ``p``-subsets of ``{0 .. V+p-2}``:
``d_i = c_i + i`` is strictly increasing, and the subset's colex rank is
``sum_i C(d_i, i+1)``.  Both directions are exact integer math on a
precomputed binomial table.

Permutation ids are Lehmer codes of the *stable argsort* permutation, so the
host quantizer and the LUT builder always agree on which of the (possibly
many, under ties) sorting permutations indexes the reordering LUT.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch


def n_multisets(v: int, p: int) -> int:
    """Number of canonical-LUT columns (paper Eq. 1): C(v + p - 1, p)."""
    return math.comb(v + p - 1, p)


def binom_table(n_max: int, k_max: int) -> np.ndarray:
    """C[n, k] for 0 <= n <= n_max, 0 <= k <= k_max (int64)."""
    c = np.zeros((n_max + 1, k_max + 1), dtype=np.int64)
    c[:, 0] = 1
    for n in range(1, n_max + 1):
        for k in range(1, k_max + 1):
            c[n, k] = c[n - 1, k - 1] + c[n - 1, k]
    return c


# ---------------------------------------------------------------------------
# numpy (host / LUT-build) side
# ---------------------------------------------------------------------------


def multiset_rank_np(sorted_codes: np.ndarray, v: int) -> np.ndarray:
    """[..., p] non-decreasing codes in [0, v) -> [...] rank (int64)."""
    sorted_codes = np.asarray(sorted_codes)
    p = sorted_codes.shape[-1]
    tbl = binom_table(v + p - 1, p)
    d = sorted_codes.astype(np.int64) + np.arange(p, dtype=np.int64)
    ranks = np.zeros(sorted_codes.shape[:-1], dtype=np.int64)
    for i in range(p):
        ranks += tbl[d[..., i], i + 1]
    return ranks


def multiset_unrank_np(rank, v: int, p: int) -> np.ndarray:
    """Inverse of :func:`multiset_rank_np`: rank -> sorted code vector [p]."""
    tbl = binom_table(v + p - 1, p)
    rank = int(rank)
    out = np.zeros(p, dtype=np.int32)
    for i in range(p - 1, -1, -1):
        # Largest d with C(d, i+1) <= rank.
        d = i  # C(i, i+1) = 0 always <= rank
        for cand in range(v + p - 1, i - 1, -1):
            if tbl[cand, i + 1] <= rank:
                d = cand
                break
        rank -= tbl[d, i + 1]
        out[i] = d - i
    return out


def all_multisets(v: int, p: int) -> np.ndarray:
    """[n_multisets(v,p), p] sorted code vectors, row i = unrank(i)."""
    n = n_multisets(v, p)
    out = np.zeros((n, p), dtype=np.int32)
    # Enumerate non-decreasing sequences directly (lexicographic) and place
    # them at their rank — O(n*p), no per-row unrank loop.
    for row, comb in enumerate(itertools.combinations_with_replacement(range(v), p)):
        arr = np.array(comb, dtype=np.int32)
        out[multiset_rank_np(arr, v)] = arr
        del row
    return out


def perm_id_np(perm: np.ndarray) -> int:
    """Lehmer code of a permutation array -> integer in [0, p!)."""
    perm = np.asarray(perm)
    p = perm.shape[-1]
    pid = 0
    for i in range(p):
        smaller = int(np.sum(perm[i + 1 :] < perm[i]))
        pid += smaller * math.factorial(p - 1 - i)
    return pid


def perm_id_np_batch(perm: np.ndarray) -> np.ndarray:
    """Vectorized :func:`perm_id_np`: [..., p] permutations -> [...] ids.

    Vectorized over the leading axes (same Lehmer convention); used
    by the streamed engine's numpy canonicalization path.
    """
    perm = np.asarray(perm)
    p = perm.shape[-1]
    facts = np.array(
        [math.factorial(p - 1 - i) for i in range(p)], dtype=np.int64
    )
    # smaller[i] = #{j > i : perm[j] < perm[i]}
    less = perm[..., :, None] > perm[..., None, :]
    upper = np.triu(np.ones((p, p), dtype=bool), k=1)
    smaller = (less & upper).sum(axis=-1)
    return (smaller @ facts).astype(np.int32)


def all_permutations(p: int) -> np.ndarray:
    """[p!, p] permutation arrays, row i = permutation with Lehmer id i."""
    out = np.zeros((math.factorial(p), p), dtype=np.int32)
    for perm in itertools.permutations(range(p)):
        arr = np.array(perm, dtype=np.int32)
        out[perm_id_np(arr)] = arr
    return out


# ---------------------------------------------------------------------------
# torch (on-device inference) side
# ---------------------------------------------------------------------------


def canonicalize(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort the last axis ascending (stable); returns (sorted, perm).

    ``sorted = codes[..., perm]`` along the last axis.  Stable order matches
    :func:`perm_id_np`'s convention under ties.
    """
    perm = torch.argsort(codes, dim=-1, stable=True)
    return torch.take_along_dim(codes, perm, dim=-1), perm


@functools.lru_cache(maxsize=None)
def _rank_consts(v: int, p: int, device: torch.device):
    """Device constants of :func:`multiset_rank` / :func:`perm_id`, uploaded
    once per (v, p, device) so a serve step copies nothing from the host."""
    tbl = torch.as_tensor(binom_table(v + p - 1, p).astype(np.int32), device=device)
    cols = torch.arange(1, p + 1, dtype=torch.int64, device=device)
    offs = torch.arange(p, dtype=torch.int32, device=device)
    facts = torch.tensor([math.factorial(p - 1 - i) for i in range(p)], dtype=torch.int32,
                         device=device)
    upper = torch.triu(torch.ones((p, p), dtype=torch.int32, device=device), diagonal=1)
    return tbl, cols, offs, facts, upper


def multiset_rank(sorted_codes: torch.Tensor, v: int, *, table: np.ndarray | None = None):
    """torch version; returns int32 ranks (caller guarantees they fit int32).
    ``table`` (``binom_table(v + p - 1, p)``, e.g. ``LutPack.binom``) is read
    for the int32 guard; the ranking uses the same table, cached on the
    device."""
    p = sorted_codes.shape[-1]
    tbl = table if table is not None else binom_table(v + p - 1, p)
    if int(tbl[v + p - 1, p]) >= 2**31:
        raise ValueError("multiset rank does not fit int32; use streaming tiles")
    tbl_t, cols, offs, _, _ = _rank_consts(v, p, sorted_codes.device)
    d = sorted_codes.to(torch.int32) + offs
    return tbl_t[d.long(), cols].sum(dim=-1, dtype=torch.int32)


def perm_id(perm: torch.Tensor) -> torch.Tensor:
    """torch Lehmer code over the last axis -> int32 id in [0, p!)."""
    p = perm.shape[-1]
    _, _, _, facts, upper = _rank_consts(1, p, perm.device)
    # smaller[i] = #{j > i : perm[j] < perm[i]}
    less = (perm[..., :, None] > perm[..., None, :]).to(torch.int32)      # [.., i, j]
    smaller = (less * upper).sum(dim=-1, dtype=torch.int32)
    return (smaller * facts).sum(dim=-1, dtype=torch.int32)
