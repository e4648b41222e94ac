"""Canonicalization math: multiset ranking and permutation (Lehmer) ids.

Port of the numpy half of ``repro.core.multiset`` (the LUT builders and the
perf model need it); the on-device ranking functions arrive with the
``lut``/``stream`` engines.

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

import itertools
import math

import numpy as np


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
