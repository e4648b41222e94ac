"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

On the CPU the kernel wrappers in :mod:`repro_torch.kernels.ops` run these;
on the card they are used only to check the kernels against.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import packing


def lut_dequant_gemm_ref(
    x: torch.Tensor,
    codes: torch.Tensor,
    scale: torch.Tensor,
    *,
    bw: int,
    k: int,
    grid: np.ndarray,
) -> torch.Tensor:
    """Plain packed-code dequant GEMM: unpack, ``grid[codes] * scale``, f32
    einsum.  ``x``: [B, K] float; ``codes``: [F, ceil(K/cpb)] uint8;
    ``scale``: [F].  Returns [B, F] float32."""
    g = torch.tensor(np.asarray(grid, dtype=np.float32), device=codes.device)
    wcodes = packing.unpack_bits(codes, bw)[:, :k]                 # [F, K]
    w_t = g[wcodes.long()] * scale[:, None]                        # [F, K]
    return torch.einsum("bk,fk->bf", x.to(torch.float32), w_t)


def lut_stream_gemm_ref(
    wpacked: torch.Tensor,
    msrank: torch.Tensor,
    permid: torch.Tensor,
    canonical: torch.Tensor,
    reordering: torch.Tensor,
) -> torch.Tensor:
    """Plain slice-streaming canonical-LUT GEMM: two gathers over the full
    ``[M, G, N]`` index space and an int32 sum over ``G``.  ``wpacked``:
    [M, G]; ``msrank``/``permid``: [G, N]; ``canonical``: [R, C];
    ``reordering``: [R, P!].  Returns [M, N] int32."""
    wcanon = reordering[wpacked[:, :, None].long(), permid[None, :, :].long()]   # [M,G,N]
    vals = canonical[wcanon.long(), msrank[None, :, :].long()]                    # [M,G,N]
    return vals.to(torch.int32).sum(dim=1, dtype=torch.int32)


def lut_canon_ref(
    acodes: torch.Tensor,
    binom: torch.Tensor,
    *,
    p: int,
    pad_code: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain form of the canonicalize kernel's arithmetic: activation codes
    ``[K, N]`` (a partial last group padded with ``pad_code``) -> int32
    ``msrank``, ``permid`` ``[G, N]``.  Each group's p codes are sorted by an
    odd-even transposition network on the distinct keys ``code * p + i``
    (whose one sorted order is the stable argsort's), then ranked through
    ``binom`` (the pack's ``[v + p, p + 1]`` binomial table) and given the
    Lehmer id of the permutation ``key % p``."""
    k, n = acodes.shape
    g = -(-k // p)
    a = acodes.to(torch.int64)
    if g * p > k:
        a = torch.nn.functional.pad(a, (0, 0, 0, g * p - k), value=pad_code)
    groups = a.reshape(g, p, n)                                          # [G, p, N]
    keys = [groups[:, i] * p + i for i in range(p)]                      # p x [G, N]
    for rnd in range(p):
        for i in range(rnd & 1, p - 1, 2):
            keys[i], keys[i + 1] = (torch.minimum(keys[i], keys[i + 1]),
                                    torch.maximum(keys[i], keys[i + 1]))
    tbl = binom.to(torch.int64)
    perm = [key % p for key in keys]
    rank = torch.zeros((g, n), dtype=torch.int64, device=acodes.device)
    pid = torch.zeros_like(rank)
    for i in range(p):
        rank += tbl[keys[i] // p + i, i + 1]
        for j in range(i + 1, p):
            pid += (perm[j] < perm[i]).to(torch.int64) * math.factorial(p - 1 - i)
    return rank.to(torch.int32), pid.to(torch.int32)


def lut_compose_ref(
    msrank: torch.Tensor,
    permid: torch.Tensor,
    canonical: torch.Tensor,
    reordering: torch.Tensor,
) -> torch.Tensor:
    """Plain compose step: ``B[n, g*R + r] = canonical[reordering[r,
    permid[g, n]], msrank[g, n]]`` as int8 ``[N, G*R]`` (the entries of a
    pack with ``b_o == 1`` fit s8)."""
    g, n = msrank.shape
    r = canonical.shape[0]
    rows = reordering[:, permid.long()].long()                           # [R, G, N]
    vals = canonical[rows, msrank.long()[None]]                          # [R, G, N]
    return vals.permute(2, 1, 0).reshape(n, g * r).to(torch.int8)


def lut_onehot_gemm_ref(wpacked: torch.Tensor, b: torch.Tensor, *, r: int) -> torch.Tensor:
    """Plain one-hot product ``onehot(wpacked)[M, G*R] . B[:, :G*R]^T`` as a
    gather: ``out[m, n] = sum_g B[n, g*R + wpacked[m, g]]``, int32 ``[M, N]``."""
    m, g = wpacked.shape
    cols = wpacked.long() + torch.arange(g, device=wpacked.device)[None] * r   # [M, G]
    return b[:, cols].sum(dim=2, dtype=torch.int32).T.contiguous()


def lut_compose_lookup_ref(
    msrank: torch.Tensor,
    permid: torch.Tensor,
    canon_t: torch.Tensor,
    reord_t: torch.Tensor,
    *,
    nt: int,
) -> torch.Tensor:
    """Plain compose step of the lookup route, tiled for it: ``S[n // nt, g, r,
    n % nt] = canon_t[msrank[g, n], reord_t[permid[g, n], r]] + 128`` as
    uint8 ``[ceil(N/nt), G, R, nt]`` (columns past N hold 128, entry 0);
    ``canon_t`` int8 ``[C, R]`` and ``reord_t`` uint8 ``[P!, R]``, the
    pack's tables transposed."""
    g, n = msrank.shape
    r = canon_t.shape[1]
    t = -(-n // nt)
    rows = reord_t[permid.long()].long()                                 # [G, N, R]
    vals = canon_t[msrank.long()[:, :, None], rows]                      # [G, N, R]
    full = torch.full((g, t * nt, r), 128, dtype=torch.uint8, device=msrank.device)
    full[:, :n] = (vals.to(torch.int16) + 128).to(torch.uint8)
    return full.reshape(g, t, nt, r).permute(1, 0, 3, 2).contiguous()


def lut_lookup_gemm_ref(wpacked: torch.Tensor, slices: torch.Tensor, *, n: int) -> torch.Tensor:
    """Plain lookup sum on the lookup route's slices ``[T, G, R, NT]``:
    ``out[m, c] = sum_g slices[c // NT, g, wpacked[m, g], c % NT] - 128 G``,
    int32 ``[M, n]``."""
    t, g, _r, nt = slices.shape
    m = wpacked.shape[0]
    gi = torch.arange(g, device=wpacked.device)[None, :]                 # [1, G]
    vals = slices[:, gi, wpacked.long(), :]                              # [T, M, G, NT]
    sums = vals.sum(dim=2, dtype=torch.int32) - 128 * g                  # [T, M, NT]
    return sums.permute(1, 0, 2).reshape(m, t * nt)[:, :n].contiguous()


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain masked softmax attention in f32.  ``q``: [B, S, H, hd];
    ``k``, ``v``: [B, T, Hkv, hd]; head ``h`` reads kv head ``h // (H/Hkv)``.
    Scores are scaled by ``1/sqrt(hd)``, soft-capped (``cap*tanh(s/cap)``),
    masked (causal ``kpos <= qpos``, window ``kpos > qpos - window``) with
    -1e30 and soft-maxed over keys.  Returns [B, S, H, hd] in ``q.dtype``."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, s, hkv, rep, hd).to(torch.float32)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k.to(torch.float32))
    scores = scores / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v.to(torch.float32))
    return out.reshape(b, s, h, hd).to(q.dtype)
