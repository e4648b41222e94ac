"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

On the CPU the kernel wrappers in :mod:`repro_torch.kernels.ops` run these;
on the card they are used only to check the kernels against.
"""

from __future__ import annotations

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
