"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

On the CPU the kernel wrappers in :mod:`repro_torch.kernels.ops` run these;
on the card they are used only to check the kernels against.
"""

from __future__ import annotations

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
