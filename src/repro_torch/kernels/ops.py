"""Entry points to the kernels (port of ``repro.kernels.ops``).

Each one launches its CUDA kernel for a CUDA tensor and runs the kernel's
plain version (:mod:`repro_torch.kernels.ref`) only for a CPU tensor.  There
is no fallback: on a CUDA tensor the kernel runs or the call raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.quantize import QuantSpec
from repro_torch.kernels import lut_dequant_gemm as _dq
from repro_torch.kernels import ref


def lut_dequant_gemm(
    x: torch.Tensor,
    codes: torch.Tensor,
    scale: torch.Tensor,
    *,
    bw: int,
    k: int,
    grid_kind: str = "int",
) -> torch.Tensor:
    """Packed-code GEMM.  x [B,K] -> y [B,F] float32."""
    grid = _grid(bw, grid_kind)
    if x.device.type == "cuda":
        return _dq.lut_dequant_gemm(x, codes, scale, bw=bw, k=k, grid_values=grid)
    if x.device.type == "cpu":
        return ref.lut_dequant_gemm_ref(x, codes, scale, bw=bw, k=k, grid=grid)
    raise ValueError(f"lut_dequant_gemm runs on cuda or cpu, got {x.device}")


@functools.lru_cache(maxsize=None)
def _grid(bw: int, grid_kind: str) -> np.ndarray:
    """The value grid as float32 (one small array per (bw, kind), read-only)."""
    g = QuantSpec(bw, grid_kind).grid().astype(np.float32)
    g.flags.writeable = False
    return g
