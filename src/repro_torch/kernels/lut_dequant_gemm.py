"""Hopper kernel: packed low-bit-code GEMM with in-kernel value-LUT decode.

Replaces the TPU kernel ``src/repro/kernels/lut_dequant_gemm.py::
lut_dequant_gemm`` (Pallas body ``_decode_kernel_body``): weights stay in
device memory as bit-packed ``bw``-bit codes (16/bw x fewer bytes than bf16)
and are decoded inside the kernel through the ``2^bw``-entry value grid —
the paper's capacity<->computation tradeoff, re-instantiated for the GPU's
memory hierarchy.

What bounds it on an H100: at decode (B = serve batch) the ``F*K*bw/8`` code
bytes, which every step reads once per projection; at prefill
(B = batch x prompt bucket) the ``2*B*F*K`` multiply-adds.  The CUDA source
(``csrc/lut_dequant_gemm.cu``) is a simple, right first version: one CTA per
output tile looping over K chunks, the chunk's packed bytes decoded through a
shared-memory grid into an f32 tile, f32 register accumulators, the scale
applied after the K sum.  It does nothing yet to approach either bound
(no tensor cores, no TMA, no split-K); its times beside the bounds are in
PERF.md.

The wrapper checks device, dtypes, shapes and contiguity, allocates ``y``,
launches on the current stream and raises on a launch error.  It counts its
launches in :data:`launches` (a plain integer, reset by the caller).  The
grid values travel as a by-value kernel argument, so a launch copies nothing
from the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

launches = 0          # incremented once per kernel launch, nowhere else

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("lut_dequant_gemm").lut_dequant_gemm
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def lut_dequant_gemm(
    x: torch.Tensor,
    codes: torch.Tensor,
    scale: torch.Tensor,
    *,
    bw: int,
    k: int,
    grid_values: np.ndarray,
) -> torch.Tensor:
    """``y[B,F] = x[B,K] @ (grid[codes] * scale)[F,K]^T`` on a CUDA device, f32.

    ``x``: [B, K] float32 or bfloat16; ``codes``: [F, ceil(K/cpb)] uint8;
    ``scale``: [F] float32; ``grid_values``: the ``2^bw`` grid as numpy.
    """
    global launches
    if not (x.is_cuda and codes.device == x.device and scale.device == x.device):
        raise ValueError(
            f"lut_dequant_gemm kernel needs x, codes and scale on one CUDA device; "
            f"got {x.device}, {codes.device}, {scale.device}"
        )
    if bw not in (1, 2, 4, 8):
        raise ValueError(f"bw must be 1, 2, 4 or 8, got {bw}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if codes.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f"codes must be uint8 and scale float32, got {codes.dtype}, {scale.dtype}")
    cpb = 8 // bw
    kb = -(-k // cpb)
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"x must be [B, {k}], got {tuple(x.shape)}")
    if codes.ndim != 2 or codes.shape[1] != kb:
        raise ValueError(f"codes must be [F, {kb}], got {tuple(codes.shape)}")
    f = codes.shape[0]
    if scale.shape != (f,):
        raise ValueError(f"scale must be [{f}], got {tuple(scale.shape)}")
    if not (x.is_contiguous() and codes.is_contiguous() and scale.is_contiguous()):
        raise ValueError("lut_dequant_gemm kernel needs contiguous x, codes and scale")
    grid = np.ascontiguousarray(grid_values, dtype=np.float32)
    if grid.shape != (1 << bw,):
        raise ValueError(f"grid must have {1 << bw} values, got {grid.shape}")
    b = x.shape[0]
    y = torch.empty((b, f), dtype=torch.float32, device=x.device)
    if b == 0 or f == 0:
        return y
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
            scale.data_ptr(), y.data_ptr(), b, k, f, kb, bw,
            grid.ctypes.data, grid.shape[0], stream,
        )
    if err != 0:
        raise RuntimeError(f"lut_dequant_gemm kernel launch failed: cudaError {err}")
    launches += 1
    return y
