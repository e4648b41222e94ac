"""Entry points to the kernels (port of ``repro.kernels.ops``).

Each one launches its CUDA kernel for a CUDA tensor and runs the kernel's
plain version (:mod:`repro_torch.kernels.ref`) only for a CPU tensor.  There
is no fallback: on a CUDA tensor the kernel runs or the call raises.

The kernels have no backward: a CUDA call whose input requires grad, with
grad enabled, raises (as the reference's Pallas kernels do under
``jax.grad``) instead of returning a result with no autograd path.  The
plain versions on the CPU are differentiable torch ops.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine, packing
from repro_torch.core.luts import LutPack
from repro_torch.core.quantize import QuantSpec
from repro_torch.kernels import flash_attention as _fa
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
    _refuse_grad("lut_dequant_gemm", x, codes, scale)
    if x.device.type == "cuda":
        return _dq.lut_dequant_gemm(x, codes, scale, bw=bw, k=k, grid_values=grid)
    if x.device.type == "cpu":
        return ref.lut_dequant_gemm_ref(x, codes, scale, bw=bw, k=k, grid=grid)
    raise ValueError(f"lut_dequant_gemm runs on cuda or cpu, got {x.device}")


def lut_stream_gemm_full(
    wcodes: torch.Tensor,
    acodes: torch.Tensor,
    pack: LutPack,
    *,
    nt: int = 8,
) -> torch.Tensor:
    """Paper-faithful slice-streaming GEMM from raw codes: ``wcodes [M, K]``,
    ``acodes [K, N]`` -> the int-exact GEMM ``[M, N]`` as float32.

    Performs the host-side steps (§IV-A step 1: pad, canonicalize, pack the
    weight index), then runs the ``lut_stream_gemm`` kernel on the pack's
    route for a CUDA tensor (``nt``: the CUDA-core route's column tile,
    rounded up to 4, 8 or 16; the tensor-core and lookup routes ignore it)
    or its plain version for a CPU tensor, and subtracts the exact pad
    correction.
    """
    _refuse_grad("lut_stream_gemm", wcodes, acodes)
    if pack.canonical.dtype.kind not in "iu":
        raise ValueError(
            "lut_stream_gemm_full accumulates in int32; float-grid packs run "
            "through engine.streamed_lut_gemm instead"
        )
    p = pack.p
    wcodes, acodes, corr = engine._pad_groups(wcodes, acodes, p, pack.wgrid, pack.agrid)
    idx = engine.canonicalize_activations(acodes, pack)
    m, k = wcodes.shape
    wpacked = packing.pack_index(wcodes.reshape(m, k // p, p), pack.bw)
    if acodes.device.type == "cuda":
        out = engine._kernel_sum(wpacked, idx, pack, nt=nt)
    elif acodes.device.type == "cpu":
        canon, reorder = engine.device_tables(pack, acodes.device)
        out = ref.lut_stream_gemm_ref(wpacked, idx.msrank, idx.permid, canon, reorder)
    else:
        raise ValueError(f"lut_stream_gemm runs on cuda or cpu, got {acodes.device}")
    return (out - corr).to(torch.float32)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention.  q [B,S,H,hd], k/v [B,T,Hkv,hd] -> [B,S,H,hd]
    in ``q.dtype``, computed in f32.  On the card an input whose head dim is
    strided (the ``lut`` mode's projections return a transposed view) is
    copied to a contiguous layout first: the kernels read rows of ``hd``."""
    _refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cuda":
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
        return _fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")


def _refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise for a CUDA input that requires grad while grad is enabled: the
    kernel fills its output through ctypes, so the result would carry no
    ``grad_fn`` and the loss would silently get no gradient through it."""
    if torch.is_grad_enabled() and any(t.is_cuda and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: a CUDA input requires grad (the reference's "
            f"Pallas kernel raises under jax.grad too); call it under torch.no_grad() "
            f"or detach the inputs"
        )


@functools.lru_cache(maxsize=None)
def _grid(bw: int, grid_kind: str) -> np.ndarray:
    """The value grid as float32 (one small array per (bw, kind), read-only)."""
    g = QuantSpec(bw, grid_kind).grid().astype(np.float32)
    g.flags.writeable = False
    return g
