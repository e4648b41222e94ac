"""Hopper kernel: online-softmax (flash) attention with GQA, causal and
sliding-window masks and a logit softcap.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (Pallas body ``_flash_body``): the scores of one query
block against one key block live only on the chip, the running max, sum and
accumulator of the online softmax are carried across key blocks, and only
the ``[B, S, H, hd]`` output returns to device memory.

What bounds it on an H100: its multiply-adds (``4 * S * T_seen * hd`` per
head; ``T_seen`` the keys the masks leave), not its bytes.  The CUDA source
(``csrc/flash_attention.cu``) is a simple, right first version on the CUDA
cores with ``fmaf``: one block per (query block of 64, batch x head), a loop
over key blocks of 64 in order, the tiles staged in shared memory as f32,
key blocks wholly masked by the causal mask or the window skipped, the
ragged tails masked in the kernel, q/k/v read in place through their
strides.  Its times beside the bound are in PERF.md.

The wrapper checks device, dtypes, shapes and strides, allocates the output,
launches on the current stream and raises on a launch error.  It counts its
launches in :data:`launches` (a plain integer, reset by the caller).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0          # incremented once per kernel launch, nowhere else

HEAD_DIMS = (16, 32, 64, 96, 128, 160, 256)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention on a CUDA device, computed in f32, returned
    in ``q.dtype``.

    ``q``: [B, S, H, hd]; ``k``, ``v``: [B, T, Hkv, hd], float32 or bfloat16
    alike, each with a contiguous last dim; ``H % Hkv == 0``; ``hd`` one of
    :data:`HEAD_DIMS`.  Masks: causal ``kpos <= qpos``, window
    ``kpos > qpos - window``; softcap ``cap * tanh(s / cap)`` after the
    ``1/sqrt(hd)`` scale.
    """
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention kernel needs q, k and v on one CUDA device; "
            f"got {q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must be float32 or bfloat16 alike, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, S, H, hd] and k, v [B, T, Hkv, hd] alike; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got {hd}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention kernel needs a contiguous head dim in q, k and v")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0 or h == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(
        x.stride(i) for x in (q, k, v, out) for i in range(3)))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, s, t, h, hkv, hd, ctypes.addressof(strides),
            int(causal), int(window is not None), int(window or 0),
            int(softcap is not None), float(softcap or 0.0), 1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err} "
                           f"(B={b} S={s} T={t} H={h} Hkv={hkv} hd={hd})")
    launches += 1
    return out
