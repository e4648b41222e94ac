"""Hopper kernel: online-softmax (flash) attention with GQA, causal and
sliding-window masks and a logit softcap.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (Pallas body ``_flash_body``): the scores of one query
block against one key block live only on the chip, the running max, sum and
accumulator of the online softmax are carried across key blocks, and only
the ``[B, S, H, hd]`` output returns to device memory.

What bounds it on an H100: its multiply-adds (``4 * hd`` operations per
visible (query, key) pair and head; the pairs the masks leave), not its
bytes.  Two CUDA sources, and a route fixed by dtype (:func:`route`):

* ``"tc"`` -- bf16 at every head dim of :data:`HEAD_DIMS` (gemma2-2b's 256,
  stablelm-12b's 160, zamba2-7b's 112, whisper's and internvl2's 64):
  ``csrc/flash_attention_sm90.cu``, on the tensor cores, one instance per
  padded width ``64 * ceil(hd / 64)`` (the tensor maps keep the real hd, so
  TMA zero-fills the columns up to the padded width; the columns past hd are
  not stored).  bf16 ``wgmma`` for both products (f32 accumulation; P
  rounded to bf16 before ``P @ V``, which the reference's f32 kernel does
  not do -- the TPU's MXU does at default precision), K/V fed by TMA into a
  ring of stages, one producer warp and two consumer warpgroups of 64
  query rows taking turns, each block's softmax run while the previous
  block's ``P @ V`` runs, against the 989 TFLOP/s bf16 peak.
* ``"cuda_core"`` -- f32 inputs (the reference's f32 compute: TF32 would not
  keep the 2e-4 tolerance): ``csrc/flash_attention.cu``, a simple version on
  the CUDA cores with ``fmaf``, f32 tiles in shared memory.

Both skip key blocks wholly masked by the causal mask or the window, mask
the ragged tails in the kernel, read q/k/v in place through their strides
and issue the longest query blocks first.  Times beside the bound are in
PERF.md.

The wrapper checks device, dtypes, shapes and strides, allocates the output,
launches on the current stream and raises on a launch error.  It counts its
launches in :data:`launches` and those of the tensor-core route also in
:data:`launches_tc` (plain integers, reset by the caller).
:func:`cuda_core_yardstick` runs the CUDA-core kernel on bf16 inputs, which
route to the tensor cores, only to time the redesign against the kernel it
replaced.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0          # incremented once per kernel launch (either route), nowhere else
launches_tc = 0       # incremented once per launch of the tensor-core route, nowhere else

HEAD_DIMS = (16, 32, 64, 96, 112, 128, 160, 256)   # every full config's hd among them

_fns: dict = {}


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a call runs on, fixed by the inputs' dtype and head dim:
    ``"tc"`` (``flash_attention_sm90.cu``) for bf16, ``"cuda_core"``
    (``flash_attention.cu``) for f32, at every head dim of :data:`HEAD_DIMS`."""
    if dtype not in (torch.float32, torch.bfloat16) or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 inputs with head "
                         f"dims {HEAD_DIMS}; got {dtype}, hd {hd}")
    return "tc" if dtype == torch.bfloat16 else "cuda_core"


def _kernel(which: str):
    if which not in _fns:
        if which == "tc":
            fn = build.load("flash_attention_sm90").flash_attention_sm90
            head = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        else:
            fn = build.load("flash_attention").flash_attention
            head = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        fn.argtypes = (head + [ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[which] = fn
    return _fns[which]


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
    ``1/sqrt(hd)`` scale.  The tensor-core route (:func:`route`) also needs
    16-byte aligned q, k, v and strides that are multiples of 8 elements.
    """
    which = _check(q, k, v, window, softcap)
    if which == "tc" and any(
            x.data_ptr() % 16 or any(x.stride(i) % 8 for i in range(3) if x.shape[i] > 1)
            for x in (q, k, v)):
        raise ValueError("the tensor-core flash_attention reads q, k and v by TMA: they need "
                         "16-byte aligned data and strides that are multiples of 8 elements")
    return _launch(which, q, k, v, causal, window, softcap)


def cuda_core_yardstick(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """The CUDA-core kernel (``csrc/flash_attention.cu``) on any inputs it
    takes, whatever :func:`route` says: a yardstick that times the kernel the
    tensor-core route replaced on the shapes that route now takes
    (``chip_smoke.py`` phase 10).  Nothing in the port calls it."""
    _check(q, k, v, window, softcap)
    return _launch("cuda_core", q, k, v, causal, window, softcap)


def _check(q, k, v, window, softcap) -> str:
    """Check device, dtypes, shapes, strides and options; return the route."""
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
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    which = route(q.dtype, hd)
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention kernel needs a contiguous head dim in q, k and v")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return which


def _launch(which, q, k, v, causal, window, softcap):
    """Launch route ``which`` on checked inputs; counts the launch."""
    global launches, launches_tc
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0 or h == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(
        x.stride(i) for x in (q, k, v, out) for i in range(3)))
    fn = _kernel(which)
    dtype_arg = () if which == "tc" else (int(q.dtype == torch.bfloat16),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *dtype_arg, b, s, t, h, hkv, hd, ctypes.addressof(strides),
            int(causal), int(window is not None), int(window or 0),
            int(softcap is not None), float(softcap or 0.0), 1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        what = (f"cuTensorMapEncodeTiled refused a tensor map (CUresult {err - 10000})"
                if err >= 10000 else "cuTensorMapEncodeTiled not found in libcuda.so.1"
                if err == -1 else f"cudaError {err}")
        raise RuntimeError(f"flash_attention kernel ({which}) launch failed: {what} "
                           f"(B={b} S={s} T={t} H={h} Hkv={hkv} hd={hd})")
    launches += 1
    launches_tc += which == "tc"
    return out
