"""Hopper kernel: packed low-bit-code GEMM with in-kernel value-LUT decode.

Replaces the TPU kernel ``src/repro/kernels/lut_dequant_gemm.py::
lut_dequant_gemm`` (Pallas body ``_decode_kernel_body``): weights stay in
device memory as bit-packed ``bw``-bit codes (16/bw x fewer bytes than bf16)
and are decoded inside the kernel through the ``2^bw``-entry value grid —
the paper's capacity<->computation tradeoff, re-instantiated for the GPU's
memory hierarchy.

What bounds it on an H100: at decode (B = serve batch, 4) the ``F*K*bw/8``
code bytes at 3.35 TB/s, which every step reads once per projection; at
prefill (B = batch x prompt bucket, 512; gemma2-2b's forward, 8192) the
``2*B*F*K`` operations at the 989 TFLOP/s bf16 tensor-core peak.  Two CUDA
sources, and a route fixed by what a layer is (:func:`route`), never by B:

* ``"tc"`` -- bf16 x and a grid whose values are all exact in bf16 (the int
  and uint grids at bw 1/2/4/8: every projection of both bf16 main paths),
  with K whose x rows (2K bytes) and code rows (ceil(K/cpb) bytes) TMA can
  address (multiples of 16 bytes): ``csrc/lut_dequant_gemm_sm90.cu``.  A
  swap-AB mixed-input GEMM: the codes decoded by table lookup straight into
  bf16 ``wgmma`` A-register fragments (the products are exact in bf16, the
  sums f32), x as the K-major B operand by TMA, one producer warp and two
  consumer warpgroups of 64 weight rows, up to 256 x rows per CTA at
  prefill (the operations bound), a 3-8 stage TMA ring, and K cut into S
  slices where a layer has few weight-row tiles (the bytes bound at decode:
  one CTA per slice, enough CTAs to stream the codes), the slices' sums
  added in the fixed order s = 0..S-1 (:func:`tile_plan`).
* ``"cuda_core"`` -- f32 x (TF32 would not hold the f32 tolerance), the
  ``fp`` grid (not exact in bf16) and K that TMA cannot address:
  ``csrc/lut_dequant_gemm.cu``, the first port's kernel on the CUDA cores (f32 tiles
  in shared memory, ``fmaf``), unchanged.

Both keep one reduction order per row at every B: the split ``S``
(:func:`split_k`) depends on F, K and the SM count only, and the K chunks,
the k16 steps and the order of the slices' sums are the same at B = 1 and
B = 8192 (whether one CTA adds them or the last of S), so a row's bits never
depend on the batch it came in (the serving contracts: per-row invariance,
kill + replay re-bucketing, scan == loop).  Times beside the bounds are in
PERF.md.

The wrapper checks device, dtypes, shapes, contiguity and (tensor-core
route) 16-byte alignment, allocates ``y`` and the split workspace, launches
on the current stream and raises on a launch error; it never switches
route.  It counts its launches in :data:`launches` and those of the
tensor-core route also in :data:`launches_tc` (plain integers, reset by the
caller).  The grid values travel as a by-value kernel argument, so a launch
copies nothing from the host.  The split's arrival counters are allocated
zeroed once per (device, stream) and left zeroed by every launch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

launches = 0          # incremented once per kernel launch (either route), nowhere else
launches_tc = 0       # incremented once per launch of the tensor-core route, nowhere else

MAX_SPLIT = 4         # K slices at most: the partials' traffic grows with S at every B
_FM = 128             # weight rows per CTA of the tensor-core kernel

_fns: dict = {}
_counters: dict = {}  # (device index, stream) -> int32 counters, zero between launches
_n_sm: dict = {}


def bf16_exact(grid_values: np.ndarray) -> bool:
    """Whether every grid value is exact in bf16."""
    return _bf16_exact(np.ascontiguousarray(grid_values, dtype=np.float32).tobytes())


@functools.lru_cache(maxsize=None)
def _bf16_exact(raw: bytes) -> bool:
    g = torch.frombuffer(bytearray(raw), dtype=torch.float32)
    return bool(torch.equal(g.to(torch.bfloat16).to(torch.float32), g))


def route(dtype: torch.dtype, bw: int, grid_values: np.ndarray, k: int) -> str:
    """The kernel a layer runs on, fixed by x's dtype, the code width, the
    grid and K: ``"tc"`` (``lut_dequant_gemm_sm90.cu``) or ``"cuda_core"``
    (``lut_dequant_gemm.cu``)."""
    if bw not in (1, 2, 4, 8):
        raise ValueError(f"bw must be 1, 2, 4 or 8, got {bw}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    kb = -(-k // (8 // bw))
    if dtype == torch.bfloat16 and bf16_exact(grid_values) and k % 8 == 0 and kb % 16 == 0:
        return "tc"
    return "cuda_core"


def split_k(f: int, k: int, bw: int, n_sm: int) -> int:
    """K slices of the tensor-core route for an [F, K] layer on a card with
    ``n_sm`` SMs: enough CTAs over F's 128-row tiles to stream the codes at
    decode, at most :data:`MAX_SPLIT`, and at least 8 K chunks a slice.
    Never a function of B."""
    f_tiles = -(-f // _FM)
    chunks = -(-k // (128 if bw == 1 else 64))
    return max(1, min(n_sm // f_tiles, MAX_SPLIT, chunks // 8))


def tile_plan(b: int, f: int, k: int, bw: int, n_sm: int) -> tuple[int, int, int]:
    """How the tensor-core kernel covers a [B, F] output: ``(n, s, ctas)``,
    the x rows per CTA (8, 64, 128 or 256: the least that covers B; 128 at
    most when the layer is split, since a CTA then keeps each slice's sum
    beside the running total), the K slices ``s`` (:func:`split_k`, never a
    function of B) and the CTAs per 128-row output tile: ``s`` while the
    tiles alone would leave SMs idle (decode), else 1, each CTA adding its
    slices' sums in order itself.  ``n`` and ``ctas`` may follow B because
    neither changes a row's f32 operations."""
    s = split_k(f, k, bw, n_sm)
    n = 8 if b <= 8 else 64 if b <= 64 else 128 if b <= 128 or s > 1 else 256
    tiles = -(-f // _FM) * -(-b // n)
    return n, s, (s if s > 1 and tiles < n_sm else 1)


def _kernel(which: str):
    if which not in _fns:
        if which == "tc":
            fn = build.load("lut_dequant_gemm_sm90").lut_dequant_gemm_sm90
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        else:
            fn = build.load("lut_dequant_gemm").lut_dequant_gemm
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ]
        fn.restype = ctypes.c_int
        _fns[which] = fn
    return _fns[which]


def _tile_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


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
    The tensor-core route (:func:`route`) also needs x and codes 16-byte
    aligned.
    """
    global launches, launches_tc
    if not (x.is_cuda and codes.device == x.device and scale.device == x.device):
        raise ValueError(
            f"lut_dequant_gemm kernel needs x, codes and scale on one CUDA device; "
            f"got {x.device}, {codes.device}, {scale.device}"
        )
    grid = np.ascontiguousarray(grid_values, dtype=np.float32)
    which = route(x.dtype, bw, grid, k)
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
    if grid.shape != (1 << bw,):
        raise ValueError(f"grid must have {1 << bw} values, got {grid.shape}")
    if which == "tc" and (x.data_ptr() % 16 or codes.data_ptr() % 16):
        raise ValueError("the tensor-core lut_dequant_gemm reads x and codes by TMA: they "
                         "need 16-byte aligned data")
    b = x.shape[0]
    y = torch.empty((b, f), dtype=torch.float32, device=x.device)
    if b == 0 or f == 0:
        return y
    fn = _kernel(which)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if which == "tc":
            dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
            if dev not in _n_sm:
                _n_sm[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
            n, s, ctas = tile_plan(b, f, k, bw, _n_sm[dev])
            ws = cnt = None
            if ctas > 1:
                ws = torch.empty((s, b, f), dtype=torch.float32, device=x.device)
                cnt = _tile_counters(x.device, stream, -(-f // _FM) * -(-b // n))
            err = fn(
                x.data_ptr(), codes.data_ptr(), scale.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(), None if cnt is None else cnt.data_ptr(),
                b, k, f, kb, bw, n, s, ctas, grid.ctypes.data, grid.shape[0], stream,
            )
        else:
            err = fn(
                x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
                scale.data_ptr(), y.data_ptr(), b, k, f, kb, bw,
                grid.ctypes.data, grid.shape[0], stream,
            )
    if err != 0:
        what = (f"cuTensorMapEncodeTiled refused a tensor map (CUresult {err - 10000})"
                if err >= 10000 else "cuTensorMapEncodeTiled not found in libcuda.so.1"
                if err == -1 else f"cudaError {err}")
        raise RuntimeError(f"lut_dequant_gemm kernel ({which}) launch failed: {what} "
                           f"(B={b} K={k} F={f} bw={bw})")
    launches += 1
    launches_tc += which == "tc"
    return y
