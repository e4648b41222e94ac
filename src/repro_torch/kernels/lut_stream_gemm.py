"""Hopper kernel: canonical-LUT slice-streaming GEMM (the paper's §IV-C).

Replaces the TPU kernel ``src/repro/kernels/lut_stream_gemm.py::
lut_stream_gemm`` (Pallas body ``_stream_kernel_body``): for each K-group
``g`` and activation column ``n`` the canonical-LUT column ``msrank[g, n]``
and the reordering-LUT column ``permid[g, n]`` are composed once into a
shared-memory table, ``composed[r] = canonical[reordering[r, pid], ms]``,
which every weight row then reads at ``wpacked[m, g]``; the sums are int32,
so the result is the integer GEMM bit for bit.

What bounds it on an H100: at decode (N = the serve batch) the ``M*G*4``
bytes of ``wpacked``; at prefill the ``M*G*N`` lookup-adds.  The CUDA source
(``csrc/lut_stream_gemm.cu``) is a simple, right first version: one block per
256 weight rows x NT columns, the weight tile staged in shared memory with
coalesced loads, the composed table in shared memory, int32 register
accumulators, and K-groups split across blocks with int32 atomics when the
(M, N) tiles alone cannot fill the card.  Its times beside the bounds are in
PERF.md.

The wrapper checks device, dtypes, shapes and contiguity, allocates ``out``,
launches on the current stream and raises on a launch error.  It counts its
launches in :data:`launches` (a plain integer, reset by the caller).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0          # incremented once per kernel launch, nowhere else

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("lut_stream_gemm").lut_stream_gemm
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def column_tile(n: int, nt=None) -> int:
    """The kernel's column tile (4, 8 or 16) for ``n`` columns, or the
    smallest one holding a requested ``nt``."""
    want = n if nt is None else nt
    return 4 if want <= 4 else 8 if want <= 8 else 16


def lut_stream_gemm(
    wpacked: torch.Tensor,
    msrank: torch.Tensor,
    permid: torch.Tensor,
    canonical: torch.Tensor,
    reordering: torch.Tensor,
    *,
    nt=None,
) -> torch.Tensor:
    """``out[m, n] = sum_g canonical[reordering[wpacked[m, g], permid[g, n]],
    msrank[g, n]]`` on a CUDA device, int32 ``[M, N]``.

    ``wpacked``: [M, G]; ``msrank``, ``permid``: [G, N]; ``canonical``:
    [R, C]; ``reordering``: [R, P!]; all int32 and contiguous on one device.
    ``nt`` sets the column tile (rounded up to 4, 8 or 16; default from N).
    """
    global launches
    args = (wpacked, msrank, permid, canonical, reordering)
    if not all(a.is_cuda and a.device == wpacked.device for a in args):
        raise ValueError(
            "lut_stream_gemm kernel needs wpacked, msrank, permid, canonical and "
            f"reordering on one CUDA device; got {[str(a.device) for a in args]}"
        )
    if any(a.dtype != torch.int32 for a in args):
        raise TypeError(f"lut_stream_gemm takes int32 operands, got {[a.dtype for a in args]}")
    if any(a.ndim != 2 for a in args):
        raise ValueError(f"lut_stream_gemm takes 2-d operands, got {[tuple(a.shape) for a in args]}")
    m, g = wpacked.shape
    n = msrank.shape[1]
    r, c = canonical.shape
    if msrank.shape != (g, n) or permid.shape != (g, n):
        raise ValueError(f"msrank and permid must be [{g}, N] alike, got "
                         f"{tuple(msrank.shape)}, {tuple(permid.shape)}")
    if reordering.shape[0] != r:
        raise ValueError(f"reordering must have {r} rows like canonical, got {tuple(reordering.shape)}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("lut_stream_gemm kernel needs contiguous operands")
    if max(m * g, g * n, m * n, r * c) >= 2**31:
        raise ValueError(f"lut_stream_gemm operand too large: M={m} G={g} N={n} R={r} C={c}")
    out = torch.empty((m, n), dtype=torch.int32, device=wpacked.device)
    if m == 0 or n == 0:
        return out
    if g == 0:
        return out.zero_()
    fn = _kernel()
    with torch.cuda.device(wpacked.device):
        stream = torch.cuda.current_stream(wpacked.device).cuda_stream
        err = fn(
            wpacked.data_ptr(), msrank.data_ptr(), permid.data_ptr(), canonical.data_ptr(),
            reordering.data_ptr(), out.data_ptr(), m, g, n, r, c, reordering.shape[1],
            column_tile(n, nt), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lut_stream_gemm kernel launch failed: cudaError {err} "
            f"(M={m} G={g} N={n} R={r} C={c}; R above ~2900 does not fit shared memory)"
        )
    launches += 1
    return out
