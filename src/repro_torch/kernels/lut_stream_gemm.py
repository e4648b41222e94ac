"""Hopper kernels: canonical-LUT slice-streaming GEMM (the paper's §IV-C) and
the canonicalization in front of it.

Replaces the TPU kernel ``src/repro/kernels/lut_stream_gemm.py::
lut_stream_gemm`` (Pallas body ``_stream_kernel_body``): for each K-group
``g`` and activation column ``n`` the canonical-LUT column ``msrank[g, n]``
and the reordering-LUT column ``permid[g, n]`` are composed once,
``composed[r] = canonical[reordering[r, pid], ms]``, and every weight row
reads ``composed[wpacked[m, g]]``; the sums are int32, so the result is the
integer GEMM bit for bit.

What bounds it on an H100: at decode (N = the serve batch) the ``M*G*4``
bytes of ``wpacked``; at prefill the ``M*G*N`` lookups.  Four CUDA sources,
and a route fixed by the pack alone (:func:`route`), never by N:

* ``"tc"`` -- integer packs whose canonical entries fit s8 (``b_o == 1``)
  and whose weight index has ``R = 2^(bw p) <= 32`` values (the serve pack
  W1A3 p=4, R = 16): the one-hot product ``onehot(wpacked)[M, G*R] .
  B[G*R, N]`` on the int8 tensor cores, ``csrc/lut_stream_gemm_sm90.cu``
  (``wgmma`` u8 x s8 -> s32; the one-hot A decoded in registers from
  ``wpacked``; B, the composed slices, K-major by TMA).  B comes from
  ``csrc/lut_canon.cu`` (:func:`canonicalize` composes it beside the
  canonicalization; :func:`compose` builds it from given indices), so the
  operations are 2*M*G*R*N at the 1979 TOP/s int8 peak, R x the lookups.
* ``"lookup"`` -- integer packs with ``b_o == 1`` and ``32 < R <= 256``
  (the p = 6-8 layers of a capacity plan at W1A3), where the one-hot
  operand, ``G*R`` columns wide, would cost more than the lookups it
  replaces: ``csrc/lut_stream_lookup_sm90.cu`` streams the composed slices
  through shared memory (a ring of stages fed by 1-D bulk copies and TMA;
  1024 weight rows per CTA, each lookup one shared load of NT bytes added as
  16-bit lanes).  Its operand, the slices tiled ``[ceil(N/NT), G, R, NT]``
  u8 with entries + 128 (:func:`lookup_tile`), comes from ``lut_canon.cu``
  too, composed from the pack's transposed byte tables
  (``engine.device_byte_tables``): :func:`canonicalize` with
  ``byte_tables``, or :func:`compose_lookup`.
* ``"cuda_core"`` -- every other pack (R > 256, ``b_o > 1``, the kernel's
  ``int32`` accumulation of ``int16`` entries, float grids) and a call
  without ``pack``: ``csrc/lut_stream_gemm.cu``, the first port's kernel on
  the CUDA cores (one block per 256 weight rows x NT columns, the composed
  table in shared memory, K-groups split with int32 atomics at decode),
  unchanged.

``csrc/lut_canon.cu`` replaces the torch chain of the canonicalization
(stable argsort, gather, rank, Lehmer id: XLA in the reference,
``src/repro/core/multiset.py:139-170``) with one launch: a sorting network
per group in registers.

The wrappers check device, dtypes, shapes and contiguity, allocate the
outputs, launch on the current stream and raise on a launch error; they never
switch route.  Launches are counted in plain integers, reset by the caller:
:data:`launches` (one per ``lut_stream_gemm`` product, any route),
:data:`launches_tc` (those on the tensor cores), :data:`launches_lookup`
(those on the lookup route) and :data:`launches_canon` (the canonicalize /
compose kernel).  Times beside the bounds are in PERF.md.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import hw
from repro_torch.kernels import build

launches = 0          # incremented once per GEMM launch (any route), nowhere else
launches_tc = 0       # incremented once per launch of the tensor-core route, nowhere else
launches_lookup = 0   # incremented once per launch of the lookup route, nowhere else
launches_canon = 0    # incremented once per canonicalize / compose launch, nowhere else

MAX_R_TC = 32         # one-hot columns per group on the tensor cores, at most
MAX_R_LOOKUP = 256    # weight-index values of the lookup route, at most (u8 reordering)
MAX_SPLIT = 8         # K slices of the tensor-core route, at most
MAX_P = 12            # the canonicalize kernel's largest group size
_KC = 128             # one-hot columns per stage of the tensor-core kernel (256 at n_tile 8)
_FM = 128             # weight rows per CTA of the tensor-core kernel
_TM_LOOKUP = 1024     # weight rows per CTA of the lookup kernel
_GC_LOOKUP = 8        # K-groups per stage of the lookup kernel
LOOKUP_FLUSH = 256    # groups between the lookup kernel's flushes of its 16-bit lanes
                      # (a lane holds 65535 = 255 x 257 biased entries at most)

_fns: dict = {}
_counters: dict = {}  # (device index, stream) -> int32 counters, zero between launches
_n_sm: dict = {}


def route(pack) -> str:
    """The kernel a pack's GEMM runs on: for integer canonical entries that
    fit s8, ``"tc"`` (``lut_stream_gemm_sm90.cu``) at ``R <= 32``
    weight-index values and ``"lookup"`` (``lut_stream_lookup_sm90.cu``) at
    ``32 < R <= 256``; else ``"cuda_core"`` (``lut_stream_gemm.cu``)."""
    if pack.canonical.dtype.kind == "i" and pack.bo == 1:
        if pack.n_rows <= MAX_R_TC:
            return "tc"
        if pack.n_rows <= MAX_R_LOOKUP:
            return "lookup"
    return "cuda_core"


def column_tile(n: int, nt=None) -> int:
    """The CUDA-core kernel's column tile (4, 8 or 16) for ``n`` columns, or the
    smallest one holding a requested ``nt``."""
    want = n if nt is None else nt
    return 4 if want <= 4 else 8 if want <= 8 else 16


def lookup_tile(n: int) -> int:
    """The lookup route's column tile NT for ``n`` columns: 4 at N <= 4, 8 at
    N <= 8, else 16 (the slices are composed ``[ceil(N/NT), G, R, NT]``)."""
    return 4 if n <= 4 else 8 if n <= 8 else 16


def lookup_split(m: int, g: int, n: int, n_sm: int) -> int:
    """The K slices ``s`` of the lookup kernel, one CTA each (summed in int32
    atomics): while the ``ceil(M/1024) x ceil(N/NT)`` output tiles leave SMs
    idle, as many as fill them (keeping 2 stages of 8 groups a slice); above
    that up to 4, where fewer waves of CTAs per unit of work save a quarter
    or more.  Integer sums are exact in any order, so ``s`` may follow N."""
    tiles = -(-m // _TM_LOOKUP) * -(-n // lookup_tile(n))
    chunks = -(-g // _GC_LOOKUP)
    if tiles < n_sm:
        s = max(1, min(n_sm // tiles, chunks // 2))
    else:
        def cost(s):
            return -(-tiles * s // n_sm) / s

        s = min(range(1, max(1, min(4, chunks // 2)) + 1), key=lambda s: (cost(s), s))
        if cost(s) > 0.75 * cost(1):
            s = 1
    per = -(-chunks // s)
    return -(-chunks // per)


def composed_pitch(g: int, r: int) -> int:
    """Bytes per row of the composed operand B ``[N, G*R]``: G*R rounded up to
    16 (TMA's row-pitch unit)."""
    return -(-(g * r) // 16) * 16


def tc_split(m: int, g: int, r: int, n: int, n_sm: int) -> tuple[int, int]:
    """How the tensor-core kernel covers an [M, N] output: ``(n_tile, s)``, the
    B columns per CTA (8, 64, 128 or 256: the least that covers N, 256 at
    most) and the K slices ``s``, one CTA each (at most :data:`MAX_SPLIT`, at
    least 4 stages a slice).  At decode (n_tile 8: the bytes bound) the
    slices fill the SMs the output tiles leave idle; above it (the
    operations bound) ``s`` minimises the waves of CTAs times each one's
    share of a tile's int8 work, plus the partial sums' traffic, at the
    card's peaks.  Integer sums are exact in any order, so both may follow N."""
    n_tile = 8 if n <= 8 else 64 if n <= 64 else 128 if n <= 128 else 256
    tiles = -(-m // _FM) * -(-n // n_tile)
    chunks = -(-(g * r) // (2 * _KC if n_tile == 8 else _KC))
    most = max(1, min(MAX_SPLIT, chunks // 4))
    if n_tile == 8:
        return n_tile, 1 if tiles >= n_sm else max(1, min(n_sm // tiles, most))
    card = hw.H100_SXM
    work = 2.0 * _FM * n_tile * g * r / (card.peak_ops_int8 / n_sm)

    def cost(s):
        waves = -(-tiles * s // n_sm)
        return waves / s * work + (8.0 * s * m * n / card.hbm_bandwidth if s > 1 else 0.0)

    return n_tile, min(range(1, most + 1), key=lambda s: (cost(s), s))


def _kernel(which: str):
    if which not in _fns:
        if which == "tc":
            fn = build.load("lut_stream_gemm_sm90").lut_stream_gemm_sm90
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        elif which == "lookup":
            fn = build.load("lut_stream_lookup_sm90").lut_stream_lookup_sm90
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        elif which == "canon":
            fn = build.load("lut_canon").lut_canon
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + \
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        else:
            fn = build.load("lut_stream_gemm").lut_stream_gemm
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[which] = fn
    return _fns[which]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sm_count(device: torch.device) -> int:
    dev = device.index if device.index is not None else torch.cuda.current_device()
    if dev not in _n_sm:
        _n_sm[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _n_sm[dev]


def _tile_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _check_cuda(what: str, args) -> None:
    dev = args[0].device
    if not all(a.is_cuda and a.device == dev for a in args):
        raise ValueError(f"{what} kernel needs its operands on one CUDA device; got "
                         f"{[str(a.device) for a in args]}")


def _raise(err: int, what: str, shape: str) -> None:
    if err != 0:
        why = (f"cuTensorMapEncodeTiled refused a tensor map (CUresult {err - 10000})"
               if err >= 10000 else "cuTensorMapEncodeTiled not found in libcuda.so.1"
               if err == -1 else f"cudaError {err}")
        raise RuntimeError(f"{what} kernel launch failed: {why} ({shape})")


def _check_tables(canonical: torch.Tensor, reordering: torch.Tensor) -> tuple[int, int, int]:
    if canonical.dtype != torch.int32 or reordering.dtype != torch.int32:
        raise TypeError(f"canonical and reordering must be int32, got {canonical.dtype}, "
                        f"{reordering.dtype}")
    if canonical.ndim != 2 or reordering.ndim != 2 or reordering.shape[0] != canonical.shape[0]:
        raise ValueError(f"canonical [R, C] and reordering [R, P!] must share R, got "
                         f"{tuple(canonical.shape)}, {tuple(reordering.shape)}")
    if not (canonical.is_contiguous() and reordering.is_contiguous()):
        raise ValueError("the LUT kernels need contiguous canonical and reordering tables")
    return canonical.shape[0], canonical.shape[1], reordering.shape[1]


def _check_byte_tables(canon_t: torch.Tensor, reord_t: torch.Tensor) -> tuple[int, int, int]:
    if canon_t.dtype != torch.int8 or reord_t.dtype != torch.uint8:
        raise TypeError(f"the lookup route's tables are int8 canonical [C, R] and uint8 "
                        f"reordering [P!, R], got {canon_t.dtype}, {reord_t.dtype}")
    if canon_t.ndim != 2 or reord_t.ndim != 2 or reord_t.shape[1] != canon_t.shape[1]:
        raise ValueError(f"canonical [C, R] and reordering [P!, R] must share R, got "
                         f"{tuple(canon_t.shape)}, {tuple(reord_t.shape)}")
    if not (canon_t.is_contiguous() and reord_t.is_contiguous()):
        raise ValueError("the lookup route needs contiguous transposed tables")
    return canon_t.shape[1], canon_t.shape[0], reord_t.shape[0]


def _lookup_slices(g: int, r: int, n: int, device) -> torch.Tensor:
    nt = lookup_tile(n)
    return torch.empty((-(-n // nt), g, r, nt), dtype=torch.uint8, device=device)


def canonicalize(
    acodes: torch.Tensor,
    binom: torch.Tensor,
    *,
    p: int,
    pad_code: int,
    tables: tuple[torch.Tensor, torch.Tensor] | None = None,
    byte_tables: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The canonicalize kernel on a CUDA device: activation codes ``[K, N]``
    int32 (any strides) -> int32 ``msrank``, ``permid`` ``[G, N]``
    (G = ceil(K/p), a partial last group padded with ``pad_code``) and the
    operand of the pack's GEMM route, if its tables are given: with
    ``tables`` (the pack's int32 canonical ``[R, C]`` and reordering ``[R,
    P!]``, entries within s8) the tensor-core route's ``B`` ``[N,
    composed_pitch(G, R)]`` int8 (columns past G*R unwritten); with
    ``byte_tables`` (their transposed byte copies, int8 ``[C, R]`` and uint8
    ``[P!, R]``, ``engine.device_byte_tables``) the lookup route's slices
    ``[ceil(N/NT), G, R, NT]`` uint8, entries + 128 (NT =
    :func:`lookup_tile`).  ``binom``: the pack's binomial table ``[v + p,
    p + 1]`` int32."""
    global launches_canon
    _check_cuda("lut_stream_gemm canonicalize",
                (acodes, binom) + tuple(tables or ()) + tuple(byte_tables or ()))
    if acodes.dtype != torch.int32 or binom.dtype != torch.int32:
        raise TypeError(f"codes and binom must be int32, got {acodes.dtype}, {binom.dtype}")
    if acodes.ndim != 2 or not 1 <= p <= MAX_P or binom.shape[1] != p + 1 or \
            not binom.is_contiguous():
        raise ValueError(f"codes must be [K, N], 1 <= p <= {MAX_P} and binom contiguous "
                         f"[v + p, p + 1]; got {tuple(acodes.shape)}, p={p}, "
                         f"{tuple(binom.shape)}")
    if tables is not None and byte_tables is not None:
        raise ValueError("give tables (the tensor-core route) or byte_tables (the lookup "
                         "route), not both")
    k, n = acodes.shape
    g = -(-k // p)
    dev = acodes.device
    ms = torch.empty((g, n), dtype=torch.int32, device=dev)
    pid = torch.empty((g, n), dtype=torch.int32, device=dev)
    b = canon = reorder = None
    r = c = pf = ldb = 0
    mode = 0
    if tables is not None:
        canon, reorder = tables
        r, c, pf = _check_tables(canon, reorder)
        ldb = composed_pitch(g, r)
        b = torch.empty((n, ldb), dtype=torch.int8, device=dev)
        mode = 1
    elif byte_tables is not None:
        canon, reorder = byte_tables
        r, c, pf = _check_byte_tables(canon, reorder)
        b = _lookup_slices(g, r, n, dev)
        mode = 3
    if k == 0 or n == 0:
        return ms, pid, b
    fn = _kernel("canon")
    with torch.cuda.device(dev):
        err = fn(acodes.data_ptr(), acodes.stride(0), acodes.stride(1), binom.data_ptr(),
                 ms.data_ptr(), pid.data_ptr(),
                 None if canon is None else canon.data_ptr(),
                 None if reorder is None else reorder.data_ptr(),
                 None if b is None else b.data_ptr(), ldb, k, n, g, p, r, c, pf, pad_code,
                 mode, lookup_tile(n), _stream(acodes))
    _raise(err, "lut_stream_gemm canonicalize", f"K={k} N={n} p={p} R={r}")
    launches_canon += 1
    return ms, pid, b


def _check_indices(msrank: torch.Tensor, permid: torch.Tensor) -> tuple[int, int]:
    if msrank.dtype != torch.int32 or permid.dtype != torch.int32 or msrank.ndim != 2 or \
            permid.shape != msrank.shape or not (msrank.is_contiguous() and permid.is_contiguous()):
        raise ValueError(f"msrank and permid must be contiguous int32 [G, N] alike, got "
                         f"{msrank.dtype} {tuple(msrank.shape)}, {permid.dtype} "
                         f"{tuple(permid.shape)}")
    return msrank.shape


def compose(
    msrank: torch.Tensor,
    permid: torch.Tensor,
    canonical: torch.Tensor,
    reordering: torch.Tensor,
    *,
    p: int,
) -> torch.Tensor:
    """The same kernel from given indices: ``B[n, g*R + r] = canonical[
    reordering[r, permid[g, n]], msrank[g, n]]`` as int8 ``[N,
    composed_pitch(G, R)]`` (columns past G*R unwritten)."""
    global launches_canon
    _check_cuda("lut_stream_gemm compose", (msrank, permid, canonical, reordering))
    r, c, pf = _check_tables(canonical, reordering)
    g, n = _check_indices(msrank, permid)
    ldb = composed_pitch(g, r)
    b = torch.empty((n, ldb), dtype=torch.int8, device=msrank.device)
    if g == 0 or n == 0:
        return b
    fn = _kernel("canon")
    with torch.cuda.device(msrank.device):
        err = fn(None, 0, 0, None, msrank.data_ptr(), permid.data_ptr(), canonical.data_ptr(),
                 reordering.data_ptr(), b.data_ptr(), ldb, 0, n, g, p, r, c, pf, 0, 2,
                 lookup_tile(n), _stream(msrank))
    _raise(err, "lut_stream_gemm compose", f"G={g} N={n} R={r}")
    launches_canon += 1
    return b


def compose_lookup(
    msrank: torch.Tensor,
    permid: torch.Tensor,
    canon_t: torch.Tensor,
    reord_t: torch.Tensor,
    *,
    p: int,
) -> torch.Tensor:
    """The same kernel's lookup layout from given indices: ``S[n // NT, g,
    r, n % NT] = canon_t[msrank[g, n], reord_t[permid[g, n], r]] + 128`` as
    uint8 ``[ceil(N/NT), G, R, NT]`` (NT = :func:`lookup_tile`; columns past
    N hold 128); ``canon_t`` int8 ``[C, R]`` and ``reord_t`` uint8 ``[P!,
    R]``, the pack's tables transposed."""
    global launches_canon
    _check_cuda("lut_stream_gemm compose", (msrank, permid, canon_t, reord_t))
    r, c, pf = _check_byte_tables(canon_t, reord_t)
    g, n = _check_indices(msrank, permid)
    b = _lookup_slices(g, r, n, msrank.device)
    if g == 0 or n == 0:
        return b
    fn = _kernel("canon")
    with torch.cuda.device(msrank.device):
        err = fn(None, 0, 0, None, msrank.data_ptr(), permid.data_ptr(), canon_t.data_ptr(),
                 reord_t.data_ptr(), b.data_ptr(), 0, 0, n, g, p, r, c, pf, 0, 4,
                 lookup_tile(n), _stream(msrank))
    _raise(err, "lut_stream_gemm compose (lookup)", f"G={g} N={n} R={r}")
    launches_canon += 1
    return b


def lut_stream_gemm(
    wpacked: torch.Tensor,
    msrank: torch.Tensor,
    permid: torch.Tensor,
    canonical: torch.Tensor,
    reordering: torch.Tensor,
    *,
    nt=None,
    pack=None,
    composed: torch.Tensor | None = None,
) -> torch.Tensor:
    """``out[m, n] = sum_g canonical[reordering[wpacked[m, g], permid[g, n]],
    msrank[g, n]]`` on a CUDA device, int32 ``[M, N]``.

    ``wpacked``: [M, G]; ``msrank``, ``permid``: [G, N]; ``canonical``:
    [R, C]; ``reordering``: [R, P!]; all int32 and contiguous on one device.
    ``pack`` (the :class:`~repro_torch.core.luts.LutPack` the tables come
    from) picks the route (:func:`route`); without it the bound of the
    canonical entries is unknown and the call takes the CUDA cores.  On the
    tensor-core and lookup routes ``composed`` (their operand from
    :func:`canonicalize`) is used as it is, else :func:`compose` /
    :func:`compose_lookup` builds it first; ``nt`` is ignored there.  On the
    CUDA cores ``nt`` sets the column tile (rounded up to 4, 8 or 16; default
    from N).  Every route and every ``nt`` give the same bits.
    """
    global launches, launches_tc, launches_lookup
    args = (wpacked, msrank, permid, canonical, reordering)
    _check_cuda("lut_stream_gemm", args)
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
    which = "cuda_core" if pack is None else route(pack)
    if pack is not None and (pack.n_rows, pack.n_canonical_cols) != (r, c):
        raise ValueError(f"the tables [{r}, {c}] are not the pack's "
                         f"[{pack.n_rows}, {pack.n_canonical_cols}]")
    dev = wpacked.device
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return out
    if g == 0:
        return out.zero_()
    if which == "tc":
        if composed is None:
            composed = compose(msrank, permid, canonical, reordering, p=pack.p)
        ldb = composed_pitch(g, r)
        if composed.dtype != torch.int8 or tuple(composed.shape) != (n, ldb) or \
                not composed.is_contiguous() or composed.device != dev:
            raise ValueError(f"composed must be contiguous int8 [{n}, {ldb}] on "
                             f"{dev}, got {composed.dtype} "
                             f"{tuple(composed.shape)} on {composed.device}")
        n_tile, s = tc_split(m, g, r, n, _sm_count(dev))
        fn = _kernel("tc")
        with torch.cuda.device(dev):
            stream = _stream(wpacked)
            ws = cnt = None
            if s > 1:
                ws = torch.empty((s, m, n), dtype=torch.int32, device=dev)
                cnt = _tile_counters(dev, stream, -(-m // _FM) * -(-n // n_tile))
            err = fn(wpacked.data_ptr(), composed.data_ptr(), out.data_ptr(),
                     None if ws is None else ws.data_ptr(),
                     None if cnt is None else cnt.data_ptr(), m, g, n, r, ldb, n_tile, s, stream)
        _raise(err, "lut_stream_gemm (tc)", f"M={m} G={g} N={n} R={r}")
    elif which == "lookup":
        if composed is None:
            from repro_torch.core import engine

            composed = compose_lookup(msrank, permid, *engine.device_byte_tables(pack, dev),
                                      p=pack.p)
        nt_l = lookup_tile(n)
        want = (-(-n // nt_l), g, r, nt_l)
        if composed.dtype != torch.uint8 or tuple(composed.shape) != want or \
                not composed.is_contiguous() or composed.device != dev:
            raise ValueError(f"composed must be contiguous uint8 {list(want)} on {dev}, got "
                             f"{composed.dtype} {tuple(composed.shape)} on {composed.device}")
        s = lookup_split(m, g, n, _sm_count(dev))
        fn = _kernel("lookup")
        with torch.cuda.device(dev):
            err = fn(wpacked.data_ptr(), composed.data_ptr(), out.data_ptr(), m, g, n, r, nt_l,
                     s, _stream(wpacked))
        _raise(err, "lut_stream_gemm (lookup)", f"M={m} G={g} N={n} R={r} S={s}")
    else:
        fn = _kernel("cuda_core")
        with torch.cuda.device(dev):
            err = fn(
                wpacked.data_ptr(), msrank.data_ptr(), permid.data_ptr(), canonical.data_ptr(),
                reordering.data_ptr(), out.data_ptr(), m, g, n, r, c, reordering.shape[1],
                column_tile(n, nt), _stream(wpacked),
            )
        _raise(err, "lut_stream_gemm (cuda_core)",
               f"M={m} G={g} N={n} R={r} C={c}; R above ~2900 does not fit shared memory")
    launches += 1
    launches_tc += which == "tc"
    launches_lookup += which == "lookup"
    return out
