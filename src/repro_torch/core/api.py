"""Framework-facing LoCaLUT API: quantized linear layers (port of
``repro.core.api``).

A :class:`QuantizedLinear` stores a weight matrix as **bit-packed low-bit
codes** plus per-output-channel scales; four execution paths share it:

* ``dequant`` — value-LUT decode + a plain matmul in the activation dtype.
* ``lut``     — paper-faithful path: activation quantization → LUT
                canonicalization → reordering LUT → canonical-LUT lookups
                (bit-exact integer semantics, :mod:`repro_torch.core.engine`);
                on the card the int32 sum is the hand-written
                ``lut_stream_gemm`` kernel.
* ``stream``  — the §IV-C tiled, deduplicated slice-streaming engine; same
                numerics as ``lut``, plus simulated DRAM→buffer traffic stats
                (:func:`stream_stats_for`).
* ``pallas``  — the fused packed-code kernel (:mod:`repro_torch.kernels`):
                the hand-written CUDA kernel on the card, its plain version
                on the CPU; same numerics as ``dequant`` with f32
                accumulation.  The name is the reference's mode string, kept
                so specs, plans and checkpoints carry over.

Weight layout: codes are stored transposed ``[F, K]`` and bit-packed along
``K`` (the contraction dim).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import engine, luts, packing, perfmodel
from repro_torch.core.quantize import (
    QuantSpec, device_grid, grid_tensor, quantize, quantize_activation, zero_code,
)


@dataclasses.dataclass(frozen=True)
class LutLinearSpec:
    """Static configuration of a LoCaLUT-quantized linear layer."""

    bw: int = 2
    ba: int = 4
    p: Optional[int] = None        # None -> perf-model auto-selection
    mode: str = "dequant"          # "dequant" | "lut" | "stream" | "pallas"
    w_kind: str = "int"
    a_kind: str = "int"
    tile_n: Optional[int] = None   # stream mode: activation columns per tile
    buffer_bytes: Optional[int] = None  # stream mode: auto tile_n from a budget

    def wspec(self) -> QuantSpec:
        return QuantSpec(self.bw, self.w_kind, axis=1)  # per-output-channel

    def aspec(self) -> QuantSpec:
        return QuantSpec(self.ba, self.a_kind, axis=None)


@dataclasses.dataclass
class QuantizedLinear:
    """The packed weight of one linear layer (tensor fields + static ones).

    Stacked model leaves carry leading ``[n_units]`` dims on every tensor
    field, as in the reference's scanned parameter trees."""

    codes: torch.Tensor                # [F, K*bw/8] uint8, bit-packed codes
    scale: torch.Tensor                # [F] fp32 per-output-channel scale
    bias: Optional[torch.Tensor]       # [F] or None
    spec: LutLinearSpec = LutLinearSpec()
    k: int = 0
    ascale: Optional[torch.Tensor] = None   # frozen activation scale (lut/stream)

    @property
    def f(self) -> int:
        return self.codes.shape[-2]

    @property
    def packed_bytes(self) -> int:
        return self.codes.numel()


def quantize_linear(
    w: torch.Tensor, spec: LutLinearSpec, bias: Optional[torch.Tensor] = None
) -> QuantizedLinear:
    """Quantize a dense ``[K, F]`` weight into a :class:`QuantizedLinear`.
    On the ``meta`` device only the leaf's shapes and dtypes are made (a
    restore target, the dry-run's rank state): nothing is computed."""
    k, f = w.shape
    if w.device.type == "meta":
        kp = -(-k // packing.codes_per_byte(spec.bw))
        return QuantizedLinear(
            codes=torch.empty((f, kp), dtype=torch.uint8, device=w.device),
            scale=torch.empty((f,), dtype=w.dtype, device=w.device), bias=bias, spec=spec, k=k)
    codes, scale = quantize(w, spec.wspec())          # codes [K,F], scale [1,F]
    codes_t = codes.T                                  # [F, K]
    pad = (-k) % packing.codes_per_byte(spec.bw)
    if pad:
        # Pad K with the grid's zero-value code (the kernel masks k >= K
        # anyway: a 1-bit grid has no zero value).
        zc = zero_code(spec.wspec().grid())
        codes_t = torch.nn.functional.pad(codes_t, (0, pad), value=zc)
    packed = packing.pack_bits(codes_t, spec.bw)       # [F, ceil(K/cpb)]
    return QuantizedLinear(
        codes=packed, scale=scale.reshape(f), bias=bias, spec=spec, k=k
    )


def dequantize_weights(q: QuantizedLinear) -> torch.Tensor:
    """Value-LUT decode back to a dense ``[..., K, F]`` float32 weight:
    ``grid[code] * scale``, one f32 rounding.  Leading stack dims (scanned
    units, MoE experts) decode together.  Each packed byte is looked up whole
    in a ``[256, codes per byte]`` table of grid values, kept on the codes'
    device, so a call copies nothing from the host."""
    table = _byte_table(q.spec.bw, q.spec.w_kind, q.codes.device)
    w_t = torch.nn.functional.embedding(q.codes.to(torch.int32), table)
    w_t = w_t.reshape(q.codes.shape[:-1] + (-1,))[..., : q.k]           # [..., F, K]
    return (w_t * q.scale[..., None]).transpose(-1, -2)


@functools.lru_cache(maxsize=None)
def _byte_table(bw: int, grid_kind: str, device: torch.device) -> torch.Tensor:
    """``[256, 8 // bw]`` f32: the grid values of the codes one byte packs, in
    :func:`repro_torch.core.packing.unpack_bits`'s order."""
    codes = packing.unpack_bits(torch.arange(256, dtype=torch.int32).to(torch.uint8)[:, None], bw)
    return device_grid(bw, grid_kind, torch.device("cpu"))[codes.long()].to(device)


def apply_linear(q, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ W (+ bias)`` through the path selected by ``q.spec.mode``.

    ``x``: [..., K] activations; returns [..., F] in ``x.dtype``.  Accepts a
    raw :class:`QuantizedLinear` or a
    :class:`repro_torch.core.prepared.PreparedLinear` (bit-identical
    results, no per-call weight work)."""
    from repro_torch.core import prepared as _prepared

    if isinstance(q, _prepared.PreparedLinear):
        return _prepared.apply_prepared(q, x)
    mode = q.spec.mode
    if mode == "dequant":
        y = _dequant_matmul(q, x)
    elif mode == "pallas":
        y = pallas_matmul(q, x)
    elif mode == "lut":
        y = _lut_matmul(q, x)
    elif mode == "stream":
        y, _ = _stream_matmul(q, x)
    else:
        raise ValueError(f"unknown mode {mode}")
    if q.bias is not None:
        y = y + q.bias.to(y.dtype)
    return y


def pallas_matmul(q, x: torch.Tensor) -> torch.Tensor:
    """The packed-code kernel over ``x [..., K]`` (raw and prepared layers
    share it): the kernel accumulates f32; the result is cast back to
    ``x.dtype`` like every other mode, so a bf16 residual stream keeps its
    dtype."""
    from repro_torch.kernels import ops

    return ops.lut_dequant_gemm(
        x.reshape(-1, x.shape[-1]).contiguous(), q.codes, q.scale, bw=q.spec.bw, k=q.k, grid_kind=q.spec.w_kind,
    ).reshape(x.shape[:-1] + (q.f,)).to(x.dtype)


def _dequant_matmul(q: QuantizedLinear, x: torch.Tensor) -> torch.Tensor:
    grid = grid_tensor(q.spec.wspec(), x.device, x.dtype)
    codes = packing.unpack_bits(q.codes, q.spec.bw)[:, : q.k]           # [F, K]
    w_t = grid[codes.long()] * q.scale[:, None].to(x.dtype)              # [F, K]
    return torch.einsum("...k,fk->...f", x, w_t)


def plan_p(f: int, k: int, n: int, spec: LutLinearSpec, device=None) -> int:
    """The packing degree every LUT path agrees on: ``spec.p``, else the
    Eq. 2/4 sweep's ``p*`` for this (M, K, N) — the reference's single
    p-selection heuristic, copied (:func:`repro_torch.core.perfmodel.make_plan`);
    ``device`` is a PIM cost model (default: the paper's UPMEM system)."""
    if spec.p:
        return spec.p
    inp = perfmodel.PlanInputs(m=f, k=k, n=n, bw=spec.bw, ba=spec.ba)
    if device is not None:
        inp = dataclasses.replace(inp, device=device)
    return perfmodel.make_plan(inp).p_star


def quantized_lut_gemm(q, x: torch.Tensor, run) -> torch.Tensor:
    """The activation side every LUT path shares — one body, so the raw and
    prepared implementations cannot drift numerically: quantize activations,
    ``o = run(acodes, n)`` (the engine GEMM, [F, B]), rescale, reshape.

    A calibrated layer (``q.ascale`` set) quantizes against its frozen scale,
    so the result for any one row is independent of which other rows share
    the batch.  The quantizer runs in f32 whatever the activation dtype, as
    in the reference, with the scale the reference's jitted programs compute
    (:func:`repro_torch.core.quantize.quantize_activation`)."""
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)                 # [B, K]
    acodes, ascale = quantize_activation(xf.T, q.spec.aspec(), scale=q.ascale)  # [K, B]
    o = run(acodes, xf.shape[0])
    y = o.to(torch.float32) * q.scale[:, None] * ascale
    return y.T.reshape(x.shape[:-1] + (q.f,)).to(x.dtype)


def _lut_matmul(q: QuantizedLinear, x: torch.Tensor) -> torch.Tensor:
    """Paper-faithful path: canonical + reordering LUT engine (bit-exact)."""
    spec = q.spec

    def run(acodes, n):
        wcodes = packing.unpack_bits(q.codes, spec.bw)[:, : q.k]    # [F, K]
        p = plan_p(q.f, q.k, n, spec)
        pack = _lut_pack_cache(spec.bw, spec.ba, p, spec.w_kind, spec.a_kind)
        return engine.canonical_lut_gemm(wcodes, acodes, pack)      # [F,B] i32

    return quantized_lut_gemm(q, x, run)


def _stream_matmul(q: QuantizedLinear, x: torch.Tensor) -> tuple[torch.Tensor, engine.StreamStats]:
    """§IV-C path: tiled, deduplicated slice streaming (bit-exact vs ``lut``)."""
    spec = q.spec
    stats_box = []

    def run(acodes, n):
        wcodes = packing.unpack_bits(q.codes, spec.bw)[:, : q.k]    # [F, K]
        p = plan_p(q.f, q.k, n, spec)
        pack = _lut_pack_cache(spec.bw, spec.ba, p, spec.w_kind, spec.a_kind)
        o, stats = engine.streamed_lut_gemm(
            wcodes, acodes, pack, tile_n=spec.tile_n, buffer_bytes=spec.buffer_bytes,
        )
        stats_box.append(stats)
        return o

    return quantized_lut_gemm(q, x, run), stats_box[0]


def stream_stats_for(q, x: torch.Tensor, *, plan_only: bool = False) -> engine.StreamStats:
    """Simulated DRAM→buffer traffic of serving ``x`` through ``q`` with the
    slice-streaming dataflow (regardless of ``q.spec.mode``).

    ``plan_only=True`` skips the GEMM: quantize the activations, run the
    stream planner, and derive every stat by counter arithmetic
    (:func:`repro_torch.core.engine.stream_plan_stats`) — same numbers, no
    compute.  Accepts a raw :class:`QuantizedLinear` or a prepared layer.
    """
    from repro_torch.core import prepared as _prepared

    if plan_only:
        spec = q.spec
        xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
        acodes, _ = quantize(xf.T, spec.aspec(), scale=q.ascale)
        if isinstance(q, _prepared.PreparedLinear):
            p = q.p
        else:
            p = plan_p(q.f, q.k, xf.shape[0], spec)
        pack = _lut_pack_cache(spec.bw, spec.ba, p, spec.w_kind, spec.a_kind)
        return engine.stream_plan_stats(
            q.f, acodes, pack, tile_n=spec.tile_n, buffer_bytes=spec.buffer_bytes,
        )
    if isinstance(q, _prepared.PreparedLinear):
        _, stats = _prepared.stream_matmul(q, x)
        return stats
    _, stats = _stream_matmul(q, x)
    return stats


def prepare_linear(q: QuantizedLinear, **kw):
    """Freeze ``q``'s weight-side serve products into a
    :class:`repro_torch.core.prepared.PreparedLinear`."""
    from repro_torch.core import prepared as _prepared

    return _prepared.prepare_linear(q, **kw)


@functools.lru_cache(maxsize=64)
def _lut_pack_cache(bw: int, ba: int, p: int, w_kind: str, a_kind: str) -> luts.LutPack:
    return luts.build_lut_pack(bw, ba, p, w_kind=w_kind, a_kind=a_kind)
