"""Framework-facing LoCaLUT API: quantized linear layers (port of
``repro.core.api``).

A :class:`QuantizedLinear` stores a weight matrix as **bit-packed low-bit
codes** plus per-output-channel scales.  This slice of the port runs two of
the reference's four execution paths:

* ``dequant`` — value-LUT decode + a plain matmul in the activation dtype.
* ``pallas``  — the fused packed-code kernel (:mod:`repro_torch.kernels`):
                the hand-written CUDA kernel on the card, its plain version
                on the CPU; same numerics as ``dequant`` with f32
                accumulation.  The name is the reference's mode string, kept
                so specs, plans and checkpoints carry over.

``lut`` and ``stream`` (the int-exact canonical/reordering LUT engines) raise
``NotImplementedError`` until ROADMAP Queue 1 item 3 ports the core engines.

Weight layout: codes are stored transposed ``[F, K]`` and bit-packed along
``K`` (the contraction dim).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import packing, perfmodel
from repro_torch.core.quantize import QuantSpec, grid_tensor, quantize, zero_code

SERVED_MODES = ("dequant", "pallas")


def _unported(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"mode {mode!r} needs the int-exact LUT engines, not ported yet "
        f"(ROADMAP Queue 1 item 3); this slice runs {SERVED_MODES}"
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
    """Quantize a dense ``[K, F]`` weight into a :class:`QuantizedLinear`."""
    k, f = w.shape
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
    """Value-LUT decode back to a dense ``[K, F]`` float32 weight."""
    grid = grid_tensor(q.spec.wspec(), q.codes.device)
    codes = packing.unpack_bits(q.codes, q.spec.bw)[:, : q.k]   # [F, K]
    w_t = grid[codes.long()] * q.scale[:, None]
    return w_t.T


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
    elif mode in ("lut", "stream"):
        raise _unported(mode)
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


def prepare_linear(q: QuantizedLinear, **kw):
    """Freeze ``q``'s weight-side serve products into a
    :class:`repro_torch.core.prepared.PreparedLinear`."""
    from repro_torch.core import prepared as _prepared

    return _prepared.prepare_linear(q, **kw)
