"""Low-bit symmetric quantization and *value LUTs* (code -> value grids).

Port of ``repro.core.quantize``.  A value grid is a ``2**bits``-entry table
mapping codes to representable values; integer grids serve the paper's WxAy
settings, float grids its format-flexibility argument (§VI-K).  Quantization
is symmetric with a per-channel (or per-tensor) scale:
``x ≈ scale * grid[code]``.

Codes and scales are bit-identical to the reference on the same f32 input:
the scale is ``max(amax, 1e-12) / gmax`` (``quantize``, the weight quantizer,
which the reference runs eagerly) or ``max(amax, 1e-12) * f32(1 / gmax)``
(``quantize_activation``, the activation quantizer, which the reference runs
under ``jax.jit``), values are divided (not multiplied by a reciprocal) by
the scale, and rounding is half-to-even (``torch.round``, like ``jnp.round``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch


def int_grid(bits: int) -> np.ndarray:
    """Signed integer value grid for ``bits``-bit codes.

    * 1 bit: binary {-1, +1}.
    * b >= 2: symmetric range ``-(2^(b-1)-1) .. 2^(b-1)-1`` (code 0
      duplicates -max), which sets the paper's ``b_o``.
    """
    if bits < 1:
        raise ValueError(f"bits must be >= 1, got {bits}")
    if bits == 1:
        return np.array([-1, 1], dtype=np.int32)
    lim = 2 ** (bits - 1) - 1
    return np.clip(np.arange(2**bits) - 2 ** (bits - 1), -lim, lim).astype(np.int32)


def uint_grid(bits: int) -> np.ndarray:
    """Unsigned integer grid 0..2^b-1."""
    return np.arange(2**bits, dtype=np.int32)


def fp_grid(bits: int) -> np.ndarray:
    """A small floating-point-ish grid (log-spaced magnitudes plus zero)."""
    n = 2**bits
    half = n // 2
    mags = np.concatenate([[0.0], np.logspace(-2, 0, half - 1)])
    grid = np.concatenate([-mags[::-1][:-1], mags])
    assert grid.shape[0] in (n, n - 1)
    if grid.shape[0] == n - 1:  # pad with max
        grid = np.concatenate([grid, [mags[-1] * 1.5]])
    return np.sort(grid).astype(np.float32)


def zero_code(grid: np.ndarray) -> int:
    """Code whose value is closest to 0 (used for padding partial groups)."""
    return int(np.argmin(np.abs(np.asarray(grid))))


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How to quantize one tensor."""

    bits: int
    grid_kind: str = "int"  # "int" | "uint" | "fp"
    axis: Optional[int] = None  # scale axis; None = per-tensor

    def grid(self) -> np.ndarray:
        if self.grid_kind == "int":
            return int_grid(self.bits)
        if self.grid_kind == "uint":
            return uint_grid(self.bits)
        if self.grid_kind == "fp":
            return fp_grid(self.bits)
        raise ValueError(f"unknown grid kind {self.grid_kind}")

    @property
    def n_codes(self) -> int:
        return 2**self.bits


def grid_tensor(spec: QuantSpec, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(spec.grid().astype(np.float32), device=device).to(dtype)


@functools.lru_cache(maxsize=None)
def device_grid(bits: int, grid_kind: str, device: torch.device) -> torch.Tensor:
    """The f32 value grid on ``device``, uploaded once per (bits, kind,
    device): a serve step that decodes weights copies nothing from the
    host."""
    return grid_tensor(QuantSpec(bits, grid_kind), device)


# Distance-tensor elements per slice of the argmin quantizer.
_ARGMIN_ELEMS = 1 << 26


def quantize(
    x: torch.Tensor, spec: QuantSpec, *, scale: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` to codes under ``spec``; returns ``(codes, scale)``.

    ``codes`` are int32 in ``[0, 2^bits)``; ``x ≈ scale * grid[codes]`` with
    broadcasting along ``spec.axis``.
    """
    g = spec.grid()
    if scale is None:
        scale = _amax(x, spec) / _gmax(spec)
    scaled = x / scale
    if spec.grid_kind in ("int", "uint") and spec.bits > 1:
        lo, hi = float(g.min()), float(g.max())
        # The clipped symmetric grid duplicates -max at code 0, so anchor on
        # the *last* index holding lo.
        off = int(np.nonzero(g == g.min())[0][-1]) - int(g.min())
        codes = (torch.clamp(torch.round(scaled), lo, hi) + off).to(torch.int32)
    else:
        # Nearest grid value by argmin over the table (first minimum on
        # ties, as jnp.argmin), in slices so the [..., 2^bits] distance
        # tensor stays small at full model width.
        grid = grid_tensor(spec, x.device)
        flat = scaled.reshape(-1)
        step = max(1, _ARGMIN_ELEMS // grid.numel())
        codes = torch.cat([
            torch.argmin((flat[i : i + step, None] - grid).abs(), dim=-1)
            for i in range(0, flat.numel(), step)
        ]).to(torch.int32).reshape(scaled.shape)
    return codes, scale


def quantize_activation(
    x: torch.Tensor, spec: QuantSpec, *, scale: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize` for activations: the dynamic scale is
    ``max(amax, 1e-12) * f32(1 / gmax)``.

    The reference quantizes activations inside jitted programs (the serve
    forward and the calibration forward), where XLA rewrites the division
    by the constant ``gmax`` into a multiplication by its f32 reciprocal,
    which can land one f32 ulp away from the true quotient; in bf16 that
    ulp moves codes.  Weights are quantized eagerly in the reference, with
    a true division (:func:`quantize`).  A frozen ``scale`` is used as it is.
    """
    if scale is None:
        recip = float(np.float32(1.0) / np.float32(_gmax(spec)))
        scale = _amax(x, spec) * recip
    return quantize(x, spec, scale=scale)


def _gmax(spec: QuantSpec) -> float:
    gmax = float(np.max(np.abs(spec.grid())))
    if gmax == 0:
        raise ValueError("degenerate grid")
    return gmax


def _amax(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """``max(|x|, 1e-12)`` per tensor, or per slice along ``spec.axis``."""
    if spec.axis is None:
        amax = x.abs().amax()
    else:
        reduce_axes = tuple(i for i in range(x.ndim) if i != spec.axis % x.ndim)
        amax = x.abs().amax(dim=reduce_axes, keepdim=True)
    return amax.clamp_min(1e-12)
