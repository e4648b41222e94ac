"""Shared primitive layers: norms, RoPE, sinusoidal positions, activations,
linears (port of ``repro.models.layers``).

A "linear" parameter is a dense dict ``{"w": [K,F], ("b": [F])}``, a
:class:`repro_torch.core.QuantizedLinear` or a
:class:`repro_torch.core.PreparedLinear` (or, during one calibration
forward, a :class:`repro_torch.core.calibrate.CalibrationProbe`, and inside
a sharded call a :class:`repro_torch.dist.runtime.ShardedLinear`, a local
shard with its collectives); :func:`linear` dispatches.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import PreparedLinear, QuantizedLinear, apply_linear, dequantize_weights
from repro_torch.core.calibrate import CalibrationProbe, probe_apply
from repro_torch.core.quantize import device_grid
from repro_torch.dist.runtime import ShardedLinear


def dense_init(gen: torch.Generator, k: int, f: int, *, bias: bool = False,
               scale: float | None = None, device=None):
    """``w ~ N(0, 1) * std`` with ``std = 1/sqrt(k)`` (or ``scale``), f32."""
    std = scale if scale is not None else (1.0 / math.sqrt(k))
    p = {"w": torch.randn((k, f), generator=gen, device=device, dtype=torch.float32) * std}
    if bias:
        p["b"] = torch.zeros((f,), dtype=torch.float32, device=device)
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    if isinstance(p, (QuantizedLinear, PreparedLinear)):
        return apply_linear(p, x)
    if isinstance(p, CalibrationProbe):   # one-shot scale-capture forward
        return probe_apply(p, x)
    if isinstance(p, ShardedLinear):      # a local shard inside a sharded call
        return p.apply(x, linear)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def decode_weight(q) -> torch.Tensor:
    """The dense f32 ``[..., K, F]`` weight of a (stacked) ``QuantizedLinear``
    or ``PreparedLinear``, as the reference's ``maybe_dequant`` decodes one:
    a prepared leaf that caches its unpacked codes (``wcodes``, the dequant
    mode) from them, any other through ``dequantize_weights``.  Both give
    ``grid[code] * scale``, one f32 rounding, so a prepared leaf decodes to
    its raw leaf's bits."""
    if isinstance(q, PreparedLinear) and q.wcodes is not None:
        grid = device_grid(q.spec.bw, q.spec.w_kind, q.codes.device)
        return (grid[q.wcodes.long()] * q.scale[..., None]).transpose(-1, -2)
    return dequantize_weights(q)


def rmsnorm_init(d: int, device=None):
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def layernorm_init(d: int, device=None):
    return {"g": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def norm(p, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    """Computes in f32 and casts back to ``x.dtype``."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * p["g"]).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """SiLU, or GELU in its tanh form (``jax.nn.gelu``'s default), computed
    op by op in ``x.dtype`` with the constants rounded to it, as
    ``jax.nn.silu`` and ``jax.nn.gelu`` compute: the fused ``F.silu`` and
    ``F.gelu`` round once at the end and differ from them in the last bf16
    bit on about a third of the elements."""
    if kind == "silu":
        return x * torch.reciprocal(torch.exp(-x) + 1.0)
    if kind == "gelu":
        c_cube = _const(0.044715, x.dtype)
        c_tanh = _const(math.sqrt(2.0 / math.pi), x.dtype)
        cdf = (torch.tanh((x + x * x * x * c_cube) * c_tanh) + 1.0) * 0.5
        return x * cdf
    raise ValueError(kind)


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (exact in the f32 arithmetic that
    torch runs a low-precision op in)."""
    return torch.tensor(value, dtype=dtype).item()


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, *, frac: float = 1.0, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated ``frac`` of the head dim."""
    rot = int(hd * frac) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               kind: str = "full") -> torch.Tensor:
    """Rotate ``x [B, S, H, hd]`` by position.  ``kind='half'`` rotates only
    the first half of the head dim, in interleaved pairs
    (``x[..., 0::2]``, ``x[..., 1::2]``), not rotate-half."""
    if kind == "none":
        return x
    hd = x.shape[-1]
    frac = 0.5 if kind == "half" else 1.0
    inv = rope_freqs(hd, theta, frac=frac, device=x.device)          # [R/2]
    ang = positions[..., None].to(torch.float32) * inv              # [B, S, R/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    r = inv.shape[0] * 2
    xr, xp = x[..., :r], x[..., r:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Sinusoidal absolute positions (rope_kind="none": whisper's encoder and decoder)
# ---------------------------------------------------------------------------


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal absolute embeddings ``[seq, d]`` f32: the
    reference's table, built the same way in numpy float64 and rounded once
    to f32, so the two are equal bit for bit."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings at dynamic positions ``[B, S] -> [B, S, d]`` f32
    (the decoder of a rope-less model, at any decode offset), with the
    angles of the reference as it runs, under ``jit``: XLA turns the
    exponent ``2 * dim / d`` into ``dim * f32(2 / d)`` and takes a correctly
    rounded f32 ``pow`` (here: in f64, rounded once), where torch's true
    quotient and f32 ``pow`` are each an ulp off on a few percent of the
    ``d / 2`` frequencies, which moves a late position's angle by an ulp of
    the angle.  The f32 angles' ``sin`` and ``cos`` are taken in f64 and
    rounded once: within an ulp of XLA's own (ROADMAP Queue 3), and the
    same bits on every call (torch's f32 ``sin`` / ``cos`` on the CPU gave
    other bits on a few first calls in a process)."""
    f64 = torch.float64
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)[None, None, :]
    freq = torch.pow(10000.0, (dim * float(np.float32(2.0 / d))).to(f64)).to(torch.float32)
    ang = (positions[..., None].to(f64) / freq.to(f64)).to(torch.float32).to(f64)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(torch.float32)
