"""Compressed cross-rank reductions (port of ``repro.dist.collectives``).

``compressed_psum`` trades reduction fidelity for wire bytes: operands are
quantized to int8 against a *shared* per-tensor scale (the global abs-max
over the group, one extra scalar all-reduce MAX), summed in int32 so the
accumulation cannot saturate, and rescaled.  As in the reference, the
all-reduce here carries the int32 accumulator: this models the *numerics*
of the compressed collective, not its bandwidth.  Worst-case absolute error
is ``n_ranks * scale / 2`` with ``scale = amax / 127``.

The steps equal the reference's bit for bit: the f32 abs-max, ``scale =
amax / 127`` (1 where amax is 0), codes rounded half to even and clipped to
+-127, the int32 sum, the rescale, NaN everywhere when any rank's input is
not finite, and the cast back to the input dtype.  A rank's non-finite
abs-max enters the MAX as ``+inf``: a NaN would survive a MAX only in some
argument orders, and the reference's (XLA's) max propagates it.
"""

from __future__ import annotations

import torch


def compressed_psum(v: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed all-reduce SUM of ``v`` over ``group`` (the default
    group where ``None``); every rank gets the same result."""
    import torch.distributed as dist

    amax = abs_max(v)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    codes, scale = int8_codes(v, amax)
    total = codes.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return rescale(total, scale, amax, v.dtype)


def abs_max(v: torch.Tensor) -> torch.Tensor:
    """This rank's f32 ``max |v|`` (0-dim), ``+inf`` where it is not finite."""
    amax = v.to(torch.float32).abs().max()
    return torch.where(torch.isfinite(amax), amax, torch.inf)


def int8_codes(v: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``v``'s int8 codes against the group's abs-max, and the scale."""
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(v.to(torch.float32) / scale), -127, 127)
    return torch.nan_to_num(q).to(torch.int8), scale


def rescale(total: torch.Tensor, scale: torch.Tensor, amax: torch.Tensor, dtype) -> torch.Tensor:
    """The int32 sum back to ``dtype``; NaN everywhere unless ``amax`` is
    finite — the quiet NaN the reference writes (torch's cast of an f32 NaN
    to bf16 gives the bits 0xFFFF, XLA's 0x7FC0)."""
    out = (total.to(torch.float32) * scale).to(dtype)
    return torch.where(torch.isfinite(amax), out, _quiet_nan(dtype, out.device))


def _quiet_nan(dtype, device) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.tensor(0x7FC0, dtype=torch.int16, device=device).view(torch.bfloat16)
    return torch.tensor(torch.nan, dtype=dtype, device=device)
