"""Mamba2-style SSD block, zamba2's sequence mixer (port of
``repro.models.ssm``).

State-space recurrence with a scalar decay per head:

    s_t = exp(A · dt_t) · s_{t-1} + dt_t · (x_t ⊗ B_t)      s: [P, N]
    y_t = s_t · C_t + D · x_t

Decode is one state update; prefill runs the same update, :func:`_step`,
once per position in a Python loop (the reference scans it; its chunked,
checkpointed scan only changes what a gradient stores).  The recurrence is
plain torch ops, as it is plain XLA in the reference: no Pallas kernel
computes it.  The in/out projections are linears and quantize.

The casts sit where the reference puts them: the projections, the causal
conv and the ``silu(z)`` gate run in ``x.dtype`` (in bf16: bf16 products and
sums, op by op), the step size, the decay and the recurrence in f32.  Left
pads are not masked: a padded row's pad tokens go through the conv and the
recurrence, as in the reference.

With a ``state``, the new SSD state and conv history are written into its
tensors **in place** (the caches of ``transformer.run_segments`` are views
into the stacked cache) and the same dict comes back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear


def ssm_dims(cfg: ModelConfig) -> tuple[int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


def _conv_dim(cfg: ModelConfig) -> int:
    return ssm_dims(cfg)[0] + 2 * cfg.ssm.n_groups * cfg.ssm.d_state


def ssm_init(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    s = cfg.ssm
    d_inner, n_heads = ssm_dims(cfg)
    conv_dim = _conv_dim(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused projection: [z, x, B, C, dt]
        "in_proj": dense_init(gen, cfg.d_model, 2 * d_inner + 2 * s.n_groups * s.d_state
                              + n_heads, device=device),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, device=device),
        "conv_w": torch.randn((s.conv_width, conv_dim), generator=gen, **f32)
        * (1.0 / math.sqrt(s.conv_width)),
        "conv_b": torch.zeros((conv_dim,), **f32),
        "a_log": torch.zeros((n_heads,), **f32),       # A = -exp(a_log)
        "dt_bias": torch.zeros((n_heads,), **f32),
        "d_skip": torch.ones((n_heads,), **f32),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, *, lead: tuple = (), device=None) -> dict:
    """Zero SSD state ``[*lead, B, H, P, N]`` and conv history ``[*lead, B,
    width - 1, conv_dim]``, both f32 whatever the cache dtype: the
    reference's ``ssm_apply`` returns its state in f32 and its history in
    ``x.dtype``, so after the first update its buffers hold values that an
    f32 buffer, written in place, holds exactly."""
    s = cfg.ssm
    _, n_heads = ssm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"ssd": torch.zeros(lead + (batch, n_heads, s.head_dim, s.d_state), **f32),
            "conv": torch.zeros(lead + (batch, s.conv_width - 1, _conv_dim(cfg)), **f32)}


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, _ = ssm_dims(cfg)
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    return (proj[..., :d_inner], proj[..., d_inner : 2 * d_inner + 2 * gn],
            proj[..., 2 * d_inner + 2 * gn :])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor]):
    """Depthwise causal conv over ``[B, S, C]`` in ``xbc.dtype``, the taps
    summed in order; ``history`` is the trailing ``width - 1`` inputs.
    Returns ``(silu(conv + b), the new history)``."""
    width = w.shape[0]
    if history is None:
        pad = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = history.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i : i + s] * w[i]
    return layers.activation(out + b, "silu"), xp[:, -(width - 1) :]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    (``torch.nn.functional.softplus`` returns ``x`` itself above 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _step(carry: torch.Tensor, dec_t, dt_t, x_t, b_t, c_t):
    """One f32 state update: ``[B,H]``, ``[B,H]``, ``[B,H,P]``, ``[B,H,N]``,
    ``[B,H,N]`` -> ``(s_new [B,H,P,N], y_t [B,H,P])``."""
    upd = (dt_t[..., None] * x_t)[..., None] * b_t[:, :, None, :]
    s_new = dec_t[..., None, None] * carry + upd
    return s_new, torch.matmul(s_new, c_t[..., None])[..., 0]


def ssm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              state: Optional[dict] = None) -> tuple[torch.Tensor, Optional[dict]]:
    """``x [B, S, D]`` -> ``(y [B, S, D], state)``; ``state`` (``{"ssd",
    "conv"}``, see :func:`init_ssm_state`) is the carried state, updated in
    place, or ``None``: a zero start, nothing kept."""
    s = cfg.ssm
    d_inner, n_heads = ssm_dims(cfg)
    b, seq, _ = x.shape
    z, xbc, dt = _split_proj(cfg, linear(p["in_proj"], x))
    hist = state["conv"] if state is not None else None
    xbc, new_hist = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype), hist)
    gn = s.n_groups * s.d_state
    rep = n_heads // s.n_groups
    xs = xbc[..., :d_inner].reshape(b, seq, n_heads, s.head_dim).float()
    bmat = xbc[..., d_inner : d_inner + gn].reshape(b, seq, s.n_groups, s.d_state)
    cmat = xbc[..., d_inner + gn :].reshape(b, seq, s.n_groups, s.d_state)
    bf = bmat.repeat_interleave(rep, dim=2).float()                  # [B, S, H, N]
    cf = cmat.repeat_interleave(rep, dim=2).float()
    dt = softplus(dt.float() + p["dt_bias"])                           # [B, S, H]
    decay = torch.exp(dt * -torch.exp(p["a_log"]))
    carry = (state["ssd"].float() if state is not None
             else torch.zeros((b, n_heads, s.head_dim, s.d_state), dtype=torch.float32,
                              device=x.device))
    ys = []
    for t in range(seq):
        carry, y_t = _step(carry, decay[:, t], dt[:, t], xs[:, t], bf[:, t], cf[:, t])
        ys.append(y_t)
    y = torch.stack(ys, dim=1) + p["d_skip"][:, None] * xs            # [B, S, H, P]
    y = y.reshape(b, seq, d_inner).to(x.dtype) * layers.activation(z, "silu")
    out = linear(p["out_proj"], y)
    if state is not None:
        state["ssd"].copy_(carry)
        state["conv"].copy_(new_hist)
    return out, state
