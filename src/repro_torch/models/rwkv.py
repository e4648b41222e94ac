"""RWKV6 "Finch" block: linear attention with data-dependent decay (port of
``repro.models.rwkv``).

Per head (dim P), with receptance r, key k, value v, decay w, bonus u:

    wkv_t = s_{t-1} + diag(u) · (k_t ⊗ v_t)
    out_t = r_t · wkv_t
    s_t   = diag(w_t) · s_{t-1} + k_t ⊗ v_t          s: [P_k, P_v]

``w_t`` is data-dependent: ``w = exp(-exp(w0 + tanh(xw · w_a) · w_b))``.  The
token-shift mixes are RWKV6's ddlerp with a small LoRA.  Decode carries
``(x_prev_t, x_prev_c, s)``: an O(1) state whatever the context length.

Decode is one state update; prefill runs the same update, :func:`_step`,
once per position in a Python loop (the reference scans it; its chunked,
checkpointed scan only changes what a gradient stores).  The recurrence is
plain torch ops, as it is plain XLA in the reference: no Pallas kernel
computes it.  The r/k/v/g/output projections and the channel mix's three
GEMMs are linears and quantize; the LoRA mixes, the decay path and the
recurrence stay dense f32.

The casts sit where the reference puts them: the mixes and projections run
in ``x.dtype``, the decay, the recurrence and the group norm in f32, and the
normed output is cast back to ``x.dtype`` before the gate.  Left pads are
not masked: a padded row's pad tokens go through the token shift and the
recurrence, as in the reference.

With a ``state``, the new recurrent state and both ``x_prev`` rows are
written into its tensors **in place** (the caches of
``transformer.run_segments`` are views into the stacked cache), rounded to
the state's dtype as the reference rounds them, and the same dict comes
back.  ``x_prev_t`` / ``x_prev_c`` hold the last row of each mix's input,
the normed ``h``, not the residual stream.

Under ``seq_shard`` a ``[B, D]`` row with ``D >= 1024`` is cut along ``D`` on
the TP axis (``cache_specs`` takes its dim 2 for a sequence): with ``seq``
(a :class:`repro_torch.dist.runtime.SeqShard`) the mix all-gathers the rank's
slice before the token shift and writes back only its slice.  The state
``s`` (``[B, H, P, P]``, H < 1024) is never cut.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear

_MIX_KEYS = ("r", "k", "v", "w", "g")


def rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def rwkv_time_init(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    d = cfg.d_model
    r = cfg.rwkv
    n_heads, hd = rwkv_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    normal = lambda *shape: torch.randn(shape, generator=gen, **f32)  # noqa: E731
    return {
        "mu": torch.full((len(_MIX_KEYS), d), 0.5, **f32),
        "mix_a": normal(d, r.mix_lora * len(_MIX_KEYS)) * 0.01,
        "mix_b": normal(len(_MIX_KEYS), r.mix_lora, d) * 0.01,
        "wr": dense_init(gen, d, d, device=device),
        "wk": dense_init(gen, d, d, device=device),
        "wv": dense_init(gen, d, d, device=device),
        "wg": dense_init(gen, d, d, device=device),
        "wo": dense_init(gen, d, d, device=device),
        "w0": torch.full((d,), -0.6, **f32),
        "w_a": normal(d, r.decay_lora) * 0.01,
        "w_b": normal(r.decay_lora, d) * 0.01,
        "u": normal(n_heads, hd) * 0.1,
        "ln_g": torch.ones((d,), **f32),
        "ln_b": torch.zeros((d,), **f32),
    }


def rwkv_channel_init(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu_k": torch.full((d,), 0.5, **f32),
        "mu_r": torch.full((d,), 0.5, **f32),
        "wk": dense_init(gen, d, f, device=device),
        "wv": dense_init(gen, f, d, device=device),
        "wr": dense_init(gen, d, d, device=device),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *, lead: tuple = (),
                    device=None) -> dict:
    """Zero state ``s [*lead, B, H, P, P]`` and token-shift rows ``x_prev_t``,
    ``x_prev_c [*lead, B, D]``, all in ``dtype``: the reference rounds its
    state to the cache's dtype after every call, so a bf16 cache holds a
    bf16 state."""
    n_heads, hd = rwkv_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    return {"s": torch.zeros(lead + (batch, n_heads, hd, hd), **kw),
            "x_prev_c": torch.zeros(lead + (batch, cfg.d_model), **kw),
            "x_prev_t": torch.zeros(lead + (batch, cfg.d_model), **kw)}


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor], seq=None) -> torch.Tensor:
    """``[B, S, D]`` -> the previous token's row (zeros, or the carried
    ``x_prev``, at t = 0).  With ``seq`` ``x_prev`` is this rank's slice of
    the row: all-gathered first."""
    if x_prev is not None and seq is not None:
        x_prev = seq.gather(x_prev, -1)
    first = (torch.zeros_like(x[:, :1]) if x_prev is None
             else x_prev[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _keep_last(row: torch.Tensor, x: torch.Tensor, seq) -> None:
    """``row`` (a carried ``x_prev``) set to ``x``'s last row in place — with
    ``seq`` this rank's slice of it."""
    last = x[:, -1]
    row.copy_(last if seq is None else seq.narrow(last, -1, row.shape[-1]))


def _step(s: torch.Tensor, r_t, k_t, v_t, w_t, u: torch.Tensor):
    """One f32 state update: ``s [B,H,P,P]``, ``r_t, k_t, v_t, w_t [B,H,P]``,
    ``u [H,P]`` -> ``(s_new, out_t [B,H,P])``."""
    kv = k_t[..., :, None] * v_t[..., None, :]                         # [B,H,Pk,Pv]
    wkv = s + u[None, :, :, None] * kv
    out_t = torch.matmul(r_t[..., None, :], wkv)[..., 0, :]
    return w_t[..., None] * s + kv, out_t


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[dict] = None, seq=None) -> tuple[torch.Tensor, Optional[dict]]:
    """``x [B, S, D]`` (the normed input) -> ``(y [B, S, D], state)``;
    ``state`` (see :func:`init_rwkv_state`) is updated in place (``s``,
    ``x_prev_t``), or ``None``: a zero start, nothing kept.  ``seq``: the
    shard of a feature-sharded ``x_prev_t``."""
    b, n_pos, d = x.shape
    n_heads, hd = rwkv_dims(cfg)
    n_lora = cfg.rwkv.mix_lora
    xp = _token_shift(x, state["x_prev_t"] if state is not None else None, seq)
    diff = xp - x
    # ddlerp: a per-target mix coefficient with a small LoRA on x
    base = x + diff * 0.5
    lora = torch.tanh(base @ p["mix_a"].to(x.dtype)).reshape(b, n_pos, len(_MIX_KEYS), n_lora)
    xr, xk, xv, xw, xg = (
        x + diff * (p["mu"][i].to(x.dtype) + lora[:, :, i] @ p["mix_b"][i].to(x.dtype))
        for i in range(len(_MIX_KEYS))
    )
    heads = (b, n_pos, n_heads, hd)
    r = linear(p["wr"], xr).reshape(heads).float()
    k = linear(p["wk"], xk).reshape(heads).float()
    v = linear(p["wv"], xv).reshape(heads).float()
    g = layers.activation(linear(p["wg"], xg), "silu")
    w = torch.exp(-torch.exp(p["w0"] + torch.tanh(xw.float() @ p["w_a"]) @ p["w_b"]))
    w = w.reshape(heads)                                                # in (0, 1)
    s = (state["s"].float() if state is not None
         else torch.zeros((b, n_heads, hd, hd), dtype=torch.float32, device=x.device))
    outs = []
    for t in range(n_pos):
        s, out_t = _step(s, r[:, t], k[:, t], v[:, t], w[:, t], p["u"])
        outs.append(out_t)
    out = torch.stack(outs, dim=1)                                      # [B, S, H, P]
    # per-head group norm
    mu = out.mean(dim=-1, keepdim=True)
    var = torch.square(out - mu).mean(dim=-1, keepdim=True)
    out = ((out - mu) * torch.rsqrt(var + 1e-5)).reshape(b, n_pos, d)
    out = out * p["ln_g"] + p["ln_b"]
    y = linear(p["wo"], out.to(x.dtype) * g)
    if state is not None:
        state["s"].copy_(s)
        _keep_last(state["x_prev_t"], x, seq)
    return y, state


def rwkv_channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     state: Optional[dict] = None, seq=None) -> tuple[torch.Tensor, Optional[dict]]:
    """The channel mix: ``sigmoid(wr(xr)) * wv(relu(wk(xk))^2)`` over
    token-shifted mixes; ``state["x_prev_c"]`` is updated in place (``seq``:
    as in :func:`rwkv_time_mix`)."""
    xp = _token_shift(x, state["x_prev_c"] if state is not None else None, seq)
    xk = x + (xp - x) * p["mu_k"].to(x.dtype)
    xr = x + (xp - x) * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(linear(p["wk"], xk)))
    y = torch.sigmoid(linear(p["wr"], xr)) * linear(p["wv"], k)
    if state is not None:
        _keep_last(state["x_prev_c"], x, seq)
    return y, state
