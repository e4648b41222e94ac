"""Mixture-of-Experts block: top-k routing, capacity-based dispatch (port of
``repro.models.moe``).

Dispatch is gather + batched matmul: tokens are written into per-expert
capacity slots, the experts run as one batched GEMM over ``[E, C, d]``, and
their outputs, weighted by the gates, are added back per token.  Overflow
beyond ``capacity_factor`` is dropped (Switch semantics).  The capacity
depends on the call's token count ``T = B * S``, pad tokens and empty decode
slots included, as in the reference: a row's output is not independent of
the rows that share its call unless no slot is dropped.

Every step is deterministic, so a call repeated on the same input gives the
same bits on the card:

* the top-k is a stable descending sort, so of two equal probabilities the
  lower expert id comes first, as ``jax.lax.top_k`` orders them;
* the combine adds a token's expert outputs one slot at a time in a fixed
  order — ascending expert id, the order of the reference's scatter-add over
  the ``[E, C]`` buffer — with no atomics (a CUDA ``index_add_`` would add
  them in whatever order its threads land);
* the buffers are written with a scatter whose only colliding writes go to
  a discarded dump slot.

The expert GEMMs and the dequantization of the expert stacks are plain
torch ops, as they are plain XLA ops in the reference (no Pallas kernel
computes them).  The reference's expert-parallel ``shard_map`` branch is not
ported: a ``ctx`` with a mesh raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import ffn, layers
from repro_torch.models.config import ModelConfig


def moe_init(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Router ``[d, E]`` and expert stacks ``w_gate`` / ``w_up`` ``[E, d, f]``,
    ``w_down`` ``[E, f, d]`` (``N(0, 1) / sqrt(fan_in)``, f32), plus the
    shared experts as one FFN of hidden ``n_shared_experts * f``."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * (1.0 / math.sqrt(fan_in))

    p = {
        "router": {"w": normal((d, e.n_experts), d)},
        "w_gate": normal((e.n_experts, d, f), d),
        "w_up": normal((e.n_experts, d, f), d),
        "w_down": normal((e.n_experts, f, d), f),
    }
    if e.n_shared_experts:
        p["shared"] = ffn.ffn_init(cfg, gen, d_ff=e.n_shared_experts * f, device=device)
    return p


def _route(xt: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """``(gates [T, k] in xt.dtype, expert ids [T, k] int32, aux loss)``: the
    f32 router's softmax, its top-k (ties to the lower id), the gates
    renormalised over the k, and the Switch load-balance loss."""
    e = cfg.moe
    logits = xt.to(torch.float32) @ router_w                  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, : e.top_k], eidx[:, : e.top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    dense_frac = probs.mean(dim=0)
    experts = torch.arange(e.n_experts, device=xt.device)
    hard_frac = (eidx[:, :1] == experts).to(torch.float32).mean(dim=0)
    aux = e.n_experts * torch.sum(dense_frac * hard_frac)
    return gates.to(xt.dtype), eidx.to(torch.int32), aux


def _dispatch_compute(
    xt: torch.Tensor,            # [T, d] tokens
    gates: torch.Tensor,         # [T, k] combine weights (normalised)
    eidx: torch.Tensor,          # [T, k] expert ids
    w_gate: torch.Tensor,        # [E, d, f]
    w_up: torch.Tensor,
    w_down: torch.Tensor,        # [E, f, d]
    *,
    capacity_factor: float,
    act_kind: str,
) -> torch.Tensor:
    """Capacity-slot dispatch over all experts; returns ``[T, d]``."""
    t, k = gates.shape
    n_e, d = w_gate.shape[0], xt.shape[1]
    cap = max(int((t * k / n_e) * capacity_factor), 4)
    dev = xt.device
    slot_e = eidx.reshape(-1).long()                                    # [T*k]
    slot_tok = torch.arange(t * k, device=dev) // k
    # Position of each slot within its expert, in slot order (token-major):
    # a running count along the innermost dim, where the scan is fast.
    hit = (torch.arange(n_e, device=dev)[:, None] == slot_e).to(torch.int32)   # [E, T*k]
    slot_pos = (torch.cumsum(hit, dim=1) - 1).gather(0, slot_e[None])[0]
    keep = slot_pos < cap
    # Flat [E * cap] buffer index of each kept slot; a dropped slot writes to
    # the dump entry E * cap, which is cut off below.
    flat = torch.where(keep, slot_e * cap + slot_pos, n_e * cap)
    buf_tok = torch.full((n_e * cap + 1,), t, dtype=torch.long, device=dev)
    buf_tok.scatter_(0, flat, slot_tok)
    buf_gate = torch.zeros((n_e * cap + 1,), dtype=gates.dtype, device=dev)
    buf_gate.scatter_(0, flat, gates.reshape(-1))
    buf_tok = buf_tok[: n_e * cap].view(n_e, cap)
    buf_gate = buf_gate[: n_e * cap].view(n_e, cap)

    x_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    xg = x_pad[buf_tok]                                                 # [E, cap, d]
    h = layers.activation(torch.bmm(xg, w_gate.to(xg.dtype)), act_kind) \
        * torch.bmm(xg, w_up.to(xg.dtype))
    out_e = torch.bmm(h, w_down.to(xg.dtype)) * buf_gate[..., None].to(xg.dtype)

    # Combine: each token's kept slots, in ascending expert id, added one at
    # a time (no atomics).
    order = torch.argsort(eidx, dim=1, stable=True)                     # [T, k]
    src = torch.where(keep, flat, 0).view(t, k).gather(1, order)
    kept = keep.view(t, k).gather(1, order)
    rows = out_e.reshape(n_e * cap, d)
    y = torch.zeros((t, d), dtype=xt.dtype, device=dev)
    for j in range(k):
        y = torch.where(kept[:, j, None], y + rows[src[:, j]], y)
    return y


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """Returns ``(y [B, S, d] in x.dtype, aux loss)``.  ``ctx`` is ``None`` or a
    context without a mesh: the expert-parallel branch is not ported."""
    if ctx is not None and getattr(ctx, "mesh", None) is not None:
        raise NotImplementedError(
            "expert parallelism (the reference's shard_map over the TP/EP axis) is not "
            "ported: it waits for the distribution item of ROADMAP Queue 1"
        )
    from repro_torch.models.model import maybe_dequant

    e = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, eidx, aux = _route(xt, p["router"]["w"], cfg)
    y = _dispatch_compute(
        xt, gates, eidx,
        maybe_dequant(p["w_gate"], x.dtype), maybe_dequant(p["w_up"], x.dtype),
        maybe_dequant(p["w_down"], x.dtype),
        capacity_factor=e.capacity_factor, act_kind=cfg.ffn_act,
    )
    if "shared" in p:
        y = y + ffn.ffn_apply(p["shared"], x, cfg).reshape(b * s, d)
    return y.reshape(b, s, d), aux
