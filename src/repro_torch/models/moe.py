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
computes them).

Under a ``ctx`` with a mesh (a sharded call, :mod:`repro_torch.dist.runtime`;
the tokens are the rank's dp rows, replicated over the TP axis):

* **expert parallelism** (``E % tp == 0``, ``tp > 1``), the reference's
  ``shard_map`` branch: each TP rank holds experts ``[rank * E/tp, (rank +
  1) * E/tp)`` (the expert stacks stay E-sharded), dispatches its dp-local
  tokens to them with the capacity of the dp-local token count, and an
  all-reduce SUM over TP adds the ranks' outputs;
* **replicated experts** (``tp == 1`` or ``E % tp != 0``): the reference
  routes and counts the capacity over the *global* token count under GSPMD,
  so the tokens are all-gathered over dp first and each rank keeps its rows
  of the result.

The aux loss is the mean over the global batch in both (over dp, its sums
are all-reduced).  Under autograd the collectives are the sharded training
rules of :mod:`repro_torch.dist.runtime`: under EP the tokens and the gates
enter the local experts through ``copy_in`` (their gradients are partial on
each TP rank) and ``y``'s all-reduce has an identity backward; the replicated
branch's dp gather of the tokens has a reduce-scatter backward; the routing
fractions' all-reduce has an all-reduce backward.
"""

from __future__ import annotations

import math

import torch

from repro_torch import tree
from repro_torch.core.calibrate import unwrap
from repro_torch.dist import runtime
from repro_torch.models import ffn, layers
from repro_torch.models.config import ModelConfig


def moe_init(cfg: ModelConfig, gen: torch.Generator, device=None, expert_fn=None) -> dict:
    """Router ``[d, E]`` and expert stacks ``w_gate`` / ``w_up`` ``[E, d, f]``,
    ``w_down`` ``[E, f, d]`` (``N(0, 1) / sqrt(fan_in)``, f32), plus the
    shared experts as one FFN of hidden ``n_shared_experts * f``.

    Each expert of a stack is drawn on its own, one ``[d, f]`` (``[f, d]``)
    matrix at a time.  With ``expert_fn`` each drawn expert is mapped by it
    before the next one is drawn and the results are stacked
    (``Model.init_quantized`` quantizes it there, so a quantized init holds
    one expert's f32 weights, never a stack's); without it the experts are
    written into one f32 stack.  The draws are the same either way, so
    ``init_quantized(seed)`` is ``quantize(init(seed))`` bit for bit."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * (1.0 / math.sqrt(fan_in))

    def experts(k, n, fan_in):
        if expert_fn is not None:
            return tree.stack([expert_fn(normal((k, n), fan_in)) for _ in range(e.n_experts)])
        out = torch.empty((e.n_experts, k, n), dtype=torch.float32, device=device)
        for i in range(e.n_experts):
            out[i] = normal((k, n), fan_in)
        return out

    p = {
        "router": {"w": normal((d, e.n_experts), d)},
        "w_gate": experts(d, f, d),
        "w_up": experts(d, f, d),
        "w_down": experts(f, d, f),
    }
    if e.n_shared_experts:
        p["shared"] = ffn.ffn_init(cfg, gen, d_ff=e.n_shared_experts * f, device=device)
    return p


def _stack_len(leaf) -> int:
    """Experts in a stack: a raw ``[E, K, F]`` tensor or a quantized
    (prepared, probed) leaf of ``[E, F, Kp]`` codes, not decoded."""
    leaf = unwrap(leaf)
    return (leaf if isinstance(leaf, torch.Tensor) else leaf.codes).shape[0]


def _route(xt: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig, dp_group=None):
    """``(gates [T, k] in xt.dtype, expert ids [T, k] int32, aux loss)``: the
    f32 router's softmax, its top-k (ties to the lower id), the gates
    renormalised over the k, and the Switch load-balance loss — over the
    whole dp batch where ``dp_group`` is given (``xt`` its rank's rows)."""
    e = cfg.moe
    logits = xt.to(torch.float32) @ router_w                  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, : e.top_k], eidx[:, : e.top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    experts = torch.arange(e.n_experts, device=xt.device)
    hard = (eidx[:, :1] == experts).to(torch.float32)
    if dp_group is None:
        dense_frac, hard_frac = probs.mean(dim=0), hard.mean(dim=0)
    else:
        import torch.distributed as dist

        sums = runtime.all_reduce_both(torch.stack([probs.sum(dim=0), hard.sum(dim=0)]),
                                       dp_group)
        dense_frac, hard_frac = sums / (xt.shape[0] * dist.get_world_size(dp_group))
    aux = e.n_experts * torch.sum(dense_frac * hard_frac)
    return gates.to(xt.dtype), eidx.to(torch.int32), aux


def _dispatch_compute(
    xt: torch.Tensor,            # [T, d] tokens
    gates: torch.Tensor,         # [T, k] combine weights (normalised)
    eidx: torch.Tensor,          # [T, k] expert ids
    w_gate,                      # [El, d, f] local experts: raw or quantized stacks
    w_up,
    w_down,                      # [El, f, d]
    *,
    capacity_factor: float,
    act_kind: str,
    e_first: int = 0,            # first global id of the local expert range
    e_total: int | None = None,  # all experts (default: the local ones)
) -> torch.Tensor:
    """Capacity-slot dispatch over the local expert range ``[e_first,
    e_first + El)``; returns ``[T, d]`` (zero rows where a token's experts
    are all elsewhere).  The capacity counts ``e_total`` experts, as the
    reference's per-shard capacity does.

    A quantized stack is decoded (``maybe_dequant``) just before its
    ``torch.bmm`` and dropped after it, so a call holds one decoded stack
    at a time: ``w_down`` is decoded once ``gate * up`` is done with
    ``w_gate`` and ``w_up``.  The products and their order are the
    reference's."""
    from repro_torch.models.model import maybe_dequant

    t, k = gates.shape
    n_e, d = _stack_len(w_gate), xt.shape[1]
    cap = max(int((t * k / (e_total or n_e)) * capacity_factor), 4)
    dev = xt.device
    local_e = eidx.reshape(-1).long() - e_first                         # [T*k]
    is_local = (local_e >= 0) & (local_e < n_e)
    slot_e = torch.where(is_local, local_e, 0)
    slot_tok = torch.arange(t * k, device=dev) // k
    # Position of each slot within its expert, in slot order (token-major):
    # a running count along the innermost dim, where the scan is fast.
    hit = (torch.arange(n_e, device=dev)[:, None] == local_e).to(torch.int32)   # [El, T*k]
    slot_pos = (torch.cumsum(hit, dim=1) - 1).gather(0, slot_e[None])[0]
    keep = is_local & (slot_pos < cap)
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

    def expert(leaf):
        return maybe_dequant(leaf, xg.dtype).to(xg.dtype)

    h = layers.activation(torch.bmm(xg, expert(w_gate)), act_kind)
    h = h * torch.bmm(xg, expert(w_up))
    out_e = torch.bmm(h, expert(w_down)) * buf_gate[..., None].to(xg.dtype)

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
    """Returns ``(y [B, S, d] in x.dtype, aux loss)``.  ``ctx`` with a mesh runs
    the sharded branches (module docstring): ``x`` is the rank's dp rows and
    the expert stacks are the rank's shard of them."""
    e = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    experts = [p[n] for n in ("w_gate", "w_up", "w_down")]
    kw = dict(capacity_factor=e.capacity_factor, act_kind=cfg.ffn_act, e_total=e.n_experts)
    sharded = runtime.active(ctx)
    tp = ctx.tp_size() if sharded else 1
    ep = tp > 1 and e.n_experts % tp == 0
    tp_group = ctx.tp_group() if ep else None
    dp_group = ctx.dp_group() if sharded and ctx.dp_size() > 1 else None
    if ep:
        el = e.n_experts // tp
        if _stack_len(experts[0]) != el:
            raise ValueError(
                f"expert parallelism over {tp} ranks takes {el} local experts a stack; got "
                f"{_stack_len(experts[0])} (cut the tree with shard_tree(param_specs(...)))"
            )
        gates, eidx, aux = _route(xt, p["router"]["w"], cfg, dp_group)
        y = _dispatch_compute(runtime.copy_in(xt, tp_group), runtime.copy_in(gates, tp_group),
                              eidx, *experts, e_first=ctx.tp_rank() * el, **kw)
        y = runtime.reduce_out(y, tp_group)
    else:
        if _stack_len(experts[0]) != e.n_experts:
            raise ValueError(f"replicated experts: {_stack_len(experts[0])} of {e.n_experts}")
        x_all = xt if dp_group is None else runtime.gather_shards(xt, 0, dp_group)
        gates, eidx, aux = _route(x_all, p["router"]["w"], cfg)
        y = _dispatch_compute(x_all, gates, eidx, *experts, **kw)
        if dp_group is not None:
            y = y[runtime.rows_of(y.shape[0], ctx)]
    if "shared" in p:
        y = y + ffn.ffn_apply(p["shared"], x, cfg).reshape(b * s, d)
    return y.reshape(b, s, d), aux
