"""The sharded forward: explicit collectives around each rank's local shards.

The reference runs a sharded forward under GSPMD: its arrays carry their
shardings and XLA inserts the collectives.  Here every rank holds plain local
shards (:func:`repro_torch.dist.sharding.shard_tree`) and the hand-written
kernels take raw pointers, so the model inserts the collectives itself, by
these rules (the reference's own layout hints — ``constrain``,
``constrain_acts``, the attention head hints — are *not* followed: this
layout is fixed by the rules below).

* Activations are full width on every TP rank, and each rank holds its dp
  rows of the batch: the tokens, the caches (``cache_specs`` dim 1) and
  ``prefix_embeds`` are dp-local.  Attention, norms and the recurrences run
  replicated over the TP axis, on all heads.
* **Quantized leaf**: the kernel runs on the local F-shard, then an
  all-gather over TP along the last dim (K is bit-packed, never split).
* **Dense ``{"w"}`` leaf**: column-parallel — a local matmul, then an
  all-gather; row-parallel — the rank's slice of x, a local matmul, an
  all-reduce SUM over TP, then the (replicated) bias.
* **Embedding**: vocab-parallel — a masked local lookup, then an all-reduce
  SUM over TP (exact: one row is not zero).  A tied LM head multiplies by
  the local rows and all-gathers the logits.
* **FSDP** (``fsdp=True``): every dim sharded over dp is all-gathered at
  use — a unit's leaves when the unit runs, a stack-dim shard when its
  segment starts.
* **A leaf decoded to a dense weight** instead of applied (MLA's
  ``W_kup`` / ``W_vup``): its shard is all-gathered first.
* **Reductions across the batch**, which GSPMD makes global: the
  uncalibrated ``lut`` / ``stream`` modes' dynamic activation abs-max is
  all-reduced MAX over dp; the MoE block's rules are in
  :func:`repro_torch.models.moe.moe_apply`.

A failed collective raises; nothing falls back, and nothing is silently
replicated.  ``seq_shard`` execution raises ``NotImplementedError`` (ROADMAP
Queue 1).

**Training** runs the same forward under autograd; each collective is an
``autograd.Function`` whose backward follows from the layout: the loss is
*replicated over TP* (every TP rank computes it from the same full-width
activations) and *split over dp* (each rank's rows).

* **Normalization.**  Each rank's whole loss — its dp-local xent mean and the
  aux term, which the routing fractions' all-reduce already makes global —
  is divided by the dp size, so the sum over dp ranks is the global loss and
  every dp-side backward is a plain SUM: the reported loss is all-reduced SUM
  over dp, and after backward the gradient of every leaf replicated over dp
  is all-reduced SUM over dp (:meth:`ShardedRun.reduce_grads`).
* **A TP gather of an output** (a linear's column shards, the tied head's
  logits, :meth:`ShardedLinear.dense_weight`): the upstream gradient is the
  same on every TP rank, so the backward is this rank's slice of it
  (:func:`gather_out`).
* **A TP-replicated tensor entering a rank-local computation whose result is
  combined over TP** (``x`` before a column-parallel matmul, before the
  narrow of a row-parallel one or before the tied head's local logits;
  ``xt`` and the gates before the local experts under EP) gets only a partial
  gradient on each rank: identity forward, all-reduce SUM over TP backward
  (Megatron's "f", :func:`copy_in`).
* **A forward all-reduce SUM over TP** (row-parallel, the vocab-parallel
  embedding, EP's ``y``): identity backward (:func:`reduce_out`).
* **A dp gather of a weight** (FSDP: :meth:`ShardedRun.gather_dp`,
  :meth:`ShardedRun.stack`, the embedding table) or of an activation (the MoE
  block's replicated-experts branch): reduce-scatter SUM over dp backward
  (:func:`gather_shards`).  The MoE routing fractions' forward all-reduce
  over dp has an all-reduce SUM backward (:func:`all_reduce_both`).
* **The gradient norm** counts each element once: local sums of squares in
  groups of leaves sharded on the same axes, each group all-reduced over
  those axes (:meth:`ShardedRun.norm_groups`).
* **Checkpointed units** (``remat=True``) run their forward collectives
  again in backward.  Every rank runs the same program, so the order agrees;
  no rank-dependent branch may start a collective.

With these the sharded step's gradient on each rank equals the same slice of
the unsharded step's gradient on the global batch, up to the order of the
sums.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.core import PreparedLinear, QuantizedLinear
from repro_torch.core.quantize import quantize_activation
from repro_torch.dist.sharding import PSpec, ShardCtx, _spec_leaves, global_like, param_specs

_INT_LUT_MODES = ("lut", "stream")


def gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather ``t`` over ``group``, concatenated along ``dim`` in group-rank
    order (no autograd: the sharded training rules are the Functions below)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` all-reduced over ``group`` in place (SUM or MAX); returns it."""
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=group)
    return t


def _slice_of(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist

    n = dist.get_world_size(group)
    k = g.shape[dim] // n
    return g.narrow(dim, dist.get_rank(group) * k, k).contiguous()


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist

    parts = [c.contiguous() for c in g.chunk(dist.get_world_size(group), dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: this rank's slice of the gradient, or
    with ``scatter`` the gradient reduce-scattered SUM."""

    @staticmethod
    def forward(ctx, t, dim, group, scatter):
        ctx.dim, ctx.group, ctx.scatter = dim, group, scatter
        return gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        back = _reduce_scatter if ctx.scatter else _slice_of
        return back(g, ctx.dim, ctx.group), None, None, None


class _AllReduce(torch.autograd.Function):
    """All-reduce SUM in the forward (``fwd``) or not (identity), and of the
    gradient in the backward (``bwd``) or not."""

    @staticmethod
    def forward(ctx, t, group, fwd, bwd):
        ctx.group, ctx.bwd = group, bwd
        return all_reduce(t.clone(), group) if fwd else t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(g.clone(), ctx.group) if ctx.bwd else g), None, None, None


def gather_out(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather over TP of a result every TP rank then uses alike; backward:
    this rank's slice of the gradient."""
    return _Gather.apply(t, dim, group, False)


def gather_shards(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather over dp of a dp-sharded weight or activation; backward:
    reduce-scatter SUM over dp."""
    return _Gather.apply(t, dim, group, True)


def copy_in(t: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward all-reduce SUM over ``group`` (a TP-replicated
    input of a rank-local computation that is combined over TP)."""
    return t if group is None else _AllReduce.apply(t, group, False, True)


def reduce_out(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM over TP of the ranks' partial results; identity backward."""
    return t if group is None else _AllReduce.apply(t, group, True, False)


def all_reduce_both(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM forward and backward (a dp-global statistic of a loss term
    replicated over dp: the MoE routing fractions)."""
    return t if group is None else _AllReduce.apply(t, group, True, True)


def active(ctx) -> bool:
    """True where ``ctx`` asks for a sharded run (a mesh is attached)."""
    return ctx is not None and ctx.mesh is not None


@dataclasses.dataclass
class ShardedLinear:
    """A linear leaf's local shard inside one sharded call, with what it
    needs around its kernel: ``out_tp`` — the output dim is sharded over TP
    (all-gather after); ``in_tp`` — the input dim is (slice x, all-reduce
    after); ``dp_amax`` — an uncalibrated int-LUT leaf whose activation
    abs-max is all-reduced over dp first."""

    inner: Any                 # {"w", ("b")} | QuantizedLinear | PreparedLinear
    run: "ShardedRun"
    out_tp: bool = False
    in_tp: bool = False
    dp_amax: bool = False

    def apply(self, x: torch.Tensor, linear) -> torch.Tensor:
        """``linear(inner, x)`` with the collectives; ``linear`` is
        :func:`repro_torch.models.layers.linear`."""
        inner, run = self.inner, self.run
        if self.dp_amax:
            inner = dataclasses.replace(inner, ascale=run.global_ascale(inner, x))
        if self.in_tp:
            w = inner["w"]
            k = w.shape[-2]
            x = copy_in(x, run.tp_group).narrow(-1, run.tp_rank * k, k)
            y = reduce_out(x @ w.to(x.dtype), run.tp_group)
            return y + inner["b"].to(y.dtype) if "b" in inner else y
        if not self.out_tp:
            return linear(inner, x)
        return gather_out(linear(inner, copy_in(x, run.tp_group)), -1, run.tp_group)

    def dense_weight(self, decode) -> torch.Tensor:
        """The whole dense ``[..., K, F]`` weight (``decode`` turns a quantized
        leaf into its local one): the local shard all-gathered."""
        w = self.inner["w"] if isinstance(self.inner, dict) else decode(self.inner)
        if self.out_tp:
            w = gather_out(w, -1, self.run.tp_group)
        if self.in_tp:
            w = gather_out(w, -2, self.run.tp_group)
        return w


class ShardedRun:
    """One sharded call's view of a rank's local tree: the specs it was cut
    with (recomputed from ``cfg`` and the local tree, :func:`global_like`),
    the groups, and the binding of each unit's leaves to the rules."""

    def __init__(self, cfg, params, ctx: ShardCtx):
        if ctx.seq_shard:
            raise NotImplementedError(
                "seq_shard execution (the sequence dim of the caches on the TP axis, "
                "context-parallel attention) is not ported: ROADMAP Queue 1, 'seq_shard "
                "execution'; its specs are (cache_specs)"
            )
        self.cfg, self.ctx = cfg, ctx
        self.specs = param_specs(cfg, global_like(cfg, params), ctx)
        self.tp_size, self.dp_size = ctx.tp_size(), ctx.dp_size()
        self.tp_group = ctx.tp_group() if self.tp_size > 1 else None
        self.dp_group = ctx.dp_group() if self.dp_size > 1 else None
        self.tp_rank = ctx.tp_rank()
        self._tp = ctx.tp_axis if self.tp_size > 1 else None
        self._dp = ctx.dp() if self.dp_size > 1 else None

    # --- leaves -----------------------------------------------------------

    def gather_dp(self, t: torch.Tensor, spec: PSpec, dims=None) -> torch.Tensor:
        """``t`` with every dim (of ``dims``, default all) sharded over dp
        all-gathered."""
        for d, entry in enumerate(spec):
            if entry is not None and entry == self._dp and (dims is None or d in dims):
                t = gather_shards(t, d, self.dp_group)
        return t

    def bind(self, node, spec, name: str = "", under_moe: bool = False):
        """``node`` (a unit's, or a top-level, local subtree) ready to run:
        dp-sharded dims gathered, and each linear leaf that needs a
        collective wrapped in a :class:`ShardedLinear`.  Expert stacks stay
        as they are (:func:`repro_torch.models.moe.moe_apply` reads them)."""
        from repro_torch.models.model import MOE_EXPERT_NAMES, in_moe_subtree

        if under_moe and name in MOE_EXPERT_NAMES:
            return node
        if isinstance(node, (QuantizedLinear, PreparedLinear)):
            out_tp = self._tp is not None and spec.codes[-2] == self._tp
            dp_amax = (self._dp is not None and node.spec.mode in _INT_LUT_MODES
                       and node.ascale is None)
            return ShardedLinear(node, self, out_tp=out_tp, dp_amax=dp_amax) \
                if out_tp or dp_amax else node
        if isinstance(node, dict):
            if isinstance(node.get("w"), torch.Tensor):
                leaf = {k: self.gather_dp(v, spec[k]) if isinstance(v, torch.Tensor) else v
                        for k, v in node.items()}
                w = spec["w"]
                out_tp = self._tp is not None and len(w) >= 2 and w[-1] == self._tp
                in_tp = self._tp is not None and len(w) >= 2 and w[-2] == self._tp
                return ShardedLinear(leaf, self, out_tp=out_tp, in_tp=in_tp) \
                    if out_tp or in_tp else leaf
            return {k: self.bind(v, spec[k], k, in_moe_subtree(k, under_moe))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [self.bind(v, s, name, under_moe) for v, s in zip(node, spec)]
            return out if isinstance(node, list) else tuple(out)
        if isinstance(node, torch.Tensor):
            return self.gather_dp(node, spec)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            raise TypeError(
                f"{type(node).__name__} at {name!r}: a sharded call takes a tree of local "
                f"shards (calibrate before cutting the shards)"
            )
        return node

    def top(self, params: dict, key: str):
        """``params[key]`` (not stacked) bound; ``None`` where absent."""
        return None if key not in params else self.bind(params[key], self.specs[key], key)

    def stack(self, stacked, spec):
        """A stacked subtree (a segment, the encoder) with its stack-dim
        shards gathered, and its units' spec (the stack entry dropped)."""
        stacked = _map_pairs(lambda t, s: self.gather_dp(t, s, dims=(0,)), stacked, spec)
        return stacked, _spec_leaves(spec, lambda s: PSpec(*s[1:]))

    def units(self, stacked, spec, n_units: int) -> list:
        """The bound units of a stacked subtree, bound one at a time as the
        caller takes them (FSDP gathers a unit's leaves at its use)."""
        stacked, unit_spec = self.stack(stacked, spec)
        for unit in tree.unstack(stacked, n_units):
            yield self.bind(unit, unit_spec)

    # --- embedding, head, activation scale --------------------------------

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel lookup: each TP rank looks up the ids in its
        rows (zeros elsewhere), then an all-reduce SUM."""
        spec = self.specs["embed"]
        table = self.gather_dp(table, spec)
        ids = tokens.long()
        if self._tp is None or spec[0] != self._tp:
            return table[ids]
        rows = table.shape[0]
        local = ids - self.tp_rank * rows
        mine = (local >= 0) & (local < rows)
        x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)], 0.0)
        return reduce_out(x, self.tp_group)

    def tied_head(self, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """``x @ embed^T`` over the local vocab rows, all-gathered."""
        spec = self.specs["embed"]
        table = self.gather_dp(table, spec)
        if self._tp is None or spec[0] != self._tp:
            return torch.einsum("bsd,vd->bsv", x, table.to(x.dtype))
        logits = torch.einsum("bsd,vd->bsv", copy_in(x, self.tp_group), table.to(x.dtype))
        return gather_out(logits, -1, self.tp_group)

    def global_ascale(self, q, x: torch.Tensor) -> torch.Tensor:
        """The dynamic activation scale over the whole dp batch: this rank's
        f32 abs-max all-reduced MAX, then the quantizer's own scale formula
        (so the scale is the one ``x`` of every rank together would give)."""
        amax = x.reshape(-1, x.shape[-1]).to(torch.float32).abs().amax()
        all_reduce(amax, self.dp_group, op="max")
        _, scale = quantize_activation(amax.reshape(1, 1), q.spec.aspec())
        return scale


    # --- training: after backward -----------------------------------------

    def sum_dp(self, t: torch.Tensor) -> torch.Tensor:
        """A rank's share of a loss (or any detached value) summed over dp."""
        return t if self.dp_group is None else all_reduce(t.detach().clone(), self.dp_group)

    def reduce_grads(self, grads):
        """The gradient tree after backward: every leaf replicated over dp
        all-reduced SUM over dp (a dp-sharded leaf's gradient was
        reduce-scattered by its gather's backward)."""
        if self.dp_group is None:
            return grads
        return tree.tree_map(
            lambda g, spec: g if self._dp in spec else all_reduce(g, self.dp_group),
            grads, self.specs)

    def norm_groups(self, grads) -> torch.Tensor:
        """The global sum of squares of a gradient tree of local shards: each
        group of leaves sharded on the same axes summed locally, then
        all-reduced over those axes, so a replicated element counts once."""
        groups: dict = {}

        def add(g, spec):
            axes = tuple(a for a in (self._dp, self._tp) if a is not None and a in spec)
            groups.setdefault(axes, []).append(torch.sum(torch.square(g.to(torch.float32))))
            return g

        tree.tree_map(add, grads, self.specs)
        total = []
        for axes, sums in groups.items():          # the same order on every rank
            s = torch.sum(torch.stack(sums))
            for a in axes:
                all_reduce(s, self.dp_group if a == self._dp else self.tp_group)
            total.append(s)
        return torch.sum(torch.stack(total))


def _map_pairs(fn, node, spec):
    """``fn(tensor, spec)`` over a tree and its spec tree (dataclass nodes:
    their tensor fields)."""
    if isinstance(node, torch.Tensor):
        return fn(node, spec)
    if isinstance(node, dict):
        return {k: _map_pairs(fn, v, spec[k]) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        out = [_map_pairs(fn, v, s) for v, s in zip(node, spec)]
        return out if isinstance(node, list) else tuple(out)
    if isinstance(node, (QuantizedLinear, PreparedLinear)):
        return node      # quantized leaves are never sharded over dp
    return node


def rows_of(n_rows: int, ctx: Optional[ShardCtx]) -> slice:
    """The slice of a batch of ``n_rows`` that this rank's dp coordinate
    holds (all of it without a mesh)."""
    if not active(ctx):
        return slice(0, n_rows)
    dp = ctx.dp_size()
    if n_rows % dp:
        raise ValueError(f"a batch of {n_rows} rows does not divide over dp {dp}")
    per = n_rows // dp
    r = ctx.dp_rank()
    return slice(r * per, (r + 1) * per)
