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
replicated.  ``seq_shard`` execution and training under a mesh raise
``NotImplementedError`` (ROADMAP Queue 1).
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
    order."""
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


def active(ctx) -> bool:
    """True where ``ctx`` asks for a sharded run (a mesh is attached)."""
    return ctx is not None and ctx.mesh is not None


def refuse_training(what: str) -> None:
    raise NotImplementedError(
        f"{what} under a mesh needs autograd through the collectives: sharded training "
        f"(make_train_step(ctx=) with the FSDP reduce-scatter) is the next distribution item "
        f"of ROADMAP Queue 1, 'Sharded training'"
    )


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
            y = x.narrow(-1, run.tp_rank * k, k) @ w.to(x.dtype)
            all_reduce(y, run.tp_group)
            return y + inner["b"].to(y.dtype) if "b" in inner else y
        y = linear(inner, x)
        return gather(y, -1, run.tp_group) if self.out_tp else y

    def dense_weight(self, decode) -> torch.Tensor:
        """The whole dense ``[..., K, F]`` weight (``decode`` turns a quantized
        leaf into its local one): the local shard all-gathered."""
        w = self.inner["w"] if isinstance(self.inner, dict) else decode(self.inner)
        if self.out_tp:
            w = gather(w, -1, self.run.tp_group)
        if self.in_tp:
            w = gather(w, -2, self.run.tp_group)
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
        if torch.is_grad_enabled() and any(t.requires_grad for t in tree.tensors(params)):
            refuse_training("a forward with parameters that require grad")
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
                t = gather(t, d, self.dp_group)
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
        return all_reduce(x, self.tp_group)

    def tied_head(self, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """``x @ embed^T`` over the local vocab rows, all-gathered."""
        spec = self.specs["embed"]
        table = self.gather_dp(table, spec)
        logits = torch.einsum("bsd,vd->bsv", x, table.to(x.dtype))
        if self._tp is None or spec[0] != self._tp:
            return logits
        return gather(logits, -1, self.tp_group)

    def global_ascale(self, q, x: torch.Tensor) -> torch.Tensor:
        """The dynamic activation scale over the whole dp batch: this rank's
        f32 abs-max all-reduced MAX, then the quantizer's own scale formula
        (so the scale is the one ``x`` of every rank together would give)."""
        amax = x.reshape(-1, x.shape[-1]).to(torch.float32).abs().amax()
        all_reduce(amax, self.dp_group, op="max")
        _, scale = quantize_activation(amax.reshape(1, 1), q.spec.aspec())
        return scale


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
