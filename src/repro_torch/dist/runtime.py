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

**Sequence-sharded caches** (``seq_shard=True``): every cache leaf whose
:func:`~repro_torch.dist.sharding.cache_specs` entry puts dim 2 on the TP
axis is cut along it (``shard_tree(caches, cache_specs(...))``), and TP rank
``r`` holds positions ``[r·T/tp, (r+1)·T/tp)`` of it (:class:`SeqShard`).
Activations stay full width and TP-replicated, as above: the reference's
sequence hint on the activations (``constrain_acts``) is not followed.

* A sharded call over caches names ``max_seq`` (what the caches were made
  with): the leaves' global shapes come from ``cfg`` and ``max_seq`` on
  ``meta``, their specs from ``cache_specs``, and each local leaf's length
  is checked against them (:meth:`ShardedRun.cache_seq`).  A shape the rule
  does not shard (T < 1024, or T % tp != 0) runs the replicated branch
  because its spec says so.
* **Writes**: a position is written only by the rank that holds it — an
  int offset's range cut to the rank's slice, a ``[B]`` offset row by row
  behind a ``torch.where`` (the old value where another rank holds it); no
  host sync.  A ring slot ``pos % W`` has one owner; the encoder's cross
  keys and values are cut to the rank's frames.
* **Attention over the shards** takes the form GSPMD gives the reference's
  jitted ops: local scores over the rank's keys, masked in *global* buffer
  positions; the rows' max combined (MAX) over TP; ``exp(s - M)`` and its
  local sum; the sums combined (SUM); the normalized probabilities (rounded
  to bf16 under ``attend_bf16``) times the local values; the products
  combined (SUM).  Each combine is an all-gather over TP and a sum (or max)
  in rank order (:func:`combine`), so every rank gets the same bits, and a
  single process that holds every shard combines them with the same
  function.  A masked score is ``MASK_FILL`` (finite): a rank with no valid
  key for a row gives ``exp(MASK_FILL - M) = 0``, and a row masked on every
  rank is uniform over all keys, as unsharded.
* **RWKV6's token-shift rows** ``x_prev_*`` ``[B, D]``: the rule's "long dim
  2" is their feature dim; they are all-gathered over TP before use and each
  rank writes back its slice.  Steps without a cache (a cache-free forward,
  a train step) run as without ``seq_shard``.

A failed collective raises; nothing falls back, and nothing is silently
replicated.

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
import functools
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.core import PreparedLinear, QuantizedLinear
from repro_torch.core.quantize import quantize_activation
from repro_torch.dist.sharding import (
    AxisMesh, PSpec, ShardCtx, _spec_leaves, cache_specs, global_like, param_specs,
)

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


def combine(parts: list, op: str) -> torch.Tensor:
    """The shards' partials ``parts`` (rank order) combined left to right:
    elementwise max (``op="max"``) or sum — the one reduction of the
    context-parallel attention, whether the partials came from an
    all-gather (:meth:`SeqShard.reduce`) or from shards held in one
    process."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p) if op == "max" else out + p
    return out


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


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This TP rank's share of a sequence-sharded cache leaf: rank ``rank``
    of ``size`` on ``group`` holds global positions ``[rank·n, (rank+1)·n)``
    of a leaf whose local dim (the sequence, or RWKV6's feature dim) has
    length ``n``."""

    rank: int
    size: int
    group: Any = None

    def lo(self, n: int) -> int:
        """The first global position of a local length ``n``."""
        return self.rank * n

    def reduce(self, parts: list, op: str) -> torch.Tensor:
        """This rank's one partial (``parts == [t]``) all-gathered over TP and
        :func:`combine`-d in rank order."""
        import torch.distributed as dist

        (t,) = parts
        t = t.contiguous()
        every = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(every, t, group=self.group)
        return combine(every, op)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf behind this rank's slice ``t`` (along ``dim``)."""
        return gather(t, dim, self.group)

    def narrow(self, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """This rank's slice of length ``n`` of a whole ``t`` along ``dim``."""
        return t.narrow(dim, self.lo(n), n)


# The cache leaves whose dim 2 the attention and RWKV6 branches can take
# sharded (the sequence, or x_prev_*'s feature dim); a spec that shards any
# other leaf is refused.
_SEQ_LEAVES = frozenset({"k", "v", "k_s", "v_s", "ckv", "krope", "ck", "cv",
                         "x_prev_t", "x_prev_c"})


@functools.lru_cache(maxsize=16)
def _seq_layout(cfg, max_seq: int, tp_size: int):
    """Per cache leaf of ``cfg`` at ``max_seq``: ``(global shape, sharded)``
    under ``cache_specs`` with ``seq_shard`` on a TP axis of ``tp_size``."""
    from repro_torch.models import transformer

    meta = transformer.init_cache(cfg, 1, max_seq, torch.float32, device="meta")
    ctx = ShardCtx(AxisMesh((tp_size,), ("model",)), dp_axes=(), seq_shard=True)
    specs = cache_specs(cfg, meta, ctx)
    return _map_pairs(lambda a, spec: (tuple(a.shape), len(spec) > 2 and spec[2] is not None),
                      meta, specs)


class ShardedRun:
    """One sharded call's view of a rank's local tree: the specs it was cut
    with (recomputed from ``cfg`` and the local tree, :func:`global_like`),
    the groups, and the binding of each unit's leaves to the rules."""

    def __init__(self, cfg, params, ctx: ShardCtx):
        self.cfg, self.ctx = cfg, ctx
        self.specs = param_specs(cfg, global_like(cfg, params), ctx)
        self.tp_size, self.dp_size = ctx.tp_size(), ctx.dp_size()
        self.tp_group = ctx.tp_group() if self.tp_size > 1 else None
        self.dp_group = ctx.dp_group() if self.dp_size > 1 else None
        self.tp_rank = ctx.tp_rank()
        self._tp = ctx.tp_axis if self.tp_size > 1 else None
        self._dp = ctx.dp() if self.dp_size > 1 else None
        self.seq = SeqShard(self.tp_rank, self.tp_size, self.tp_group) \
            if ctx.seq_shard and self._tp is not None else None

    # --- sequence-sharded caches -----------------------------------------

    def cache_seq(self, caches, max_seq: Optional[int]):
        """A tree like ``caches`` (this rank's local cache leaves) with the
        :class:`SeqShard` of every leaf sharded along dim 2 and ``None``
        elsewhere; ``None`` without ``seq_shard``.  Each leaf's local shape
        is checked against the one ``cache_specs`` cuts from the caches of
        ``cfg`` at ``max_seq``."""
        if self.seq is None:
            return None
        if max_seq is None:
            raise ValueError(
                "a seq_shard call over caches needs max_seq= (the length the caches were "
                "made with): it fixes which leaves cache_specs cut along the sequence"
            )
        layout = _seq_layout(self.cfg, max_seq, self.tp_size)

        def leaf(t, entry, name):
            shape, sharded = entry
            if len(shape) > 2:
                want = shape[2] // self.tp_size if sharded else shape[2]
                if t.ndim != len(shape) or t.shape[2] != want:
                    raise ValueError(
                        f"cache leaf {name!r} of local shape {tuple(t.shape)}: cache_specs at "
                        f"max_seq {max_seq} and tp {self.tp_size} cut dim 2 to {want} "
                        f"(global {shape})"
                    )
            if sharded and name not in _SEQ_LEAVES:
                raise ValueError(
                    f"cache leaf {name!r} {shape}: seq_shard cuts its dim 2, which no "
                    f"branch takes sharded"
                )
            return self.seq if sharded else None

        return _map_named(leaf, caches, layout)

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


def local_cache(cfg, batch: int, max_seq: int, dtype, ctx: ShardCtx, device) -> list:
    """This rank's zero caches: the shard ``cache_specs`` cuts from the caches
    of ``batch`` rows and ``max_seq`` positions (its dp rows, and under
    ``seq_shard`` its slice of the sequence), allocated at the local shape
    only."""
    from repro_torch.dist.sharding import _cut, _map_specs, mesh_axes
    from repro_torch.models import transformer

    meta = transformer.init_cache(cfg, batch, max_seq, dtype, device="meta")
    sizes, coords = mesh_axes(ctx.mesh), ctx.coords()
    return _map_specs(lambda t, spec: torch.zeros(_cut(t, spec, sizes, coords).shape,
                                                  dtype=t.dtype, device=device),
                      meta, cache_specs(cfg, meta, ctx))


def _map_named(fn, node, other, name: str = ""):
    """``fn(tensor, other leaf, dict key)`` over a tree of tensors and a tree
    of the same structure."""
    if isinstance(node, torch.Tensor):
        return fn(node, other, name)
    if isinstance(node, dict):
        return {k: _map_named(fn, v, other[k], k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        if len(node) != len(other):
            raise ValueError(f"{len(node)} cache segments for the config's {len(other)}")
        return [_map_named(fn, v, o, name) for v, o in zip(node, other)]
    return None


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
