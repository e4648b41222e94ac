"""Sharding specs for the model zoo, including LoCaLUT-quantized trees (port
of ``repro.dist.sharding``).

:class:`ShardCtx` names the mesh axes one forward / serve step runs over:
``dp_axes`` (data / FSDP axes, possibly hierarchical: ``("pod", "data")`` on
the multi-pod mesh) and ``tp_axis`` (tensor / expert parallelism).
:func:`param_specs` walks any parameter tree of ``configs/`` and assigns a
:class:`PSpec` per leaf, with the reference's rules, leaf for leaf:

* dense "column" projections (``wq`` / ``wk`` / ``wv`` / ``w_up`` / ...)
  shard the output dim on the TP axis; "row" projections (``wo`` /
  ``w_down`` / ``out_proj``) the input dim;
* MoE expert stacks (``[units, E, d, f]``) shard the expert dim on the TP
  axis: expert parallelism;
* **LoCaLUT-quantized leaves** shard their packed codes along the *output*
  dim only (K is bit-packed: splitting it would cut inside bytes), and the
  per-channel scales and bias follow; the canonical / reordering LUT tables
  are not in the tree (they are rebuilt from ``(bw, ba, p)`` on every host);
* with ``fsdp=True`` dense matrices also shard their non-TP matrix dim over
  the dp axes.

Every rule replicates a dim that the mesh-axis size does not divide.

The port keeps two things of its own.  A spec leaf is a :class:`PSpec` (one
entry per dim: an axis name, a tuple of names, or ``None``), the stand-in for
``jax.sharding.PartitionSpec``; :func:`to_shardings` turns it into DTensor
placements that carry their mesh (:class:`Placements`, the stand-in for
``NamedSharding``: what ``ckpt.save`` / ``restore(shardings=)`` gather and
cut a leaf with, :func:`whole_leaf` / :func:`shard_leaf`).  And a quantized leaf's frozen activation scale ``ascale`` gets a
replicated spec, where the reference leaves the array itself in the spec
tree (its ``dataclasses.replace`` touches only codes, scale and bias): a
scalar is replicated either way.

A rank holds plain local shards: :func:`shard_tree` cuts one rank's shard of
every leaf (the port's ``device_put`` under the shardings), and the model
applies them with explicit collectives (:mod:`repro_torch.dist.runtime`).
The specs are derived from the *raw* quantized tree, as in the reference; a
rank prepares its own shard after :func:`shard_tree` (a prepared leaf's rows
are row-local), and a :class:`~repro_torch.core.PreparedLinear` handed to
:func:`param_specs` raises.

Under a plan (``ServeEngine(plan=, ctx=)``) a rank prepares its raw shard
by the *global* plan, made on the global raw tree.  The plan's fingerprint
hashes the global codes shapes, so the rank checks it against the global
leaves' identities, which :func:`global_codes_shapes` rebuilds from the
shard and its spec over the mesh (``global_like`` gives the global shapes
the specs are derived from); every rank of the mesh refuses a plan that does
not match before any of them serves.  Each ``LayerPlan`` then applies to the
local leaf at its path unchanged, its ``wcanon`` cap that of the global leaf
(``tune.planner.apply_plan(shapes=)``).  A prepared leaf's products are
row-local, so a shard holding ``1/n`` of its leaf's codes holds ``1/n`` of the
plan's bytes for that leaf, and a replicated leaf all of them
(``tune.planner.verify_capacity(shapes=)``): a tp group's shards sum to the
plan's per-leaf bytes, replicated leaves once a rank, and no rank's tree is
held to the plan's total.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import PreparedLinear, QuantizedLinear

# Output-dim-parallel projections: the output grows with heads / ffn width.
_COL_PARALLEL = frozenset(
    {"wq", "wk", "wv", "wg", "wr", "w_up", "w_gate", "w_kup", "w_vup",
     "in_proj", "lm_head"}
)
# Input-dim-parallel projections: consume a TP-sharded activation.
_ROW_PARALLEL = frozenset({"wo", "w_down", "out_proj"})

# Minimum length for a cache dim 2 to count as the sequence dim under
# ``seq_shard`` (SSM / RWKV states have a small feature dim 2).
_SEQ_SHARD_MIN = 1024


class PSpec(tuple):
    """One entry per dim of a leaf: a mesh-axis name, a tuple of names
    (sharded over their product, the first axis major), or ``None``
    (replicated) — the port's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AxisMesh:
    """Axis names and sizes without devices or process groups: specs can be
    derived for any mesh in one process (the counterpart of jax's
    ``AbstractMesh``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a :class:`torch.distributed.device_mesh.DeviceMesh`
    or an :class:`AxisMesh` (empty for ``None``)."""
    if mesh is None:
        return {}
    if isinstance(mesh, AxisMesh):
        return mesh.shape
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(
            f"a ShardCtx mesh is a DeviceMesh with mesh_dim_names, an AxisMesh or None; "
            f"got {type(mesh).__name__}"
        )
    return dict(zip(names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh axes + policy knobs threaded through the model and serve code.

    ``mesh`` may be a :class:`torch.distributed.device_mesh.DeviceMesh` (a
    process group per axis: execution), an :class:`AxisMesh` (spec
    derivation without ranks), or ``None`` (one device: every helper is a
    no-op).  An axis the mesh lacks has size 1."""

    mesh: Any = None
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    fsdp: bool = False
    seq_shard: bool = False

    def dp_size(self) -> int:
        axes = mesh_axes(self.mesh)
        return math.prod(axes.get(a, 1) for a in self.dp_axes)

    def tp_size(self) -> int:
        return mesh_axes(self.mesh).get(self.tp_axis, 1)

    def dp(self):
        """The dp axes as a single spec entry."""
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    # --- process groups (DeviceMesh only) ---------------------------------

    def coords(self) -> dict:
        """This rank's coordinate along every mesh axis."""
        return dict(zip(self._device_mesh().mesh_dim_names,
                        self._device_mesh().get_coordinate()))

    def tp_group(self):
        """The TP axis's process group (``None`` where the mesh lacks it)."""
        return _groups(self._device_mesh(), (self.tp_axis,))

    def dp_group(self):
        """One process group over every dp axis the mesh has, its ranks in
        row-major order of the dp coordinates (``None`` where it has none)."""
        return _groups(self._device_mesh(), tuple(self.dp_axes))

    def tp_rank(self) -> int:
        return self.coords().get(self.tp_axis, 0)

    def dp_rank(self) -> int:
        return _row_major(self.coords(), mesh_axes(self.mesh), self.dp_axes)

    def _device_mesh(self):
        if self.mesh is None or isinstance(self.mesh, AxisMesh):
            raise TypeError(
                f"process groups need a DeviceMesh; this ShardCtx has {self.mesh!r}"
            )
        return self.mesh


def _row_major(coords: dict, sizes: dict, axes) -> int:
    """Index of ``coords`` over ``axes`` (first axis major; missing axes are
    size 1)."""
    idx = 0
    for a in axes:
        idx = idx * sizes.get(a, 1) + coords.get(a, 0)
    return idx


def _groups(mesh, axes: tuple):
    """The process group spanning ``axes`` of ``mesh`` that holds this rank.
    One axis: the mesh's own group.  Several: every rank creates one group
    per combination of the other axes' coordinates, in the same order
    (``new_group`` is collective), and keeps its own, cached on the mesh."""
    present = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if not present:
        return None
    if len(present) == 1:
        return mesh.get_group(present[0])
    cache = mesh.__dict__.setdefault("_flattened_groups", {})
    if present not in cache:
        import torch.distributed as dist

        names = list(mesh.mesh_dim_names)
        order = [names.index(a) for a in names if a not in present] + \
            [names.index(a) for a in present]
        rows = mesh.mesh.permute(order).reshape(-1, math.prod(
            mesh.mesh.shape[names.index(a)] for a in present))
        me = dist.get_rank()
        mine = None
        for row in rows.tolist():
            g = dist.new_group(row)
            if me in row:
                mine = g
                # torch orders a group's ranks by global rank; the dp rank is
                # the row-major dp coordinate, so the two must agree.
                if dist.get_rank(g) != row.index(me) or row != sorted(row):
                    raise RuntimeError(
                        f"the mesh's ranks along {present} are not in row-major "
                        f"order: {row}"
                    )
        cache[present] = mine
    return cache[present]


# ---------------------------------------------------------------------------
# param_specs
# ---------------------------------------------------------------------------


def param_specs(cfg, params: Any, ctx: ShardCtx) -> Any:
    """A :class:`PSpec` tree mirroring ``params`` (tensors of any device,
    ``meta`` included).  :class:`QuantizedLinear` nodes are kept, with spec
    leaves in their tensor fields, so a spec tree lines up with its
    parameter tree leaf for leaf."""
    # The models import the dist layer (their linears dispatch its shards).
    from repro_torch.models.model import MOE_EXPERT_NAMES, in_moe_subtree

    tp_size = ctx.tp_size()
    dp_size = ctx.dp_size()
    tp = ctx.tp_axis if tp_size > 1 else None
    dp = ctx.dp() if dp_size > 1 else None
    fsdp = ctx.fsdp and dp is not None

    def dense_w(a, name: str) -> PSpec:
        # a: [*stack, K, F]
        dims = [None] * a.ndim
        if a.ndim >= 2:
            if tp and name in _COL_PARALLEL and a.shape[-1] % tp_size == 0:
                dims[-1] = tp
            elif tp and name in _ROW_PARALLEL and a.shape[-2] % tp_size == 0:
                dims[-2] = tp
            if fsdp:
                for d in (-2, -1):
                    if dims[d] is None and a.shape[d] % dp_size == 0:
                        dims[d] = dp
                        break
        return PSpec(*dims)

    def dense_b(a, parent: str) -> PSpec:
        dims = [None] * a.ndim
        if tp and parent in _COL_PARALLEL and a.shape[-1] % tp_size == 0:
            dims[-1] = tp
        return PSpec(*dims)

    def quantized(q: QuantizedLinear, name: str, under_moe: bool) -> QuantizedLinear:
        codes, scale = q.codes, q.scale
        cdims = [None] * codes.ndim
        sdims = [None] * scale.ndim
        if under_moe and name in MOE_EXPERT_NAMES and codes.ndim >= 3:
            # Expert parallelism: the expert dim of [*, E, F, Kp].  A count the
            # TP size does not divide replicates outright (moe_apply then runs
            # replicated experts).
            if tp and codes.shape[-3] % tp_size == 0:
                cdims[-3] = tp
                if scale.ndim >= 2 and scale.shape[-2] % tp_size == 0:
                    sdims[-2] = tp
        elif tp and codes.shape[-2] % tp_size == 0:
            # The output (N) dim; K stays whole (it is bit-packed).
            cdims[-2] = tp
            if scale.shape[-1] % tp_size == 0:
                sdims[-1] = tp
        bias_spec = None
        if q.bias is not None:
            bdims = [None] * q.bias.ndim
            if sdims and sdims[-1] is not None and q.bias.shape[-1] % tp_size == 0:
                bdims[-1] = tp
            bias_spec = PSpec(*bdims)
        ascale_spec = None if q.ascale is None else PSpec(*([None] * q.ascale.ndim))
        return dataclasses.replace(q, codes=PSpec(*cdims), scale=PSpec(*sdims),
                                   bias=bias_spec, ascale=ascale_spec)

    def embed_spec(a) -> PSpec:
        # [V, D]: vocab-parallel on tp; fsdp shards the model dim on dp.
        dims = [None] * a.ndim
        if tp and a.shape[0] % tp_size == 0:
            dims[0] = tp
        if fsdp and a.ndim >= 2 and a.shape[-1] % dp_size == 0:
            dims[-1] = dp
        return PSpec(*dims)

    def moe_expert(a) -> PSpec:
        # Raw stacked experts [*, E, d, f]: expert-parallel on the TP axis.
        dims = [None] * a.ndim
        if tp and a.ndim >= 3 and a.shape[-3] % tp_size == 0:
            dims[-3] = tp
        return PSpec(*dims)

    def generic(a) -> PSpec:
        dims = [None] * a.ndim
        if fsdp and a.ndim >= 2:
            for d in range(a.ndim - 1, -1, -1):
                if a.shape[d] >= dp_size and a.shape[d] % dp_size == 0:
                    dims[d] = dp
                    break
        return PSpec(*dims)

    def walk(node, name: str = "", under_moe: bool = False):
        if isinstance(node, PreparedLinear):
            raise TypeError(
                f"param_specs takes the raw quantized tree (a QuantizedLinear at {name!r} "
                f"here is a PreparedLinear): cut each rank's shard with shard_tree, then "
                f"prepare it on that rank"
            )
        if isinstance(node, QuantizedLinear):
            return quantized(node, name, under_moe)
        if isinstance(node, dict):
            if isinstance(node.get("w"), torch.Tensor):
                out = {"w": dense_w(node["w"], name)}
                for k, v in node.items():
                    if k != "w":
                        out[k] = dense_b(v, name) if isinstance(v, torch.Tensor) else v
                return out
            return {k: walk(v, k, in_moe_subtree(k, under_moe)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            walked = [walk(v, name, under_moe) for v in node]
            return tuple(walked) if isinstance(node, tuple) else walked
        if isinstance(node, torch.Tensor):
            if name == "embed":
                return embed_spec(node)
            if under_moe and name in MOE_EXPERT_NAMES and node.ndim >= 3:
                return moe_expert(node)
            return generic(node)
        return node

    return walk(params)


# ---------------------------------------------------------------------------
# cache_specs
# ---------------------------------------------------------------------------


def cache_specs(cfg, caches: Any, ctx: ShardCtx) -> Any:
    """Specs for the stacked cache trees of ``init_cache``: leaves are
    ``[units, batch, ...]``; the batch dim shards on dp, and with
    ``seq_shard=True`` a long dim 2 (the sequence) on the TP axis."""
    dp_size = ctx.dp_size()
    tp_size = ctx.tp_size()
    dp = ctx.dp() if dp_size > 1 else None
    tp = ctx.tp_axis if tp_size > 1 else None

    def leaf(a) -> PSpec:
        if a.ndim < 2:
            return PSpec()
        dims = [None] * a.ndim
        if dp and a.shape[1] % dp_size == 0 and a.shape[1] >= dp_size:
            dims[1] = dp
        if (ctx.seq_shard and tp and a.ndim >= 3 and a.shape[2] >= _SEQ_SHARD_MIN
                and a.shape[2] % tp_size == 0):
            dims[2] = tp
        return PSpec(*dims)

    return _map_specs(lambda a, _s: leaf(a), caches, caches)


# ---------------------------------------------------------------------------
# to_shardings / shard_tree
# ---------------------------------------------------------------------------


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over every tensor leaf of ``tree`` and the matching
    entry of ``specs`` (a tree of the same structure); ``None`` and other
    non-tensor leaves pass through, and a :class:`QuantizedLinear` node keeps
    its static fields."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_specs(fn, v, s) for v, s in zip(tree, specs)]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, QuantizedLinear):
        return dataclasses.replace(tree, **{
            f: _map_specs(fn, getattr(tree, f), getattr(specs, f))
            for f in ("codes", "scale", "bias", "ascale")})
    if isinstance(tree, PreparedLinear):
        raise TypeError("shard_tree takes the raw quantized tree: prepare each rank's shard")
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):     # a TrainState
        return dataclasses.replace(tree, **{
            f.name: _map_specs(fn, getattr(tree, f.name), getattr(specs, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _spec_leaves(specs, fn):
    """``fn(spec)`` over every :class:`PSpec` of a spec tree."""
    if isinstance(specs, PSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _spec_leaves(v, fn) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        out = [_spec_leaves(v, fn) for v in specs]
        return out if isinstance(specs, list) else tuple(out)
    if isinstance(specs, QuantizedLinear):
        return dataclasses.replace(specs, **{
            f: _spec_leaves(getattr(specs, f), fn) for f in ("codes", "scale", "bias", "ascale")})
    if dataclasses.is_dataclass(specs) and not isinstance(specs, type):   # a TrainState
        return dataclasses.replace(specs, **{
            f.name: _spec_leaves(getattr(specs, f.name), fn) for f in dataclasses.fields(specs)})
    return specs


def _axes_of(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


class Placements(tuple):
    """One leaf's DTensor placements, one per mesh axis, and the ``mesh``
    they refer to: the port's ``NamedSharding`` (a tuple, equal to the bare
    placements)."""

    def __new__(cls, placements, mesh):
        out = super().__new__(cls, placements)
        out.mesh = mesh
        return out


def _spec_of(placements: Placements) -> PSpec:
    """The :class:`PSpec` behind a leaf's placements (its rank: the highest
    sharded dim + 1; trailing replicated dims need no entry)."""
    names = tuple(mesh_axes(placements.mesh))
    dims: dict = {}
    for a, pl in zip(names, placements):
        if pl.is_shard():
            dims.setdefault(pl.dim, []).append(a)
    n = max(dims, default=-1) + 1
    return PSpec(*(None if d not in dims else dims[d][0] if len(dims[d]) == 1
                   else tuple(dims[d]) for d in range(n)))


def shard_leaf(t: torch.Tensor, placements: Placements) -> torch.Tensor:
    """This rank's shard of a whole leaf ``t`` under ``placements``
    (:func:`shard_tree`'s rule)."""
    mesh = placements.mesh
    return _cut(t, _spec_of(placements), mesh_axes(mesh),
                dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())))


def whole_leaf(t: torch.Tensor, placements: Placements) -> torch.Tensor:
    """The whole leaf behind this rank's shard ``t``: all-gathered over every
    axis that shards it, the minor axis first (no autograd)."""
    from repro_torch.dist.runtime import gather

    mesh = placements.mesh
    for a, pl in reversed(list(zip(mesh.mesh_dim_names, placements))):
        if pl.is_shard():
            t = gather(t, pl.dim, mesh.get_group(a))
    return t


def to_shardings(specs: Any, mesh) -> Any:
    """Every :class:`PSpec` of ``specs`` as DTensor placements: a tuple with
    one placement per mesh axis, ``Shard(d)`` where the axis shards dim
    ``d`` and ``Replicate()`` elsewhere (a dim on several axes is split over
    them in the mesh's axis order, major first, as a tuple entry's first
    axis is major).  Each is a :class:`Placements` that carries ``mesh``
    (what ``ckpt.save`` / ``restore(shardings=)`` gather and cut with)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_axes(mesh))

    def conv(spec: PSpec):
        where = {a: d for d, entry in enumerate(spec) for a in _axes_of(entry)}
        unknown = set(where) - set(names)
        if unknown:
            raise ValueError(f"spec {spec} names axes {sorted(unknown)} the mesh lacks: {names}")
        for entry in spec:
            axes = _axes_of(entry)
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        return Placements(tuple(Shard(where[a]) if a in where else Replicate() for a in names),
                          mesh)

    return _spec_leaves(specs, conv)


def shard_tree(tree: Any, specs: Any, ctx: ShardCtx, coords: Optional[dict] = None) -> Any:
    """One rank's local shard of every leaf of ``tree`` under ``specs``
    (contiguous copies; a replicated leaf is returned as it is).

    ``coords`` — ``{axis: index}`` — picks the rank; it defaults to this
    rank's mesh coordinates, so one process can cut any rank's shard (with
    an :class:`AxisMesh` it must be given).  A dim sharded over several axes
    is cut into their product of chunks, indexed row-major over the axes."""
    sizes = mesh_axes(ctx.mesh)
    if coords is None:
        coords = ctx.coords()
    for a, i in coords.items():
        if a in sizes and not 0 <= i < sizes[a]:
            raise ValueError(f"coordinate {a}={i} outside the mesh's {sizes[a]}")
    return _map_specs(lambda t, spec: _cut(t, spec, sizes, coords), tree, specs)


def _cut(t: torch.Tensor, spec: PSpec, sizes: dict, coords: dict) -> torch.Tensor:
    """The shard of ``t`` at ``coords`` under ``spec`` (a contiguous copy)."""
    if len(spec) > t.ndim:
        raise ValueError(f"spec {spec} has more entries than the leaf {tuple(t.shape)}")
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        if not axes:
            continue
        n = math.prod(sizes.get(a, 1) for a in axes)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide into {n} ({spec})")
        step = t.shape[d] // n
        t = t.narrow(d, _row_major(coords, sizes, axes) * step, step)
    return t.contiguous()


@functools.lru_cache(maxsize=8)
def _meta_params(cfg):
    """The dense parameter tree of ``cfg`` on the ``meta`` device: its
    global shapes, nothing allocated."""
    from repro_torch.models.model import Model

    return Model(cfg).init(device="meta")


def global_like(cfg, local: Any) -> Any:
    """A shape-only tree of the *global* leaves behind one rank's ``local``
    shard tree, on the ``meta`` device: the dense shapes come from ``cfg``,
    and a quantized (or prepared) local leaf stands for a
    :class:`QuantizedLinear` of the dense leaf's ``[..., F]`` codes and
    scale (the quantized spec rules read nothing else).  ``param_specs`` of
    it gives the specs the local tree was cut with."""

    def walk(node, dense):
        if isinstance(node, (QuantizedLinear, PreparedLinear)):
            w = dense["w"] if isinstance(dense, dict) else dense   # a leaf or an expert stack
            lead, f = tuple(w.shape[:-2]), w.shape[-1]
            meta = functools.partial(torch.empty, device="meta")
            return QuantizedLinear(
                codes=meta(lead + (f, 1), dtype=torch.uint8), scale=meta(lead + (f,)),
                bias=None if node.bias is None else meta(lead + (f,)), spec=node.spec,
                k=node.k, ascale=None if node.ascale is None else meta(tuple(node.ascale.shape)))
        if isinstance(node, dict):
            return {k: walk(v, dense[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, d) for v, d in zip(node, dense)]
            return out if isinstance(node, list) else tuple(out)
        return dense

    return walk(local, _meta_params(cfg))


def global_codes_shapes(cfg, local: Any, ctx: ShardCtx) -> dict:
    """``{path: codes shape}`` of the global quantized leaves behind one
    rank's ``local`` shard tree (raw or prepared): each local codes dim
    times the sizes of the mesh axes its spec shards it over, the specs
    derived, as :func:`shard_tree` cut them, from the global shapes of
    :func:`global_like`.  What a rank's plan fingerprint is checked
    against (module docstring)."""
    from repro_torch.tune.plan import quantized_leaf_items

    sizes = mesh_axes(ctx.mesh)
    specs = dict(quantized_leaf_items(param_specs(cfg, global_like(cfg, local), ctx)))
    out = {}
    for path, leaf in quantized_leaf_items(local):
        spec = tuple(specs[path].codes)
        out[path] = tuple(
            int(n) * (math.prod(sizes.get(a, 1) for a in _axes_of(spec[d])) if d < len(spec) else 1)
            for d, n in enumerate(leaf.codes.shape))
    return out
