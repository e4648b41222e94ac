"""Device-less dry-run: one rank of every (arch x shape x mesh) cell, traced on
``meta`` over a fake process group (port of ``repro.launch.dryrun``).

For each cell the dry-run:

1. opens a fake world of the mesh's size (256 ranks single-pod, 512
   multi-pod: ``init_process_group("fake")`` from
   ``torch.testing._internal.distributed.fake_pg``, a private module of
   torch; where it is missing the dry-run raises) as one rank, and builds
   ``launch/mesh.make_production_mesh(device="cpu")`` over it
   (:func:`fake_world`);
2. builds that rank's local state on ``meta`` — the W4A4 ``dequant`` tree of
   ``Model.init_quantized`` for prefill / decode cells (dense with
   ``--dense``), ``init_train_state`` for train cells — and cuts it with
   ``dist/sharding.py`` (``param_specs`` / ``train_state_specs``,
   ``shard_tree``), its caches with ``dist/runtime.local_cache``, its inputs
   from :func:`input_specs` (its dp rows);
3. runs the step the reference lowers, on those tensors, under one dispatch
   mode (:class:`Counter`): train ``make_train_step(ctx=, remat=True)``
   (the recomputation is in the count), prefill ``Model.prefill(ctx=)``,
   decode ``Model.decode_step(ctx=)`` and the greedy ``argmax`` (the
   reference's ``make_serve_step``);
4. writes ``runs/dryrun_torch/<mesh>/<arch>__<shape>[__dense][__variant].json``.

It traces rank 0 and the mesh's last rank; the artifact keeps rank 0's
counts and says whether the last rank's argument bytes differ (it does not
average them).  Nothing runs on a device: the counts come from shapes alone,
and ``dist/runtime.py`` and the models carry no recording hooks.

**What is counted** (``full_analysis``, the reference's field names where the
meaning is the same — the values are counts from shapes, not measurements):

* ``flops``: matrix-product FLOPs through ``torch.utils.flop_counter``'s
  registry, an op decomposed as ``FlopCounterMode`` decomposes it.  XLA's ``cost_analysis`` also
  counts elementwise ops, so the two packages' figures differ by those
  (``"flops_counts": "matmul"``).
* ``bytes_accessed``: for every aten op that is not a view, the bytes of its
  distinct tensor inputs plus those of its outputs (an in-place op's
  mutated input once; allocation ops nothing; ``*_like`` / ``new_*``
  factories their outputs).  Nothing is fused, so this is an upper figure,
  where XLA's is counted after fusion (``"bytes_counts": "unfused"``).
* ``argument_size_in_bytes`` / ``output_size_in_bytes``: the rank's local
  parameters (or training state) and caches and inputs; then what the step
  returns (the caches it updates in place again).  A decode's ``pos`` is a
  host int here (a 4-byte argument in the reference).
* ``temp_size_in_bytes``: the peak of live storage that the step's ops
  allocate, tracked as each op's outputs are allocated and released when
  their storage dies.
* ``collective_bytes``: every ``c10d`` op the mode sees, by kind, with the
  reference's ring model (:func:`ring_bytes`, the factors of its
  ``parse_collective_bytes``) over the group size read from the op's
  ``ProcessGroup``; the same bytes by mesh axis (the axes along which the
  group's ranks vary) in ``collective_bytes_by_axis``.
* ``t_trace_s`` stands where the reference has ``t_lower_s`` /
  ``t_compile_s``: host seconds to build and trace the rank, not a speed of
  the system.

**Depth.**  XLA's cost analysis counts a rolled ``lax.scan`` body once, so the
reference compiles depth variants (2 and 3 units a segment) and differences
them.  The port's unit stack is a Python loop (``transformer.run_segments``),
so a full-depth trace counts every unit; ``--cost`` still computes the
reference's ``calibrated`` block from the same variants, as a check that it
equals the full count (``calibrated_equals_full``).

**Recurrences** are the one thing not traced step by step.  The port's Mamba2
and RWKV6 prefills run one eager ``_step`` a position and layer, so a 32768-
position prefill would dispatch tens of millions of ``meta`` ops.  Where a
call is longer than :data:`REC_SHORT`'s lengths (and a whole number of their
steps past the first), ``ssm.ssm_apply`` and ``rwkv.rwkv_time_mix`` are
counted at those three short lengths and the counts carried to the real
length by Newton's forward differences: a forward is affine in its length
(projections, the causal conv, one step a position), and its backward
quadratic (each position's ``select_backward`` materializes a gradient of
the whole length), so three points give both exactly.  The artifact then says
``"recurrence_scaled": true``.  Unlike the reference's rolled scan, whose
state stays in on-chip memory (``repro.flags``), every step's state traffic
is counted as bytes here: on the card the eager step moves its state
through HBM.

**``flags.py`` has no counterpart.**  ``REPRO_COST_UNROLL`` only switches the
reference's ``lax.scan`` sites between rolled and unrolled so that XLA counts
every iteration; the port has no scan, and every loop already runs
unrolled in Python.

Run on the CPU, no card needed::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
    PYTHONPATH=src python -m repro_torch.launch.roofline --markdown
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import time
import traceback
import weakref
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import LutLinearSpec
from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

QUANT_SPEC = LutLinearSpec(bw=4, ba=4, mode="dequant")
RESULTS_DIR = str(pathlib.Path(__file__).resolve().parents[3] / "runs" / "dryrun_torch")

# §Perf variants: config transforms applied on top of the baseline.
VARIANTS = {
    "ring": lambda c: dataclasses.replace(c, ring_window_cache=True),
    "mla-headshard": lambda c: dataclasses.replace(c, mla_prefill_headshard=True),
    "kv-int8": lambda c: dataclasses.replace(c, kv_cache_int8=True),
    "ring+kv-int8": lambda c: dataclasses.replace(
        c, ring_window_cache=True, kv_cache_int8=True
    ),
    "bf16-attend": lambda c: dataclasses.replace(c, attend_bf16=True),
    "gqa-headshard": lambda c: dataclasses.replace(c, gqa_prefill_headshard=True),
    "best-gqa-prefill": lambda c: dataclasses.replace(
        c, gqa_prefill_headshard=True, attend_bf16=True
    ),
    "best-decode": lambda c: dataclasses.replace(
        c, ring_window_cache=True, kv_cache_int8=True, attend_bf16=True
    ),
    "best-prefill": lambda c: dataclasses.replace(
        c, mla_prefill_headshard=True, attend_bf16=True
    ),
}
# weight-bitwidth variants handled via QUANT_SPEC override
BW_VARIANTS = {"w1": 1, "w2": 2, "w8": 8}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

# The short lengths, evenly spaced, a recurrence is counted at (module docstring).
REC_SHORT = (8, 16, 24)


def _scalable(n: int) -> bool:
    """Whether a recurrence of length ``n`` is counted by length scaling."""
    s1, s2, s3 = REC_SHORT
    return n > s3 and (n - s1) % (s2 - s1) == 0


def skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    if shape == "long_500k" and not cfg.subquadratic:
        return (
            "full-attention decoder: 500k-token decode requires sub-quadratic "
            "attention (DESIGN.md §5 skip list)"
        )
    return None


# ---------------------------------------------------------------------------
# Depth knobs for the calibrated costing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DepthKnob:
    name: str
    n_real: int                   # real unit count of this segment
    set_k: Callable               # (cfg, k) -> cfg with this segment at k units


def depth_knobs(cfg: ModelConfig) -> list[DepthKnob]:
    knobs = []
    if cfg.layer_pattern:
        period = len(cfg.layer_pattern)
        n_units, rem = divmod(cfg.n_layers, period)
        knobs.append(
            DepthKnob(
                "stack", n_units,
                lambda c, k, p=period, r=rem: dataclasses.replace(c, n_layers=p * k + r),
            )
        )
    elif cfg.moe is not None and cfg.first_dense_layers:
        fd = cfg.first_dense_layers
        knobs.append(
            DepthKnob(
                "stack", cfg.n_layers - fd,
                lambda c, k, f=fd: dataclasses.replace(c, n_layers=f + k),
            )
        )
    else:
        knobs.append(
            DepthKnob(
                "stack", cfg.n_layers,
                lambda c, k: dataclasses.replace(c, n_layers=k),
            )
        )
    if cfg.is_encdec:
        knobs.append(
            DepthKnob(
                "encoder", cfg.encoder_layers,
                lambda c, k: dataclasses.replace(c, encoder_layers=k),
            )
        )
    return knobs


def with_knobs(cfg: ModelConfig, ks: dict) -> ModelConfig:
    for knob in depth_knobs(cfg):
        cfg = knob.set_k(cfg, ks.get(knob.name, 2))
    return cfg


# ---------------------------------------------------------------------------
# Inputs and the sharding context
# ---------------------------------------------------------------------------


def _input_shapes(cfg: ModelConfig, kind: str, batch: int, seq: int) -> dict:
    """``{name: (shape, dtype)}`` of a ``kind`` step's inputs over ``batch`` x
    ``seq`` (a decode's ``pos`` apart: a host int in the port)."""
    if kind == "decode":
        return {"tokens": ((batch, 1), torch.int32)}
    text = seq
    if cfg.frontend is not None and not cfg.is_encdec:
        text = seq - cfg.frontend_seq       # image positions count toward seq
    out = {"tokens": ((batch, text + 1 if kind == "train" else text), torch.int32)}
    if cfg.frontend is not None:
        out["prefix_embeds"] = ((batch, cfg.frontend_seq, cfg.frontend_dim), torch.float32)
    return out


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """The step's global inputs as ``meta`` tensors (shape and dtype, nothing
    allocated): the reference's ``ShapeDtypeStruct`` stand-ins."""
    sh = SHAPES[shape_name]
    out = {name: torch.empty(shape, dtype=dtype, device="meta")
           for name, (shape, dtype) in _input_shapes(cfg, sh["kind"], sh["batch"],
                                                      sh["seq"]).items()}
    if sh["kind"] == "decode":
        out["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return out


def make_ctx(mesh, shape_name: str, kind: str):
    from repro_torch.dist.sharding import ShardCtx, mesh_axes

    dp_axes = tuple(a for a in mesh_axes(mesh) if a != "model")
    return ShardCtx(
        mesh=mesh,
        dp_axes=dp_axes,
        tp_axis="model",
        fsdp=(kind == "train"),
        seq_shard=(shape_name == "long_500k"),
    )


# ---------------------------------------------------------------------------
# Collective bytes (ring model, group-size aware)
# ---------------------------------------------------------------------------


def ring_bytes(kind: str, size: float, g: int) -> float:
    """Per-rank traffic of one collective whose result is ``size`` bytes over
    a group of ``g`` ranks: the reference's ring model
    (``parse_collective_bytes``), factor for factor."""
    if kind == "collective-permute":
        factor = 1.0            # pairwise; no replica_groups attribute
    elif g <= 1:
        factor = 0.0
    elif kind == "all-reduce":
        factor = 2.0 * (g - 1) / g
    elif kind == "all-gather":
        factor = (g - 1) / g
    elif kind == "reduce-scatter":
        factor = float(g - 1)       # result is the scattered piece
    elif kind == "all-to-all":
        factor = (g - 1) / g
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    return size * factor


# c10d op -> collective kind.  The op's first argument holds its result (the
# gathered or scattered tensors, the reduced ones, the ones sent).
_C10D_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
_C10D_FREE = frozenset({"recv_", "recv_any_source_", "barrier", "monitored_barrier_"})

# Allocation ops move no bytes; ``*_like`` / ``new_*`` factories write only
# their outputs.
_ALLOC = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"})


def _flat_tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat_tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensor_bytes(*trees) -> int:
    """The bytes of every distinct tensor leaf of ``trees`` (dicts, lists,
    tuples, dataclass nodes such as a ``QuantizedLinear`` or a
    ``TrainState``)."""
    seen, total = set(), 0
    for t in tree.tensors(list(trees)):
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------


def _axes_of_ranks(ranks: list, shape: tuple, names: tuple) -> str:
    """The mesh axes along which ``ranks`` (row-major over ``shape``) vary,
    joined by ``+`` ("world" without a mesh)."""
    if not names:
        return "world"
    coords = []
    for r in ranks:
        c = []
        for n in reversed(shape):
            c.append(r % n)
            r //= n
        coords.append(tuple(reversed(c)))
    varying = [a for i, a in enumerate(names) if len({c[i] for c in coords}) > 1]
    return "+".join(varying) if varying else "none"


_VIEW, _COMPOSITE, _C10D, _OP = range(4)


def _meta_key(x):
    """A hashable key of an op argument's metadata; ``None`` where the op's
    output could depend on more than metadata (a tensor off ``meta``, a
    generator)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            return None
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        keys = tuple(_meta_key(y) for y in x)
        return None if any(k is None for k in keys) else (type(x), keys)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.device,
                                   torch.memory_format, torch.layout)):
        return (type(x), x)             # 1, 1.0 and True give other outputs
    return None


class Counter(TorchDispatchMode):
    """Counts one traced step (module docstring): FLOPs, unfused bytes, the
    peak of live intermediate storage and collective bytes by kind and mesh
    axis.  ``mesh``: the ``DeviceMesh`` whose axes name the groups (``None``:
    one rank).

    An op with a ``CompositeImplicitAutograd`` kernel is decomposed and its
    parts counted, as ``torch.utils.flop_counter.FlopCounterMode`` does, so
    the FLOPs are that mode's.  A ``meta`` op whose output depends only on
    its arguments' metadata runs once per distinct metadata; later calls get
    fresh tensors of the recorded shapes (shape inference on ``meta`` is the
    trace's cost)."""

    def __init__(self, mesh=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self._mesh = ((tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names))
                      if mesh is not None else ((), ()))
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll: dict = {}        # (kind, axes, group size) -> result bytes
        self.peak = 0
        self.outputs = 0            # bytes of what the step returned
        self._groups: dict = {}     # id(ProcessGroup) -> (size, axes)
        self._live: dict = {}       # storage address -> bytes, while it lives
        self._live_bytes = 0
        self._paused = 0
        self._kinds: dict = {}      # op -> _VIEW | _COMPOSITE | _C10D | _OP
        self._shapes: dict = {}     # (op, argument metadata) -> output metadata

    @contextlib.contextmanager
    def paused(self):
        """Ops run but are not counted (the counter's own bookkeeping)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # --- dispatch -------------------------------------------------------------

    def _kind(self, func) -> int:
        if func.namespace == "c10d":
            return _C10D
        if func.is_view or func._overloadpacket.__name__ == "_unsafe_view":
            return _VIEW        # shares its input's storage: no bytes, nothing allocated
        if func is not torch.ops.prim.device.default and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            return _COMPOSITE
        return _OP

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = self._kind(func)
        if kind == _VIEW:
            return func(*args, **kwargs)
        if kind == _COMPOSITE:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if kind == _C10D:
            out = func(*args, **kwargs)
            if not self._paused:
                self._collective(func, args)
            return out
        out = self._run(func, args, kwargs)
        if self._paused:
            return out
        ins = {id(t): t for t in _flat_tensors(list(kwargs.values()), _flat_tensors(args, []))}
        # An in-place op returns its input: counted once, as an input.
        outs = [t for t in _flat_tensors(out, []) if id(t) not in ins]
        if not any(t.device.type == "meta" for t in (*ins.values(), *outs)):
            return out          # host work on the CPU (a constant rounded once and cached)
        self.ops += 1
        packet = func._overloadpacket
        if packet in self._registry:
            self.flops += int(self._registry[packet](*args, **kwargs, out_val=out))
        name = packet.__name__
        if name in _ALLOC:
            nbytes = 0
        elif name.endswith("_like") or name.startswith("new_"):
            nbytes = sum(_nbytes(t) for t in outs)
        else:
            nbytes = sum(_nbytes(t) for t in ins.values()) + sum(_nbytes(t) for t in outs)
        self.bytes += nbytes
        for t in outs:
            self._alloc(t)
        return out

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``, or fresh ``meta`` tensors of the shapes it
        gave for the same argument metadata (a functional op only)."""
        if func._schema.is_mutable:
            return func(*args, **kwargs)
        key = _meta_key((args, tuple(sorted(kwargs.items()))))
        if key is None:
            return func(*args, **kwargs)
        key = (func, key)
        spec = self._shapes.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self._shapes[key] = (
                (type(out) if isinstance(out, (tuple, list)) else None,
                 tuple((tuple(t.shape), t.stride(), t.dtype) for t in outs))
                if all(isinstance(t, torch.Tensor) for t in outs) else False)
            return out
        if spec is False:
            return func(*args, **kwargs)
        seq, metas = spec
        outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                for shape, stride, dtype in metas]
        return outs[0] if seq is None else seq(outs)

    def _collective(self, func, args):
        name = func._overloadpacket.__name__
        if name in _C10D_FREE:
            return
        if name not in _C10D_KIND:
            raise NotImplementedError(f"the dry-run has no ring model for c10d.{name}")
        kind = _C10D_KIND[name]
        pg = next(a for a in args if isinstance(a, torch.ScriptObject)
                  and "ProcessGroup" in str(a._type()))
        size, axes = self._group(pg)
        key = (kind, axes, size)
        self.coll[key] = self.coll.get(key, 0) + sum(
            _nbytes(t) for t in _flat_tensors(args[0], []))

    def _group(self, script_pg):
        import torch.distributed as dist

        pg = torch._C._distributed_c10d.ProcessGroup.unbox(script_pg)
        if id(pg) not in self._groups:
            shape, names = self._mesh
            self._groups[id(pg)] = (pg.size(), _axes_of_ranks(
                dist.get_process_group_ranks(pg), shape, names))
        return self._groups[id(pg)]

    # --- live storage -----------------------------------------------------------

    def _alloc(self, t: torch.Tensor) -> None:
        """Counts ``t``'s storage as live until it dies.  A storage's Python
        object lives as long as the storage does (views, autograd's saved
        tensors), so a finalizer on it marks the exact moment."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        self.peak = max(self.peak, self._live_bytes)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key) -> None:
        self._live_bytes -= self._live.pop(key)

    # --- scaled recurrences -----------------------------------------------------

    def _snapshot(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "coll": dict(self.coll)}

    def _restore(self, snap: dict) -> None:
        self.flops, self.bytes, self.ops = snap["flops"], snap["bytes"], snap["ops"]
        self.coll = dict(snap["coll"])

    def _measure(self, fn) -> tuple[dict, int]:
        """The counts ``fn()`` adds, and the peak of live bytes above those at
        its start; the counter is left as it was."""
        start = self._snapshot()
        live0, peak0 = self._live_bytes, self.peak
        self.peak = live0
        fn()
        end, rise = self._snapshot(), self.peak - live0
        self._restore(start)
        self.peak = peak0
        return {"flops": end["flops"] - start["flops"], "bytes": end["bytes"] - start["bytes"],
                "ops": end["ops"] - start["ops"],
                "coll": {k: end["coll"].get(k, 0) - start["coll"].get(k, 0)
                         for k in end["coll"]}}, rise

    def _add_scaled(self, runs: list, n: int) -> None:
        """Adds the counts of a call of length ``n`` from ``runs``, the counts
        and peak rises at the lengths :data:`REC_SHORT`: Newton's forward
        differences, exact for counts quadratic in the length (a backward
        through the per-position loop materializes a whole-length gradient a
        position)."""
        s1, s2, _s3 = REC_SHORT
        k = (n - s1) // (s2 - s1)           # a whole number: _scalable(n)

        def at_n(f1, f2, f3):
            return f1 + k * (f2 - f1) + k * (k - 1) // 2 * (f3 - 2 * f2 + f1)

        (d1, r1), (d2, r2), (d3, r3) = runs
        self.flops += at_n(d1["flops"], d2["flops"], d3["flops"])
        self.bytes += at_n(d1["bytes"], d2["bytes"], d3["bytes"])
        self.ops += at_n(d1["ops"], d2["ops"], d3["ops"])
        for key in set(d1["coll"]) | set(d2["coll"]) | set(d3["coll"]):
            self.coll[key] = self.coll.get(key, 0) + at_n(
                *(d["coll"].get(key, 0) for d in (d1, d2, d3)))
        self.peak = max(self.peak, self._live_bytes + at_n(r1, r2, r3))

    def scaled_forward(self, fn, x: torch.Tensor, n: int) -> torch.Tensor:
        """``fn(x)`` for an ``x`` of length ``n`` (dim 1), counted at the short
        lengths and scaled; returns a placeholder of the output's shape."""
        runs, y_short = [], None
        for m in REC_SHORT:
            with self.paused():
                xs = x[:, :m].contiguous()

            def call():
                nonlocal y_short
                y_short = fn(xs)

            runs.append(self._measure(call))
        self._add_scaled(runs, n)
        with self.paused():
            y = y_short.new_empty((y_short.shape[0], n) + tuple(y_short.shape[2:]))
        del y_short
        self._alloc(y)
        return y

    def scaled_backward(self, fn, rebuild, x, leaves, g, n) -> list:
        """The backward of a scaled call: at each short length the forward is
        rebuilt uncounted and ``autograd.grad`` counted; returns placeholder
        gradients for ``x`` and ``leaves``."""
        runs = []
        wants = [x.requires_grad] + [t.requires_grad for t in leaves]
        for m in REC_SHORT:
            with self.paused(), torch.enable_grad():
                xs = x[:, :m].detach().contiguous().requires_grad_(x.requires_grad)
                ls = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
                ys = fn(rebuild(ls), xs)
                gs = g[:, :m].contiguous()
            inputs = [t for t, w in zip([xs] + ls, wants) if w]
            runs.append(self._measure(
                lambda: torch.autograd.grad(ys, inputs, gs, allow_unused=True)))
            del ys, xs, ls, gs, inputs
        self._add_scaled(runs, n)
        out = []
        with self.paused():
            for t, w in zip([x] + list(leaves), wants):
                out.append(torch.empty_like(t) if w else None)
        for t in out:
            if t is not None:
                self._alloc(t)
        return out

    # --- result -----------------------------------------------------------------

    def analysis(self) -> dict:
        by_kind = {k: 0.0 for k in COLLECTIVE_KINDS}
        by_axis: dict = {}
        groups: dict = {}
        for (kind, axes, g), size in sorted(self.coll.items()):
            b = ring_bytes(kind, size, g)
            by_kind[kind] += b
            by_axis[axes] = by_axis.get(axes, 0.0) + b
            groups[axes] = g
        return {
            "flops": float(self.flops),
            "flops_counts": "matmul",
            "bytes_accessed": float(self.bytes),
            "bytes_counts": "unfused",
            "temp_size_in_bytes": int(self.peak),
            "collective_bytes": by_kind,
            "collective_bytes_by_axis": by_axis,
            "collective_group_sizes": groups,
            "output_size_in_bytes": self.outputs,
            "ops_counted": self.ops,
        }


def _replace_tensors(node, it):
    """``node`` with its tensor leaves taken from the iterator ``it`` in the
    order :func:`_leaf_tensors` lists them."""
    if isinstance(node, torch.Tensor):
        return next(it)
    if isinstance(node, dict):
        return {k: _replace_tensors(v, it) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        out = [_replace_tensors(v, it) for v in node]
        return out if isinstance(node, list) else tuple(out)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: _replace_tensors(getattr(node, f.name), it)
            for f in dataclasses.fields(node) if f.init})
    return node


def _leaf_tensors(node, out: list) -> list:
    if isinstance(node, torch.Tensor):
        out.append(node)
    elif isinstance(node, dict):
        for v in node.values():
            _leaf_tensors(v, out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _leaf_tensors(v, out)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            if f.init:
                _leaf_tensors(getattr(node, f.name), out)
    return out


class _ScaledCall(torch.autograd.Function):
    """A scaled recurrence under autograd: the forward and the backward are
    each counted at :data:`REC_SHORT` and scaled (:class:`Counter`)."""

    @staticmethod
    def forward(ctx, info, x, *leaves):
        counter, fn, p, n = info
        ctx.info = info
        ctx.save_for_backward(x, *leaves)
        return counter.scaled_forward(lambda xs: fn(_rebuild(p, leaves), xs), x, n)

    @staticmethod
    def backward(ctx, g):
        counter, fn, p, n = ctx.info
        x, *leaves = ctx.saved_tensors
        grads = counter.scaled_backward(fn, lambda ls: _rebuild(p, ls), x, leaves, g, n)
        return (None, *grads)


def _rebuild(p, leaves):
    return _replace_tensors(p, iter(leaves))


def _skip_linear():
    """A linear leaf that returns its input (``layers.linear`` applies a
    ``ShardedLinear`` through its ``apply``)."""
    from repro_torch.dist.runtime import ShardedLinear

    class _Skip(ShardedLinear):
        def apply(self, x, linear):
            return x

    return _Skip(inner=None, run=None)


def _scaled(orig, last: str, counter: Counter):
    """``orig(p, x, cfg, state, **kw) -> (y, state)``, whose last op is the
    projection ``p[last]``, counted at the short lengths and scaled where ``x``
    is longer (module docstring).  The last projection runs whole on the
    scaled output: under ``remat`` a checkpoint's recomputation stops before
    the op whose inputs are the last tensors it saves — that projection, in a
    unit that ends with it — and so it does here too."""
    from repro_torch.models.layers import linear

    skip = _skip_linear()

    def call(p, x, cfg, state=None, **kw):
        n = x.shape[1]
        if not _scalable(n):
            return orig(p, x, cfg, state, **kw)
        core = {**p, last: skip}

        def fn(p_, xs):
            return orig(p_, xs, cfg, state, **kw)[0]

        leaves = _leaf_tensors(core, [])
        if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
            y = _ScaledCall.apply((counter, fn, core, n), x, *leaves)
        else:
            y = counter.scaled_forward(lambda xs: fn(core, xs), x, n)
        return linear(p[last], y), state

    return call


@contextlib.contextmanager
def scaled_recurrences(counter: Counter):
    """``ssm.ssm_apply`` and ``rwkv.rwkv_time_mix`` counted by length
    scaling while the block runs (the models' own functions are put back
    after)."""
    from repro_torch.models import rwkv, ssm

    sites = [(ssm, "ssm_apply", "out_proj"), (rwkv, "rwkv_time_mix", "wo")]
    orig = [getattr(mod, name) for mod, name, _last in sites]
    try:
        for (mod, name, last), f in zip(sites, orig):
            setattr(mod, name, _scaled(f, last, counter))
        yield
    finally:
        for (mod, name, _last), f in zip(sites, orig):
            setattr(mod, name, f)


# ---------------------------------------------------------------------------
# One rank's step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One rank's step: its model, local state, caches and inputs."""

    kind: str                       # "train" | "prefill" | "decode"
    model: Any
    state: Any                      # params tree, or a TrainState (train)
    inputs: dict                    # tokens [, prefix_embeds] — the rank's rows
    caches: Any = None
    max_seq: Optional[int] = None
    pos: Optional[int] = None       # a decode's write offset (a host int)
    ctx: Any = None

    def args(self) -> tuple:
        """What the step receives."""
        return (self.state, self.caches, self.inputs)

    def step(self):
        """The reference's step for this kind, once; returns its outputs."""
        from repro_torch.train import optimizer as opt
        from repro_torch.train import train_step as ts

        model, ctx = self.model, self.ctx
        if self.kind == "train":
            return ts.make_train_step(model, opt.AdamWConfig(), ctx=ctx, remat=True)(
                self.state, dict(self.inputs))
        with torch.no_grad():
            if self.kind == "prefill":
                return model.prefill(self.state, self.inputs["tokens"], self.caches,
                                     prefix_embeds=self.inputs.get("prefix_embeds"), ctx=ctx,
                                     max_seq=self.max_seq)
            logits, caches = model.decode_step(self.state, self.inputs["tokens"], self.caches,
                                               self.pos, ctx=ctx, max_seq=self.max_seq)
            nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
            return nxt, caches


def build_cell(cfg: ModelConfig, kind: str, batch: int, seq: int, *, ctx=None,
               device="meta", quantized: bool = True, quant_spec: LutLinearSpec = QUANT_SPEC,
               seed: int = 0) -> Cell:
    """One rank's state, caches and inputs for a ``kind`` step over ``batch``
    x ``seq`` (the reference's cell layout: a prefill's and a decode's caches
    hold ``seq`` positions, a decode writes at ``seq - 1``; a VLM's patches
    count toward ``seq``).  On ``meta`` the inputs are shapes; on a device
    they are drawn from ``seed``.  With ``ctx`` (a mesh) the state is cut with
    ``shard_tree`` and the caches with ``local_cache``."""
    from repro_torch import devices
    from repro_torch.dist import runtime
    from repro_torch.dist.sharding import param_specs, shard_tree
    from repro_torch.models.model import Model
    from repro_torch.train import train_step as ts

    dev = devices.resolve(device)
    model = Model(cfg)
    sharded = runtime.active(ctx)
    if kind == "train":
        state = ts.init_train_state(model, seed, device=dev)
        if sharded:
            state = shard_tree(state, ts.train_state_specs(cfg, ctx), ctx)
    else:
        state = (model.init_quantized(quant_spec, seed, device=dev) if quantized
                 else model.init(seed, device=dev))
        if sharded:
            state = shard_tree(state, param_specs(cfg, state, ctx), ctx)
    # The rank's dp share of the rows where dp divides the batch, else all of
    # them (the reference's replicated ``P()`` inputs).
    dp = ctx.dp_size() if sharded else 1
    rows = batch // dp if batch % dp == 0 else batch
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, dtype):
        if gen is None:
            return torch.empty(shape, dtype=dtype, device=dev)
        if dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev,
                                 dtype=dtype)
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    inputs = {name: draw(shape, dtype)
              for name, (shape, dtype) in _input_shapes(cfg, kind, rows, seq).items()}
    caches = None
    if kind != "train":
        caches = (runtime.local_cache(cfg, batch, seq, torch.bfloat16, ctx, dev) if sharded
                  else model.init_cache(batch, seq, torch.bfloat16, device=dev))
    return Cell(kind=kind, model=model, state=state, inputs=inputs, caches=caches,
                max_seq=None if kind == "train" else seq,
                pos=seq - 1 if kind == "decode" else None, ctx=ctx)


def _count(cell: Cell, scale_recurrences: bool = True) -> Counter:
    """A :class:`Counter` after ``cell``'s step ran once under it.  What a
    step caches on its first use in a process — a sharded call's spec
    derivations (``global_like``'s ``meta`` tree, the sequence layout), the
    per-device decode tables of the quantized leaves — is made before: it is
    work once per process, not part of the step."""
    from repro_torch.dist import runtime

    sharded = runtime.active(cell.ctx)
    params = cell.state.params if cell.kind == "train" else cell.state
    if sharded:
        run = runtime.ShardedRun(cell.model.cfg, params, cell.ctx)
        if cell.caches is not None:
            run.cache_seq(cell.caches, cell.max_seq)
    _warm_decode_tables(params)
    counter = Counter(cell.ctx.mesh if sharded else None)
    scaled = scaled_recurrences(counter) if scale_recurrences else contextlib.nullcontext()
    with counter, scaled:
        counter.outputs = tensor_bytes(cell.step())
    return counter


def _warm_decode_tables(params) -> None:
    """Decodes a one-row leaf of each quantized spec in ``params`` on its
    device, so the decode tables a step uploads once per process exist."""
    from repro_torch.core import QuantizedLinear
    from repro_torch.models.layers import decode_weight

    specs = set()
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, QuantizedLinear):
            specs.add((node.spec, node.codes.device))
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    for spec, device in specs:
        decode_weight(QuantizedLinear(
            codes=torch.zeros((1, 1), dtype=torch.uint8, device=device),
            scale=torch.zeros((1,), device=device), bias=None, spec=spec, k=1))


def count_step(cell: Cell, *, scale_recurrences: bool = True) -> dict:
    """Runs ``cell``'s step once under a :class:`Counter`; returns its
    ``full_analysis`` (module docstring)."""
    full = _count(cell, scale_recurrences).analysis()
    full["argument_size_in_bytes"] = tensor_bytes(*cell.args())
    full["recurrence_scaled"] = scale_recurrences and _has_scaled_recurrence(cell)
    return full


def _has_scaled_recurrence(cell: Cell) -> bool:
    from repro_torch.models import transformer

    n = cell.inputs["tokens"].shape[1] - (cell.kind == "train")
    return (bool(transformer.unit_kinds(cell.model.cfg) & transformer.RECURRENT_UNITS)
            and _scalable(n))


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake default process group of ``world_size`` ranks, this process
    being ``rank``: collectives dispatch (and are counted) but move nothing.
    Raises where a default group already exists; always destroyed on exit."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "the dry-run opens its own fake world, and a default process group already "
            "exists in this process: run it in a process of its own"
        )
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the dry-run needs torch.testing._internal.distributed.fake_pg (a private "
            f"module of torch), which this torch {torch.__version__} lacks: {e}"
        ) from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world_size(mesh_kind: str) -> int:
    return 512 if mesh_kind == "multi" else 256


# ---------------------------------------------------------------------------
# The calibrated (depth-differenced) count
# ---------------------------------------------------------------------------


def _calibrated_fields(a: Counter, variants: dict, knobs: list) -> dict:
    def scale(get):
        total = get(a)
        for knob in knobs:
            total += (knob.n_real - 2) * max(get(variants[knob.name]) - get(a), 0)
        return total

    keys = set(a.coll).union(*(v.coll for v in variants.values()))
    coll = {k: scale(lambda c, k=k: c.coll.get(k, 0)) for k in keys}
    by_kind = {k: 0.0 for k in COLLECTIVE_KINDS}
    for (kind, _axes, g), size in sorted(coll.items()):
        by_kind[kind] += ring_bytes(kind, size, g)
    return {"flops": float(scale(lambda c: c.flops)),
            "bytes_accessed": float(scale(lambda c: c.bytes)),
            "collective_bytes": by_kind}


def calibrated_costs(cfg: ModelConfig, kind: str, batch: int, seq: int, *, ctx=None,
                     quantized: bool = True, quant_spec: LutLinearSpec = QUANT_SPEC,
                     full: Optional[dict] = None) -> dict:
    """The reference's depth-differenced count (every segment at k = 2, then
    each at k = 3: ``total = cost(A) + Σ_s (n_s − 2) · (cost(B_s) − cost(A))``)
    from traces of the cut configs of a ``kind`` step over ``batch`` x
    ``seq``; ``full`` (the full-depth ``full_analysis``) adds
    ``calibrated_equals_full``, field by field."""

    def counted(c):
        return _count(build_cell(c, kind, batch, seq, ctx=ctx, quantized=quantized,
                                 quant_spec=quant_spec))

    knobs = depth_knobs(cfg)
    t0 = time.perf_counter()
    a = counted(with_knobs(cfg, {}))
    variants = {knob.name: counted(with_knobs(cfg, {knob.name: 3})) for knob in knobs}
    out = _calibrated_fields(a, variants, knobs)
    out["per_unit"] = {knob.name: {"n_real": knob.n_real,
                                   "flops": float(max(variants[knob.name].flops - a.flops, 0))}
                       for knob in knobs}
    out["base_meta"] = {"t_trace_s": round(time.perf_counter() - t0, 3)}
    if full is not None:
        out["calibrated_equals_full"] = {
            k: out[k] == full[k] for k in ("flops", "bytes_accessed", "collective_bytes")}
    return out


# ---------------------------------------------------------------------------
# Running cells
# ---------------------------------------------------------------------------


def _cell_config(arch: str, variant: str):
    """``(cfg, quant_spec)`` of a cell: the published config, and a variant's
    transform or weight bit width."""
    cfg, quant_spec = get_config(arch), QUANT_SPEC
    if variant in VARIANTS:
        cfg = VARIANTS[variant](cfg)
    elif variant in BW_VARIANTS:
        quant_spec = dataclasses.replace(QUANT_SPEC, bw=BW_VARIANTS[variant])
    elif variant:
        raise KeyError(f"unknown variant {variant}")
    return cfg, quant_spec


def trace_rank(arch: str, shape_name: str, mesh_kind: str, rank: int, *, do_cost: bool = False,
               quantized: bool = True, variant: str = "") -> dict:
    """One rank of a cell, traced in a fake world of its own: its
    ``full_analysis``, ``t_trace_s``, mesh coordinates and mesh, and with
    ``do_cost`` the ``calibrated`` count."""
    from repro_torch.launch.mesh import make_production_mesh

    cfg, quant_spec = _cell_config(arch, variant)
    sh = SHAPES[shape_name]
    with fake_world(_world_size(mesh_kind), rank):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="cpu")
        ctx = make_ctx(mesh, shape_name, sh["kind"])
        t0 = time.perf_counter()
        full = count_step(build_cell(cfg, sh["kind"], sh["batch"], sh["seq"], ctx=ctx,
                                     quantized=quantized, quant_spec=quant_spec))
        out = {"full_analysis": full, "t_trace_s": round(time.perf_counter() - t0, 3),
               "coords": list(mesh.get_coordinate()), "mesh_shape": list(mesh.mesh.shape),
               "mesh_axes": list(mesh.mesh_dim_names)}
        if do_cost:
            out["calibrated"] = calibrated_costs(
                cfg, sh["kind"], sh["batch"], sh["seq"], ctx=ctx, quantized=quantized,
                quant_spec=quant_spec, full=full)
    return out


def _trace_unit(unit: tuple) -> dict:
    """:func:`trace_rank` of one ``(arch, shape, mesh, rank, do_cost,
    quantized, variant)`` unit; a failure comes back as its error and the
    tail of its traceback."""
    arch, shape_name, mesh_kind, rank, do_cost, quantized, variant = unit
    try:
        return trace_rank(arch, shape_name, mesh_kind, rank, do_cost=do_cost,
                          quantized=quantized, variant=variant)
    except Exception as e:
        return {"error": repr(e), "traceback": traceback.format_exc()[-4000:]}


def _record(arch: str, shape_name: str, mesh_kind: str, quantized: bool, variant: str) -> dict:
    cfg, _ = _cell_config(arch, variant)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "variant": variant,
        "quantized": quantized and SHAPES[shape_name]["kind"] != "train",
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    reason = skip_reason(cfg, shape_name)
    if reason:
        rec["status"] = "skipped"
        rec["skip_reason"] = reason
    return rec


def _finish(rec: dict, first: dict, last: dict, world: int) -> None:
    """``rec`` from its rank-0 and last-rank traces."""
    for r in (first, last):
        if "error" in r:
            rec.update(status="failed", error=r["error"], traceback=r["traceback"])
            return
    full = first["full_analysis"]
    rec.update({k: first[k] for k in ("t_trace_s", "mesh_shape", "mesh_axes")})
    rec["world_size"] = world
    rec["rank"] = 0
    rec["coords"] = first["coords"]
    rec["full_analysis"] = full
    if "calibrated" in first:
        rec["calibrated"] = first["calibrated"]
    rec["recurrence_scaled"] = full["recurrence_scaled"]
    rec["last_rank"] = {"rank": world - 1, "coords": last["coords"], "t_trace_s": last["t_trace_s"],
                        **{k: last["full_analysis"][k] for k in (
                            "argument_size_in_bytes", "output_size_in_bytes", "flops",
                            "bytes_accessed", "temp_size_in_bytes", "collective_bytes")}}
    rec["argument_bytes_differ"] = (last["full_analysis"]["argument_size_in_bytes"]
                                    != full["argument_size_in_bytes"])
    rec["status"] = "traced"


def run_cells(cells: list, *, do_cost: bool = False, results_dir: str = RESULTS_DIR,
              jobs: int = 1, on_done: Optional[Callable] = None) -> list:
    """Trace rank 0 and the last rank of each ``(arch, shape, mesh, quantized,
    variant)`` cell, each rank in a fake world of its own, and write each
    cell's artifact (``on_done(rec)`` as each is written).  ``jobs > 1``
    traces that many ranks at a time in spawned processes.  Refuses to run
    where this process has a default process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "the dry-run opens fake worlds of 256 / 512 ranks; this process already has a "
            "default process group"
        )
    recs, units = [], []
    for i, (arch, shape_name, mesh_kind, quantized, variant) in enumerate(cells):
        recs.append(_record(arch, shape_name, mesh_kind, quantized, variant))
        if recs[-1].get("status") == "skipped":
            _save(recs[-1], results_dir)
            if on_done:
                on_done(recs[-1])
            continue
        last = _world_size(mesh_kind) - 1
        for rank in (0, last):
            units.append((i, (arch, shape_name, mesh_kind, rank,
                              do_cost and rank == 0 and mesh_kind == "single", quantized,
                              variant)))
    done: dict = {}

    def land(i: int, rank: int, result: dict) -> None:
        done.setdefault(i, {})[rank] = result
        if len(done[i]) == 2:
            world = _world_size(recs[i]["mesh"])
            _finish(recs[i], done[i][0], done[i][world - 1], world)
            _save(recs[i], results_dir)
            if on_done:
                on_done(recs[i])

    if jobs <= 1:
        for i, unit in units:
            land(i, unit[3], _trace_unit(unit))
        return recs
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {pool.submit(_trace_unit, unit): (i, unit[3]) for i, unit in units}
        for fut in concurrent.futures.as_completed(futures):
            land(*futures[fut], fut.result())
    return recs


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, do_cost: bool,
             quantized: bool = True, results_dir: str = RESULTS_DIR,
             variant: str = "") -> dict:
    """:func:`run_cells` of one cell, in this process."""
    return run_cells([(arch, shape_name, mesh_kind, quantized, variant)], do_cost=do_cost,
                     results_dir=results_dir)[0]


def artifact_path(results_dir: str, mesh_kind: str, arch: str, shape_name: str, *,
                  quantized: bool = True, variant: str = "") -> str:
    suffix = "" if quantized or shape_name == "train_4k" else "__dense"
    if variant:
        suffix += f"__{variant}"
    return os.path.join(results_dir, mesh_kind, f"{arch}__{shape_name}{suffix}.json")


def _save(rec: dict, results_dir: str) -> dict:
    path = artifact_path(results_dir, rec["mesh"], rec["arch"], rec["shape"],
                         quantized=rec.get("quantized", True), variant=rec.get("variant", ""))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    rec["_path"] = path
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--cost", action="store_true",
                    help="also compute the depth-differenced count (a check: it equals the "
                         "full-depth trace)")
    ap.add_argument("--dense", action="store_true", help="serve cells without quantization")
    ap.add_argument("--variant", default="", help="perf variant: " + ",".join(
        list(VARIANTS) + list(BW_VARIANTS)))
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="ranks traced at a time, each in a spawned process")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    t_all = time.perf_counter()
    quant = not args.dense
    cells = []
    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in meshes:
                path = artifact_path(args.results_dir, mesh_kind, arch, shape_name,
                                     quantized=quant, variant=args.variant)
                if args.skip_done and os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("traced", "skipped") and (
                        not args.cost
                        or mesh_kind != "single"
                        or "calibrated" in prev
                        or prev.get("status") == "skipped"
                    ):
                        print(f"[skip-done] {arch} {shape_name} {mesh_kind}")
                        continue
                cells.append((arch, shape_name, mesh_kind, quant, args.variant))

    def report(rec):
        secs = rec.get("t_trace_s", 0.0) + rec.get("last_rank", {}).get("t_trace_s", 0.0)
        print(f"[{rec['status']:8s}] {rec['arch']:28s} {rec['shape']:12s} {rec['mesh']:6s}"
              f" ({secs:6.1f}s) {rec.get('skip_reason', rec.get('error', ''))[:80]}",
              flush=True)

    run_cells(cells, do_cost=args.cost, results_dir=args.results_dir, jobs=args.jobs,
              on_done=report)
    print(f"dry-run host time: {time.perf_counter() - t_all:.1f} s ({args.jobs} jobs)")


if __name__ == "__main__":
    main()
