"""Versioned, JSON-serializable whole-model execution plans (port of
``repro.tune.plan``).

A :class:`ModelPlan` is the autotuner's compiled artifact: one
:class:`LayerPlan` per quantized leaf of a model's parameter tree, keyed by
the leaf's tree path (dict keys and list indices joined with ``/``), plus
the capacity accounting that justifies it.  The JSON is the reference's
byte for byte, so a plan compiled by either package applies in the other.

* **Versioned** — ``version`` is bumped whenever the schema or the meaning
  of a field changes; :func:`ModelPlan.from_json` refuses newer versions.
* **Fingerprinted** — ``fingerprint`` hashes the *plan-invariant* identity
  of every quantized leaf: tree path, packed-code shape, logical K, the
  quantization bitwidths/grid kinds and the :func:`numerics_family` of the
  base mode.  ``p``/``tile_n``/``wcanon`` and the mode *within* a family are
  plan outputs and excluded (:func:`repro_torch.tune.planner.apply_plan`
  checks it).  Every element hashed is a plain Python ``int``/``str``, so
  the hash equals the reference's on the same tree.
* **Budget semantics** — ``budget_bytes`` is the global LUT-capacity budget
  the plan was compiled under; ``total_bytes`` is what it spends: every
  layer's prepared-product bytes
  (:attr:`repro_torch.core.prepared.PreparedLinear.prepared_bytes`, exact)
  plus each *distinct* shared LUT pack's table bytes counted once
  (``table_bytes``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Optional

import torch

PLAN_VERSION = 1


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One quantized leaf's compiled execution config.

    ``capacity_bytes`` is the exact byte size of the prepared products this
    config materializes (0 when ``prepared`` is False — the degradation
    floor serves the raw layer); ``est_us``/``measured_us`` record the
    analytic estimate and the measured correction the planner ranked it by.
    Within a numerics family every choice here gives the same bits."""

    mode: str
    p: int
    tile_n: Optional[int] = None
    buffer_bytes: Optional[int] = None
    wcanon: bool = False          # lut mode: materialize the weight-static
                                  # [F, G, p!] reordering table
    prepared: bool = True         # False -> serve the raw QuantizedLinear
    capacity_bytes: int = 0       # exact prepared-product bytes (x stack)
    table_bytes: int = 0          # shared LUT pack bytes (deduped in totals)
    est_us: float = 0.0           # analytic estimate (pim_cost / perfmodel)
    measured_us: Optional[float] = None   # measured correction
    stack: int = 1                # leading stacked units

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "LayerPlan":
        return cls(**d)


@dataclasses.dataclass
class ModelPlan:
    """The whole-model execution plan: ``layers[path] -> LayerPlan``."""

    fingerprint: str
    budget_bytes: int
    layers: dict[str, LayerPlan]
    total_bytes: int = 0          # sum(capacity) + deduped shared tables
    table_bytes: int = 0          # deduped shared LUT table bytes alone
    version: int = PLAN_VERSION
    meta: dict = dataclasses.field(default_factory=dict)

    def to_json(self, indent: int | None = 2) -> str:
        d = dict(
            version=self.version,
            fingerprint=self.fingerprint,
            budget_bytes=self.budget_bytes,
            total_bytes=self.total_bytes,
            table_bytes=self.table_bytes,
            layers={k: v.to_dict() for k, v in sorted(self.layers.items())},
            meta=self.meta,
        )
        return json.dumps(d, indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "ModelPlan":
        d = json.loads(s)
        version = d.get("version", 0)
        if version > PLAN_VERSION:
            raise ValueError(
                f"plan version {version} is newer than this build's "
                f"{PLAN_VERSION}; re-run the autotuner"
            )
        return cls(
            fingerprint=d["fingerprint"],
            budget_bytes=d["budget_bytes"],
            layers={k: LayerPlan.from_dict(v) for k, v in d["layers"].items()},
            total_bytes=d.get("total_bytes", 0),
            table_bytes=d.get("table_bytes", 0),
            version=version,
            meta=d.get("meta", {}),
        )

    def save(self, path) -> None:
        pathlib.Path(path).write_text(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "ModelPlan":
        return cls.from_json(pathlib.Path(path).read_text())


# ---------------------------------------------------------------------------
# Parameter-tree walking + shape fingerprint
# ---------------------------------------------------------------------------


def _is_quantized_leaf(x) -> bool:
    from repro_torch.core import PreparedLinear, QuantizedLinear

    return isinstance(x, (QuantizedLinear, PreparedLinear))


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _collect(node, path: str, out: list) -> None:
    if _is_quantized_leaf(node):
        out.append((path, node))
    elif isinstance(node, dict):
        for k in node:
            _collect(node[k], _join(path, k), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _collect(v, _join(path, i), out)


def quantized_leaf_items(params) -> list[tuple[str, object]]:
    """``(path, leaf)`` for every (Prepared)QuantizedLinear leaf, in a stable
    depth-first order.  The walkers here are module functions, not closures
    that call themselves: such a closure is a reference cycle, which would
    keep the returned leaves (a whole prepared model) alive until the
    garbage collector runs."""
    out: list[tuple[str, object]] = []
    _collect(params, "", out)
    return out


def _map(node, path: str, fn):
    if _is_quantized_leaf(node):
        return fn(path, node)
    if isinstance(node, dict):
        return {k: _map(v, _join(path, k), fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(v, _join(path, i), fn) for i, v in enumerate(node)]
    if isinstance(node, tuple):
        return tuple(_map(v, _join(path, i), fn) for i, v in enumerate(node))
    return node


def map_quantized_leaves(params, fn):
    """Rebuild the tree with ``fn(path, leaf)`` applied to every quantized
    leaf."""
    return _map(params, "", fn)


def numerics_family(spec) -> str:
    """The bit-exactness equivalence class a spec belongs to: int-grid
    ``lut``/``stream`` share integer semantics at any p (``"int-lut"``);
    ``dequant`` and ``pallas`` are float matmuls with their own
    accumulation orders; float-grid LUT modes each keep their own mode."""
    if spec.mode in ("lut", "stream"):
        if spec.w_kind == "int" and spec.a_kind == "int":
            return "int-lut"
        return f"fp-{spec.mode}"
    return spec.mode


def leaf_identities(params) -> dict[str, tuple]:
    """``path -> (codes.shape, k, bw, ba, w_kind, a_kind, family)`` for every
    quantized leaf: the plan-invariant identity tuple the fingerprint hashes,
    in plain Python ints and strs."""
    out: dict[str, tuple] = {}
    for path, leaf in quantized_leaf_items(params):
        spec = leaf.spec
        out[path] = (
            tuple(int(d) for d in leaf.codes.shape), int(leaf.k), int(spec.bw), int(spec.ba),
            str(spec.w_kind), str(spec.a_kind), numerics_family(spec),
        )
    return out


def param_fingerprint(params) -> str:
    """Shape fingerprint of a parameter tree's quantized leaves: the sha256
    of ``repr((path, codes.shape, k, bw, ba, w_kind, a_kind, family))`` per
    leaf, first 32 hex digits.  The numerics family of the base mode is a
    plan INPUT, so a plan compiled on a ``lut`` tree refuses a ``dequant``
    tree of the same shapes."""
    h = hashlib.sha256()
    for path, ident in leaf_identities(params).items():
        h.update(repr((path,) + ident).encode())
    return h.hexdigest()[:32]


_IDENT_FIELDS = ("codes shape", "k", "bw", "ba", "w_kind", "a_kind",
                 "numerics family")


def calibration_digest(leaf) -> Optional[str]:
    """Content digest of a leaf's frozen activation scale (its f32 bytes and
    shape, as the reference hashes them), or ``None`` when the leaf
    quantizes activations dynamically.  Not part of
    :func:`param_fingerprint` (a plan stays valid across calibration), but
    part of :func:`describe_drift`."""
    a = getattr(leaf, "ascale", None)
    if a is None:
        return None
    arr = torch.as_tensor(a).detach().to(torch.float32).cpu().contiguous().numpy()
    h = hashlib.sha256(arr.tobytes() + str(arr.shape).encode())
    return h.hexdigest()[:16]


def calibration_digests(params) -> dict[str, Optional[str]]:
    return {p: calibration_digest(l) for p, l in quantized_leaf_items(params)}


def describe_drift(old_params, new_params) -> list[str]:
    """Human-readable per-leaf differences between two trees' plan-invariant
    identities and frozen calibrations (shape, bitwidth, numerics-family and
    calibration drift, layers appearing or vanishing).  Empty list ==
    swap-compatible."""
    old_i, new_i = leaf_identities(old_params), leaf_identities(new_params)
    old_c, new_c = calibration_digests(old_params), calibration_digests(new_params)
    msgs: list[str] = []
    for path in sorted(set(old_i) | set(new_i)):
        if path not in new_i:
            msgs.append(f"{path}: quantized layer missing from new tree")
        elif path not in old_i:
            msgs.append(f"{path}: quantized layer absent from active tree")
        else:
            diffs = [
                f"{name} {o!r} -> {n!r}"
                for name, o, n in zip(_IDENT_FIELDS, old_i[path], new_i[path])
                if o != n
            ]
            if old_c.get(path) != new_c.get(path):
                diffs.append(f"calibration {old_c.get(path)!r} -> {new_c.get(path)!r}")
            if diffs:
                msgs.append(f"{path}: " + ", ".join(diffs))
    return msgs
