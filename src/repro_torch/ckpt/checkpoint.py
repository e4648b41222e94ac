"""Checkpoints of the port, in the reference's on-disk format (counterpart of
``repro.ckpt.checkpoint``).

Layout (one directory per step)::

    <dir>/step_000000042/
        manifest.json            # structure + leaf shapes/dtypes
        leaf_00000.npy ...       # one .npy per leaf (the full array)
        _COMMITTED               # written last -> crash-safe atomicity

A step is written into ``<step dir>.tmp`` and renamed into place after
``_COMMITTED``; a checkpoint without ``_COMMITTED`` is ignored by
:func:`latest_step` and refused by every restore.  A restore reads every
leaf, holds it to the manifest's shape and dtype, and only then returns: a
truncated ``.npy`` or a corrupt manifest raises, nothing loads partially.

**The same files as the reference's.**  Leaves are numbered in the order
jax's tree functions visit the reference's trees (dict keys sorted, lists in
order, ``None`` empty, a quantized leaf's array fields in declaration order),
and the manifest holds the same keys and values, so either package restores
the other's checkpoints.  Two differences:

* the generic manifest's ``"treedef"`` is jax's ``PyTreeDef`` repr in the
  reference.  The port writes the same notation for dicts, lists, tuples,
  ``None``, leaves and a dataclass node whose every field is data (a
  ``TrainState``: ``CustomNode(TrainState[()], [...])``), but a node with
  static fields (``QuantizedLinear``, ...) as ``Name(field=..., ...)``, not
  jax's ``CustomNode(...)`` with its static values; no restore reads the
  string (the ``like`` structure is the truth).
* bf16 leaves.  ``np.save`` of the reference's ``ml_dtypes.bfloat16`` array
  writes the two-byte payload with descr ``'<V2'`` and the manifest says
  ``"bfloat16"``; ``np.load`` gives that back as ``V2``, which ``jnp.asarray``
  refuses, so the reference cannot restore its own bf16 checkpoints.  The
  port writes bf16 leaves as the same header and payload and reads a
  two-byte payload back as ``torch.bfloat16`` by a view, guided by the
  manifest's dtype.

**Prepared-pytree checkpoints** (:func:`save_prepared` /
:func:`restore_prepared`) serialize serve-ready trees —
:class:`~repro_torch.core.PreparedLinear` /
:class:`~repro_torch.core.QuantizedLinear` leaves with their static fields
(spec, k, p) in the manifest — so a restore rebuilds the exact tree without
``Model.prepare`` (the fast cold start).  The shared canonical/reordering
tables are not stored: the manifest records each layer's ``LutPack`` key and
the restore rebuilds the packs (``repro_torch.core.api._lut_pack_cache``)
and their copies on the device the tree is restored to.

Leaves restore onto ``device`` (default ``"cuda"``, which raises without a
card); ``onehot`` leaves stay host numpy arrays, as in the reference.

**Sharded trees** (each rank holds its shards, ``shardings=`` the tree's
:func:`repro_torch.dist.to_shardings`): :func:`save` all-gathers every leaf
to its global shape and global rank 0 writes exactly the files of the whole
tree, so the checkpoint does not depend on the mesh; :func:`restore` reads
each whole leaf and cuts this rank's shard for *its* placements.  Any mesh,
or none, restores any save: the elastic re-mesh of the reference's
``restore(shardings=)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import devices, tree as trees

_COMMIT = "_COMMITTED"
# v2: quantized/prepared leaves may carry a frozen activation scale
# ("ascale", repro_torch.core.calibrate).  v1 checkpoints restore fine (the
# field defaults to None == dynamic scaling); newer-versioned ones are refused.
PREPARED_VERSION = 2

# the numpy name the manifests use for each torch dtype
_NAMES = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
    torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
# the header ml_dtypes' bfloat16 gives a .npy: a two-byte void payload
_BF16_DESCR = "<V2"


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:09d}")


def _step_of(name: str) -> Optional[int]:
    """Parse a ``step_*`` directory name; None for anything else (stray
    files, ``.tmp`` staging dirs, non-numeric suffixes like ``step_foo``)."""
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# Leaves: host payloads, .npy files, device tensors
# ---------------------------------------------------------------------------


def dtype_name(x) -> str:
    """The manifest's dtype string of a tensor, array or Python scalar (the
    numpy name, as the reference's ``str(arr.dtype)``)."""
    if isinstance(x, torch.Tensor):
        return _NAMES[x.dtype]
    return str(np.asarray(x).dtype)


def _to_host(x) -> np.ndarray:
    """A leaf as a C-contiguous host array; a bf16 tensor as its two-byte
    payload (int16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.ascontiguousarray(np.asarray(x))


def _write_leaf(path: str, x) -> None:
    arr = _to_host(x)
    if dtype_name(x) != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        arr.tofile(f)


def _read_leaf(path: str, meta: dict) -> np.ndarray:
    """The payload of one leaf file, held to its manifest entry: a truncated
    or foreign file raises.  bf16 comes back as its int16 payload."""
    arr = np.load(path, allow_pickle=False)
    want = meta["dtype"]
    if want == "bfloat16":
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Vui":
            raise ValueError(f"{path}: a bfloat16 leaf holds {arr.dtype}, not a 2-byte payload")
        arr = arr.view(np.int16)
    elif str(arr.dtype) != want:
        raise ValueError(f"{path}: dtype {arr.dtype} != the manifest's {want}")
    if tuple(arr.shape) != tuple(meta["shape"]):
        raise ValueError(f"{path}: shape {arr.shape} != the manifest's {tuple(meta['shape'])}")
    return arr


def _to_device(arr: np.ndarray, name: str, device: torch.device, placements=None
               ) -> torch.Tensor:
    """The payload as a tensor on ``device``; with ``placements``, only this
    rank's shard of it (cut on the host)."""
    t = torch.from_numpy(arr)
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    if placements is not None:
        from repro_torch.dist.sharding import shard_leaf

        t = shard_leaf(t, placements)
    return t.to(device)


# ---------------------------------------------------------------------------
# Generic pytree checkpoints
# ---------------------------------------------------------------------------


_is_node = trees._is_node


def _data_fields(node) -> list:
    """A dataclass node's array-carrying fields in declaration order (the
    reference registers the same ones as data, the rest as static): arrays,
    dataclass nodes, and dicts (a training state's parameter and optimizer
    trees)."""
    return [f.name for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), (torch.Tensor, np.ndarray, dict))
            or _is_node(getattr(node, f.name))]


def _flatten(tree, out: list) -> list:
    """Leaves in jax's order: dict keys sorted, lists/tuples in order, None
    empty; a dataclass node's data fields in declaration order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    elif _is_node(tree):
        for name in _data_fields(tree):
            _flatten(getattr(tree, name), out)
    elif tree is not None:
        out.append(tree)
    return out


def _placements(tree, shardings) -> list:
    """Each leaf's placements from the ``shardings`` tree, in :func:`_flatten`'s
    order (the walk follows ``tree``'s structure)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _placements(tree[k], shardings[k])]
    if isinstance(tree, (list, tuple)):
        return [p for v, s in zip(tree, shardings) for p in _placements(v, s)]
    if _is_node(tree):
        return [p for n in _data_fields(tree)
                for p in _placements(getattr(tree, n), getattr(shardings, n))]
    return [] if tree is None else [shardings]


def place(tree, shardings):
    """This rank's shard of every leaf of a whole ``tree`` under ``shardings``
    (the port's ``jax.device_put(tree, shardings)``)."""
    from repro_torch.dist.sharding import shard_leaf

    return _unflatten(tree, iter([shard_leaf(t, p) for t, p in
                                  zip(_flatten(tree, []), _placements(tree, shardings))]))


def _whole_leaves(tree, shardings):
    """The whole leaves behind this rank's shards, one at a time (each
    all-gathered over the axes that shard it: every rank takes part)."""
    from repro_torch.dist.sharding import whole_leaf

    for t, p in zip(_flatten(tree, []), _placements(tree, shardings)):
        yield whole_leaf(t, p)


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        return out if isinstance(like, list) else tuple(out)
    if _is_node(like):
        return dataclasses.replace(
            like, **{n: _unflatten(getattr(like, n), leaves) for n in _data_fields(like)})
    if like is None:
        return None
    return next(leaves)


def _treedef_str(tree) -> str:
    """The structure in jax's ``PyTreeDef`` notation (dataclass nodes in the
    port's own, see the module docstring)."""
    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(walk(v) for v in t) + ("," if len(t) == 1 else "") + ")"
        if _is_node(t):
            names = _data_fields(t)
            if len(names) == len(dataclasses.fields(t)):      # jax's register_dataclass
                return (f"CustomNode({type(t).__name__}[()], ["
                        + ", ".join(walk(getattr(t, n)) for n in names) + "])")
            return (f"{type(t).__name__}("
                    + ", ".join(f"{n}={walk(getattr(t, n))}" for n in names) + ")")
        return "None" if t is None else "*"

    return f"PyTreeDef({walk(tree)})"


def _commit(tmp: str, d: str) -> str:
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    return d


def _staging(d: str) -> str:
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    return tmp


def save(base: str, step: int, tree: Any, *, shardings: Any = None) -> str:
    """Synchronous checkpoint write; returns the step directory.

    ``shardings`` (the tree's :func:`repro_torch.dist.to_shardings`): ``tree``
    holds this rank's shards.  Every rank of the default process group
    calls it; each leaf is all-gathered to its global shape, global rank 0
    writes the files of the whole tree, and a barrier follows, so every rank
    returns once the step is committed."""
    if shardings is None:
        return _write_step(base, step, tree, _flatten(tree, []))
    import torch.distributed as dist

    d = _write_step(base, step, tree, _whole_leaves(tree, shardings),
                    write=dist.get_rank() == 0)
    dist.barrier()
    return d


def _write_step(base: str, step: int, tree: Any, leaves, *, write: bool = True) -> str:
    """Write ``leaves`` (an iterable, consumed whether or not this process
    ``write``s) and the manifest of ``tree``'s structure as step ``step``."""
    d = _step_dir(base, step)
    tmp = _staging(d) if write else None
    manifest = {"step": step, "treedef": _treedef_str(tree), "leaves": []}
    for i, leaf in enumerate(leaves):
        if write:
            _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf)
        manifest["leaves"].append({"shape": list(np.shape(leaf)), "dtype": dtype_name(leaf)})
    if not write:
        return d
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return _commit(tmp, d)


def latest_step(base: str) -> Optional[int]:
    if not os.path.isdir(base):
        return None
    steps = []
    for name in os.listdir(base):
        s = _step_of(name)
        if s is not None and os.path.exists(os.path.join(base, name, _COMMIT)):
            steps.append(s)
    return max(steps) if steps else None


def _read_manifest(d: str) -> dict:
    mpath = os.path.join(d, "manifest.json")
    if not os.path.exists(mpath):
        raise FileNotFoundError(f"checkpoint {d} has no manifest.json")
    with open(mpath) as f:
        return json.load(f)


def _validate_manifest(d: str, like_leaves: list) -> None:
    """Leaf count/shape/dtype of the stored checkpoint must match ``like`` —
    a checkpoint from a different model/optimizer structure fails loudly
    instead of silently mis-unflattening into the wrong leaves."""
    stored = _read_manifest(d).get("leaves", [])
    if len(stored) != len(like_leaves):
        raise ValueError(
            f"checkpoint {d} has {len(stored)} leaves but the requested "
            f"structure has {len(like_leaves)} — it was written for a "
            f"different model/optimizer config"
        )
    bad = []
    for i, (meta, ref) in enumerate(zip(stored, like_leaves)):
        want_shape = tuple(np.shape(ref))
        if tuple(meta["shape"]) != want_shape:
            bad.append(f"leaf {i}: stored shape {tuple(meta['shape'])} != requested {want_shape}")
        elif meta["dtype"] != dtype_name(ref):
            bad.append(f"leaf {i}: stored dtype {meta['dtype']} != requested {dtype_name(ref)}")
    if bad:
        shown = "; ".join(bad[:5]) + ("; ..." if len(bad) > 5 else "")
        raise ValueError(f"checkpoint {d} does not match the requested structure: {shown}")


def restore(base: str, step: int, like: Any, *, shardings: Any = None, device="cuda",
            validate: bool = True) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, for
    example on the ``meta`` device: only shapes and dtypes are read), every
    leaf a tensor on ``device``.  ``validate`` (default) checks the stored
    manifest's leaf count/shapes/dtypes against ``like`` first.

    ``shardings`` (:func:`repro_torch.dist.to_shardings` of the tree's specs
    on this run's mesh): ``like`` is the *global* structure, and each rank
    gets its shard of every whole leaf it reads — the elastic re-shard:
    whatever mesh saved the step, and none."""
    dev = devices.resolve(device)
    d = _step_dir(base, step)
    if not os.path.exists(os.path.join(d, _COMMIT)):
        raise FileNotFoundError(f"checkpoint {d} is not committed")
    like_leaves = _flatten(like, [])
    if validate:
        _validate_manifest(d, like_leaves)
    metas = _read_manifest(d)["leaves"]
    if len(metas) != len(like_leaves):
        raise ValueError(f"checkpoint {d} has {len(metas)} leaves, the structure "
                         f"{len(like_leaves)}")
    places = [None] * len(metas) if shardings is None else _placements(like, shardings)
    out = [_to_device(_read_leaf(os.path.join(d, f"leaf_{i:05d}.npy"), meta), meta["dtype"], dev,
                      places[i])
           for i, meta in enumerate(metas)]
    return _unflatten(like, iter(out))


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in-flight save).

    The snapshot (a copy of every tensor leaf on the host) is taken on the
    caller's thread; the files are written on a background thread.  A
    failure there (disk full, permissions) is captured and re-raised on the
    *next* ``save()`` / ``wait()`` call.

    ``save(shardings=)`` (a sharded tree, as :func:`save` takes it): every
    rank gathers the whole leaves on its own thread, only global rank 0
    keeps the host copy and writes it in the background, and the next
    ``save()`` / ``wait()`` of every rank ends in a barrier, so no rank reads
    the step before it is committed.
    """

    def __init__(self, base: str, keep_last: int = 3):
        self.base = base
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False

    def save(self, step: int, tree: Any, *, shardings: Any = None):
        self.wait()
        if shardings is None:
            host_tree = trees.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        else:
            import torch.distributed as dist

            leaves = [t.detach().to("cpu", copy=True) for t in _whole_leaves(tree, shardings)]
            self._barrier = True
            if dist.get_rank() != 0:
                return
            host_tree = _unflatten(tree, iter(leaves))
        self._thread = threading.Thread(target=self._write, args=(step, host_tree), daemon=True)
        self._thread.start()

    def _write(self, step: int, host_tree):
        try:
            save(self.base, step, host_tree)
            self._gc()
        except BaseException as e:  # captured; re-raised on the caller thread
            self._error = e

    def _gc(self):
        steps = sorted(
            s for n in os.listdir(self.base)
            if (s := _step_of(n)) is not None and os.path.exists(os.path.join(self.base, n, _COMMIT))
        )
        for s in steps[: -self.keep_last]:
            shutil.rmtree(_step_dir(self.base, s), ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist

            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"background checkpoint write to {self.base} failed") from err


# ---------------------------------------------------------------------------
# Prepared-pytree checkpoints: serve-ready trees, restore skips prepare
# ---------------------------------------------------------------------------

_PREPARED_ARRAYS = ("codes", "scale", "bias", "wcodes", "wpk", "wcanon", "onehot", "ascale")
_QUANTIZED_ARRAYS = ("codes", "scale", "bias", "ascale")


def _encode_node(node, arrays: list, path: str):
    """Recursively encode a (possibly prepared) parameter tree into a JSON
    manifest node, appending array leaves to ``arrays`` in visit order."""
    from repro_torch.core import PreparedLinear, QuantizedLinear

    def arr_ref(a) -> Optional[int]:
        if a is None:
            return None
        arrays.append(a)
        return len(arrays) - 1

    if isinstance(node, PreparedLinear):
        spec = node.spec
        return {
            "kind": "prepared",
            "spec": dataclasses.asdict(spec),
            "k": node.k,
            "p": node.p,
            # The shared canonical/reordering tables are rebuilt on restore
            # from this key, never stored.
            "pack_key": [spec.bw, spec.ba, node.p, spec.w_kind, spec.a_kind],
            "arrays": {name: arr_ref(getattr(node, name)) for name in _PREPARED_ARRAYS},
        }
    if isinstance(node, QuantizedLinear):
        return {
            "kind": "quantized",
            "spec": dataclasses.asdict(node.spec),
            "k": node.k,
            "arrays": {name: arr_ref(getattr(node, name)) for name in _QUANTIZED_ARRAYS},
        }
    if isinstance(node, dict):
        return {"kind": "dict",
                "items": {k: _encode_node(v, arrays, f"{path}/{k}") for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"kind": "list" if isinstance(node, list) else "tuple",
                "items": [_encode_node(v, arrays, f"{path}/{i}") for i, v in enumerate(node)]}
    if node is None:
        return {"kind": "none"}
    if hasattr(node, "shape") or isinstance(node, (int, float, np.generic)):
        return {"kind": "leaf", "array": arr_ref(node)}
    raise TypeError(
        f"cannot serialize node of type {type(node).__name__} at {path!r} "
        f"in a prepared checkpoint"
    )


def _decode_node(node: dict, load):
    from repro_torch.core import LutLinearSpec, PreparedLinear, QuantizedLinear

    kind = node["kind"]
    if kind == "prepared":
        spec = LutLinearSpec(**node["spec"])
        a = {name: load(ref, host=(name == "onehot")) for name, ref in node["arrays"].items()}
        return PreparedLinear(spec=spec, k=node["k"], p=node["p"], **a)
    if kind == "quantized":
        spec = LutLinearSpec(**node["spec"])
        a = {name: load(ref) for name, ref in node["arrays"].items()}
        return QuantizedLinear(spec=spec, k=node["k"], **a)
    if kind == "dict":
        return {k: _decode_node(v, load) for k, v in node["items"].items()}
    if kind == "list":
        return [_decode_node(v, load) for v in node["items"]]
    if kind == "tuple":
        return tuple(_decode_node(v, load) for v in node["items"])
    if kind == "none":
        return None
    if kind == "leaf":
        return load(node["array"])
    raise ValueError(f"unknown manifest node kind {kind!r}")


def save_prepared(base: str, step: int, tree: Any, *,
                  plan_fingerprint: Optional[str] = None) -> str:
    """Checkpoint a serve-ready (prepared) parameter tree; returns the dir.

    The manifest records the static fields of every quantized leaf (spec, k,
    p, LutPack key) beside its arrays, so :func:`restore_prepared` rebuilds
    the exact tree with no ``like`` structure and no ``Model.prepare`` pass.
    ``plan_fingerprint`` optionally stamps the ModelPlan the tree was
    prepared under."""
    from repro_torch.tune.plan import param_fingerprint

    d = _step_dir(base, step)
    tmp = _staging(d)
    arrays: list = []
    root = _encode_node(tree, arrays, "")
    manifest = {
        "prepared_version": PREPARED_VERSION,
        "step": step,
        "fingerprint": param_fingerprint(tree),
        "plan_fingerprint": plan_fingerprint,
        "tree": root,
        "leaves": [{"shape": list(np.shape(a)), "dtype": dtype_name(a)} for a in arrays],
    }
    for i, a in enumerate(arrays):
        _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return _commit(tmp, d)


def prepared_meta(base: str, step: int) -> dict:
    """The manifest header of a prepared checkpoint (fingerprints, leaf
    stats) — readable without loading any arrays."""
    d = _step_dir(base, step)
    if not os.path.exists(os.path.join(d, _COMMIT)):
        raise FileNotFoundError(f"checkpoint {d} is not committed")
    m = _read_manifest(d)
    if "prepared_version" not in m:
        raise ValueError(f"checkpoint {d} is not a prepared checkpoint")
    return {k: m[k] for k in ("prepared_version", "step", "fingerprint", "plan_fingerprint")}


def restore_prepared(base: str, step: int, *, device="cuda",
                     expect_fingerprint: Optional[str] = None) -> Any:
    """Rebuild a serve-ready tree from a :func:`save_prepared` checkpoint
    (either package's) onto ``device``.

    The restore-only cold start: no ``like`` structure, no quantize, no
    ``Model.prepare``.  Every leaf is held to the manifest's shape and dtype
    and the rebuilt tree to the manifest's fingerprint, and each distinct
    ``LutPack`` the manifest names is rebuilt with its tables on ``device``.
    ``expect_fingerprint`` refuses a checkpoint whose shape fingerprint does
    not match the serving config it is restored for."""
    from repro_torch.tune.plan import param_fingerprint

    dev = devices.resolve(device)
    d = _step_dir(base, step)
    if not os.path.exists(os.path.join(d, _COMMIT)):
        raise FileNotFoundError(f"checkpoint {d} is not committed")
    manifest = _read_manifest(d)
    version = manifest.get("prepared_version")
    if version is None:
        raise ValueError(
            f"checkpoint {d} is a plain checkpoint (no static-field "
            f"manifest); use ckpt.restore with a like structure"
        )
    if version > PREPARED_VERSION:
        raise ValueError(
            f"prepared checkpoint version {version} is newer than this build's {PREPARED_VERSION}"
        )
    if expect_fingerprint is not None and manifest["fingerprint"] != expect_fingerprint:
        raise ValueError(
            f"prepared checkpoint fingerprint {manifest['fingerprint']} does "
            f"not match the expected {expect_fingerprint}: shapes or "
            f"quantization changed — re-prepare and re-save"
        )
    metas = manifest["leaves"]

    def load(ref: Optional[int], host: bool = False):
        if ref is None:
            return None
        meta = metas[ref]
        arr = _read_leaf(os.path.join(d, f"leaf_{ref:05d}.npy"), meta)
        return arr if host else _to_device(arr, meta["dtype"], dev)

    tree = _decode_node(manifest["tree"], load)
    if param_fingerprint(tree) != manifest["fingerprint"]:
        raise ValueError(f"checkpoint {d}: the rebuilt tree's fingerprint differs from its "
                         f"manifest's {manifest['fingerprint']}")
    _rebuild_packs(manifest["tree"], dev)
    return tree


def _rebuild_packs(node: dict, device: torch.device) -> None:
    """Warm the LUT pack cache, and the packs' tables on ``device``, for
    every distinct pack key the restored tree's LUT-mode layers consult at
    serve time."""
    from repro_torch.core import engine
    from repro_torch.core.api import _lut_pack_cache

    keys: set = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if n["kind"] == "prepared" and n["spec"]["mode"] in ("lut", "stream"):
            keys.add(tuple(n["pack_key"]))
        items = n.get("items")
        stack.extend(items.values() if isinstance(items, dict) else items or [])
    for bw, ba, p, w_kind, a_kind in sorted(keys):
        engine.device_tables(_lut_pack_cache(bw, ba, p, w_kind, a_kind), device)
