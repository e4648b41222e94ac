"""Parameter-tree helpers: the port's stand-in for ``jax.tree.map``.

A tree is nested dicts, lists and tuples whose leaves are tensors (or
``None``).  A dataclass node (``QuantizedLinear``, ``PreparedLinear``,
``CalibrationProbe``) is a node whose tensor and dataclass fields are
children; its other fields (``k``, ``p``, a probe's ``path`` and ``tape``)
are static and taken from the first tree.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf (zipped across ``rest``, which must
    share ``tree``'s structure); ``None`` and non-tensor leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if _is_node(tree):
        changes = {
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor) or _is_node(getattr(tree, f.name))
        }
        return dataclasses.replace(tree, **changes) if changes else tree
    return tree


def tensors(tree) -> list:
    """Every tensor leaf of ``tree`` (any order), without rebuilding it."""
    out, stack = [], [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif _is_node(node):
            stack.extend(getattr(node, f.name) for f in dataclasses.fields(node))
    return out


def _is_node(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def stack(trees: list):
    """Stack identically-shaped trees along a new leading dim."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def index(tree, i: int):
    """Unit ``i`` of a stacked tree (views: in-place writes reach the stack)."""
    return tree_map(lambda t: t[i], tree)


def unstack(tree, n: int) -> list:
    """The ``n`` units of a stacked tree, each leaf split by one ``unbind``
    (views, as :func:`index` gives): under autograd the gradient of a
    stacked leaf is then one stack of its units' gradients, not ``n``
    full-size scatters added up.  A dataclass node's static fields are
    shared by its units."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [unstack(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    if _is_node(tree):
        names = [f.name for f in dataclasses.fields(tree)
                 if isinstance(getattr(tree, f.name), torch.Tensor)
                 or _is_node(getattr(tree, f.name))]
        if not names:
            return [tree] * n
        parts = {name: unstack(getattr(tree, name), n) for name in names}
        return [dataclasses.replace(tree, **{k: v[i] for k, v in parts.items()})
                for i in range(n)]
    return [tree] * n


def sort_keys(tree):
    """The tree with every dict's keys in sorted order, recursively: the order
    jax's tree operations give every reference tree, so both packages walk a
    model's leaves in one order (plan fingerprints and the planner's
    tie-breaks follow it)."""
    if isinstance(tree, dict):
        return {k: sort_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [sort_keys(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return tree
