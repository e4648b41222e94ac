"""Parameter-tree walking over quantized leaves (port of the tree walkers of
``repro.tune.plan``).

Paths join dict keys and list indices with ``/``, the key space the
reference's ``ModelPlan.layers`` and calibration scales are indexed by.
"""

from __future__ import annotations


def _is_quantized_leaf(x) -> bool:
    from repro_torch.core import PreparedLinear, QuantizedLinear

    return isinstance(x, (QuantizedLinear, PreparedLinear))


def quantized_leaf_items(params) -> list[tuple[str, object]]:
    """``(path, leaf)`` for every (Prepared)QuantizedLinear leaf, in a stable
    depth-first order."""
    out: list[tuple[str, object]] = []

    def walk(node, path: str):
        if _is_quantized_leaf(node):
            out.append((path, node))
            return
        if isinstance(node, dict):
            for k in node:
                walk(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))

    walk(params, "")
    return out


def map_quantized_leaves(params, fn):
    """Rebuild the tree with ``fn(path, leaf)`` applied to every quantized
    leaf."""

    def walk(node, path: str):
        if _is_quantized_leaf(node):
            return fn(path, node)
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(node)]
        if isinstance(node, tuple):
            return tuple(walk(v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(node))
        return node

    return walk(params, "")
