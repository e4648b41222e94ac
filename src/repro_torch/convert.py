"""Carry parameter trees from the JAX reference into the port.

:func:`params_from_numpy` takes a reference tree after
``jax.tree.map(np.asarray, tree)`` — nested dicts and lists of numpy arrays,
with quantized leaves still the reference's ``QuantizedLinear`` /
``PreparedLinear`` objects holding numpy fields — and returns the port's
tree with the same keys and stacked shapes.  The quantized leaves are
recognised by their fields (``codes``, ``scale``, ``bias``, ``spec``, ``k``,
``ascale``; ``wcodes`` and ``p`` mark a prepared one), so nothing of the
reference is imported and no JAX is needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import devices
from repro_torch.core.api import LutLinearSpec, QuantizedLinear
from repro_torch.core.prepared import PreparedLinear

_QUANT_FIELDS = ("codes", "scale", "bias", "spec", "k", "ascale")
_PREPARED_FIELDS = ("wcodes", "wpk", "wcanon", "onehot", "p")


def _tensor(a, device):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _spec(s) -> LutLinearSpec:
    return LutLinearSpec(**{f.name: getattr(s, f.name) for f in dataclasses.fields(LutLinearSpec)})


def _is_quantized(node) -> bool:
    return all(hasattr(node, f) for f in _QUANT_FIELDS)


def params_from_numpy(tree, *, device="cuda"):
    """Reference tree (numpy leaves) -> the port's tree of tensors on ``device``."""
    dev = devices.resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if _is_quantized(node):
            common = dict(
                codes=_tensor(node.codes, dev), scale=_tensor(node.scale, dev),
                bias=_tensor(node.bias, dev), spec=_spec(node.spec), k=int(node.k),
                ascale=_tensor(node.ascale, dev),
            )
            if all(hasattr(node, f) for f in _PREPARED_FIELDS):
                return PreparedLinear(
                    wcodes=_tensor(node.wcodes, dev), wpk=_tensor(node.wpk, dev),
                    wcanon=_tensor(node.wcanon, dev),
                    onehot=None if node.onehot is None else np.asarray(node.onehot),
                    p=int(node.p), **common,
                )
            return QuantizedLinear(**common)
        if node is None:
            return None
        return _tensor(node, dev)

    return walk(tree)
