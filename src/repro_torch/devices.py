"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import dataclasses

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked for
    and absent — an entry point never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def upload(a, device: torch.device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` without a stream sync.

    A copy from pageable host memory makes the host wait for the device;
    staging through pinned memory lets the copy run asynchronously, which
    keeps the serve loop's only device->host wait at its token fetch."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def tree_device(tree) -> torch.device:
    """Device of the first tensor found in a parameter tree."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            return node.device
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            stack.extend(getattr(node, f.name) for f in dataclasses.fields(node))
    raise ValueError("parameter tree holds no tensor")
