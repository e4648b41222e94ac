"""Pipeline parallelism: a GPipe schedule over a ``stage`` mesh axis (port of
``repro.dist.pipeline``).

:func:`pipeline_apply` gives rank ``s`` of the ``stage`` axis stage ``s`` of
a stacked stage tree and streams microbatches through the ring: at step
``t`` stage ``s`` works on microbatch ``t - s`` (the GPipe diagonal), and
each step's activation moves one hop along the ring (one
``batch_isend_irecv``: send to the next stage, receive from the previous),
so the schedule is ``n_micro + n_stages - 1`` steps.  The last stage's
outputs are broadcast, so every rank returns them all (the reference's
``psum`` of outputs only the last stage wrote).

Stages must be shape-preserving: ``stage_fn(w, x)`` returns an activation
shaped like ``x``.  Each microbatch passes through the same calls as the
stages applied one after another, so the result equals that bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.dist.sharding import mesh_axes


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    mesh,
    *,
    axis: str = "stage",
) -> torch.Tensor:
    """Apply ``n_stages`` stages to every microbatch; returns ``[n_micro, ...]``.

    ``stage_params`` is a tree whose leaves lead with the stage dim
    (``[n_stages, ...]``); ``microbatches`` is ``[n_micro, *mb_shape]``, the
    same on every rank (only stage 0 reads it)."""
    import torch.distributed as dist

    sizes = mesh_axes(mesh)
    if axis not in sizes:
        raise ValueError(f"mesh has no {axis!r} axis: {tuple(sizes)}")
    n_stages = sizes[axis]
    n_micro = int(microbatches.shape[0])
    lead = {int(leaf.shape[0]) for leaf in tree.tensors(stage_params)}
    if lead != {n_stages}:
        raise ValueError(
            f"stage_params leading dims {sorted(lead)} != mesh {axis} size {n_stages}"
        )
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    w = tree.index(stage_params, sid)
    nxt = dist.get_global_rank(group, (sid + 1) % n_stages)
    prev = dist.get_global_rank(group, (sid - 1) % n_stages)

    buf = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(n_micro + n_stages - 1):
        # Stage 0 injects microbatch t; later stages take the activation
        # rotated in from their predecessor.
        inp = microbatches[min(t, n_micro - 1)] if sid == 0 else buf
        y = stage_fn(w, inp)
        mb = t - (n_stages - 1)
        if sid == n_stages - 1 and mb >= 0:
            outs[mb] = y
        if n_stages == 1:
            buf = y
            continue
        buf = torch.empty_like(y)
        for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, buf, prev, group),
        ]):
            req.wait()
    dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1), group=group)
    return outs
