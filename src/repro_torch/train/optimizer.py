"""AdamW with global-norm clipping (port of ``repro.train.optimizer``).

Optimizer state is a plain tree (``mu`` / ``nu`` mirror the parameters, f32,
and ``step`` an int32 scalar), so checkpoints treat it as they treat the
parameters.  The arithmetic is the reference's, in f32: the clip scale
``min(1, clip / (norm + 1e-9))``, the warmup schedule, and the bias
corrections ``b ** step`` taken on f32 tensors.  Weight decay applies to
every leaf with ``ndim >= 2`` of the *stacked* tree, so a stacked norm
scale ``[n_units, d]`` decays as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import devices, tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def _leaves(t) -> list:
    """The tensor leaves of a tree in the reference's order (dict keys sorted,
    lists in order): the order the global norm sums them in."""
    if isinstance(t, torch.Tensor):
        return [t]
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return []


def init_opt_state(params) -> dict:
    zeros = lambda t: tree.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), t)
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=devices.tree_device(params))}


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(grads, run=None) -> torch.Tensor:
    """The f32 norm of every gradient leaf; with ``run`` (a sharded step's
    :class:`~repro_torch.dist.runtime.ShardedRun`, ``grads`` the rank's
    shards) the global norm of the whole gradient."""
    if run is not None:
        return torch.sqrt(run.norm_groups(grads))
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in _leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def apply_updates(params, grads, state: dict, cfg: AdamWConfig, *, run=None):
    """Returns ``(new_params, new_state, metrics)``; nothing is updated in
    place.  A Python number divided by a tensor is written as ``torch.div``
    of two f32 tensors: ``number / tensor`` is a reciprocal and a product in
    torch, one rounding more than the reference's division.  ``run``: the
    trees are a rank's shards (:func:`global_norm`); every other step is
    elementwise, and weight decay on ``ndim >= 2`` holds for a shard as for
    its leaf."""
    step = state["step"] + 1
    dev = step.device
    gnorm = global_norm(grads, run)
    scale = torch.clamp(torch.div(_f32(cfg.clip_norm, dev), gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), stepf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), stepf)
    moments = []

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu2 = cfg.b1 * mu + (1 - cfg.b1) * g
        nu2 = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        delta = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices (and stacked vectors)
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        moments.append((mu2, nu2))
        return (p.to(torch.float32) - lr * delta).to(p.dtype)

    new_p = tree.tree_map(upd, params, grads, state["mu"], state["nu"])
    mus, nus = iter([m for m, _ in moments]), iter([n for _, n in moments])
    new_state = {"mu": tree.tree_map(lambda _: next(mus), params),
                 "nu": tree.tree_map(lambda _: next(nus), params), "step": step}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
