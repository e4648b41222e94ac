"""Train step factory: next-token cross-entropy + AdamW, checkpointed units
(port of ``repro.train.train_step``).

Gradients come from torch autograd (the reference's ``jax.value_and_grad``):
:func:`value_and_grad` takes each floating leaf of the parameter tree as a
fresh leaf that requires grad, so the state itself never carries autograd
history.  Training runs on float trees under ``attn_impl="xla"``, as the
reference's loss does: the CUDA kernels have no backward and refuse inputs
that require grad (``kernels/ops.py::_refuse_grad``), so a ``"flash"``
config raises on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import devices, tree
from repro_torch.dist import runtime
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.train import optimizer as opt


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: dict
    step: torch.Tensor            # int32 scalar


def init_train_state(model: Model, seed: int = 0, *, device="cuda") -> TrainState:
    """Random parameters (:meth:`Model.init`), zero moments, step 0, on
    ``device``; on ``meta`` only the structure (what a checkpoint is
    restored into)."""
    dev = devices.resolve(device)
    params = model.init(seed, device=dev)
    return TrainState(params=params, opt=opt.init_opt_state(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token xent; logits [B, S, V] (f32), targets [B, S] int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


_XENT_CHUNK = 256


def _chunk_xent_sum(params, cfg: ModelConfig, h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    logits = transformer.lm_head(params, cfg, h).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def chunked_head_xent(params, cfg: ModelConfig, hidden: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """LM head + xent in sequence chunks of 256: the ``[B, S, V]`` logits
    never exist.  Each chunk is checkpointed, so backward keeps only the
    ``[B, 256, D]`` hidden slice and recomputes the chunk's logits.  The
    reference's condition picks the unchunked form: ``S`` not a multiple of
    256, ``S <= 256``, or a vocabulary under 32768."""
    b, s, _ = hidden.shape
    if s % _XENT_CHUNK or s <= _XENT_CHUNK or cfg.vocab_size < 32768:
        logits = transformer.lm_head(params, cfg, hidden)
        return cross_entropy(logits.to(torch.float32), targets)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, _XENT_CHUNK):
        h_i, t_i = hidden[:, c0 : c0 + _XENT_CHUNK], targets[:, c0 : c0 + _XENT_CHUNK]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_xent_sum, params, cfg, h_i, t_i, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            part = _chunk_xent_sum(params, cfg, h_i, t_i)
        total = total + part
    return total / (b * s)


def make_loss_fn(model: Model, *, ctx=None, aux_weight: float = 0.01, remat: bool = True):
    """``loss_fn(params, batch) -> (loss, {"xent", "moe_aux"})``: the
    hidden states of ``batch["tokens"][:, :-1]`` (with a VLM's
    ``prefix_embeds`` prepended, their positions dropped before the loss),
    the chunked head's xent against ``tokens[:, 1:]``, plus ``aux_weight``
    x the MoE aux loss on a MoE config."""
    _refuse_ctx(ctx)
    cfg = model.cfg

    def loss_fn(params, batch):
        tokens = batch["tokens"]                      # [B, S+1]
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        hidden, _, aux = model.forward(
            params, inp, prefix_embeds=batch.get("prefix_embeds"), remat=remat,
            return_hidden=True, return_aux=True,
        )
        if batch.get("prefix_embeds") is not None and not cfg.is_encdec:
            hidden = hidden[:, cfg.frontend_seq :, :]  # drop image positions
        loss = chunked_head_xent(params, cfg, hidden, tgt)
        if cfg.moe is not None:
            loss = loss + aux_weight * aux
        return loss, {"xent": loss.detach(), "moe_aux": aux.detach()}

    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, extras), grads)`` of ``loss_fn(params, batch)`` with respect
    to every floating leaf of ``params`` (the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)``).  A leaf the loss does not
    reach gets a zero gradient, as in the reference."""
    leaves = []

    def as_leaf(t):
        if not t.is_floating_point():
            return t
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]

    with torch.enable_grad():
        p = tree.tree_map(as_leaf, params)
        loss, extras = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)])
    g_tree = tree.tree_map(lambda t: next(it) if t.is_floating_point() else None, params)
    return (loss.detach(), extras), g_tree


def make_train_step(
    model: Model,
    opt_cfg: opt.AdamWConfig,
    *,
    ctx=None,
    remat=True,
    accum_steps: int = 1,
):
    """Train step factory: ``train_step(state, batch) -> (state, metrics)``.

    ``accum_steps > 1`` splits the batch into that many microbatches and
    averages their gradients (``acc + g / accum_steps`` in f32, as the
    reference's scan), so activation memory scales down by the factor; the
    extras are the last microbatch's."""
    _refuse_ctx(ctx)
    loss_fn = make_loss_fn(model, remat=remat)

    def grads_of(params, batch):
        if accum_steps == 1:
            return value_and_grad(loss_fn, params, batch)
        b = next(iter(batch.values())).shape[0]
        mb = b // accum_steps
        acc_loss = None
        acc_g = tree.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                    device=x.device), params)
        for i in range(accum_steps):
            micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
            (loss, extras), g = value_and_grad(loss_fn, params, micro)
            acc_loss = loss / accum_steps if acc_loss is None else acc_loss + loss / accum_steps
            acc_g = tree.tree_map(lambda a, x: a + x / accum_steps, acc_g, g)
        return (acc_loss, extras), acc_g

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        (loss, extras), grads = grads_of(state.params, batch)
        new_params, new_opt, metrics = opt.apply_updates(state.params, grads, state.opt,
                                                         opt_cfg)
        metrics.update(extras)
        metrics["loss"] = loss
        return TrainState(params=new_params, opt=new_opt, step=state.step + 1), metrics

    return train_step


def _refuse_ctx(ctx) -> None:
    if ctx is not None:
        runtime.refuse_training("training (make_train_step / make_loss_fn with a ShardCtx)")
