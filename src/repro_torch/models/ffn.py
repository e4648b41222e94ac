"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain MLPs (port of
``repro.models.ffn``)."""

from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear


def ffn_init(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None,
             device=None) -> dict:
    d_ff = d_ff or cfg.d_ff
    p = {
        "w_up": dense_init(gen, cfg.d_model, d_ff, device=device),
        "w_down": dense_init(gen, d_ff, cfg.d_model, device=device),
    }
    if cfg.gated_ffn:
        p["w_gate"] = dense_init(gen, cfg.d_model, d_ff, device=device)
    return p


def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = linear(p["w_up"], x)
    if "w_gate" in p:
        h = layers.activation(linear(p["w_gate"], x), cfg.ffn_act) * up
    else:
        h = layers.activation(up, cfg.ffn_act)
    return linear(p["w_down"], h)
