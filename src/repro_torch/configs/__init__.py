"""Architecture registry: ``--arch <id>`` -> (full config, smoke config).

Ten assigned architectures (each with its four input-shape cells) plus the
paper's own BERT/OPT/ViT evaluation models.
"""

from __future__ import annotations

from repro_torch.configs import (
    chatglm3_6b,
    command_r_plus_104b,
    deepseek_v2_lite_16b,
    gemma2_2b,
    internvl2_1b,
    llama4_maverick_400b_a17b,
    paper_models,
    rwkv6_3b,
    stablelm_12b,
    whisper_large_v3,
    zamba2_7b,
)
from repro_torch.models.config import ModelConfig

_MODULES = {
    "whisper-large-v3": whisper_large_v3,
    "gemma2-2b": gemma2_2b,
    "command-r-plus-104b": command_r_plus_104b,
    "stablelm-12b": stablelm_12b,
    "chatglm3-6b": chatglm3_6b,
    "zamba2-7b": zamba2_7b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "rwkv6-3b": rwkv6_3b,
    "internvl2-1b": internvl2_1b,
}

ARCH_IDS = tuple(_MODULES)

PAPER_MODELS = {
    "bert-base": paper_models.bert_base,
    "opt-125m": paper_models.opt_125m,
    "vit-base": paper_models.vit_base,
}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch in _MODULES:
        mod = _MODULES[arch]
        return mod.smoke() if smoke else mod.full()
    if arch in PAPER_MODELS:
        return PAPER_MODELS[arch]()
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS) + sorted(PAPER_MODELS)}")
