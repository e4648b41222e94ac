"""internvl2-1b [vlm]: 24L, d=896, 14H (GQA kv=2), d_ff=4864.

[arXiv:2404.16821; hf].  Qwen2-0.5B language backbone; the InternViT frontend
is a STUB per the assignment — ``input_specs()`` provides 256 precomputed
patch embeddings (dim 1024) which are projected and prepended to the token
sequence.  Vocab padded 151655 -> 151664 (multiple of 16) for TP sharding.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "internvl2-1b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151664,       # 151655 padded to /16
        qkv_bias=True,
        frontend="vision",
        frontend_seq=256,
        frontend_dim=1024,
        subquadratic=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        n_layers=3,
        d_model=56,
        n_heads=7,
        n_kv_heads=1,
        d_ff=112,
        vocab_size=512,
        qkv_bias=True,
        frontend="vision",
        frontend_seq=8,
        frontend_dim=32,
    )
