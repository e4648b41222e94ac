"""chatglm3-6b [dense]: 28L, d=4096, 32H (GQA kv=2), d_ff=13696, vocab=65024.

[arXiv:2406.12793; hf].  2D (half-dim) RoPE, 2-group multi-query attention,
QKV bias, RMSNorm, SwiGLU.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "chatglm3-6b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        rope_kind="half",
        qkv_bias=True,
        subquadratic=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        rope_kind="half",
        qkv_bias=True,
    )
