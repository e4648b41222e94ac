"""stablelm-12b [dense]: 40L, d=5120, 32H (GQA kv=8), d_ff=13824.

[hf:stabilityai/stablelm-2-1_6b; hf].  LayerNorm, partial rotary (we model it
as rope_kind="half"), gated SiLU FFN.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "stablelm-12b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        norm_kind="layernorm",
        rope_kind="half",
        qkv_bias=False,
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
        norm_kind="layernorm",
        rope_kind="half",
    )
