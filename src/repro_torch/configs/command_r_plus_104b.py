"""command-r-plus-104b [dense]: 64L, d=12288, 96H (GQA kv=8), d_ff=33792.

[hf:CohereForAI/c4ai-command-r-v01; unverified].  GQA, no biases, parallel
attention+FFN block (Cohere-style), tied embeddings, layernorm.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "command-r-plus-104b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        parallel_block=True,
        norm_kind="layernorm",
        qkv_bias=False,
        tie_embeddings=True,
        subquadratic=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=3,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        parallel_block=True,
        norm_kind="layernorm",
        tie_embeddings=True,
    )
