"""gemma2-2b [dense]: 26L, d=2304, 8H (GQA kv=4), d_ff=9216, vocab=256000.

[arXiv:2408.00118; hf].  Local(4096-window)/global alternating attention,
attention-logit softcap 50, final-logit softcap 30, head_dim=256, GeGLU FFN,
tied embeddings.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "gemma2-2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        layer_pattern="LG",
        window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        ffn_act="gelu",
        gated_ffn=True,
        tie_embeddings=True,
        subquadratic=False,  # global layers are full attention -> skip long_500k
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        layer_pattern="LG",
        window=8,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        ffn_act="gelu",
        gated_ffn=True,
        tie_embeddings=True,
    )
