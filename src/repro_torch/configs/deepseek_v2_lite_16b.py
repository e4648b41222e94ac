"""deepseek-v2-lite-16b [moe]: 27L, d=2048, 16H MLA, 64 routed + 2 shared, top-6.

[arXiv:2405.04434; hf].  MLA with kv_lora_rank=512 (the compressed-latent KV
cache), qk_nope=128 + qk_rope=64, v_head=128.  Layer 0 is a dense FFN
(d_ff=10944); layers 1-26 are MoE with expert hidden 1408.  Router stays fp32
(paper keeps accuracy-critical host ops in fp).
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v2-lite-16b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,             # the first dense layer
        vocab_size=102400,
        attn_kind="mla",
        mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(
            n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
            capacity_factor=1.25,
        ),
        first_dense_layers=1,
        subquadratic=False,     # MLA is still quadratic attention
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        attn_kind="mla",
        mla=MLAConfig(kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8),
        moe=MoEConfig(n_experts=8, n_shared_experts=2, top_k=2, d_ff_expert=32),
        first_dense_layers=1,
    )
