"""llama4-maverick-400b-a17b [moe]: 48L, d=5120, 40H (GQA kv=8), 128e top-1.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Dense and MoE layers
alternate (interleave step 2 -> pattern "FD"); each MoE layer has 128 routed
experts (top-1) + 1 shared expert, expert hidden 8192; head_dim=128,
vocab=202048.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

ARCH_ID = "llama4-maverick-400b-a17b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        layer_pattern="FD",     # alternate dense-FFN / MoE layers
        moe=MoEConfig(
            n_experts=128, n_shared_experts=1, top_k=1, d_ff_expert=8192,
            capacity_factor=1.25,
        ),
        subquadratic=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        layer_pattern="FD",
        moe=MoEConfig(n_experts=8, n_shared_experts=1, top_k=1, d_ff_expert=32),
    )
