"""rwkv6-3b [ssm]: 32L, d=2560 (attention-free), d_ff=8960, vocab=65536.

[arXiv:2404.05892; hf].  RWKV6 "Finch": linear attention with data-dependent
decay; head_dim=64 -> 40 heads.  Sub-quadratic (O(1) recurrent state): runs
the long_500k decode cell.
"""

from repro_torch.models.config import ModelConfig, RWKVConfig

ARCH_ID = "rwkv6-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        attn_kind="none",
        rope_kind="full",       # unused by RWKV blocks
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
        gated_ffn=False,
        norm_kind="layernorm",
        subquadratic=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        n_layers=3,
        d_model=64,
        n_heads=8,
        n_kv_heads=8,
        d_ff=128,
        vocab_size=512,
        attn_kind="none",
        rwkv=RWKVConfig(head_dim=8, decay_lora=8, mix_lora=4),
        gated_ffn=False,
        norm_kind="layernorm",
        subquadratic=True,
    )
