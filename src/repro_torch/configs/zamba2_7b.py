"""zamba2-7b [hybrid]: 81L, d=3584, Mamba2 + shared attention blocks.

[arXiv:2411.15242; unverified].  Mamba2 backbone (ssm_state=64, expand=2,
head_dim=64 -> 112 SSD heads) with a *shared* full-attention+FFN block applied
every 6 layers (pattern "MMMMMS": 13 units + 3 trailing Mamba layers = 81).
Shared attention: 32H MHA (kv=32), d_ff=14336.  Sub-quadratic: runs the
long_500k decode cell (O(1) SSD state; the shared-attn KV cache is the only
seq-length-bound state).

LoCaLUT applicability: in/out projections + shared-attn GEMMs quantize; the
SSD recurrence is elementwise and stays bf16 (DESIGN.md §5).
"""

from repro_torch.models.config import ModelConfig, SSMConfig

ARCH_ID = "zamba2-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        layer_pattern="MMMMMS",
        attn_every=6,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, n_groups=1),
        subquadratic=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        n_layers=7,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        layer_pattern="MMS",
        attn_every=3,
        ssm=SSMConfig(d_state=8, head_dim=8, expand=2, conv_width=4, n_groups=1),
        subquadratic=True,
    )
