"""whisper-large-v3 [audio]: enc-dec, 32L, d=1280, 20H (MHA), d_ff=5120.

[arXiv:2212.04356; unverified].  Conv frontend is a STUB per the assignment:
``input_specs()`` delivers precomputed 1500-frame embeddings (30 s of audio at
the post-conv 50 Hz rate).  Vocab padded 51866 -> 51872 (multiple of 32) for
TP sharding; decoder uses sinusoidal absolute positions (rope_kind="none" +
learned-pos stand-in is the documented deviation: the dry-run decode shapes
exceed whisper's trained 448-token window, which is a perf exercise, not an
accuracy claim).
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "whisper-large-v3"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51872,          # 51866 padded to /32
        is_encdec=True,
        encoder_layers=32,
        frontend="audio",
        frontend_seq=1500,
        frontend_dim=1280,
        norm_kind="layernorm",
        gated_ffn=False,
        ffn_act="gelu",
        rope_kind="none",
        qkv_bias=True,
        subquadratic=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        is_encdec=True,
        encoder_layers=2,
        frontend="audio",
        frontend_seq=24,
        frontend_dim=64,
        norm_kind="layernorm",
        gated_ffn=False,
        ffn_act="gelu",
        rope_kind="none",
        qkv_bias=True,
    )
