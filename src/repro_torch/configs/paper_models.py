"""The paper's own evaluation models (§VI-A): BERT-base, OPT-125M, ViT-Base.

These drive the end-to-end benchmark harnesses (Fig. 10/14/19).  BERT is
modeled as an encoder stack (pattern "E", prefill-only, Fig. 19(a)); OPT is a
rope-less decoder; ViT is an encoder over stub patch embeddings.
"""

from repro_torch.models.config import ModelConfig


def bert_base() -> ModelConfig:
    return ModelConfig(
        name="bert-base",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=30528,       # 30522 padded to /32
        layer_pattern="E",      # encoder-only: bidirectional, no decode step
        norm_kind="layernorm",
        gated_ffn=False,
        ffn_act="gelu",
        rope_kind="none",
        qkv_bias=True,
    )


def opt_125m() -> ModelConfig:
    return ModelConfig(
        name="opt-125m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=50272,
        norm_kind="layernorm",
        gated_ffn=False,
        ffn_act="gelu",
        rope_kind="none",       # learned abs pos modeled as sinusoid
        qkv_bias=True,
    )


def vit_base() -> ModelConfig:
    return ModelConfig(
        name="vit-base",
        family="vlm",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=1024,        # classification head stand-in
        layer_pattern="E",
        norm_kind="layernorm",
        gated_ffn=False,
        ffn_act="gelu",
        rope_kind="none",
        qkv_bias=True,
        frontend="vision",
        frontend_seq=197,
        frontend_dim=768,
    )
