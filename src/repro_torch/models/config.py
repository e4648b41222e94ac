"""Unified model configuration covering every assigned architecture family."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0          # routed expert hidden size
    capacity_factor: float = 1.25
    router_dtype: str = "float32"  # router stays fp (accuracy-critical)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD block (zamba2)."""

    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 "Finch" block (data-dependent decay)."""

    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- attention ---------------------------------------------------------
    attn_kind: str = "gqa"        # gqa | mla | none
    rope_kind: str = "full"       # full | half (chatglm 2d-RoPE) | none
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding-window size for local layers
    layer_pattern: Optional[str] = None
    #   layer_pattern semantics (scanned over its period):
    #     "LG"  gemma2: alternate local / global attention
    #     "M"*k+"A": zamba2: k mamba blocks then a shared attention block
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qkv_bias: bool = False
    parallel_block: bool = False  # stablelm-style parallel attn+FFN
    mla: Optional[MLAConfig] = None

    # --- FFN / MoE ---------------------------------------------------------
    ffn_act: str = "silu"         # silu | gelu | geglu
    gated_ffn: bool = True
    moe: Optional[MoEConfig] = None
    first_dense_layers: int = 0   # deepseek: leading dense-FFN layers

    # --- SSM / RWKV --------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    attn_every: int = 0           # zamba2: shared attn block every N layers

    # --- encoder-decoder / frontends ---------------------------------------
    is_encdec: bool = False
    encoder_layers: int = 0
    frontend: Optional[str] = None   # audio | vision (stub: precomputed embeds)
    frontend_seq: int = 0            # frames / patches emitted by the stub
    frontend_dim: int = 0            # embedding dim delivered by the stub

    # --- misc ---------------------------------------------------------------
    norm_kind: str = "rmsnorm"    # rmsnorm | layernorm
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # Which linears the LoCaLUT quantization transform covers.
    quant_targets: Tuple[str, ...] = ("attn", "ffn", "moe")
    # Sub-quadratic? (drives the long_500k dry-run skip list)
    subquadratic: bool = False
    # Sliding-window layers allocate a ring-buffer KV cache of `window` slots
    # instead of the full context (§Perf optimization; exact semantics).
    ring_window_cache: bool = False
    # MLA prefill: shard the absorbed-query head dim over TP and replicate the
    # (small) latent, instead of contracting a TP-sharded latent — removes the
    # per-layer [B,H,S,T] score all-reduce (§Perf optimization).
    mla_prefill_headshard: bool = False
    # Store GQA KV caches as int8 with per-row scales (§Perf optimization).
    kv_cache_int8: bool = False
    # Mixed-precision attention: bf16 Q/K/V + probs with f32 MXU accumulation
    # (no f32 cache-sized copies; §Perf optimization, TPU-canonical).
    attend_bf16: bool = False
    # GQA prefill: constrain the query-head dim onto the TP axis so scores
    # compute chip-local instead of model-axis-replicated (§Perf optimization;
    # applies when n_heads divides |model|).
    gqa_prefill_headshard: bool = False
    # Full-sequence attention implementation: "xla" (chunked einsum) or
    # "flash" (Pallas online-softmax kernel; scores stay in VMEM — §Perf 4c).
    attn_impl: str = "xla" 

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pattern_period(self) -> int:
        return len(self.layer_pattern) if self.layer_pattern else 1

    def layer_kinds(self) -> list[str]:
        """Expanded per-layer pattern characters across n_layers."""
        if self.layer_pattern:
            pat = self.layer_pattern
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        if self.rwkv is not None:
            return ["R"] * self.n_layers
        if self.is_encdec:
            return ["C"] * self.n_layers
        if self.moe is not None and self.first_dense_layers:
            return ["F"] * self.first_dense_layers + ["D"] * (
                self.n_layers - self.first_dense_layers
            )
        return ["D"] * self.n_layers

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_kind == "mla":
            m = self.mla
            return (
                d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                + d * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                + self.n_heads * m.v_head_dim * d
            )
        return (
            d * self.n_heads * self.hd
            + 2 * d * self.n_kv_heads * self.hd
            + self.n_heads * self.hd * d
        )

    def _ffn_params(self) -> int:
        return (3 if self.gated_ffn else 2) * self.d_model * self.d_ff

    def _moe_params(self, active_only: bool = False) -> int:
        e = self.moe
        d = self.d_model
        n_routed = e.top_k if active_only else e.n_experts
        return (
            n_routed * 3 * d * e.d_ff_expert
            + e.n_shared_experts * 3 * d * e.d_ff_expert
            + d * e.n_experts
        )

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        di = s.expand * d
        nh = di // s.head_dim
        return d * (2 * di + 2 * s.n_groups * s.d_state + nh) + di * d

    def _rwkv_params(self) -> int:
        d, f = self.d_model, self.d_ff
        return 5 * d * d + (d * f + f * d + d * d)

    def _layer_params(self, ch: str, active_only: bool = False) -> int:
        if ch == "D" and self.moe is not None:
            return self._attn_params() + self._moe_params(active_only)
        if ch in ("D", "F", "L", "G", "E"):
            return self._attn_params() + self._ffn_params()
        if ch == "C":
            return 2 * self._attn_params() + self._ffn_params()
        if ch in ("M",):
            return self._ssm_params()
        if ch == "S":
            return self._ssm_params()  # shared attn counted once, below
        if ch == "R":
            return self._rwkv_params()
        raise ValueError(ch)

    def _count(self, active_only: bool) -> int:
        d, v = self.d_model, self.vocab_size
        n = v * d * (1 if self.tie_embeddings else 2)
        kinds = self.layer_kinds()
        n += sum(self._layer_params(ch, active_only) for ch in kinds)
        if "S" in kinds:  # zamba2 shared attention+FFN block (one copy)
            n += self._attn_params() + self._ffn_params()
        if self.is_encdec:
            n += self.encoder_layers * (self._attn_params() + self._ffn_params())
        return n

    def param_count(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS = 6·N·D)."""
        return self._count(active_only=False)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        return self._count(active_only=True)

    def n_moe_layers(self) -> int:
        return sum(
            1 for ch in self.layer_kinds() if ch == "D" and self.moe is not None
        )
