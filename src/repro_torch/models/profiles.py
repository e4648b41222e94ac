"""Production performance profiles (port of ``repro.models.profiles``).

``apply_perf_profile(cfg, "serve")`` turns on the inference flags that the
reference validated (ring window caches, int8 KV, bf16-operand attention,
MLA/GQA prefill head-sharding), under the same applicability conditions.
The paper-faithful baseline is the config without a profile.

The two head-sharding hints are set as the reference sets them.  They only
place query heads on a tensor-parallel mesh axis during prefill; on one card
(no mesh) they change nothing, as they change nothing in the reference
without a mesh.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

PROFILES = ("baseline", "serve")


def apply_perf_profile(cfg: ModelConfig, profile: str, *, tp: int = 16) -> ModelConfig:
    if profile == "baseline":
        return cfg
    if profile != "serve":
        raise ValueError(f"unknown profile {profile!r}")
    kw = {}
    if cfg.window:
        kw["ring_window_cache"] = True
    if cfg.attn_kind == "gqa" and cfg.n_kv_heads >= 1:
        kw["kv_cache_int8"] = True
    kw["attend_bf16"] = True
    if cfg.attn_kind == "mla":
        kw["mla_prefill_headshard"] = True
    if cfg.attn_kind == "gqa" and cfg.n_heads % tp == 0:
        kw["gqa_prefill_headshard"] = True
    return dataclasses.replace(cfg, **kw)
