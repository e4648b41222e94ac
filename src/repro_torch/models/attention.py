"""Grouped-query attention with a plain KV cache (port of the GQA branch of
``repro.models.attention``).

``cache=None`` runs full-sequence attention; otherwise ``cache`` is a dict of
preallocated ``[B, Smax, Hkv, hd]`` buffers written at ``pos``.  Unlike the
reference (functional updates on donated buffers), cache writes here update
the buffers **in place** and the returned cache dict holds the same tensors.

Ported: the plain-cache and no-cache branches, pad masking, query-chunked
long prefill, and ``attn_impl="flash"`` on the no-cache branch (the
``flash_attention`` kernel).  Not yet: the ring-window KV cache (the next
module slice of the port), and the int8 KV cache, MLA and cross attention
(the slice of the other model families) — each raises
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear

# Masked scores are filled with this, not -inf: a fully padded query row
# stays finite (uniform weights over don't-care keys), as in the reference.
MASK_FILL = -1e30


def gqa_init(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    hd = cfg.hd
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias, device=device),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, device=device),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, device=device),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, device=device),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _cache_write(cache_arr: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new [B, S, ...]`` into ``cache_arr`` at sequence offset ``pos``,
    in place; returns ``cache_arr``.

    ``pos`` is an int (all rows share the offset — prefill and the loop
    driver) or a ``[B]`` tensor of per-slot offsets (continuous-batching
    decode, where ``S == 1``), written at ``[arange(B), pos]``.
    """
    new = new.to(cache_arr.dtype)
    if isinstance(pos, torch.Tensor) and pos.ndim:
        b = cache_arr.shape[0]
        cache_arr[torch.arange(b, device=cache_arr.device), pos.long()] = new[:, 0]
    else:
        cache_arr[:, pos : pos + new.shape[1]] = new
    return cache_arr


def _key_mask(kpos: torch.Tensor, qpos: torch.Tensor, pad_len, window) -> torch.Tensor:
    """Causal key-validity mask in *logical* coordinates.

    ``kpos`` are buffer key positions ``[1, T]``; ``qpos`` logical query
    positions ``[B, S, 1]``.  With left-padding, ``pad_len [B]`` shifts keys
    into logical coordinates and masks the pad positions out (logical < 0).
    """
    if pad_len is not None:
        kpos = kpos - pad_len[:, None]
    k = kpos[:, None, :]                                   # [B|1, 1, T]
    m = k <= qpos
    if pad_len is not None:
        m = m & (k >= 0)
    if window is not None:
        m = m & (k > qpos - window)
    return m


def _attend(
    q: torch.Tensor,            # [B, S, H, hd]
    k: torch.Tensor,            # [B, T, Hkv, hd]
    v: torch.Tensor,            # [B, T, Hkv, hd]
    *,
    mask: torch.Tensor,         # [B, 1, S, T] or broadcastable boolean
    softcap_val: Optional[float],
) -> torch.Tensor:
    """Masked softmax attention in f32; output in ``q.dtype``."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, s, hkv, rep, hd)
    scores = torch.einsum(
        "bsgrd,btgd->bgrst", qg.to(torch.float32), k.to(torch.float32)
    ) / math.sqrt(hd)
    scores = layers.softcap(scores, softcap_val)
    scores = torch.where(mask[:, :, None] if mask.ndim == 4 else mask, scores, MASK_FILL)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v.to(torch.float32))
    return out.reshape(b, s, h, hd).to(q.dtype)


def causal_mask(s: int, t: int, *, offset: int = 0, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """[1, 1, s, t] boolean; query i (global pos offset+i) sees keys <= it."""
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m[None, None]


# Above this many query positions, full-sequence attention runs in query
# chunks so scores never materialize at [S, S].
CHUNK_THRESHOLD = 4096
CHUNK_SIZE = 512


def _attend_chunked(
    q: torch.Tensor,            # [B, S, H, hd]
    k: torch.Tensor,            # [B, T, Hkv, hd]
    v: torch.Tensor,
    positions: torch.Tensor,    # [B, S] query positions (logical)
    *,
    window: Optional[int],
    softcap_val: Optional[float],
    causal: bool,
    pad_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    b, s, h, hd = q.shape
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    outs = []
    for c0 in range(0, s, CHUNK_SIZE):
        q_i = q[:, c0 : c0 + CHUNK_SIZE]
        pos_i = positions[:, c0 : c0 + CHUNK_SIZE]
        if causal:
            m = _key_mask(kpos, pos_i[:, :, None], pad_len, window)
        else:
            m = torch.ones((b, q_i.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
            if window is not None:
                m = m & (kpos[:, None, :] > pos_i[:, :, None] - window)
        outs.append(_attend(q_i, k, v, mask=m[:, None], softcap_val=softcap_val))
    return torch.cat(outs, dim=1)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: the ring-window KV cache and the "
        f"other model families); this slice runs GQA with a plain KV cache"
    )


def gqa_attention(
    p: dict,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,                 # [B, S] logical positions (RoPE + mask)
    cache: Optional[dict] = None,            # {"k": [B, Smax, Hkv, hd], "v": ...}
    pos=None,                                # cache write offset: int or [B] tensor
    window: Optional[int] = None,
    causal: bool = True,
    pad_len: Optional[torch.Tensor] = None,  # [B] left-pad lengths: pad keys masked
) -> tuple[torch.Tensor, Optional[dict]]:
    b, s, _ = x.shape
    hd = cfg.hd
    if cache is not None and "k_s" in cache:
        raise _unported("the int8 KV cache")
    if cache is not None and window is not None and cache["k"].shape[1] <= window:
        raise _unported("the ring window cache")
    q = _split_heads(linear(p["wq"], x), cfg.n_heads)
    k = _split_heads(linear(p["wk"], x), cfg.n_kv_heads)
    v = _split_heads(linear(p["wv"], x), cfg.n_kv_heads)
    q = layers.apply_rope(q, positions, cfg.rope_theta, cfg.rope_kind)
    k = layers.apply_rope(k, positions, cfg.rope_theta, cfg.rope_kind)

    if cache is not None:
        kc = _cache_write(cache["k"], k, pos)
        vc = _cache_write(cache["v"], v, pos)
        new_cache = {"k": kc, "v": vc}
        if s > CHUNK_THRESHOLD and s % CHUNK_SIZE == 0:
            out = _attend_chunked(
                q, kc, vc, positions, window=window,
                softcap_val=cfg.attn_logit_softcap, causal=True, pad_len=pad_len,
            )
        else:
            t = kc.shape[1]
            m = _key_mask(torch.arange(t, device=x.device)[None, :],
                          positions[:, :, None], pad_len, window)   # [B, S, T]
            out = _attend(q, kc, vc, mask=m[:, None], softcap_val=cfg.attn_logit_softcap)
    else:
        new_cache = None
        if cfg.attn_impl == "flash":
            out = ops.flash_attention(
                q, k, v, causal=causal, window=window,
                softcap=cfg.attn_logit_softcap,
            )
        elif s > CHUNK_THRESHOLD and s % CHUNK_SIZE == 0:
            out = _attend_chunked(
                q, k, v, positions, window=window,
                softcap_val=cfg.attn_logit_softcap, causal=causal,
            )
        else:
            m = (causal_mask(s, s, window=window, device=x.device) if causal
                 else torch.ones((1, 1, s, s), dtype=torch.bool, device=x.device))
            out = _attend(q, k, v, mask=m, softcap_val=cfg.attn_logit_softcap)
    y = linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
    return y, new_cache
