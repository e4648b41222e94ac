"""Attention with a KV cache: grouped-query attention and DeepSeek's
multi-head latent attention (port of the GQA and MLA branches of
``repro.models.attention``).

``cache=None`` runs full-sequence attention; otherwise ``cache`` is a dict of
preallocated buffers written at ``pos``: ``[B, Smax, Hkv, hd]`` keys and
values for GQA, the ``[B, Smax, lora]`` compressed latent and ``[B, Smax,
rope]`` rotated key part for MLA.  Unlike the reference (functional updates
on donated buffers), cache writes here update the buffers **in place** and
the returned cache dict holds the same tensors.

GQA: the plain-cache and no-cache branches, pad masking, query-chunked long
prefill, ``attn_impl="flash"`` on the no-cache branch (the
``flash_attention`` kernel), the ring-window cache of a sliding-window layer
(any cache no longer than the window), the int8 KV cache (``{"k", "k_s",
"v", "v_s"}``: codes and per-row scales) and ``attend_bf16`` (bf16 Q/K/V and
probabilities, f32 scores and sums).  MLA (:func:`mla_attention`): the
absorbed formulation, the latent cache, pad masking, the chunked long
prefill and ``attend_bf16``.  Cross attention (:func:`cross_attention`,
:func:`cross_kv`): the decoder's queries over the encoder's keys and values,
cached in ``ck`` / ``cv`` at the encoder's length.  The attention itself is
plain torch ops, as it is plain XLA in the reference.

Every cached branch also runs over **sequence-sharded caches** (``seq=``, a
:class:`repro_torch.dist.runtime.SeqShard`: this TP rank holds positions
``[r·n, (r+1)·n)`` of a leaf of local length ``n``): the writes land only on
the rank that holds the position, and the softmax runs context-parallel
over the shards (:func:`_cp_softmax`, the rules in
:mod:`repro_torch.dist.runtime`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import PreparedLinear, QuantizedLinear
from repro_torch.core.calibrate import unwrap
from repro_torch.dist.runtime import ShardedLinear
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


def _cache_write(cache_arr: torch.Tensor, new: torch.Tensor, pos, seq=None) -> torch.Tensor:
    """Write ``new [B, S, ...]`` into ``cache_arr`` at sequence offset ``pos``,
    in place; returns ``cache_arr``.

    ``pos`` is an int (all rows share the offset — prefill and the loop
    driver) or a ``[B]`` tensor of per-slot offsets (continuous-batching
    decode, where ``S == 1``), written at ``[arange(B), pos]``.  With ``seq``
    ``cache_arr`` is this rank's slice of the sequence (:func:`_shard_write`).
    """
    if seq is not None:
        return _shard_write(cache_arr, new, pos, seq.lo(cache_arr.shape[1]))
    new = new.to(cache_arr.dtype)
    if isinstance(pos, torch.Tensor) and pos.ndim:
        b = cache_arr.shape[0]
        cache_arr[torch.arange(b, device=cache_arr.device), pos.long()] = new[:, 0]
    else:
        cache_arr[:, pos : pos + new.shape[1]] = new
    return cache_arr


def _shard_write(cache_arr: torch.Tensor, new: torch.Tensor, pos, lo: int) -> torch.Tensor:
    """Write the positions of ``new [B, S, ...]`` at global offset ``pos`` that
    fall in this rank's slice ``[lo, lo + n)`` of the sequence, in place.  An
    int ``pos`` copies the overlap of ``[pos, pos + S)`` with the slice; a
    ``[B]`` tensor (``S == 1``) writes each row at ``pos - lo`` where the rank
    holds it and the old value back elsewhere (a ``torch.where``: no host
    sync)."""
    n = cache_arr.shape[1]
    new = new.to(cache_arr.dtype)
    if isinstance(pos, torch.Tensor) and pos.ndim:
        rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
        local = pos.long() - lo
        at = local.clamp(0, n - 1)
        mine = ((local >= 0) & (local < n)).reshape((-1,) + (1,) * (new.ndim - 2))
        cache_arr[rows, at] = torch.where(mine, new[:, 0], cache_arr[rows, at])
    else:
        a, e = max(pos, lo), min(pos + new.shape[1], lo + n)
        if a < e:
            cache_arr[:, a - lo : e - lo] = new[:, a - pos : e - pos]
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
    bf16_operands: bool = False,
    seq=None,
) -> torch.Tensor:
    """Masked softmax attention with f32 scores and sums; output in
    ``q.dtype``.  ``bf16_operands`` rounds Q, K, V and the probabilities to
    bf16 first (the reference's bf16 einsums with f32 accumulation): the
    products of bf16 values are exact in f32, so the scores are f32 sums of
    the same products — never rounded to bf16 before the softcap.  With
    ``seq`` the keys are this rank's slice (``mask`` over it) and the softmax
    runs over every rank's (:func:`_cp_softmax`)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, s, hkv, rep, hd)
    op = _bf16_rounded if bf16_operands else (lambda t: t.to(torch.float32))
    scores = torch.einsum("bsgrd,btgd->bgrst", op(qg), op(k)) / math.sqrt(hd)
    scores = layers.softcap(scores, softcap_val)
    scores = torch.where(mask[:, :, None] if mask.ndim == 4 else mask, scores, MASK_FILL)
    if seq is not None:
        out = _cp_softmax([scores], [op(v)], lambda w, vv: torch.einsum(
            "bgrst,btgd->bsgrd", w, vv), op, seq.reduce)
        return out.reshape(b, s, h, hd).to(q.dtype)
    w = op(torch.softmax(scores, dim=-1))
    out = torch.einsum("bgrst,btgd->bsgrd", w, op(v))
    return out.reshape(b, s, h, hd).to(q.dtype)


def _cp_softmax(scores: list, values: list, product, op, reduce) -> torch.Tensor:
    """The context-parallel softmax product over key shards: ``scores`` (the
    masked f32 scores of each shard, keys last) and ``values``, one each per
    shard held here.  The rows' max is combined over the shards (MAX),
    ``exp(s - M)`` summed locally and combined (SUM), the normalized
    probabilities (``op``: rounded to bf16 where the plain form rounds them)
    multiplied with the local values (``product(w, v)``) and combined (SUM).
    ``reduce(partials, op)`` combines: over TP
    (:meth:`repro_torch.dist.runtime.SeqShard.reduce`, one partial a rank) or
    over every shard held in one process
    (:func:`repro_torch.dist.runtime.combine`).  A shard whose keys are all
    masked for a row adds ``exp(MASK_FILL - M) = 0``."""
    m = reduce([sc.amax(dim=-1, keepdim=True) for sc in scores], "max")
    es = [torch.exp(sc - m) for sc in scores]
    total = reduce([e.sum(dim=-1, keepdim=True) for e in es], "sum")
    return reduce([product(op(e / total), v) for e, v in zip(es, values)], "sum")


def _bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and held in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


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
# The full-cache branch attends in blocks of this many query rows.
INVARIANT_ROWS = 32


def _attend_cache_invariant(
    q: torch.Tensor,            # [B, S, H, hd]
    kc: torch.Tensor,           # [B, T, Hkv, hd] the cache, buffer order
    vc: torch.Tensor,
    positions: torch.Tensor,    # [B, S] query positions (logical)
    *,
    window: Optional[int],
    softcap_val: Optional[float],
    bf16_operands: bool,
    pad_len: Optional[torch.Tensor],
    seq=None,
) -> torch.Tensor:
    """The cached branch's attention, computed so that a query row's bits do
    not depend on how many rows share the call or on its row's left pad:
    the function is ``_attend`` over the cache with ``_key_mask``.  With
    ``seq`` the cache is this rank's slice of the sequence
    (:func:`_attend_cache_shards`).

    Served on the card, a row is decoded alone (S = 1) and, after a restart,
    prefilled among S rows behind another pad (the request log's
    teacher-forced replay).  cuBLAS picks its GEMM kernel by the shape, and
    the softmax and the GEMMs group their sums by buffer index, so the same
    row can come out with other last bits — which the 3-bit activation
    quantizer of the next layer turns into other codes.  Here each row's
    keys are first rolled into logical order (key ``j`` at index ``j``, the
    pad wrapped past the end and masked) and laid out once for the products,
    and the queries go through in blocks of :data:`INVARIANT_ROWS` rows, the
    last block padded with masked rows: every product has one shape, every
    sum one grouping."""
    if seq is not None:
        return _attend_cache_shards(
            q, [kc], [vc], [seq.lo(kc.shape[1])], positions, window=window,
            softcap_val=softcap_val, bf16_operands=bf16_operands, pad_len=pad_len,
            reduce=seq.reduce)
    b, s, h, hd = q.shape
    t, hkv = kc.shape[1], kc.shape[2]
    rep = h // hkv
    n = INVARIANT_ROWS
    blocks = -(-s // n)
    j = torch.arange(t, device=q.device)
    shift = 0 if pad_len is None else pad_len.long()[:, None]
    idx = (j[None, :] + shift) % t if pad_len is not None else j[None, :].expand(b, t)
    valid = j[None, :] < t - shift                                        # [B|1, T]
    m = (j[None, None, :] <= positions[:, :, None]) & valid[:, None, :]  # [B, S, T]
    if window is not None:
        m = m & (j[None, None, :] > positions[:, :, None] - window)
    op = _bf16_rounded if bf16_operands else (lambda x: x.to(torch.float32))
    # Keys and values rolled into logical order and laid out for the
    # products in one gather each; the queries in their blocks in one copy.
    kt = op(torch.gather(kc.permute(0, 2, 3, 1), 3,
                         idx[:, None, None, :].expand(b, hkv, hd, t)))    # [B, Hkv, hd, T]
    vt = op(torch.gather(vc.permute(0, 2, 1, 3), 2,
                         idx[:, None, :, None].expand(b, hkv, t, hd)))    # [B, Hkv, T, hd]
    if blocks * n != s:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, blocks * n - s))
        m = torch.nn.functional.pad(m, (0, 0, 0, blocks * n - s))
    qb = op(q).view(b, blocks, n, hkv, rep, hd).permute(1, 0, 3, 4, 2, 5).contiguous()
    mb = m.view(b, 1, 1, blocks, n, t)
    outs = []
    for i in range(blocks):                         # [B, Hkv, rep * n, hd] each
        scores = torch.matmul(qb[i].view(b, hkv, rep * n, hd), kt) / math.sqrt(hd)
        scores = torch.where(mb[:, :, :, i], layers.softcap(scores, softcap_val)
                             .view(b, hkv, rep, n, t), MASK_FILL)
        w = op(torch.softmax(scores, dim=-1)).view(b, hkv, rep * n, t)
        outs.append(torch.matmul(w, vt))
    out = torch.stack(outs).view(blocks, b, hkv, rep, n, hd).permute(1, 0, 4, 2, 3, 5)
    return out.reshape(b, blocks * n, h, hd)[:, :s].to(q.dtype)


def _attend_cache_shards(
    q: torch.Tensor,            # [B, S, H, hd]
    kcs: list,                  # [B, n_i, Hkv, hd] each: cache slices, buffer order
    vcs: list,
    los: list,                  # the first global buffer position of each slice
    positions: torch.Tensor,    # [B, S] query positions (logical)
    *,
    window: Optional[int],
    softcap_val: Optional[float],
    bf16_operands: bool,
    pad_len: Optional[torch.Tensor],
    reduce,
) -> torch.Tensor:
    """:func:`_attend_cache_invariant` over slices of the cache's sequence:
    the same blocks of :data:`INVARIANT_ROWS` query rows, each key masked at
    its *global* buffer position ``lo + j`` (logical ``lo + j - pad``: valid
    from 0 up to the query's position, within the window), and the softmax
    of each block over the slices (:func:`_cp_softmax`, ``reduce``).  Keys
    are not rolled: a roll would cross the slices, so a row's sums are
    grouped by where its pad puts the slices' boundaries."""
    b, s, h, hd = q.shape
    hkv = kcs[0].shape[2]
    rep = h // hkv
    n = INVARIANT_ROWS
    blocks = -(-s // n)
    op = _bf16_rounded if bf16_operands else (lambda x: x.to(torch.float32))
    pad = 0 if pad_len is None else pad_len.long()[:, None]
    qpos = positions[:, :, None]
    shards = []
    for kc, vc, lo in zip(kcs, vcs, los):
        t = kc.shape[1]
        kl = (lo + torch.arange(t, device=q.device))[None, :] - pad         # [B|1, t] logical
        m = (kl[:, None, :] <= qpos) & (kl >= 0)[:, None, :]                # [B, S, t]
        if window is not None:
            m = m & (kl[:, None, :] > qpos - window)
        if blocks * n != s:
            m = torch.nn.functional.pad(m, (0, 0, 0, blocks * n - s))
        shards.append((op(kc.permute(0, 2, 3, 1).contiguous()),         # [B, Hkv, hd, t]
                       op(vc.permute(0, 2, 1, 3).contiguous()),         # [B, Hkv, t, hd]
                       m.view(b, 1, 1, blocks, n, t)))
    if blocks * n != s:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, blocks * n - s))
    qb = op(q).view(b, blocks, n, hkv, rep, hd).permute(1, 0, 3, 4, 2, 5).contiguous()
    outs = []
    for i in range(blocks):                         # [B, Hkv, rep * n, hd] each
        qi = qb[i].view(b, hkv, rep * n, hd)
        scores = [torch.where(mb[:, :, :, i], layers.softcap(
            torch.matmul(qi, kt) / math.sqrt(hd), softcap_val).view(b, hkv, rep, n, -1),
            MASK_FILL).view(b, hkv, rep * n, -1) for kt, _vt, mb in shards]
        outs.append(_cp_softmax(scores, [vt for _kt, vt, _mb in shards], torch.matmul, op,
                                reduce))
    out = torch.stack(outs).view(blocks, b, hkv, rep, n, hd).permute(1, 0, 4, 2, 3, 5)
    return out.reshape(b, blocks * n, h, hd)[:, :s].to(q.dtype)


def _attend_chunked(
    q: torch.Tensor,            # [B, S, H, hd]
    k: torch.Tensor,            # [B, T, Hkv, hd]
    v: torch.Tensor,
    positions: torch.Tensor,    # [B, S] query positions (logical)
    *,
    window: Optional[int],
    softcap_val: Optional[float],
    causal: bool,
    bf16_operands: bool = False,
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
        outs.append(_attend(q_i, k, v, mask=m[:, None], softcap_val=softcap_val,
                            bf16_operands=bf16_operands))
    return torch.cat(outs, dim=1)


def _quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(token, head) row quantization: [B,S,H,hd] ->
    (int8 codes, f32 scales [B,S,H]).  The reference serves this function
    under ``jit``, where XLA turns its ``/ 127`` into a product with
    ``f32(1/127)``; the scale here is that product, so it equals the served
    (jitted) scale bit for bit, where a true quotient can differ in the last
    bit.  ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
    codes are the reference's too."""
    xf = x.to(torch.float32)
    recip = float(np.float32(1.0) / np.float32(127.0))
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) * recip
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def _ring_update(cache_arr: torch.Tensor, new: torch.Tensor, global_start, tail: int,
                 seq=None):
    """Write the last ``tail`` tokens of ``new`` into the ring buffer at their
    ``global_position % W`` slots, in place; returns ``cache_arr``.
    ``global_start`` is an int, written at ``[:, idx]``, or a per-slot ``[B]``
    tensor (continuous-batching decode), written at ``[arange(B)[:, None],
    idx]``.  The ``tail <= W`` slots are distinct: no write lands twice.
    With ``seq`` ``cache_arr`` is this rank's slots ``[lo, lo + n)`` of a ring
    of ``W = n·tp``: each slot is written by the rank that holds it
    (:func:`_shard_write`; an int start's slots in at most two runs, split
    where the ring wraps)."""
    if seq is not None:
        n = cache_arr.shape[1]
        w, lo, src = n * seq.size, seq.lo(n), new[:, -tail:]
        if isinstance(global_start, torch.Tensor) and global_start.ndim:
            for i in range(tail):
                _shard_write(cache_arr, src[:, i : i + 1], (global_start.long() + i) % w, lo)
            return cache_arr
        first = global_start % w
        run = min(tail, w - first)
        _shard_write(cache_arr, src[:, :run], first, lo)
        if run < tail:
            _shard_write(cache_arr, src[:, run:], 0, lo)
        return cache_arr
    w, dev = cache_arr.shape[1], cache_arr.device
    src = new[:, -tail:].to(cache_arr.dtype)
    ar = torch.arange(tail, device=dev)
    if isinstance(global_start, torch.Tensor) and global_start.ndim:
        b = cache_arr.shape[0]
        idx = (global_start.long()[:, None] + ar[None, :]) % w           # [B, tail]
        cache_arr[torch.arange(b, device=dev)[:, None], idx] = src
    else:
        cache_arr[:, (global_start + ar) % w] = src
    return cache_arr


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
    seq=None,                                # SeqShard: the cache holds this rank's slice
) -> tuple[torch.Tensor, Optional[dict]]:
    b, s, _ = x.shape
    hd = cfg.hd
    bf16 = cfg.attend_bf16
    softcap_val = cfg.attn_logit_softcap
    q = _split_heads(linear(p["wq"], x), cfg.n_heads)
    k = _split_heads(linear(p["wk"], x), cfg.n_kv_heads)
    v = _split_heads(linear(p["wv"], x), cfg.n_kv_heads)
    q = layers.apply_rope(q, positions, cfg.rope_theta, cfg.rope_kind)
    k = layers.apply_rope(k, positions, cfg.rope_theta, cfg.rope_kind)
    chunked = s > CHUNK_THRESHOLD and s % CHUNK_SIZE == 0

    # Sliding-window layers may carry a ring-buffer cache of exactly `window`
    # slots (Mistral-style): decode reads W entries instead of the full
    # context.  Any cache no longer than the window takes this branch (its
    # global length: a sharded cache holds 1/tp of it).
    n_local = cache["k"].shape[1] if cache is not None else 0
    if cache is not None and window is not None and n_local * (seq.size if seq else 1) <= window:
        w = n_local * (seq.size if seq else 1)
        if s == 1:  # decode: write slot pos % W, then attend over the ring
            kc = _ring_update(cache["k"], k, pos, 1, seq)
            vc = _ring_update(cache["v"], v, pos, 1, seq)
            lo = seq.lo(n_local) if seq else 0
            slots = lo + torch.arange(n_local, device=x.device)[None]      # [1, n] global
            pos2 = pos.long()[:, None] if isinstance(pos, torch.Tensor) and pos.ndim else pos
            kpos_global = pos2 - ((pos2 - slots) % w)                      # in (pos-W, pos]
            start = 0 if pad_len is None else pad_len[:, None]
            m = (kpos_global >= start)[:, None, :].expand(b, 1, n_local)
            out = _attend(q, kc, vc, mask=m[:, None], softcap_val=softcap_val,
                          bf16_operands=bf16, seq=seq)
        else:       # prefill: in-sequence attention; store the last W tokens
            if chunked:
                out = _attend_chunked(q, k, v, positions, window=window,
                                      softcap_val=softcap_val, causal=True,
                                      bf16_operands=bf16, pad_len=pad_len)
            else:
                if pad_len is None:
                    m = causal_mask(s, s, window=window, device=x.device)
                else:
                    m = _key_mask(torch.arange(s, device=x.device)[None, :],
                                  positions[:, :, None], pad_len, window)[:, None]
                out = _attend(q, k, v, mask=m, softcap_val=softcap_val, bf16_operands=bf16)
            tail = min(s, w)
            kc = _ring_update(cache["k"], k, pos + s - tail, tail, seq)
            vc = _ring_update(cache["v"], v, pos + s - tail, tail, seq)
        y = linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
        return y, {"k": kc, "v": vc}

    if cache is not None:
        if "k_s" in cache:
            # int8 KV cache: codes + per-row scales are stored; attention
            # reads them back as codes * scale in f32.
            k8, ks = _quant_rows(k)
            v8, vs = _quant_rows(v)
            new_cache = {"k": _cache_write(cache["k"], k8, pos, seq),
                         "k_s": _cache_write(cache["k_s"], ks, pos, seq),
                         "v": _cache_write(cache["v"], v8, pos, seq),
                         "v_s": _cache_write(cache["v_s"], vs, pos, seq)}
            kc = new_cache["k"].to(torch.float32) * new_cache["k_s"][..., None]
            vc = new_cache["v"].to(torch.float32) * new_cache["v_s"][..., None]
        else:
            kc = _cache_write(cache["k"], k, pos, seq)
            vc = _cache_write(cache["v"], v, pos, seq)
            new_cache = {"k": kc, "v": vc}
        # One form at every S: its blocks bound the scores as the reference's
        # query chunks do (S > CHUNK_THRESHOLD), and keep a row's bits.
        out = _attend_cache_invariant(
            q, kc, vc, positions, window=window, softcap_val=softcap_val,
            bf16_operands=bf16, pad_len=pad_len, seq=seq,
        )
    else:
        new_cache = None
        if cfg.attn_impl == "flash":   # attend_bf16 does not reach it, as in the reference
            out = ops.flash_attention(
                q, k, v, causal=causal, window=window, softcap=softcap_val,
            )
        elif chunked:
            out = _attend_chunked(
                q, k, v, positions, window=window, softcap_val=softcap_val,
                causal=causal, bf16_operands=bf16,
            )
        else:
            m = (causal_mask(s, s, window=window, device=x.device) if causal
                 else torch.ones((1, 1, s, s), dtype=torch.bool, device=x.device))
            out = _attend(q, k, v, mask=m, softcap_val=softcap_val, bf16_operands=bf16)
    y = linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
    return y, new_cache


# ---------------------------------------------------------------------------
# Cross attention (enc-dec)
# ---------------------------------------------------------------------------


def cross_attention(
    p: dict,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    enc_k: torch.Tensor,                     # [B, T, Hkv, hd] (from the encoder output)
    enc_v: torch.Tensor,
    seq=None,                                # SeqShard: enc_k / enc_v hold this rank's frames
) -> torch.Tensor:
    """The decoder's queries over the encoder's keys and values: every key
    visible, no softcap, the f32 ``_attend`` (the reference's too, whatever
    ``attend_bf16`` says), output in ``x.dtype``."""
    b, s, _ = x.shape
    q = _split_heads(linear(p["wq"], x), cfg.n_heads)
    m = torch.ones((1, 1, s, enc_k.shape[1]), dtype=torch.bool, device=x.device)
    out = _attend(q, enc_k, enc_v, mask=m, softcap_val=None, seq=seq)
    return linear(p["wo"], out.reshape(b, s, -1))


def cross_kv(p: dict, enc_out: torch.Tensor, *, cfg: ModelConfig):
    """The cross keys and values ``[B, T, Hkv, hd]`` of the encoder output, in
    its dtype (``wk`` and ``wv`` of the cross block)."""
    k = _split_heads(linear(p["wk"], enc_out), cfg.n_kv_heads)
    v = _split_heads(linear(p["wv"], enc_out), cfg.n_kv_heads)
    return k, v


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention, absorbed formulation)
# ---------------------------------------------------------------------------


def _dense_weight(p) -> torch.Tensor:
    """The f32 ``[K, F]`` matrix of a dense dict, a ``QuantizedLinear`` or a
    ``PreparedLinear`` (MLA absorbs ``W_kup`` / ``W_vup`` into the query and
    output paths, so it needs the matrix itself).  A prepared leaf decodes
    as ``maybe_dequant`` decodes one, so a prepared layer equals its raw
    layer bit for bit; the reference's ``_dense_weight`` decodes only a
    ``QuantizedLinear`` and raises on a ``PreparedLinear`` (ROADMAP, reference
    caveats).  Inside a sharded call a
    :class:`repro_torch.dist.runtime.ShardedLinear` gives its whole matrix:
    the local shard decoded, then all-gathered."""
    p = unwrap(p)   # absorbed matrices never consume an activation scale
    if isinstance(p, ShardedLinear):
        return p.dense_weight(layers.decode_weight)
    if isinstance(p, (QuantizedLinear, PreparedLinear)):
        return layers.decode_weight(p)
    return p["w"]


def mla_init(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    return {
        "w_dkv": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_dim, device=device),
        "w_kup": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_dim, device=device),
        "w_vup": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, device=device),
        "wq": dense_init(gen, d, h * (m.qk_nope_dim + m.qk_rope_dim), device=device),
        "wo": dense_init(gen, h * m.v_head_dim, d, device=device),
        "kv_norm": layers.rmsnorm_init(m.kv_lora_rank, device),
    }


def _latent_attend(q_lat, q_rope, ckv, krope, positions, pad_len, scale: float,
                   bf16: bool, seq=None) -> torch.Tensor:
    """Softmax attention of the absorbed queries over the latent keys:
    ``q_lat [B, S, H, lora]``, ``q_rope [B, S, H, rope]`` against ``ckv
    [B, T, lora]``, ``krope [B, T, rope]`` (all f32; bf16 values held in f32
    under ``bf16``), masked by :func:`_key_mask` at the logical query
    ``positions [B, S]``.  Returns ``[B, S, H, lora]`` f32: the probabilities
    times the latent values (the latent itself).  With ``seq`` the latents
    are this rank's slice of the sequence, masked at their global positions,
    and the softmax runs over every rank's (:func:`_cp_softmax`)."""
    sc = (torch.einsum("bshl,btl->bhst", q_lat, ckv)
          + torch.einsum("bshr,btr->bhst", q_rope, krope)) * scale
    lo = seq.lo(ckv.shape[1]) if seq is not None else 0
    kpos = lo + torch.arange(ckv.shape[1], device=ckv.device)[None, :]
    mk = _key_mask(kpos, positions[:, :, None], pad_len, None)           # [B, S, T]
    sc = torch.where(mk[:, None], sc, MASK_FILL)
    if seq is not None:
        return _cp_softmax([sc], [ckv], lambda w, v: torch.einsum("bhst,btl->bshl", w, v),
                           _bf16_rounded if bf16 else (lambda t: t), seq.reduce)
    w = torch.softmax(sc, dim=-1)
    if bf16:
        w = _bf16_rounded(w)
    return torch.einsum("bhst,btl->bshl", w, ckv)


def mla_attention(
    p: dict,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,                 # [B, S] logical positions
    cache: Optional[dict] = None,            # {"ckv": [B, Smax, lora], "krope": [B, Smax, rope]}
    pos=None,                                # cache write offset: int or [B] tensor
    pad_len: Optional[torch.Tensor] = None,  # [B] left-pad lengths: pad keys masked
    seq=None,                                # SeqShard: the cache holds this rank's slice
) -> tuple[torch.Tensor, Optional[dict]]:
    """Multi-head latent attention, absorbed: the cache holds the normed
    compressed latent ``ckv`` and the rotated shared key part ``krope``;
    ``W_kup`` is folded into the queries and ``W_vup`` into the output, so
    keys and values are never expanded per head.  A prefill longer than
    :data:`CHUNK_THRESHOLD` tokens and a multiple of :data:`CHUNK_SIZE` runs
    in query chunks of that size.  The reference's head-sharding hint
    (``ctx``) places heads on a mesh axis; it is not taken: inside a sharded
    call every TP rank attends over all heads (:mod:`repro_torch.dist.runtime`)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dkv = linear(p["w_dkv"], x)
    ckv, krope = dkv[..., : m.kv_lora_rank], dkv[..., m.kv_lora_rank :]
    ckv = layers.norm(p["kv_norm"], ckv, "rmsnorm", cfg.norm_eps)
    krope = layers.apply_rope(krope[:, :, None, :], positions, cfg.rope_theta, "full")[:, :, 0, :]

    q = linear(p["wq"], x).reshape(b, s, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim :]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta, "full")

    # Absorb W_kup into the query: q_lat[b,s,h,lora] = q_nope . W_kup^T
    wkup = _dense_weight(p["w_kup"]).reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope.to(torch.float32), wkup)

    if cache is not None:
        ckv_c = _cache_write(cache["ckv"], ckv, pos, seq)
        krope_c = _cache_write(cache["krope"], krope, pos, seq)
        new_cache = {"ckv": ckv_c, "krope": krope_c}
    else:
        ckv_c, krope_c = ckv, krope
        new_cache = None

    scale = float(np.float32(1.0) / np.sqrt(np.float32(m.qk_nope_dim + m.qk_rope_dim)))
    op = _bf16_rounded if cfg.attend_bf16 else (lambda t: t.to(torch.float32))
    ckv_f, krope_f, qr_f, q_lat = op(ckv_c), op(krope_c), op(q_rope), op(q_lat)

    if s > CHUNK_THRESHOLD and s % CHUNK_SIZE == 0:
        # chunked prefill: scores never materialize at [S, S]
        out_lat = torch.cat([
            _latent_attend(q_lat[:, c0 : c0 + CHUNK_SIZE], qr_f[:, c0 : c0 + CHUNK_SIZE],
                           ckv_f, krope_f, positions[:, c0 : c0 + CHUNK_SIZE], pad_len, scale,
                           cfg.attend_bf16, seq)
            for c0 in range(0, s, CHUNK_SIZE)], dim=1)
    else:
        out_lat = _latent_attend(q_lat, qr_f, ckv_f, krope_f, positions, pad_len, scale,
                                 cfg.attend_bf16, seq)
    wvup = _dense_weight(p["w_vup"]).reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bshl,lhv->bshv", out_lat, wvup).to(x.dtype)
    y = linear(p["wo"], out.reshape(b, s, h * m.v_head_dim))
    return y, new_cache
