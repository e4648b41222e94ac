"""Transformer assembly over stacked units (port of
``repro.models.transformer`` for ``"D"``, ``"L"``, ``"G"``, ``"F"``, ``"M"``,
``"S"``, ``"R"``, ``"C"`` and ``"E"`` units: attention + FFN, with a sliding
window on ``"L"``; on a MoE config a ``"D"`` unit's FFN is the MoE block and
an ``"F"`` unit keeps a dense FFN; ``"M"`` is a Mamba2 block
(:mod:`repro_torch.models.ssm`) and ``"S"`` a Mamba2 block followed by
zamba2's *shared* attention + FFN block, whose parameters appear once in the
tree, at ``params["shared_attn"]``; ``"R"`` is an RWKV6 time mix + channel
mix (:mod:`repro_torch.models.rwkv`); ``"C"`` is an enc-dec decoder unit
(causal self attention, cross attention over the encoder output, FFN) and
``"E"`` a bidirectional encoder unit, stacked at ``params["encoder"]`` and
run by :func:`encode` over the stub frontend's frames).

Every architecture is a sequence of *segments*; each segment is a stack of
identical *units* whose parameters are stacked along a leading
``[n_units]`` dim, leaf for leaf as in the reference, so converted trees
and prepared checkpoints line up.  The reference scans a unit with
``lax.scan``; here :func:`run_segments` is a Python loop over the stack.
Caches follow the same segmentation (``[n_units, B, Smax, Hkv, hd]``) and
are updated in place.

Decoders of ``"D"``, ``"L"``, ``"G"`` and ``"F"`` units are ported, with GQA
or MLA attention (``cfg.attn_kind``) and dense or MoE FFNs, zamba2's hybrid
of ``"M"`` and ``"S"`` units, RWKV6's attention-free ``"R"`` units,
whisper's encoder-decoder (``prefix_embeds`` through the encoder, sinusoidal
positions for ``rope_kind="none"``) and the VLM branch of a frontend without
an encoder (internvl2: ``prefix_embeds`` are patch embeddings, cast to the
model's dtype, projected by ``frontend_proj`` and prepended to the tokens).

``forward(ctx=)`` with a mesh runs one rank's part of a sharded forward
over its local shards (:mod:`repro_torch.dist.runtime`: the tokens, caches
and ``prefix_embeds`` are the rank's dp rows; the embedding, the head and
each unit's leaves are bound to the sharded rules; the collectives are
explicit).  Under ``seq_shard`` the caches are also cut along the sequence
on the TP axis: ``forward(max_seq=)`` names the length they were made with,
and each sublayer gets the :class:`repro_torch.dist.runtime.SeqShard` of its
sequence-sharded leaves (``seq``) from :meth:`ShardedRun.cache_seq`.

``forward(remat=True)`` checkpoints each unit of a cache-free forward under
autograd (``torch.utils.checkpoint``; the reference's ``jax.checkpoint``
around its scan body): backward recomputes a unit's activations from its
input instead of keeping them.  ``forward(return_aux=True)`` also returns
the MoE load-balance loss summed over the pass, as the reference's third
output.

Inside a unit, a norm that follows a residual add reads the unrounded f32
sum, while the residual stream itself is stored in ``x.dtype``: the
reference runs a unit as one compiled scan body, where XLA fuses the add
into the norm and keeps the sum in f32 (its default excess precision).  In
bf16 this gives the reference's bits; in f32 it changes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.dist import runtime
from repro_torch.models import attention, ffn, layers, moe, rwkv, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear, norm


def segments(cfg: ModelConfig) -> list[tuple[str, int]]:
    if cfg.layer_pattern:
        period = len(cfg.layer_pattern)
        n_units, rem = divmod(cfg.n_layers, period)
        segs = [(cfg.layer_pattern, n_units)]
        if rem:
            segs.append((cfg.layer_pattern[0] * rem, 1))
        return segs
    if cfg.rwkv is not None:
        return [("R", cfg.n_layers)]
    if cfg.is_encdec:
        return [("C", cfg.n_layers)]
    if cfg.moe is not None and cfg.first_dense_layers:
        return [("F", cfg.first_dense_layers), ("D", cfg.n_layers - cfg.first_dense_layers)]
    return [("D", cfg.n_layers)]


PORTED_UNITS = frozenset({"D", "L", "G", "F", "M", "S", "R", "C", "E"})
RECURRENT_UNITS = frozenset({"M", "S", "R"})


def unit_kinds(cfg: ModelConfig) -> set[str]:
    return {ch for pat, _ in segments(cfg) for ch in pat}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run: units outside
    :data:`PORTED_UNITS`, or a config without attention whose units are not
    all ``"R"``."""
    kinds = unit_kinds(cfg)
    attn_ok = cfg.attn_kind in ("gqa", "mla") or (cfg.attn_kind == "none" and kinds == {"R"})
    if not kinds <= PORTED_UNITS or not attn_ok:
        raise NotImplementedError(
            f"{cfg.name}: units {sorted(kinds)}, attn_kind={cfg.attn_kind!r} are not "
            f"ported yet (only decoders of {sorted(PORTED_UNITS)} units with GQA or MLA "
            f"attention, or of \"R\" units alone without it); they wait for the other "
            f"model families (ROADMAP)"
        )


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _sublayer_init(cfg: ModelConfig, ch: str, gen: torch.Generator, device,
                   expert_fn=None) -> dict:
    d = cfg.d_model
    nrm = layers.rmsnorm_init if cfg.norm_kind == "rmsnorm" else layers.layernorm_init
    if ch in ("M", "S"):
        return {"norm": nrm(d, device), "ssm": ssm.ssm_init(cfg, gen, device)}
    if ch == "R":
        return {"tm_norm": nrm(d, device), "time_mix": rwkv.rwkv_time_init(cfg, gen, device),
                "cm_norm": nrm(d, device),
                "channel_mix": rwkv.rwkv_channel_init(cfg, gen, device)}
    if ch == "C":
        return {"attn_norm": nrm(d, device), "attn": attention.gqa_init(cfg, gen, device),
                "cross_norm": nrm(d, device), "cross": attention.gqa_init(cfg, gen, device),
                "ffn_norm": nrm(d, device), "ffn": ffn.ffn_init(cfg, gen, device=device)}
    p = {"attn_norm": nrm(d, device), "ffn_norm": nrm(d, device)}   # "E" units too
    if cfg.attn_kind == "mla":
        p["attn"] = attention.mla_init(cfg, gen, device)
    else:
        p["attn"] = attention.gqa_init(cfg, gen, device)
    if cfg.moe is not None and ch == "D":
        p["moe"] = moe.moe_init(cfg, gen, device, expert_fn=expert_fn)
    else:
        p["ffn"] = ffn.ffn_init(cfg, gen, device=device)
    return p


def unit_init(cfg: ModelConfig, pattern: str, gen: torch.Generator, device,
              expert_fn=None) -> dict:
    return {f"s{i}_{ch}": _sublayer_init(cfg, ch, gen, device, expert_fn)
            for i, ch in enumerate(pattern)}


def init_params(cfg: ModelConfig, gen: torch.Generator, *, device,
                unit_fn: Optional[Callable[[dict], dict]] = None,
                expert_fn: Optional[Callable[[torch.Tensor], object]] = None) -> dict:
    """Random f32 parameters with the reference's distributions
    (``N(0,1)/sqrt(fan_in)`` linears, ``N(0,1)*0.02`` embeddings, unit
    norms), drawn from ``gen``.  The numbers differ from the reference's
    (another generator); tests that compare the two packages convert the
    reference's tree instead (:mod:`repro_torch.convert`).

    ``unit_fn`` maps each unit's tree before the units are stacked, and
    zamba2's shared attention + FFN block (``params["shared_attn"]``, drawn
    once beside the units) and each encoder unit of an enc-dec model
    (stacked at ``params["encoder"]``, beside ``enc_final_norm`` and the stub
    frontend's dense ``frontend_proj``) — e.g. quantizing it — so a
    full-width model never holds all its f32 weights at once.  ``expert_fn``
    maps each MoE expert ``[K, F]`` as soon as it is drawn, before the next
    (:func:`repro_torch.models.moe.moe_init`): a unit's f32 expert stacks
    are never held either.  Dict keys come in
    the order of the reference's ``init_params``: a stack's keys sorted, as the
    reference's ``jax.tree.map`` stack rebuilds them
    (:func:`repro_torch.tree.sort_keys`), every other dict in insertion order,
    so the quantized leaves walk as in ``Model.quantize(Model.init(key))`` of
    the reference (plan fingerprints and the planner's tie-breaks follow the
    walk)."""
    check_supported(cfg)
    unit_fn = unit_fn or (lambda u: u)
    seg_list = []
    for pattern, n_units in segments(cfg):
        units = [unit_fn(unit_init(cfg, pattern, gen, device, expert_fn))
                 for _ in range(n_units)]
        seg_list.append(tree.sort_keys(tree.stack(units)))
        del units
    params: dict = {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             device=device, dtype=torch.float32) * 0.02,
        "final_norm": (
            layers.rmsnorm_init(cfg.d_model, device)
            if cfg.norm_kind == "rmsnorm"
            else layers.layernorm_init(cfg.d_model, device)
        ),
        "segments": seg_list,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, device=device)
    if "S" in unit_kinds(cfg):
        params["shared_attn"] = unit_fn({
            "attn_norm": layers.rmsnorm_init(cfg.d_model, device),
            "attn": attention.gqa_init(cfg, gen, device),
            "ffn_norm": layers.rmsnorm_init(cfg.d_model, device),
            "ffn": ffn.ffn_init(cfg, gen, device=device),
        })
    if cfg.is_encdec:
        enc = [unit_fn(unit_init(cfg, "E", gen, device)) for _ in range(cfg.encoder_layers)]
        params["encoder"] = tree.sort_keys(tree.stack(enc))
        del enc
        params["enc_final_norm"] = (
            layers.rmsnorm_init(cfg.d_model, device)
            if cfg.norm_kind == "rmsnorm"
            else layers.layernorm_init(cfg.d_model, device)
        )
    if cfg.frontend is not None:
        params["frontend_proj"] = dense_init(gen, cfg.frontend_dim, cfg.d_model, device=device)
    return params


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _sublayer_cache(cfg: ModelConfig, ch: str, n_units: int, batch: int, max_seq: int,
                    dtype, device) -> dict:
    """One sublayer's stacked cache, as the reference's ``_sublayer_cache``
    sizes it: an ``"L"`` cache holds ``min(max_seq, window)`` slots under
    ``ring_window_cache``; a cache that holds all ``max_seq`` positions is
    int8 codes + f32 per-row scales under ``kv_cache_int8``.  An MLA cache is
    the latent ``ckv`` and the rotated key part ``krope`` over all
    ``max_seq`` positions (neither flag applies to it).  An ``"M"`` cache is
    the Mamba2 state (:func:`repro_torch.models.ssm.init_ssm_state`); an
    ``"S"`` cache is that state and the shared attention's plain K/V cache,
    ``{"mamba": ..., "attn": {"k", "v"}}``, as in the reference.  An ``"R"``
    cache is the RWKV6 state in the cache dtype
    (:func:`repro_torch.models.rwkv.init_rwkv_state`), whatever ``max_seq``.
    A ``"C"`` cache is the self-attention K/V over ``max_seq`` and the cross
    K/V ``ck`` / ``cv`` over the encoder's ``frontend_seq`` frames (neither
    flag applies to it); an ``"E"`` unit has none."""
    if ch == "E":
        return None
    if ch == "C":
        lead = (n_units, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        enc = (n_units, batch, cfg.frontend_seq, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(lead, dtype=dtype, device=device),
                "v": torch.zeros(lead, dtype=dtype, device=device),
                "ck": torch.zeros(enc, dtype=dtype, device=device),
                "cv": torch.zeros(enc, dtype=dtype, device=device)}
    if ch == "R":
        return rwkv.init_rwkv_state(cfg, batch, dtype, lead=(n_units,), device=device)
    if ch in ("M", "S"):
        state = ssm.init_ssm_state(cfg, batch, lead=(n_units,), device=device)
        if ch == "M":
            return state
        lead = (n_units, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        return {"mamba": state,
                "attn": {"k": torch.zeros(lead, dtype=dtype, device=device),
                         "v": torch.zeros(lead, dtype=dtype, device=device)}}
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return {"ckv": torch.zeros((n_units, batch, max_seq, m.kv_lora_rank), dtype=dtype,
                                   device=device),
                "krope": torch.zeros((n_units, batch, max_seq, m.qk_rope_dim), dtype=dtype,
                                     device=device)}
    seq = max_seq
    if ch == "L" and cfg.ring_window_cache and cfg.window:
        seq = min(max_seq, cfg.window)   # ring buffer
    lead = (n_units, batch, seq, cfg.n_kv_heads)
    if cfg.kv_cache_int8 and seq == max_seq:
        if ch == "L" and cfg.window and seq <= cfg.window:
            raise NotImplementedError(
                f"{cfg.name}: an int8 'L' cache of {seq} slots is no longer than the "
                f"window ({cfg.window}), so it would take the ring branch; the reference "
                f"writes int8 codes there without a scale and drops k_s / v_s "
                f"(repro.models.attention._ring_update; ROADMAP Queue 3). Serve with "
                f"max_seq > window"
            )
        return {"k": torch.zeros(lead + (cfg.hd,), dtype=torch.int8, device=device),
                "k_s": torch.zeros(lead, dtype=torch.float32, device=device),
                "v": torch.zeros(lead + (cfg.hd,), dtype=torch.int8, device=device),
                "v_s": torch.zeros(lead, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(lead + (cfg.hd,), dtype=dtype, device=device),
            "v": torch.zeros(lead + (cfg.hd,), dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               *, device) -> list:
    """Stacked zero KV caches mirroring the parameter segmentation
    (``[n_units, B, seq, ...]`` per sublayer; see :func:`_sublayer_cache`)."""
    check_supported(cfg)
    return [{f"s{i}_{ch}": _sublayer_cache(cfg, ch, n_units, batch, max_seq, dtype, device)
             for i, ch in enumerate(pattern)}
            for pattern, n_units in segments(cfg)]


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunState:
    """Context for one forward pass."""

    cfg: ModelConfig
    positions: torch.Tensor                 # [B, S] logical positions
    pos: object                             # cache write offset: None (no
                                            # cache), int, or [B] tensor
    pad_len: Optional[torch.Tensor] = None  # [B] left-pad lengths
    aux: Optional[torch.Tensor] = None      # MoE load-balance loss, summed over
                                            # the MoE layers of the pass (f32)
    shared_attn: Optional[dict] = None      # zamba2's shared block parameters
    enc_out: Optional[torch.Tensor] = None  # the encoder output [B, T, D] (enc-dec)
    ctx: object = None                      # ShardCtx (a sharded call where it has a mesh)
    run: object = None                      # its repro_torch.dist.runtime.ShardedRun


def _seq(seq, *path):
    """The :class:`repro_torch.dist.runtime.SeqShard` at ``path`` of a
    sublayer's tree of them (``None`` where nothing is sequence-sharded)."""
    for key in path:
        if seq is None:
            return None
        seq = seq[key]
    return seq


def _apply_sublayer(rs: RunState, ch: str, p: dict, x: torch.Tensor, x_sum, cache, seq=None):
    """One sublayer: attention + FFN (or MoE), or a Mamba2 block (``"M"``),
    followed on ``"S"`` by the shared attention + FFN block, or an RWKV6
    time mix + channel mix (``"R"``), or an enc-dec unit (``"C"``, ``"E"``:
    :func:`_apply_encdec`).  ``x_sum`` is
    the f32 sum that ``x`` was rounded from (``None`` at the start of a
    unit); returns the new ``x``, its f32 sum and the cache.  A MoE block's
    aux loss is added to ``rs.aux``.  ``seq`` mirrors ``cache``: the
    :class:`repro_torch.dist.runtime.SeqShard` of each sequence-sharded
    leaf, ``None`` elsewhere (or ``None`` outright)."""
    cfg = rs.cfg
    nk, eps = cfg.norm_kind, cfg.norm_eps
    if ch in ("M", "S"):
        return _apply_mamba(rs, ch, p, x, x_sum, cache, seq)
    if ch in ("C", "E"):
        return _apply_encdec(rs, ch, p, x, x_sum, cache, seq)
    if ch == "R":
        h = norm(p["tm_norm"], x if x_sum is None else x_sum, nk, eps).to(x.dtype)
        y, _ = rwkv.rwkv_time_mix(p["time_mix"], h, cfg, cache, seq=_seq(seq, "x_prev_t"))
        x, x_sum = _residual(x, y)
        h = norm(p["cm_norm"], x_sum, nk, eps).to(x.dtype)
        y, _ = rwkv.rwkv_channel_mix(p["channel_mix"], h, cfg, cache,
                                     seq=_seq(seq, "x_prev_c"))
        x, x_sum = _residual(x, y)
        return x, x_sum, cache
    h = norm(p["attn_norm"], x if x_sum is None else x_sum, nk, eps).to(x.dtype)
    if cfg.attn_kind == "mla":
        a, new_cache = attention.mla_attention(
            p["attn"], h, cfg=cfg, positions=rs.positions, cache=cache,
            pos=rs.pos, pad_len=rs.pad_len, seq=_seq(seq, "ckv"),
        )
    else:
        a, new_cache = attention.gqa_attention(
            p["attn"], h, cfg=cfg, positions=rs.positions, cache=cache,
            pos=rs.pos, window=cfg.window if ch == "L" else None, pad_len=rs.pad_len,
            seq=_seq(seq, "k"),
        )
    x, x_sum = _residual(x, a)
    h = norm(p["ffn_norm"], x_sum, nk, eps).to(x.dtype)
    if "moe" in p:
        f, aux = moe.moe_apply(p["moe"], h, cfg, rs.ctx)
        rs.aux = aux if rs.aux is None else rs.aux + aux
    else:
        f = ffn.ffn_apply(p["ffn"], h, cfg)
    x, x_sum = _residual(x, f)
    return x, x_sum, new_cache


def _apply_mamba(rs: RunState, ch: str, p: dict, x: torch.Tensor, x_sum, cache, seq=None):
    """An ``"M"`` sublayer, or an ``"S"`` one: the Mamba2 block, then the
    shared block's attention (no window, its own plain K/V cache) and FFN."""
    cfg = rs.cfg
    nk, eps = cfg.norm_kind, cfg.norm_eps
    h = norm(p["norm"], x if x_sum is None else x_sum, nk, eps).to(x.dtype)
    state = cache if ch == "M" or cache is None else cache["mamba"]
    y, _ = ssm.ssm_apply(p["ssm"], h, cfg, state)
    x, x_sum = _residual(x, y)
    if ch == "M":
        return x, x_sum, cache
    sp = rs.shared_attn
    h = norm(sp["attn_norm"], x_sum, nk, eps).to(x.dtype)
    a, _ = attention.gqa_attention(
        sp["attn"], h, cfg=cfg, positions=rs.positions,
        cache=cache["attn"] if cache is not None else None, pos=rs.pos, pad_len=rs.pad_len,
        seq=_seq(seq, "attn", "k"),
    )
    x, x_sum = _residual(x, a)
    h = norm(sp["ffn_norm"], x_sum, nk, eps).to(x.dtype)
    x, x_sum = _residual(x, ffn.ffn_apply(sp["ffn"], h, cfg))
    return x, x_sum, cache


def _apply_encdec(rs: RunState, ch: str, p: dict, x: torch.Tensor, x_sum, cache, seq=None):
    """An ``"E"`` sublayer (bidirectional self attention without a cache,
    FFN) or a ``"C"`` one: causal self attention over ``k`` / ``v``, cross
    attention over the encoder output's keys and values, FFN.

    With frames (``rs.enc_out``) a ``"C"`` unit computes the cross K/V from
    the encoder output in its dtype and, with a cache, writes them into
    ``ck`` / ``cv`` in place — rounded to the cache's dtype *before* the
    cross attention reads them, as the reference casts them; without a cache
    they are used unrounded.  Without frames it reads the cached ``ck`` /
    ``cv``; without frames or a cache there is nothing to attend to, and it
    raises ``TypeError`` where the reference does (``cache["ck"]`` of
    ``None``).  Over sequence-sharded cross caches (``seq``) a rank keeps its
    frames of the cross K/V and attends over them context-parallel."""
    cfg = rs.cfg
    nk, eps = cfg.norm_kind, cfg.norm_eps
    h = norm(p["attn_norm"], x if x_sum is None else x_sum, nk, eps).to(x.dtype)
    if ch == "E":
        a, _ = attention.gqa_attention(p["attn"], h, cfg=cfg, positions=rs.positions,
                                       causal=False)
        x, x_sum = _residual(x, a)
    else:
        self_cache = {"k": cache["k"], "v": cache["v"]} if cache is not None else None
        a, _ = attention.gqa_attention(
            p["attn"], h, cfg=cfg, positions=rs.positions, cache=self_cache, pos=rs.pos,
            pad_len=rs.pad_len, seq=_seq(seq, "k"),
        )
        x, x_sum = _residual(x, a)
        h = norm(p["cross_norm"], x_sum, nk, eps).to(x.dtype)
        cseq = _seq(seq, "ck")
        if rs.enc_out is not None:
            ck, cv = attention.cross_kv(p["cross"], rs.enc_out, cfg=cfg)
            if cseq is not None:
                n = cache["ck"].shape[1]
                ck, cv = cseq.narrow(ck, 1, n), cseq.narrow(cv, 1, n)
            if cache is not None:
                ck, cv = cache["ck"].copy_(ck), cache["cv"].copy_(cv)
        elif cache is None:
            raise TypeError(
                f"{cfg.name}: a forward without frames (prefix_embeds) and without a cache "
                f"has no cross keys and values; the reference raises here too ('NoneType' "
                f"object is not subscriptable at cache['ck'])"
            )
        else:
            ck, cv = cache["ck"], cache["cv"]
        x, x_sum = _residual(x, attention.cross_attention(p["cross"], h, cfg=cfg,
                                                          enc_k=ck, enc_v=cv, seq=cseq))
    h = norm(p["ffn_norm"], x_sum, nk, eps).to(x.dtype)
    x, x_sum = _residual(x, ffn.ffn_apply(p["ffn"], h, cfg))
    return x, x_sum, cache


def _residual(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x + y`` in ``x.dtype`` (the residual stream) and the f32 sum it is
    rounded from (what the next norm in the unit reads)."""
    s = x.float() + y            # y is promoted inside the add: no separate cast
    return s.to(x.dtype), s


def unit_apply(rs: RunState, pattern: str, unit_p: dict, x: torch.Tensor, unit_cache,
               unit_seq=None):
    x_sum = None
    for i, ch in enumerate(pattern):
        key = f"s{i}_{ch}"
        c = unit_cache[key] if unit_cache is not None else None
        x, x_sum, _ = _apply_sublayer(rs, ch, unit_p[key], x, x_sum, c, _seq(unit_seq, key))
    return x


def _unit_remat(rs: RunState, pattern: str, unit_p: dict, x: torch.Tensor) -> torch.Tensor:
    """A cache-free unit under ``torch.utils.checkpoint``: its activations
    are recomputed in backward.  The unit's MoE aux loss is returned by the
    checkpointed function rather than added to ``rs.aux`` inside it, so the
    recomputation in backward leaves ``rs`` as the forward left it."""
    from torch.utils.checkpoint import checkpoint

    def body(x_in):
        outer, rs.aux = rs.aux, None
        try:
            return unit_apply(rs, pattern, unit_p, x_in, None), rs.aux
        finally:
            rs.aux = outer

    x, aux = checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)
    if aux is not None:
        rs.aux = aux if rs.aux is None else rs.aux + aux
    return x


def run_segments(rs: RunState, seg_params: list, x: torch.Tensor,
                 caches: Optional[list], *, remat: bool = False, seqs: Optional[list] = None):
    """Loop over every unit of every segment; returns ``(x, caches)`` — the
    caches are the ones passed in, updated in place.  A stack's units are
    taken with one ``unbind`` a leaf (:func:`repro_torch.tree.unstack`), so
    the gradient of a stacked leaf is one stack of the units' gradients.
    ``remat`` checkpoints each unit of a cache-free pass under autograd.  In
    a sharded call each unit's leaves are bound as the unit runs; ``seqs``
    (:meth:`repro_torch.dist.runtime.ShardedRun.cache_seq`) mirrors
    ``caches`` with the sequence shards, the same for every unit of a stack."""
    remat = remat and caches is None and torch.is_grad_enabled()
    for si, (pattern, n_units) in enumerate(segments(rs.cfg)):
        units = _units(rs, seg_params[si], n_units, rs.run and rs.run.specs["segments"][si])
        c_stack = caches[si] if caches is not None else None
        for u, unit in enumerate(units):
            if remat:
                x = _unit_remat(rs, pattern, unit, x)
                continue
            unit_c = tree.index(c_stack, u) if c_stack is not None else None
            x = unit_apply(rs, pattern, unit, x, unit_c, _seq(seqs, si))
    return x, caches


def _units(rs: RunState, stacked, n_units: int, spec):
    """A stack's units: ``unbind`` views, or in a sharded call the bound
    units (:meth:`repro_torch.dist.runtime.ShardedRun.units`)."""
    if rs.run is None:
        return tree.unstack(stacked, n_units)
    return rs.run.units(stacked, spec, n_units)


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor, ctx=None) -> torch.Tensor:
    """Whisper-style encoder over the stub frontend's frames ``[B, T,
    frontend_dim]``: ``frontend_proj``, the sinusoidal table, the ``"E"``
    units (bidirectional, no cache; ``attn_impl="flash"`` is the
    ``flash_attention`` kernel with ``causal=False``) and
    ``enc_final_norm``.  As in the reference, the frames are not cast: the
    encoder runs in their dtype, whatever ``cfg.dtype`` says.  ``ctx`` with a
    mesh: the rank's part of a sharded call (``frames`` its dp rows)."""
    run = runtime.ShardedRun(cfg, params, ctx) if runtime.active(ctx) else None
    top = (lambda key: run.top(params, key)) if run else params.get
    x = linear(top("frontend_proj"), frames)
    b, t = x.shape[:2]
    x = x + layers.sinusoidal_positions(t, cfg.d_model, device=x.device)[None].to(x.dtype)
    rs = RunState(cfg=cfg, positions=torch.arange(t, device=x.device)[None].expand(b, t),
                  pos=None, ctx=ctx, run=run)
    for unit in _units(rs, params["encoder"], cfg.encoder_layers,
                       run and run.specs["encoder"]):
        x = unit_apply(rs, "E", unit, x, None)
    return norm(top("enc_final_norm"), x, cfg.norm_kind, cfg.norm_eps)


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                   # [B, S] int
    *,
    caches: Optional[list] = None,
    pos=None,                               # cache write offset: int or [B] tensor
    prefix_embeds: Optional[torch.Tensor] = None,  # [B, P, frontend_dim] stub frontend
    last_token_only: bool = False,          # head over the final position only
    pad_len: Optional[torch.Tensor] = None, # [B] left-pad lengths; pad positions
                                            # become attention don't-cares and
                                            # logical positions shift by -pad_len
    return_hidden: bool = False,            # skip the LM head
    remat: bool = False,                    # checkpoint each unit (training)
    return_aux: bool = False,               # also return the MoE aux loss
    ctx=None,                               # ShardCtx: a sharded call where it has a mesh
    max_seq: Optional[int] = None,          # the caches' length (a seq_shard call needs it)
):
    """Returns ``(logits [B, S', V] f32, caches)``, or with ``return_hidden``
    the final-normed hidden states ``[B, S', D]`` in the model's dtype in
    place of the logits; with ``return_aux`` a third element, the MoE
    load-balance loss summed over the pass (f32, 0 without MoE layers), as
    the reference returns ``(out, caches, aux)``.

    On an enc-dec model ``prefix_embeds`` are the frames :func:`encode` runs
    over; the decoder's cross attention reads its output (and a cache keeps
    its keys and values for the decode steps).  On a model with a frontend
    and no encoder (the VLM) they are ``P`` patch embeddings: cast to the
    model's dtype, projected by ``frontend_proj`` and prepended to the
    embedded tokens, so positions, cache writes and the logits run over ``P
    + S``.  As in the reference, ``pad_len`` then counts from the first
    patch: a left-padded prompt's first ``pad_len`` *buffer* positions
    (patches, not the pad tokens) become the don't-cares, and the logical
    positions shift the patches too.

    With ``ctx`` (a :class:`repro_torch.dist.ShardCtx` with a mesh) this is
    one rank's part of a sharded forward: ``params`` its local shards (cut by
    :func:`repro_torch.dist.shard_tree`), ``tokens``, ``caches``, ``pos``,
    ``pad_len`` and ``prefix_embeds`` its dp rows; the outputs are its rows,
    full width (:mod:`repro_torch.dist.runtime`).  With ``ctx.seq_shard`` the
    caches are also its slices of the sequence, cut by ``cache_specs`` from
    caches of ``max_seq`` positions (required there: it fixes which leaves
    were cut)."""
    b, s = tokens.shape
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    run = runtime.ShardedRun(cfg, params, ctx) if runtime.active(ctx) else None
    top = (lambda key: run.top(params, key)) if run else params.get
    x = (run.embed(params["embed"], tokens) if run else params["embed"][tokens.long()]).to(dtype)
    enc_out = None
    if prefix_embeds is not None and cfg.is_encdec:
        enc_out = encode(params, cfg, prefix_embeds, ctx=ctx)
    elif prefix_embeds is not None and cfg.frontend is not None:
        pe = linear(top("frontend_proj"), prefix_embeds.to(x.dtype))
        x = torch.cat([pe, x], dim=1)
        s = x.shape[1]
    ar = torch.arange(s, device=x.device)[None].expand(b, s)
    if pos is None:
        positions = ar
    elif isinstance(pos, torch.Tensor) and pos.ndim:
        positions = pos[:, None] + ar
    else:
        positions = ar + pos
    if pad_len is not None:
        # Real token i of a left-padded row sits at buffer index pad+i but
        # logical position i; RoPE and the causal mask use logical
        # positions, cache writes keep buffer offsets (``pos``).
        positions = positions - pad_len[:, None]
    if cfg.rope_kind == "none":
        # Absolute sinusoidal positions for rope-less decoders (whisper).
        x = x + layers.sinusoid_at(positions, cfg.d_model).to(x.dtype)
    rs = RunState(cfg=cfg, positions=positions, pos=pos, pad_len=pad_len,
                  shared_attn=top("shared_attn"), enc_out=enc_out, ctx=ctx, run=run)
    seqs = run.cache_seq(caches, max_seq) if run and caches is not None else None
    x, caches = run_segments(rs, params["segments"], x, caches, remat=remat, seqs=seqs)
    x = norm(top("final_norm"), x, cfg.norm_kind, cfg.norm_eps)
    if not return_hidden:
        if last_token_only:
            x = x[:, -1:, :]
        x = lm_head(params, cfg, x, run)
    if not return_aux:
        return x, caches
    aux = rs.aux if rs.aux is not None else torch.zeros((), dtype=torch.float32,
                                                        device=x.device)
    return x, caches, aux


def lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor, run=None) -> torch.Tensor:
    """The f32 logits (softcapped); ``run``: a sharded call's
    :class:`repro_torch.dist.runtime.ShardedRun`."""
    if cfg.tie_embeddings:
        logits = run.tied_head(x, params["embed"]) if run else \
            torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    else:
        logits = linear(run.top(params, "lm_head") if run else params["lm_head"], x)
    return layers.softcap(logits.to(torch.float32), cfg.final_logit_softcap)
