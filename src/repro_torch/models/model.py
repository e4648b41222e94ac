"""Model facade: init / forward / prefill / decode + the LoCaLUT transform
(port of ``repro.models.model``).

:func:`quantize_model` walks a parameter tree and replaces every GEMM weight
named in ``_QUANT_LINEAR_NAMES``, and every raw expert stack of a ``"moe"``
subtree, with a bit-packed :class:`repro_torch.core.QuantizedLinear`;
embeddings, the LM head and the MoE router stay dense, as in the reference.
:func:`prepare_params` freezes each quantized leaf into its
weight-stationary :class:`repro_torch.core.PreparedLinear`.
``Model.prepare(calibrate=tokens)`` freezes each int-LUT leaf's activation
scale first (:mod:`repro_torch.core.calibrate`); ``Model.prepare(plan=)``
prepares each leaf at its autotuned config instead
(:mod:`repro_torch.tune`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import devices, tree
from repro_torch.core import (
    LutLinearSpec, PreparedLinear, QuantizedLinear, prepare_linear, quantize_linear,
)
from repro_torch.core.calibrate import unwrap
from repro_torch.core.prepared import WCANON_MAX_ENTRIES
from repro_torch.models import transformer
from repro_torch.models.layers import decode_weight
from repro_torch.models.config import ModelConfig

_QUANT_LINEAR_NAMES = frozenset(
    {
        "wq", "wk", "wv", "wo", "wg", "wr",
        "w_up", "w_gate", "w_down",
        "w_kup", "w_vup", "w_dkv",
        "in_proj", "out_proj",
    }
)
# Stacked expert-weight leaves inside a "moe" subtree.
MOE_EXPERT_NAMES = frozenset({"w_gate", "w_up", "w_down"})


def in_moe_subtree(key: str, under_moe: bool) -> bool:
    """Propagate the 'inside a MoE block' flag through a parameter walk
    (shared experts are ordinary FFNs, not expert stacks)."""
    return key == "moe" or (under_moe and key != "shared")


def _quantize_dense(p: dict, spec: LutLinearSpec) -> QuantizedLinear:
    """Quantize a dense ``{"w": [..., K, F], ("b")}`` leaf; leading stack
    dims are quantized unit by unit and stacked."""
    w, bias = p["w"], p.get("b")
    if w.ndim == 2:
        return quantize_linear(w, spec, bias=bias)
    return tree.stack([
        _quantize_dense({"w": w[i], **({"b": bias[i]} if bias is not None else {})}, spec)
        for i in range(w.shape[0])
    ])


def _quantize_raw(w: torch.Tensor, spec: LutLinearSpec) -> QuantizedLinear:
    """Quantize a raw ``[..., K, F]`` expert stack, one expert at a time."""
    if w.ndim == 2:
        return quantize_linear(w, spec)
    return tree.stack([_quantize_raw(w[i], spec) for i in range(w.shape[0])])


def quantize_model(params, cfg: ModelConfig, spec: LutLinearSpec):
    """Replace GEMM weights with packed QuantizedLinear leaves (recursive)."""

    def walk(node, under_moe: bool = False):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if (
                    isinstance(v, dict)
                    and isinstance(v.get("w"), torch.Tensor)
                    and v["w"].ndim >= 2
                    and k in _QUANT_LINEAR_NAMES
                ):
                    out[k] = _quantize_dense(v, spec)
                elif (
                    under_moe
                    and k in MOE_EXPERT_NAMES
                    and isinstance(v, torch.Tensor)
                    and v.ndim >= 3
                ):
                    out[k] = _quantize_raw(v, spec)
                else:
                    out[k] = walk(v, in_moe_subtree(k, under_moe))
            return out
        if isinstance(node, list):
            return [walk(v, under_moe) for v in node]
        return node

    return walk(params)


def _prepare_leaf(x: QuantizedLinear, **kw):
    """Prepare one quantized leaf; a stacked leaf is prepared unit by unit
    and restacked (the reference vmaps).  ``p`` is the same for every unit:
    it depends only on the shapes and the spec.  As in the reference, a
    stacked leaf divides the ``wcanon`` entry cap over the stack and builds
    no host products (the stream mode's one-hot)."""
    if x.codes.ndim == 2:
        return prepare_linear(x, **kw)
    stack = math.prod(x.codes.shape[:-2])
    kw_s = dict(kw)
    kw_s.setdefault("wcanon_max_entries", max(WCANON_MAX_ENTRIES // max(stack, 1), 1))
    kw_s["host_products"] = False
    return _prepare_stacked(x, kw_s)


def _prepare_stacked(x: QuantizedLinear, kw: dict):
    if x.codes.ndim == 2:
        return prepare_linear(x, **kw)
    return tree.stack([_prepare_stacked(tree.index(x, i), kw)
                       for i in range(x.codes.shape[0])])


def prepare_params(params, plan=None, **kw):
    """Freeze every :class:`QuantizedLinear` leaf into its weight-stationary
    :class:`repro_torch.core.PreparedLinear` form; ``kw`` forwards to
    :func:`repro_torch.core.prepare_linear` (``n_hint`` etc.).

    ``plan`` — a :class:`repro_torch.tune.ModelPlan` — switches to the
    autotuned path: each leaf's spec is rewritten to its per-layer config
    (mode/p/tile/wcanon, or left raw where the plan degraded it) before
    preparing; the plan's fingerprint is checked first
    (:func:`repro_torch.tune.planner.apply_plan`)."""
    if plan is not None:
        from repro_torch.tune.planner import apply_plan

        return apply_plan(params, plan, **kw)

    def walk(node):
        if isinstance(node, QuantizedLinear):
            return _prepare_leaf(node, **kw)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def maybe_dequant(p, dtype=torch.bfloat16):
    """Raw-tensor-or-(Prepared)QuantizedLinear -> dense ``[..., K, F]`` tensor
    (the MoE expert einsums).  A quantized leaf decodes in f32 and is cast to
    ``dtype`` (:func:`repro_torch.models.layers.decode_weight`: from the
    cached ``wcodes`` of a prepared dequant-mode leaf, else from the packed
    codes); a raw tensor comes back as it is.  A calibration probe is
    unwrapped: dense einsums consume no activation scale."""
    p = unwrap(p)
    if isinstance(p, (QuantizedLinear, PreparedLinear)):
        return decode_weight(p).to(dtype)
    return p


@dataclasses.dataclass
class Model:
    """Thin facade bundling a config with the apply functions."""

    cfg: ModelConfig

    def init(self, seed: int = 0, *, device="cuda", unit_fn=None) -> dict:
        """Random f32 parameters from ``torch.Generator(device).manual_seed(seed)``
        (see :func:`repro_torch.models.transformer.init_params`).  On the
        ``meta`` device only the shapes and dtypes are made (the structure a
        checkpoint is restored into)."""
        dev = devices.resolve(device)
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
        return transformer.init_params(self.cfg, gen, device=dev, unit_fn=unit_fn)

    def init_quantized(self, spec: LutLinearSpec, seed: int = 0, *, device="cuda") -> dict:
        """:meth:`init` + :meth:`quantize`, one unit at a time: each unit (and
        zamba2's shared block, drawn once beside them, and each encoder unit
        of an enc-dec model) is drawn in f32,
        quantized, and only then stacked, so a full-width model never holds
        its f32 projection weights at once."""
        return self.init(seed, device=device,
                         unit_fn=lambda u: quantize_model(u, self.cfg, spec))

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16, *, device="cuda"):
        return transformer.init_cache(self.cfg, batch, max_seq, dtype,
                                      device=devices.resolve(device))

    def forward(self, params, tokens, *, return_hidden: bool = False, **kw):
        """Full-sequence forward: ``(logits [B, S, V] f32, caches)``, or with
        ``return_hidden`` the final-normed hidden states ``[B, S, D]`` (no
        LM head).  Without caches, attention runs ``cfg.attn_impl``:
        ``"flash"`` is the ``flash_attention`` kernel on the card.  ``kw``
        goes to :func:`repro_torch.models.transformer.forward`
        (``prefix_embeds=`` the frames of an enc-dec model or the patches of
        a VLM, ``caches``, ``pos``, ``pad_len``, ``last_token_only``,
        ``remat``, ``return_aux=True`` for the MoE aux loss as a third
        element, and ``ctx=`` a :class:`repro_torch.dist.ShardCtx`: with a
        mesh, this rank's part of a sharded forward over its local shards
        and its dp rows; with ``seq_shard`` and caches, ``max_seq=`` the
        length they were made with)."""
        return transformer.forward(params, self.cfg, tokens, return_hidden=return_hidden, **kw)

    def prefill(self, params, tokens, caches, *, prefix_embeds=None, ctx=None, pad_len=None,
                max_seq=None):
        """Fill caches for positions [0, S) in place; returns (last-pos logits
        [B,1,V], caches).  ``pad_len [B]`` marks per-row left-padding: padded
        positions become attention don't-cares and logical positions shift,
        so a left-padded prompt prefills output-identically to the unpadded
        one.  On an enc-dec model ``prefix_embeds`` are the frames: the
        encoder runs over them and the cross caches ``ck`` / ``cv`` are
        filled for the decode steps that follow.  On a VLM they are the
        ``P`` patches, prepended to the tokens: the prefill fills ``P + S``
        cache positions, and the next decode offset is ``P + S``.  ``ctx``
        and ``max_seq``: as in :meth:`forward` (every argument the rank's dp
        rows; under ``seq_shard`` the caches its slices of the sequence)."""
        return transformer.forward(
            params, self.cfg, tokens, caches=caches, pos=0, prefix_embeds=prefix_embeds,
            last_token_only=True, pad_len=pad_len, ctx=ctx, max_seq=max_seq,
        )

    def decode_step(self, params, token, caches, pos, *, ctx=None, pad_len=None,
                    max_seq=None):
        """One token per sequence: token [B, 1]; ``pos`` is the cache write
        offset — an int, or a ``[B]`` tensor of per-slot offsets (continuous
        batching).  Caches are updated in place.  ``ctx`` and ``max_seq``: as
        in :meth:`forward`."""
        return transformer.forward(
            params, self.cfg, token, caches=caches, pos=pos, pad_len=pad_len, ctx=ctx,
            max_seq=max_seq,
        )

    def quantize(self, params, spec: LutLinearSpec):
        return quantize_model(params, self.cfg, spec)

    def prepare(self, params, plan=None, calibrate=None, **kw):
        """Weight-stationary serve form: cache all per-call weight products.
        ``plan`` applies a :class:`repro_torch.tune.ModelPlan` (autotuned
        per-layer configs) instead of preparing every leaf at its own spec.

        ``calibrate`` — a small token batch ``[B, S]`` — freezes each int-LUT
        leaf's activation scale from one forward pass over it *before*
        preparing (:mod:`repro_torch.core.calibrate`): the ``lut``/``stream``
        engines become batch-composition invariant, and on the calibration
        batch itself outputs are bit-identical to the dynamic-scale path.
        With both, calibration runs first and then the plan is applied."""
        if calibrate is not None:
            from repro_torch.core import calibrate as _cal

            tokens = torch.as_tensor(calibrate, device=devices.tree_device(params))
            params = _cal.calibrate_tree(lambda probed: self.forward(probed, tokens)[0], params)
        return prepare_params(params, plan=plan, **kw)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
