"""Weight-stationary prepared layers: the prepare/apply split (port of
``repro.core.prepared``).

``prepare_linear`` freezes the weight-side products of a
:class:`~repro_torch.core.api.QuantizedLinear` once; :func:`apply_prepared`
is the serve-time path and is bit-identical to ``apply_linear`` on the raw
layer.  Each product is cached only for the mode whose apply path consumes
it:

===================  =====================================================
cached product       paper step it replaces at serve time
===================  =====================================================
``wcodes [F, K]``    unpacking the bit-packed weight words back into codes
                     (§V-A layout step) — ``mode="dequant"``
``wpk [F, G]``       grouping K into packs of p and packing each group's
                     codes into a LUT row index (§III-A operation packing)
                     — ``mode="lut"``/``"stream"``; the ``lut_stream_gemm``
                     kernel reads it on the card
``p``                the host-side Eq. 2/4 sweep picking ``p*`` (§IV-D) —
                     planned in every mode so plan queries agree with the
                     reference
``wcanon [F,G,p!]``  the reordering-LUT lookup itself (§IV-B Fig. 5 step 3):
                     ``wcanon[m, g, pid] == reorder[wpk[m, g], pid]`` —
                     ``mode="lut"`` only, and capped
                     (:data:`WCANON_MAX_ENTRIES`)
``onehot [F, G*R]``  the exact one-hot contraction matrix of the host
                     streamed engine's BLAS path (§IV-C Fig. 7 reuse) —
                     ``mode="stream"``, unstacked leaves only, host numpy
===================  =====================================================

``pallas`` keeps just the packed codes the kernel reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine, packing
from repro_torch.core.api import (
    LutLinearSpec,
    QuantizedLinear,
    _lut_pack_cache,
    pallas_matmul,
    plan_p,
    quantized_lut_gemm,
)
from repro_torch.core.quantize import grid_tensor, quantize_activation

# Entry cap for the weight-static canonical table [F, G, p!]: above this the
# capacity side of the tradeoff stops paying and apply reads the shared
# reordering LUT through wpk.
WCANON_MAX_ENTRIES = 32_000_000


@dataclasses.dataclass
class PreparedLinear:
    """One linear layer's weight-stationary serve products."""

    codes: torch.Tensor                # [F, K*bw/8] uint8 packed (pallas path)
    scale: torch.Tensor                # [F] fp32 per-output-channel scale
    bias: Optional[torch.Tensor]       # [F] or None
    wcodes: Optional[torch.Tensor]     # [F, K] uint8 codes (dequant mode)
    wpk: Optional[torch.Tensor]        # [F, G] int32 indices (lut/stream)
    wcanon: Optional[torch.Tensor]     # [F, G, p!] int32 reorder table (lut)
    onehot: Optional[np.ndarray]       # [F, G*R] f32 (stream mode only)
    spec: LutLinearSpec = LutLinearSpec()
    k: int = 0
    p: int = 1
    ascale: Optional[torch.Tensor] = None   # frozen activation scale (lut/stream)

    @property
    def f(self) -> int:
        return self.codes.shape[-2]

    @property
    def g(self) -> int:
        return (self.k + (-self.k) % self.p) // self.p

    @property
    def prepared_bytes(self) -> int:
        """Extra bytes the prepare/apply tradeoff spends on this layer."""
        total = 0
        for a in (self.wcodes, self.wpk, self.wcanon):
            if a is not None:
                total += a.numel() * a.element_size()
        if self.onehot is not None:
            total += self.onehot.nbytes
        return total


def prepare_linear(
    q: QuantizedLinear,
    *,
    n_hint: int = 128,
    wcanon_max_entries: int = WCANON_MAX_ENTRIES,
    host_products: bool = True,
    calibration: Optional[torch.Tensor] = None,
    ascale: Optional[torch.Tensor] = None,
) -> PreparedLinear:
    """Freeze every weight-side product of ``q`` into a :class:`PreparedLinear`.

    ``n_hint`` is the activation-column count the Eq. 2/4 sweep plans ``p*``
    for when ``q.spec.p`` is ``None`` (any value is exact; it only steers
    the LUT engines).  ``host_products=False`` skips the stream mode's host
    one-hot (stacked leaves, as in the reference, which prepares those under
    ``vmap``).  ``calibration`` / ``ascale`` freeze the activation scale as
    in the reference (consumed only by the lut/stream engines).
    """
    spec = q.spec
    if calibration is not None and ascale is not None:
        raise ValueError("pass calibration or ascale, not both")
    if calibration is not None:
        cf = calibration.reshape(-1, calibration.shape[-1]).to(torch.float32)
        _, ascale = quantize_activation(cf.T, spec.aspec())
    if ascale is None:
        ascale = q.ascale
    if ascale is not None:
        ascale = torch.as_tensor(ascale, dtype=torch.float32)
    if q.codes.ndim != 2:
        raise ValueError(
            f"prepare_linear handles single layers ([F, KB] codes); got "
            f"{q.codes.ndim}-d codes — prepare each unit of the stack "
            f"(see repro_torch.models.model.prepare_params)"
        )
    p = plan_p(q.f, q.k, n_hint, spec)
    wcodes = wpk = wcanon = onehot = None
    if spec.mode in ("dequant", "lut", "stream"):
        wcodes = packing.unpack_bits(q.codes, spec.bw)[:, : q.k]     # [F, K]
    if spec.mode in ("lut", "stream"):
        pack = _lut_pack_cache(spec.bw, spec.ba, p, spec.w_kind, spec.a_kind)
        # The pack's tables on the weights' device, uploaded here once: the
        # first serve under a new p (a hot-swapped plan) copies nothing from
        # the host, so its waves keep their one host sync.
        engine.device_tables(pack, q.codes.device)
        if spec.mode == "stream" and host_products:
            # One prepare_stream_weights call yields both the packed group
            # indices (on the weights' device) and the host one-hot.
            sw = engine.prepare_stream_weights(wcodes, pack)
            wpk, onehot = sw.wpk, sw.onehot
        else:
            pad, cw, _, _ = engine.pad_info(q.k, p, pack.wgrid, pack.agrid)
            wc_pad = torch.nn.functional.pad(wcodes, (0, pad), value=cw) if pad else wcodes
            wpk = packing.pack_index(wc_pad.reshape(q.f, -1, p), spec.bw)   # [F, G]
        if spec.mode == "lut" and q.f * wpk.shape[1] * math.factorial(p) <= wcanon_max_entries:
            # Weight-static reordering table in the int32 the gather wants.
            reorder = torch.as_tensor(pack.reordering.astype(np.int32), device=wpk.device)
            wcanon = reorder[wpk.long()]                              # [F, G, p!]
    return PreparedLinear(
        codes=q.codes, scale=q.scale, bias=q.bias,
        wcodes=wcodes.to(torch.uint8) if spec.mode == "dequant" else None,
        wpk=wpk, wcanon=wcanon, onehot=onehot,
        spec=spec, k=q.k, p=p, ascale=ascale,
    )


def _pack_for(pl: PreparedLinear):
    return _lut_pack_cache(pl.spec.bw, pl.spec.ba, pl.p, pl.spec.w_kind, pl.spec.a_kind)


def stream_weights(pl: PreparedLinear) -> engine.StreamWeights:
    """The streamed engine's :class:`~repro_torch.core.engine.StreamWeights`
    from the cached products (no unpack/pack/one-hot recompute).  Prepared
    layers of other modes carry no ``wpk``: for those (traffic queries via
    ``stream_stats_for`` on a dequant-mode layer) the products are built
    from the packed codes on the fly."""
    pack = _pack_for(pl)
    if pl.wpk is None:
        wcodes = packing.unpack_bits(pl.codes, pl.spec.bw)[:, : pl.k]
        return engine.prepare_stream_weights(wcodes, pack)
    pad, _, _, corr = engine.pad_info(pl.k, pl.p, pack.wgrid, pack.agrid)
    return engine.StreamWeights(
        wpk=pl.wpk, onehot=pl.onehot, m=pl.f, g=pl.g, r=pack.n_rows, pad=pad, corr=corr,
    )


def apply_prepared(pl: PreparedLinear, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ W (+ bias)`` through the cached weight-stationary products;
    bit-identical to ``apply_linear`` on the raw layer."""
    mode = pl.spec.mode
    if mode == "dequant":
        y = _dequant_matmul(pl, x)
    elif mode == "pallas":
        y = pallas_matmul(pl, x)
    elif mode == "lut":
        y = _lut_matmul(pl, x)
    elif mode == "stream":
        y, _ = stream_matmul(pl, x)
    else:
        raise ValueError(f"unknown mode {mode}")
    if pl.bias is not None:
        y = y + pl.bias.to(y.dtype)
    return y


def _dequant_matmul(pl: PreparedLinear, x: torch.Tensor) -> torch.Tensor:
    grid = grid_tensor(pl.spec.wspec(), x.device, x.dtype)
    w_t = grid[pl.wcodes.long()] * pl.scale[:, None].to(x.dtype)
    return torch.einsum("...k,fk->...f", x, w_t)


def _lut_matmul(pl: PreparedLinear, x: torch.Tensor) -> torch.Tensor:
    pack = _pack_for(pl)
    return quantized_lut_gemm(
        pl, x,
        lambda acodes, n: engine.canonical_lut_gemm(
            None, acodes, pack, wpacked=pl.wpk, wcanon_table=pl.wcanon
        ),
    )


def stream_matmul(pl: PreparedLinear, x: torch.Tensor) -> tuple[torch.Tensor, engine.StreamStats]:
    spec = pl.spec
    pack = _pack_for(pl)
    stats_box = []

    def run(acodes, n):
        o, stats = engine.streamed_lut_gemm(
            None, acodes, pack, tile_n=spec.tile_n, buffer_bytes=spec.buffer_bytes,
            prep=stream_weights(pl),
        )
        stats_box.append(stats)
        return o

    return quantized_lut_gemm(pl, x, run), stats_box[0]
