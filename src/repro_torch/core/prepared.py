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
``p``                the host-side Eq. 2/4 sweep picking ``p*`` (§IV-D) —
                     planned in every mode so plan queries agree with the
                     reference
===================  =====================================================

``pallas`` keeps just the packed codes the kernel reads.  The ``lut`` and
``stream`` products (``wpk``, ``wcanon``, ``onehot``) arrive with those
engines (ROADMAP Queue 1 item 3); their fields stay, as ``None``, so trees
keep the reference's shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.api import (
    LutLinearSpec,
    QuantizedLinear,
    _unported,
    pallas_matmul,
    plan_p,
)
from repro_torch.core.quantize import grid_tensor, quantize

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
    calibration: Optional[torch.Tensor] = None,
    ascale: Optional[torch.Tensor] = None,
) -> PreparedLinear:
    """Freeze every weight-side product of ``q`` into a :class:`PreparedLinear`.

    ``n_hint`` is the activation-column count the Eq. 2/4 sweep plans ``p*``
    for when ``q.spec.p`` is ``None`` (any value is exact; it only steers
    the LUT engines).  ``calibration`` / ``ascale`` freeze the activation
    scale as in the reference (consumed only by the lut/stream engines).
    """
    spec = q.spec
    if calibration is not None and ascale is not None:
        raise ValueError("pass calibration or ascale, not both")
    if calibration is not None:
        cf = calibration.reshape(-1, calibration.shape[-1]).to(torch.float32)
        _, ascale = quantize(cf.T, spec.aspec())
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
    if spec.mode in ("lut", "stream"):
        raise _unported(spec.mode)
    p = plan_p(q.f, q.k, n_hint, spec)
    wcodes = None
    if spec.mode == "dequant":
        wcodes = packing.unpack_bits(q.codes, spec.bw)[:, : q.k].to(torch.uint8)
    return PreparedLinear(
        codes=q.codes, scale=q.scale, bias=q.bias, wcodes=wcodes,
        wpk=None, wcanon=None, onehot=None,
        spec=spec, k=q.k, p=p, ascale=ascale,
    )


def apply_prepared(pl: PreparedLinear, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ W (+ bias)`` through the cached weight-stationary products;
    bit-identical to ``apply_linear`` on the raw layer."""
    mode = pl.spec.mode
    if mode == "dequant":
        y = _dequant_matmul(pl, x)
    elif mode == "pallas":
        y = pallas_matmul(pl, x)
    elif mode in ("lut", "stream"):
        raise _unported(mode)
    else:
        raise ValueError(f"unknown mode {mode}")
    if pl.bias is not None:
        y = y + pl.bias.to(y.dtype)
    return y


def _dequant_matmul(pl: PreparedLinear, x: torch.Tensor) -> torch.Tensor:
    grid = grid_tensor(pl.spec.wspec(), x.device, x.dtype)
    w_t = grid[pl.wcodes.long()] * pl.scale[:, None].to(x.dtype)
    return torch.einsum("...k,fk->...f", x, w_t)
