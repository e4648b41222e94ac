"""Frozen activation calibration: capture static per-tensor activation scales
(port of ``repro.core.calibrate``).

The int-LUT engines quantize activations with a *dynamic* per-tensor scale
(``api.quantized_lut_gemm``): the max over whatever rows share the batch, so
one request's tokens depend on which other requests it was batched with.
LUT-based PIM hardware precomputes its tables against a *fixed* input grid,
so a frozen scale is the faithful deployment regime.  This module captures
that scale once per quantized leaf from a small calibration batch:

1. :func:`capture_scales` wraps every quantized leaf in a
   :class:`CalibrationProbe` (the leaf, its tree path and the run's tape) and
   runs ONE forward pass.  ``models.layers.linear`` dispatches a probe to
   :func:`probe_apply`, which appends the exact scale the dynamic quantizer
   picks for the activations reaching that leaf to the tape — as a device
   tensor, so capture costs no host sync.  The model walks a stacked leaf
   unit by unit (``tree.index`` slices the probe's leaf and keeps its path
   and tape), so a stacked leaf's scales arrive in stack order.
2. :func:`attach_scales` installs the captured scales on the (raw or
   prepared) tree: a scalar per plain leaf, ``[stack]`` per stacked leaf
   (``tree.index`` slices it back to a scalar per unit, like the codes).

The reference records its scales through an ordered ``io_callback`` under
``lax.scan``; the port runs eagerly and stacks the tape once at the end.
On the calibration batch itself, frozen apply is bit-identical to dynamic
apply: the captured scale IS the dynamic scale of that batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.api import apply_linear
from repro_torch.core.quantize import quantize_activation


@dataclasses.dataclass
class CalibrationProbe:
    """Tree node marking one quantized leaf for scale capture.

    ``inner`` is the (Prepared)QuantizedLinear being probed (a tree child:
    ``tree.index`` slices it); ``path`` is its ``tune.plan`` tree path and
    ``tape`` the capture run's ``path -> [scale, ...]`` record, both carried
    unchanged through tree maps."""

    inner: Any
    path: str = ""
    tape: dict = dataclasses.field(default_factory=dict)


def probe_apply(probe: CalibrationProbe, x: torch.Tensor) -> torch.Tensor:
    """Apply hook for probed leaves: record the dynamic activation scale of
    ``x`` (int-LUT modes only — the sole consumers of a frozen scale), then
    run the real engine so downstream activations are faithful."""
    q = probe.inner
    if q.spec.mode in ("lut", "stream"):
        xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
        # The quantizer quantized_lut_gemm runs: the frozen scale is
        # bit-equal to the dynamic one on the calibration batch.
        _, scale = quantize_activation(xf.T, q.spec.aspec())
        probe.tape.setdefault(probe.path, []).append(scale.reshape(()))
    return apply_linear(q, x)


def unwrap(p):
    """Probe-or-leaf -> leaf (for dense paths that bypass ``apply_linear``)."""
    return p.inner if isinstance(p, CalibrationProbe) else p


def capture_scales(run_fn: Callable, params) -> dict[str, torch.Tensor]:
    """Run one calibration forward and return ``path -> frozen scale``.

    ``run_fn(probed_params)`` must execute exactly one forward pass of the
    model over the calibration batch.  Returns an f32 scalar tensor per plain
    leaf and a ``[stack]`` tensor per stacked leaf, on the leaf's device.  A
    leaf applied through several call sites per pass freezes the max scale
    across sites.
    """
    from repro_torch.tune.plan import map_quantized_leaves, quantized_leaf_items

    tape: dict[str, list] = {}
    probed = map_quantized_leaves(
        params, lambda path, leaf: CalibrationProbe(inner=leaf, path=path, tape=tape)
    )
    run_fn(probed)
    stacks = {
        path: leaf.codes.shape[:-2].numel() if leaf.codes.ndim > 2 else 0
        for path, leaf in quantized_leaf_items(params)
    }
    scales: dict[str, torch.Tensor] = {}
    for path, recs in tape.items():
        stack = stacks.get(path, 0)
        expect = stack if stack else 1
        if len(recs) % expect:
            raise ValueError(
                f"calibration capture for {path!r} saw {len(recs)} records, "
                f"not a multiple of its stack size {expect}"
            )
        arr = torch.stack(recs).reshape(-1, expect).amax(dim=0)     # [expect]
        scales[path] = arr if stack else arr.reshape(())
    return scales


def attach_scales(params, scales: dict[str, torch.Tensor]):
    """Install captured frozen scales on a (raw or prepared) tree."""
    from repro_torch.tune.plan import map_quantized_leaves

    def f(path, leaf):
        s = scales.get(path)
        if s is None:
            return leaf
        return dataclasses.replace(
            leaf, ascale=torch.as_tensor(s, dtype=torch.float32, device=leaf.codes.device))

    return map_quantized_leaves(params, f)


def calibrate_tree(run_fn: Callable, params):
    """capture + attach in one step: the ``Model.prepare(calibrate=...)``
    backend.  ``params`` may be raw or already prepared."""
    return attach_scales(params, capture_scales(run_fn, params))
