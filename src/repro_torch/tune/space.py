"""Per-layer candidate enumeration with exact capacity accounting (port of
``repro.tune.space``).

For one quantized linear layer ``[F, K]`` served at batch width ``n_hint``,
:func:`layer_candidates` enumerates every execution config the autotuner may
pick — ``mode x feasible p x (wcanon | tile_n/buffer_bytes) x prepared`` —
each priced with

* **capacity_bytes** — the *exact* byte size of the prepared products the
  config materializes, replicating
  :func:`repro_torch.core.prepared.prepare_linear` byte for byte
  (``wcodes``/``wpk``/``wcanon``/one-hot, including the one-hot feasibility
  rule of :func:`repro_torch.core.engine.stream_onehot_feasible` and the
  per-stack ``wcanon`` entry cap);
* **table_bytes** — the shared canonical + reordering LUT pack bytes of the
  config's ``(bw, ba, p)``, which the planner charges once per model;
* **est_us** — the analytic time from the paper's cost models
  (:mod:`repro_torch.core.pim_cost` Eq. 2/4 at the bank tile; plan-only
  stream traffic via ``stream_stats_for`` when the concrete layer is given),
  on the paper's UPMEM device by default, later corrected by measurement
  (:mod:`repro_torch.tune.measure`).

All of it is numpy arithmetic over the port's copies of the reference's cost
models, so the candidate lists equal the reference's: the same order, the
same bytes and the same ``est_us``.

**Numerics families.**  Candidates never leave the layer's numerics family:
int-grid ``lut``/``stream`` form one family (any ``p``, any engine, the
same bits); ``dequant`` and ``pallas`` each keep their own mode (only the
raw/prepared axis varies); a float-grid LUT layer gets a single
keep-as-is candidate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch import hw
from repro_torch.core import engine, luts, perfmodel, pim_cost
from repro_torch.core.api import LutLinearSpec
from repro_torch.core.prepared import WCANON_MAX_ENTRIES

# Keep candidate LUT packs materializable in sane host memory/time: the
# canonical + reordering tables of one (bw, ba, p) config must stay under
# this many bytes to enter the space at all.
MAX_TABLE_BYTES = 64 * 1024 * 1024

# Analytic penalty for serving the raw (unprepared) layer: every call redoes
# the weight-side unpack/pack work the prepared path caches.  Measurement
# corrects it; it only has to rank raw below prepared without measurements.
RAW_PENALTY = 2.0


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of a layer's (mode, p, capacity) tradeoff curve."""

    mode: str
    p: int
    tile_n: Optional[int] = None
    buffer_bytes: Optional[int] = None
    wcanon: bool = False
    prepared: bool = True
    capacity_bytes: int = 0        # exact prepared-product bytes (x stack)
    table_bytes: int = 0           # shared LUT pack bytes (deduped later)
    est_us: float = 0.0
    servable: bool = True          # False: stream's simulated host dataflow,
                                   # excluded from serving plans

    def spec_for(self, base: LutLinearSpec) -> LutLinearSpec:
        return dataclasses.replace(
            base, mode=self.mode, p=self.p,
            tile_n=self.tile_n, buffer_bytes=self.buffer_bytes,
        )

    def pack_key(self, base: LutLinearSpec):
        """Identity of the shared LUT pack this candidate needs (None when
        the mode touches no LUT tables)."""
        if self.mode not in ("lut", "stream"):
            return None
        return (base.bw, base.ba, self.p, base.w_kind, base.a_kind)


def group_count(k: int, p: int) -> int:
    """G: K padded to a multiple of p, in packs of p."""
    return (k + (-k) % p) // p


def table_bytes_for(bw: int, ba: int, p: int, w_kind: str, a_kind: str) -> int:
    """Shared canonical + reordering LUT pack bytes at ``(bw, ba, p)``: what
    :attr:`repro_torch.core.luts.LutPack.total_bytes` reports for the built
    tables."""
    if w_kind == "fp" or a_kind == "fp":
        from repro_torch.core import multiset

        canon = 4 * (1 << (bw * p)) * multiset.n_multisets(1 << ba, p)
    else:
        from repro_torch.core.quantize import QuantSpec

        bo = luts.auto_bo(bw, ba, p, QuantSpec(bw).grid(), QuantSpec(ba).grid())
        canon = luts.canonical_lut_bytes(bw, ba, p, bo)
    return canon + luts.reordering_lut_bytes(bw, p)


def prepared_capacity_bytes(
    f: int,
    k: int,
    spec: LutLinearSpec,
    p: int,
    *,
    wcanon: bool = False,
    stack: int = 1,
) -> int:
    """Exact ``PreparedLinear.prepared_bytes`` of one leaf (whole stack).

    Mirrors :func:`repro_torch.core.prepared.prepare_linear` product by
    product; a stacked leaf (``stack > 1``) builds no host products (no
    one-hot) and divides the ``wcanon`` entry cap by the stack, as
    :func:`repro_torch.models.model.prepare_params` does."""
    g = group_count(k, p)
    per_unit = 0
    if spec.mode == "dequant":
        per_unit += f * k                                  # wcodes uint8
    if spec.mode in ("lut", "stream"):
        per_unit += f * g * 4                              # wpk int32
    if spec.mode == "lut" and wcanon:
        cap = max(WCANON_MAX_ENTRIES // max(stack, 1), 1)
        if f * g * math.factorial(p) <= cap:
            per_unit += f * g * math.factorial(p) * 4      # wcanon int32
    if spec.mode == "stream" and stack == 1:
        pack = _pack(spec, p)
        if pack is not None and engine.stream_onehot_feasible(f, g, pack):
            per_unit += f * g * pack.n_rows * 4            # one-hot f32
    return per_unit * stack


def wcanon_fits(f: int, k: int, p: int, stack: int = 1) -> bool:
    cap = max(WCANON_MAX_ENTRIES // max(stack, 1), 1)
    return f * group_count(k, p) * math.factorial(p) <= cap


def _pack(spec: LutLinearSpec, p: int):
    from repro_torch.core.api import _lut_pack_cache

    if table_bytes_for(spec.bw, spec.ba, p, spec.w_kind, spec.a_kind) > MAX_TABLE_BYTES:
        return None
    return _lut_pack_cache(spec.bw, spec.ba, p, spec.w_kind, spec.a_kind)


def _us(seconds: float) -> float:
    return seconds * 1e6


def _lut_est_us(f, k, n, spec, p, device) -> float:
    s = pim_cost.GemmShape(f, k, n)
    return _us(pim_cost.localut_time_at_p(s, spec.bw, spec.ba, p, device))


def _stream_est_us(f, k, n, spec, p, device, q, x) -> float:
    """Stream candidate estimate: planner-measured deduplicated traffic when
    the concrete layer and activations are given (``stream_stats_for``
    plan-only: no GEMM runs), else the flat Eq. 2 walk."""
    if q is not None and x is not None:
        from repro_torch.core import api as _api

        qq = dataclasses.replace(
            q, spec=dataclasses.replace(
                q.spec, mode="stream", p=p,
                tile_n=None, buffer_bytes=device.buffer_lut_budget,
            )
        )
        st = _api.stream_stats_for(qq, x, plan_only=True)
        pack = _pack(spec, p)
        entries = st.slices_streamed * (pack.n_rows if pack else 1 << (spec.bw * p))
        return _us(entries * device.l_d + st.lookups * device.l_local)
    return _us(perfmodel.eq2_time(f, k, n, p, spec.bw, device))


def _dense_est_us(f, k, n, spec, device) -> float:
    return _us(pim_cost.naive_pim_time(
        pim_cost.GemmShape(f, k, n), spec.bw, spec.ba, device
    ))


def layer_candidates(
    f: int,
    k: int,
    *,
    n_hint: int,
    base_spec: LutLinearSpec,
    device: hw.PimDevice = hw.UPMEM,
    stack: int = 1,
    q=None,
    x=None,
    p_cap: Optional[int] = None,
    servable_only: bool = False,
) -> list[Candidate]:
    """Enumerate the layer's candidate configs, cheapest-capacity first.

    ``q``/``x`` (the concrete raw layer and an activation sample) refine the
    stream candidates' traffic estimate through the plan-only stream stats;
    without them the flat Eq. 2 walk is used.  ``p_cap`` bounds the
    packing-degree sweep further (the device's ``capacity_limits`` p_dram is
    always respected).  ``servable_only`` skips the stream candidates, which
    no serve path runs."""
    spec = base_spec
    int_lut = spec.mode in ("lut", "stream") and spec.w_kind == "int" and spec.a_kind == "int"
    cands: list[Candidate] = []

    if spec.mode == "pallas":
        # The kernel reads the packed codes the layer already stores.
        cands.append(Candidate(
            mode="pallas", p=spec.p or 1, capacity_bytes=0,
            est_us=_dense_est_us(f, k, n_hint, spec, device),
        ))
    elif spec.mode == "dequant":
        base_us = _dense_est_us(f, k, n_hint, spec, device)
        cands.append(Candidate(                       # degradation floor
            mode="dequant", p=spec.p or 1, prepared=False,
            capacity_bytes=0, est_us=base_us * RAW_PENALTY,
        ))
        cands.append(Candidate(
            mode="dequant", p=spec.p or 1,
            capacity_bytes=prepared_capacity_bytes(f, k, spec, spec.p or 1, stack=stack),
            est_us=base_us,
        ))
    elif not int_lut:
        # Float-grid LUT layer: float accumulation is association-sensitive,
        # so re-planning p/engine would change bits.  Keep as-is (a
        # float-grid stream layer is also non-servable: under servable_only
        # it has no candidates and the planner raises).
        p = spec.p or 1
        cands.append(Candidate(
            mode=spec.mode, p=p, tile_n=spec.tile_n,
            buffer_bytes=spec.buffer_bytes,
            capacity_bytes=prepared_capacity_bytes(f, k, spec, p, stack=stack),
            table_bytes=table_bytes_for(spec.bw, spec.ba, p, spec.w_kind, spec.a_kind),
            est_us=_lut_est_us(f, k, n_hint, spec, p, device),
            servable=spec.mode != "stream",
        ))
    else:
        _, p_dram = perfmodel.capacity_limits(spec.bw, spec.ba, device)
        p_hi = min(p_dram, p_cap) if p_cap else p_dram
        lut_spec = dataclasses.replace(spec, mode="lut")
        stream_spec = dataclasses.replace(spec, mode="stream")
        # Degradation floor: raw lut at p=1 — zero capacity, tiny tables.
        cands.append(Candidate(
            mode="lut", p=1, prepared=False, capacity_bytes=0,
            table_bytes=table_bytes_for(spec.bw, spec.ba, 1, spec.w_kind, spec.a_kind),
            est_us=_lut_est_us(f, k, n_hint, spec, 1, device) * RAW_PENALTY,
        ))
        for p in range(1, max(p_hi, 1) + 1):
            tb = table_bytes_for(spec.bw, spec.ba, p, spec.w_kind, spec.a_kind)
            if tb > MAX_TABLE_BYTES:
                break                                  # tables only grow in p
            lut_us = _lut_est_us(f, k, n_hint, spec, p, device)
            cands.append(Candidate(
                mode="lut", p=p,
                capacity_bytes=prepared_capacity_bytes(f, k, lut_spec, p, stack=stack),
                table_bytes=tb, est_us=lut_us,
            ))
            if wcanon_fits(f, k, p, stack):
                # Weight-static reordering table [F, G, p!].  The analytic
                # model cannot tell it apart (the same instruction count on
                # the paper's device).  On the card it changes nothing that
                # runs: the lut_stream_gemm kernel reads wpk and ignores the
                # table, so the candidate spends its bytes and measures as
                # the plain one; the plan stays valid and bit-exact.
                cands.append(Candidate(
                    mode="lut", p=p, wcanon=True,
                    capacity_bytes=prepared_capacity_bytes(
                        f, k, lut_spec, p, wcanon=True, stack=stack),
                    table_bytes=tb, est_us=lut_us,
                ))
            if not servable_only:
                cands.append(Candidate(
                    mode="stream", p=p, tile_n=None,
                    buffer_bytes=device.buffer_lut_budget,
                    capacity_bytes=prepared_capacity_bytes(f, k, stream_spec, p, stack=stack),
                    table_bytes=tb,
                    est_us=_stream_est_us(f, k, n_hint, spec, p, device, q, x),
                    servable=False,
                ))
    if servable_only:
        cands = [c for c in cands if c.servable]
    cands.sort(key=lambda c: (c.capacity_bytes + c.table_bytes, c.est_us))
    return cands
