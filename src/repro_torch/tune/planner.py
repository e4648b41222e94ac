"""Greedy capacity-budget knapsack over the whole model's quantized leaves
(port of ``repro.tune.planner``).

The paper solves the capacity-computation tradeoff for ONE GEMM (Eq. 2-6:
spend LUT bytes on a larger packing degree to buy lookups); a model is many
GEMMs drawing on one LUT-capacity pool, so the planner allocates a global
``lut_budget_bytes`` across layers by **marginal speedup per byte**:

1. Walk the quantized leaves (a stacked leaf is one planning unit: the plan
   applies to the whole stack, capacity and time scale by it).
2. Enumerate each leaf's candidates (:mod:`repro_torch.tune.space`) and
   optionally correct the analytic estimates by measurement
   (:mod:`repro_torch.tune.measure`) on the stack's first unit.
3. Start every layer at its cheapest config (the degradation floor: raw
   serving, zero prepared bytes) and greedily apply the upgrade with the
   best time-saved-per-extra-byte until nothing fits.  Shared LUT packs are
   charged once model-wide, so the first layer to want a pack pays for it
   and the rest ride along.

Under a tightening budget the degradation order is the reverse: drop the
weight-static ``wcanon`` table, then lower ``p``, then serve the raw layer.

:func:`apply_plan` replays a plan onto a raw quantized tree, refusing a
fingerprint mismatch, and :func:`verify_capacity` checks the plan's byte
accounting against the prepared tree, leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch import hw
from repro_torch.core import QuantizedLinear
from repro_torch.core.prepared import WCANON_MAX_ENTRIES, PreparedLinear
from repro_torch.tune import measure as measure_mod
from repro_torch.tune import space
from repro_torch.tune.plan import (
    LayerPlan,
    ModelPlan,
    map_quantized_leaves,
    param_fingerprint,
    quantized_leaf_items,
)


def _leaf_stack(q) -> int:
    return math.prod(int(d) for d in q.codes.shape[:-2])


def _unit_slice(q: QuantizedLinear) -> QuantizedLinear:
    """First unit of a stacked leaf (representative for measurement): its
    ``codes[0]``, ``scale[0]`` and ``bias[0]``, and a stacked frozen
    activation scale's first entry."""
    while q.codes.ndim > 2:
        q = dataclasses.replace(
            q,
            codes=q.codes[0],
            scale=q.scale[0],
            bias=None if q.bias is None else q.bias[0],
            ascale=None if q.ascale is None or q.ascale.ndim == 0 else q.ascale[0],
        )
    return q


def _unit_shape(q) -> tuple[int, int]:
    return int(q.codes.shape[-2]), int(q.k)      # F (output rows), logical K


@dataclasses.dataclass
class _LayerState:
    path: str
    spec: object                             # base LutLinearSpec
    stack: int
    f: int
    k: int
    cands: list[space.Candidate]
    eff_us: list[float]                      # measured-else-analytic, per unit
    measured: list[Optional[float]]
    choice: int = 0


def _totals(states: list[_LayerState]) -> tuple[int, int]:
    """(total_bytes, table_bytes) of the current choices, shared packs
    charged once."""
    cap = 0
    packs: dict = {}
    for st in states:
        c = st.cands[st.choice]
        cap += c.capacity_bytes
        key = c.pack_key(st.spec)
        if key is not None:
            packs[key] = c.table_bytes
    tb = sum(packs.values())
    return cap + tb, tb


def plan_model(
    qparams,
    *,
    lut_budget_bytes: int,
    n_hint: int = 8,
    device: hw.PimDevice = hw.UPMEM,
    measure: bool = True,
    servable_only: bool = True,
    p_cap: Optional[int] = None,
    measurer: Optional[measure_mod.Measurer] = None,
    measure_n: Optional[int] = None,
    seed: int = 0,
) -> ModelPlan:
    """Compile a :class:`ModelPlan` for ``qparams`` under a global budget.

    ``qparams`` must be a raw quantized tree (``Model.quantize`` output);
    ``n_hint`` is the serve-time activation column count candidates are
    priced at (decode batch width); ``device`` the PIM cost model of the
    analytic estimates; ``servable_only`` leaves out the stream candidates
    (the simulated slice-streaming dataflow, which no serve path runs);
    ``measure=False`` plans from the analytic cost models alone.

    ``measure_n`` (default ``max(n_hint, 128)``) is the activation column
    count measurements run at, on the device the leaves live on: at
    decode-width batches one ``apply_linear`` call is launch-bound and every
    config measures alike."""
    items = quantized_leaf_items(qparams)
    if not items:
        raise ValueError("no QuantizedLinear leaves to plan; quantize first")
    if any(isinstance(q, PreparedLinear) for _, q in items):
        raise ValueError("plan_model takes the raw quantized tree; prepared "
                         "leaves are already frozen to one config")
    meas = measurer or measure_mod.Measurer()
    measure_n = measure_n or max(n_hint, 128)
    states: list[_LayerState] = []
    for path, q in items:
        stack = _leaf_stack(q)
        # Every stacked leaf is measured on its first unit, a stack of one
        # too (the reference slices only where stack > 1, and its measured
        # plan raises on deepseek's one-unit "F" segment: ROADMAP Queue 3).
        unit = _unit_slice(q)
        f, k = _unit_shape(unit)
        dev = unit.codes.device
        # The q/x sample only feeds the stream candidates' plan-only traffic
        # stats, which servable_only leaves out.
        xs = None if servable_only else measure_mod.sample_activations(
            k, n_hint, seed=seed, device=dev)
        cands = space.layer_candidates(
            f, k, n_hint=n_hint, base_spec=q.spec, device=device,
            stack=stack, q=None if servable_only else unit, x=xs,
            p_cap=p_cap, servable_only=servable_only,
        )
        if not cands:
            # Only float-grid stream layers end up here: keep-as-is is their
            # sole numerics-safe config and no serve path runs it.
            raise ValueError(
                f"layer {path!r} has no servable candidates "
                f"(spec {q.spec}); serve it outside a plan"
            )
        xm = measure_mod.sample_activations(k, measure_n, seed=seed, device=dev) \
            if measure else None
        eff, meas_us = [], []
        for c in cands:
            m = meas.measure(unit, xm, c) if measure else None
            meas_us.append(m)
            eff.append(m if m is not None else c.est_us)
        states.append(_LayerState(path, q.spec, stack, f, k, cands, eff, meas_us))

    # --- greedy marginal-speedup-per-byte knapsack -------------------------
    for st in states:   # floor: cheapest (capacity+table), already sorted
        st.choice = 0
    # Running totals: one switch is a capacity delta plus shared-pack
    # refcounts (the last user of a pack releases its table bytes; the first
    # user of a new pack pays for it).
    pack_refs: dict = {}
    pack_bytes: dict = {}
    for st in states:
        key = st.cands[st.choice].pack_key(st.spec)
        if key is not None:
            pack_refs[key] = pack_refs.get(key, 0) + 1
            pack_bytes[key] = st.cands[st.choice].table_bytes
    total = sum(st.cands[st.choice].capacity_bytes for st in states) + sum(pack_bytes.values())
    over_budget = total > lut_budget_bytes

    def switch_delta(st: _LayerState, ci: int) -> int:
        old_c, new_c = st.cands[st.choice], st.cands[ci]
        d = new_c.capacity_bytes - old_c.capacity_bytes
        ok, nk = old_c.pack_key(st.spec), new_c.pack_key(st.spec)
        if ok != nk:
            if ok is not None and pack_refs[ok] == 1:
                d -= pack_bytes[ok]
            if nk is not None and pack_refs.get(nk, 0) == 0:
                d += new_c.table_bytes
        return d

    def apply_switch(st: _LayerState, ci: int) -> None:
        old_c, new_c = st.cands[st.choice], st.cands[ci]
        ok, nk = old_c.pack_key(st.spec), new_c.pack_key(st.spec)
        if ok != nk:
            if ok is not None:
                pack_refs[ok] -= 1
                if pack_refs[ok] == 0:
                    del pack_refs[ok], pack_bytes[ok]
            if nk is not None:
                pack_refs[nk] = pack_refs.get(nk, 0) + 1
                pack_bytes[nk] = new_c.table_bytes
        st.choice = ci

    while True:
        best = None                              # (ratio, gain, li, ci)
        for li, st in enumerate(states):
            cur_us = st.eff_us[st.choice]
            for ci in range(len(st.cands)):
                if ci == st.choice:
                    continue
                gain = (cur_us - st.eff_us[ci]) * st.stack
                if gain <= 0:
                    continue
                delta = switch_delta(st, ci)
                new_total = total + delta
                if new_total > lut_budget_bytes and new_total > total:
                    continue
                # Free (or byte-releasing) upgrades dominate outright.
                ratio = float("inf") if delta <= 0 else gain / delta
                if best is None or (ratio, gain) > best[:2]:
                    best = (ratio, gain, li, ci)
        if best is None:
            break
        _, _, li, ci = best
        total += switch_delta(states[li], ci)
        apply_switch(states[li], ci)

    total_bytes, table_bytes = _totals(states)
    layers = {}
    for st in states:
        c = st.cands[st.choice]
        layers[st.path] = LayerPlan(
            mode=c.mode, p=c.p, tile_n=c.tile_n, buffer_bytes=c.buffer_bytes,
            wcanon=c.wcanon, prepared=c.prepared,
            capacity_bytes=c.capacity_bytes, table_bytes=c.table_bytes,
            est_us=c.est_us, measured_us=st.measured[st.choice],
            stack=st.stack,
        )
    return ModelPlan(
        fingerprint=param_fingerprint(qparams),
        budget_bytes=lut_budget_bytes,
        layers=layers,
        total_bytes=total_bytes,
        table_bytes=table_bytes,
        meta=dict(
            n_hint=n_hint, measure_n=measure_n, device=device.name,
            measured=measure, servable_only=servable_only,
            over_budget=over_budget,
            measure_cache_hits=meas.hits, measure_cache_misses=meas.misses,
        ),
    )


def apply_plan(params, plan: ModelPlan, *, strict: bool = True, **kw):
    """Replay ``plan`` onto a raw quantized tree: per-leaf spec rewrite +
    weight-stationary prepare (raw leaves stay raw where the plan degraded
    them).  Refuses a fingerprint mismatch and a prepared tree.  ``n_hint``
    defaults to the plan's; ``kw`` forwards to
    :func:`repro_torch.core.prepare_linear`."""
    fp = param_fingerprint(params)
    if fp != plan.fingerprint:
        raise ValueError(
            f"plan fingerprint {plan.fingerprint} does not match the "
            f"parameter tree ({fp}): shapes or quantization changed — "
            f"re-run the autotuner"
        )
    if any(isinstance(q, PreparedLinear) for _, q in quantized_leaf_items(params)):
        raise ValueError("apply_plan takes the raw quantized tree (plans "
                         "rewrite specs before preparing)")
    from repro_torch.models.model import _prepare_leaf

    n_hint = kw.pop("n_hint", plan.meta.get("n_hint", 128))

    def fn(path, q):
        lp = plan.layers.get(path)
        if lp is None:
            if strict:
                raise KeyError(f"plan has no entry for layer {path!r}")
            return q
        qq = dataclasses.replace(
            q, spec=dataclasses.replace(
                q.spec, mode=lp.mode, p=lp.p,
                tile_n=lp.tile_n, buffer_bytes=lp.buffer_bytes,
            )
        )
        if not lp.prepared:
            return qq
        stack = _leaf_stack(qq)
        cap = max(WCANON_MAX_ENTRIES // max(stack, 1), 1) if lp.wcanon else 0
        return _prepare_leaf(qq, n_hint=n_hint, wcanon_max_entries=cap, **kw)

    return map_quantized_leaves(params, fn)


def verify_capacity(prepared_params, plan: ModelPlan) -> dict:
    """Check the plan's capacity accounting against the prepared tree, leaf
    by leaf; returns the per-layer actual bytes.  Raises ``AssertionError``
    where the plan's byte count is not the tree's."""
    actual: dict[str, int] = {}
    for path, leaf in quantized_leaf_items(prepared_params):
        lp = plan.layers[path]
        got = leaf.prepared_bytes if isinstance(leaf, PreparedLinear) else 0
        if got != lp.capacity_bytes:
            raise AssertionError(
                f"{path}: plan says {lp.capacity_bytes} prepared bytes, "
                f"actual pytree has {got}"
            )
        actual[path] = got
    want_cap = sum(lp.capacity_bytes for lp in plan.layers.values())
    if plan.total_bytes != want_cap + plan.table_bytes:
        raise AssertionError(
            f"plan totals inconsistent: {plan.total_bytes} != "
            f"{want_cap} + {plan.table_bytes}"
        )
    return actual
