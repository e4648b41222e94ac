"""Metrics registry + derived SLO stats for the port's serving stack (port of
``repro.obs.metrics``).

Counters, gauges and fixed-bucket histograms with the same zero-sync
contract as :mod:`repro_torch.obs.trace`: every observation is a host-resident
scalar recorded at an existing host sync — never a device readback.

Two derived layers sit on top of the raw registry:

* :func:`slo_stats` — the serving SLOs computed from
  the request-lifecycle timestamps the :class:`repro_torch.obs.trace.Observer`
  collects at wave syncs: **TTFT** (submit → first token durable on host),
  **TPOT** (steady-state seconds per subsequent token), **queue wait**
  (submit → slot admission) as exact p50/p90/p99, and **goodput**
  (completed-request tokens per wall second — shed/quarantined/unfinished
  requests contribute nothing, so a server that finishes nothing scores 0
  no matter how busy it was).
* :func:`scrape_engine` — engine-level gauges read from structures the
  engine already maintains: slot count, cumulative host syncs / swaps /
  admissions, the prefill bucket usage histogram, the active
  :class:`repro_torch.tune.ModelPlan`'s per-layer mode mix and packing degrees,
  and (for stream-mode layers) the planner's buffer-hit ratio via
  ``stream_stats_for(plan_only=True)`` — counter arithmetic, no GEMM (but
  a host read of the codes per stream-mode leaf: see
  :func:`_stream_buffer_ratios`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

# Default histogram buckets: log-spaced seconds from 100us to ~2min — wide
# enough for TTFT under heavy-tail arrivals and tight enough for per-wave
# host-sync durations.
DEFAULT_BUCKETS_S = tuple(1e-4 * (2.0 ** i) for i in range(21))


@dataclasses.dataclass
class Counter:
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclasses.dataclass
class Gauge:
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: cumulative-style bucket counts plus
    count/sum/min/max.  Buckets are upper bounds; observations above the
    last bound land in the implicit +inf bucket."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS_S):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)   # [..., +inf]
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {
            "count": self.count, "sum": self.sum, "mean": self.mean,
            "min": self.min, "max": self.max,
            "buckets": [[ub, c] for ub, c in zip(self.buckets, self.counts)]
            + [["+inf", self.counts[-1]]],
        }


class MetricsRegistry:
    """Create-or-get named metrics; ``snapshot()`` is the export surface."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS_S) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(buckets)
        return h

    def snapshot(self) -> dict:
        """One JSON-ready dict of everything the registry holds."""
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.to_dict()
                           for k, h in sorted(self._histograms.items())},
        }


def percentile(values: Sequence[float], q: float) -> float:
    """Exact nearest-rank percentile (``q`` in [0, 100]) of raw samples —
    the SLO stats are computed from the per-request timestamps, not from
    bucketed approximations."""
    if not values:
        return float("nan")
    xs = sorted(values)
    if q <= 0:
        return xs[0]
    rank = math.ceil(q / 100.0 * len(xs))
    return xs[min(len(xs), max(1, rank)) - 1]


def _pcts(values: list[float]) -> dict:
    return {
        "n": len(values),
        "p50_s": percentile(values, 50),
        "p90_s": percentile(values, 90),
        "p99_s": percentile(values, 99),
        "mean_s": sum(values) / len(values) if values else float("nan"),
        "max_s": max(values) if values else float("nan"),
    }


def slo_stats(records: list[dict]) -> dict:
    """Derive the serving SLOs from request-lifecycle records
    (``{"submit", "admit", "first", "done", "tokens"}`` timestamps in one
    monotonic clock domain — what :meth:`repro_torch.obs.trace.Observer.
    request_records` returns)."""
    ttft = [r["first"] - r["submit"] for r in records
            if r.get("first") is not None]
    qwait = [r["admit"] - r["submit"] for r in records
             if r.get("admit") is not None]
    tpot = [(r["done"] - r["first"]) / (r["tokens"] - 1) for r in records
            if r.get("done") is not None and r.get("first") is not None
            and r["tokens"] > 1]
    done = [r for r in records if r.get("done") is not None]
    good_tokens = sum(r["tokens"] for r in done)
    if done:
        t0 = min(r["submit"] for r in records)
        t1 = max(r["done"] for r in done)
        wall = max(t1 - t0, 1e-12)
    else:
        wall = float("nan")
    return {
        "requests": len(records),
        "completed": len(done),
        "total_tokens": sum(r["tokens"] for r in records),
        "ttft": _pcts(ttft),
        "tpot": _pcts(tpot),
        "queue_wait": _pcts(qwait),
        "goodput": {
            "completed_tokens": good_tokens,
            "wall_s": wall,
            "tokens_per_s": (good_tokens / wall) if done else 0.0,
        },
    }


def scrape_engine(engine, *, metrics: Optional[MetricsRegistry] = None,
                  stream_sample_n: int = 1) -> dict:
    """Engine-level gauges from existing structures (host-side reads only,
    except for stream-mode leaves: :func:`_stream_buffer_ratios`).

    Returns the gauge dict and, when ``metrics`` is given, mirrors the
    scalar values into it.  Plan gauges come from the engine's active
    :class:`repro_torch.tune.ModelPlan`; stream-layer buffer-hit ratios come from
    the stream *planner* on a tiny synthetic activation sample
    (``plan_only=True`` — no GEMM executes)."""
    out: dict = {
        "batch_slots": engine.batch,
        "max_seq": engine.max_seq,
        "decode": engine.decode,
        "host_syncs": engine.host_syncs,
        "swaps": engine.swaps,
        "admissions_logged": len(engine.admissions),
        "prefill_buckets": dict(getattr(engine, "bucket_counts", {})),
    }
    plan = getattr(engine, "plan", None)
    if plan is not None:
        modes: dict[str, int] = {}
        ps: dict[str, int] = {}
        for lp in plan.layers.values():
            modes[lp.mode] = modes.get(lp.mode, 0) + 1
            ps[str(lp.p)] = ps.get(str(lp.p), 0) + 1
        out["plan"] = {
            "layers": len(plan.layers),
            "budget_bytes": plan.budget_bytes,
            "total_bytes": plan.total_bytes,
            "modes": modes,
            "p": ps,
        }
    stream_layers = _stream_buffer_ratios(engine, stream_sample_n)
    if stream_layers:
        out["stream_buffer_hit_ratio"] = stream_layers
    if metrics is not None:
        metrics.gauge("batch_slots").set(engine.batch)
        metrics.gauge("host_syncs").set(engine.host_syncs)
        metrics.gauge("swaps").set(engine.swaps)
        if plan is not None:
            metrics.gauge("plan_layers").set(len(plan.layers))
            metrics.gauge("plan_total_bytes").set(plan.total_bytes)
        for path, ratio in (stream_layers or {}).items():
            metrics.gauge(f"stream_buffer_hit_ratio:{path}").set(ratio)
    return out


def _stream_buffer_ratios(engine, n: int) -> dict:
    """Planner-derived buffer-hit ratio per stream-mode quantized leaf of
    the engine's serving tree (empty when none: serving plans exclude the
    stream dataflow, which simulates the PIM device's traffic, so this fires
    only on explicitly stream-configured trees).

    **Not zero-sync on the card.**  For each stream-mode leaf a sample
    ``[n, K]`` is made on the engine's device and quantized there
    (:func:`repro_torch.core.api.stream_stats_for` with ``plan_only=True``),
    and the planner (:func:`repro_torch.core.engine.stream_plan_stats`) reads
    the activation codes on the host: one device-to-host copy, hence a sync,
    per stream-mode leaf.  :meth:`Observer.serve_end` scrapes the engine
    inside ``generate``'s ``finally``, after the serve's last wave, so such a
    tree pays those syncs once per ``generate``.  No serve path has a
    stream-mode leaf today (plans exclude ``stream``), so none pays them."""
    import numpy as np

    from repro_torch import devices
    from repro_torch.core import api
    from repro_torch.tune.plan import map_quantized_leaves

    found: dict[str, float] = {}

    def visit(path, q):
        spec = getattr(q, "spec", None)
        if spec is None or getattr(spec, "mode", None) != "stream":
            return None
        rng = np.random.default_rng(0)
        x = rng.normal(size=(n, q.k)).astype(np.float32)
        st = api.stream_stats_for(q, devices.upload(x, engine.device), plan_only=True)
        addressed = st.buffer_hits + st.slices_streamed
        found[path] = st.buffer_hits / addressed if addressed else 0.0
        return None

    # As the reference: a leaf the planner cannot take ends the walk with the
    # ratios found so far (the gauges are best effort, the serve goes on).
    try:
        map_quantized_leaves(engine.params, visit)
    except Exception:
        return found
    return found
