"""Zero-sync tracing: an in-process event bus with ring buffering (port of
``repro.obs.trace``).

**Recording happens only at existing host syncs.**  The serve loop already
crosses device->host once per admission wave
(:attr:`repro_torch.serve.serving.ServeEngine.host_syncs`); every value a
trace event carries (wave index, step counts, admitted request ids, host
clock reads) is on the host at that point.  The tracer never reads a tensor,
never calls ``.item()``, ``.cpu()`` or ``torch.cuda.synchronize()``: with
tracing on, ``host_syncs``, ``admissions`` and the tokens are those of an
untraced run (``tests/test_torch_obs.py``; on the card ``chip_smoke.py``
phase 16 also asserts the same synchronizing calls and kernel launches).

**What a span covers on the card.**  Every timestamp is a read of the host
clock (:func:`repro_torch.timing.clock`), and kernel launches return before
the card runs them.  So in a wave of the continuous driver:

* ``prefill`` (``t_start`` -> ``t_decode``) is the host's time to admit the
  wave and enqueue its prefill (plus any wait the enqueue itself met);
* the span from ``t_decode`` to ``t_fetch`` is the host's time to *enqueue*
  the wave's decode steps, not the card's time to run them;
* ``host_sync`` (``t_fetch`` -> ``t_sync``) is the wait for the card to
  drain what was enqueued and copy the token matrix back;
* ``wave N`` (``t_start`` -> ``t_sync``) is the whole wave, enqueue and
  drain; a request's ``decode rN`` and ``rN lifecycle`` spans end at the
  sync that brought its tokens to the host.

Where the host enqueues more slowly than the card runs, the enqueue span is
the wave's time and ``host_sync`` is short; where the card is the slower,
``host_sync`` holds the difference.  Device time per kernel comes from CUDA
events or the profiler, never from these spans.

**Ring buffer.**  Events append to a ``collections.deque`` with a fixed
``maxlen``: O(1), bounded memory, and atomic under CPython's GIL, so a
hot-swap stage thread and the serving thread share one tracer without a lock
on the append path.  When the ring wraps, the oldest events fall off and
``dropped`` counts them.

Event vocabulary (``cat`` groups them; ``track`` is the Perfetto lane):

* ``request`` — per-request lifecycle: ``submit`` -> ``admit`` (slot) ->
  ``prefill`` (bucket) -> per-wave ``decode`` spans -> ``finish`` /
  ``shed`` / ``quarantine``.
* ``wave`` — per admission wave: the wave span, the host-sync span.
* ``ops`` — live operations: swap ``stage`` / ``flip`` / ``refuse``,
  supervisor ``restart`` / ``giveup`` / ``replay`` / ``quarantine`` /
  ``shed``.
* ``tune`` — per-candidate measurement spans from
  :class:`repro_torch.tune.measure.Measurer`.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional

from repro_torch import timing


@dataclasses.dataclass
class Event:
    """One trace event in the Chrome ``trace_event`` vocabulary subset the
    exporter understands: ``ph="X"`` complete span (``ts`` + ``dur``),
    ``ph="i"`` instant, ``ph="C"`` counter sample.  ``ts``/``dur`` are
    seconds in the :func:`repro_torch.timing.clock` domain; ``track`` names the
    Perfetto thread the event renders on (one per slot, one per live-ops
    actor)."""

    name: str
    cat: str = "serve"
    ph: str = "i"
    ts: float = 0.0
    dur: float = 0.0
    track: str = "engine"
    args: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"name": self.name, "cat": self.cat, "ph": self.ph,
             "ts": self.ts, "track": self.track}
        if self.ph == "X":
            d["dur"] = self.dur
        if self.args:
            d["args"] = self.args
        return d


class Tracer:
    """Ring-buffered event sink; every method is safe to call from any
    thread and never blocks on more than the GIL."""

    def __init__(self, capacity: int = 65536):
        if capacity <= 0:
            raise ValueError(f"tracer capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._appended = 0            # lifetime appends (dropped = appended - held)

    # --- recording --------------------------------------------------------

    def emit(self, event: Event) -> None:
        self._appended += 1
        self._events.append(event)

    def instant(self, name: str, *, cat: str = "serve", track: str = "engine",
                ts: Optional[float] = None, **args) -> None:
        self.emit(Event(name=name, cat=cat, ph="i",
                        ts=timing.clock() if ts is None else ts,
                        track=track, args=args))

    def complete(self, name: str, t0: float, t1: float, *, cat: str = "serve",
                 track: str = "engine", **args) -> None:
        """A finished span ``[t0, t1]`` — recorded after the fact, from
        host-side clock reads taken at existing sync points."""
        self.emit(Event(name=name, cat=cat, ph="X", ts=t0,
                        dur=max(0.0, t1 - t0), track=track, args=args))

    def counter(self, name: str, value, *, cat: str = "serve",
                track: str = "engine", ts: Optional[float] = None) -> None:
        self.emit(Event(name=name, cat=cat, ph="C",
                        ts=timing.clock() if ts is None else ts,
                        track=track, args={"value": value}))

    # --- reading ----------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Events that fell off the ring (lifetime appends minus held)."""
        return self._appended - len(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> list[Event]:
        """Snapshot of the ring's current contents, oldest first."""
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self._appended = 0


class Observer:
    """The object a serving stack threads through itself: one
    :class:`Tracer` + one :class:`repro_torch.obs.metrics.MetricsRegistry`, plus
    the request-lifecycle bookkeeping that turns wave timestamps into SLO
    stats (TTFT / TPOT / queue wait / goodput).

    ``ServeEngine(obs=...)`` calls the ``serve_*``/``wave`` hooks at its
    existing host syncs; :class:`repro_torch.serve.ops.LiveServer`,
    :class:`repro_torch.serve.ops.SwapController` and
    :class:`repro_torch.tune.measure.Measurer` call ``ops_span``/``ops_event``/
    ``measurement``.  Every hook is pure host-side bookkeeping — see the
    module docstring's zero-sync contract.
    """

    def __init__(self, *, tracer: Optional[Tracer] = None, metrics=None,
                 capacity: int = 65536):
        from repro_torch.obs.metrics import MetricsRegistry

        self.tracer = Tracer(capacity=capacity) if tracer is None else tracer
        self.metrics = MetricsRegistry() if metrics is None else metrics
        # request-lifecycle records: key -> dict(submit/admit/first/done
        # timestamps, tokens, slot).  Keys are (generation, request_idx) so
        # consecutive generate() calls on one engine never collide.
        self.requests: dict = {}
        self._gen = 0
        self._lock = threading.Lock()   # generation bump only (cold path)

    # --- request lifecycle (called by ServeEngine at host syncs) ----------

    def serve_begin(self, n_requests: int, *, decode: str, batch: int) -> int:
        """A generate() call is starting: all ``n_requests`` are submitted
        now.  Returns the generation id the engine hands back to the other
        hooks."""
        with self._lock:
            self._gen += 1
            gen = self._gen
        now = timing.clock()
        for i in range(n_requests):
            self.requests[(gen, i)] = {
                "submit": now, "admit": None, "first": None, "done": None,
                "tokens": 0, "slot": None,
            }
        self.tracer.instant("submit", cat="request", track="engine",
                            ts=now, n_requests=n_requests, decode=decode)
        self.metrics.counter("requests_submitted").inc(n_requests)
        self.metrics.gauge("batch_slots").set(batch)
        return gen

    def wave(self, rec, *, gen: int, engine=None) -> None:
        """One admission wave's record (:class:`repro_torch.serve.serving.
        WaveRecord`), at the wave's single host sync.  Emits the wave span,
        per-request admit/prefill/decode/finish events, and updates the
        metric registry — all from host-resident values."""
        tr = self.tracer
        m = self.metrics
        tr.complete(f"wave {rec.wave}", rec.t_start, rec.t_sync, cat="wave",
                    track="engine", steps=rec.steps,
                    admitted=len(rec.admitted), active=rec.active_slots,
                    queue_depth=rec.queue_depth)
        tr.complete("host_sync", rec.t_fetch, rec.t_sync, cat="wave",
                    track="engine", wave=rec.wave)
        for idx, slot in rec.admitted:
            r = self.requests.get((gen, idx))
            if r is not None:
                r["admit"] = rec.t_start
                r["slot"] = slot
                m.histogram("queue_wait_s").observe(rec.t_start - r["submit"])
            tr.instant(f"admit r{idx}", cat="request", track=f"slot {slot}",
                       ts=rec.t_start, request=idx, slot=slot,
                       bucket=rec.prefill_bucket)
        if rec.admitted and rec.prefill_bucket is not None:
            m.histogram("prefill_bucket").observe(rec.prefill_bucket)
            tr.complete("prefill", rec.t_start, rec.t_decode, cat="wave",
                        track="engine", bucket=rec.prefill_bucket,
                        admitted=len(rec.admitted))
        done = 0
        for idx, slot, toks in rec.emitted:
            r = self.requests.get((gen, idx))
            tr.complete(f"decode r{idx}", rec.t_decode, rec.t_sync,
                        cat="request", track=f"slot {slot}", request=idx,
                        wave=rec.wave, tokens=len(toks))
            if r is None:
                continue
            if toks and r["first"] is None:
                r["first"] = rec.t_sync
                m.histogram("ttft_s").observe(rec.t_sync - r["submit"])
            r["tokens"] += len(toks)
            if idx in rec.finished:
                r["done"] = rec.t_sync
                done += 1
                tr.instant(f"finish r{idx}", cat="request",
                           track=f"slot {slot}", ts=rec.t_sync, request=idx,
                           tokens=r["tokens"])
                # One complete span per request lifecycle (submit -> done):
                # the span an operator hunts for first in the Perfetto UI.
                tr.complete(f"r{idx} lifecycle", r["submit"], rec.t_sync,
                            cat="request", track=f"slot {slot}", request=idx,
                            tokens=r["tokens"], slot=slot)
                if r["first"] is not None and r["tokens"] > 1:
                    m.histogram("tpot_s").observe(
                        (r["done"] - r["first"]) / (r["tokens"] - 1))
        m.counter("waves").inc()
        m.counter("tokens_emitted").inc(
            sum(len(t) for _i, _s, t in rec.emitted))
        m.counter("admissions").inc(len(rec.admitted))
        m.counter("requests_finished").inc(done)
        m.histogram("wave_steps").observe(rec.steps)
        m.histogram("host_sync_s").observe(rec.t_sync - rec.t_fetch)
        m.gauge("slot_occupancy").set(rec.active_slots)
        m.gauge("queue_depth").set(rec.queue_depth)
        if engine is not None:
            m.gauge("host_syncs").set(engine.host_syncs)
            m.gauge("swaps").set(engine.swaps)
        tr.counter("slot_occupancy", rec.active_slots, cat="wave",
                   ts=rec.t_sync)
        tr.counter("queue_depth", rec.queue_depth, cat="wave", ts=rec.t_sync)

    def serve_end(self, gen: int, *, engine=None) -> None:
        self.tracer.instant("serve done", cat="request", track="engine",
                            gen=gen)
        if engine is not None:
            self.scrape(engine)

    # --- live-ops / tune events -------------------------------------------

    def ops_event(self, name: str, *, actor: str = "ops",
                  ts: Optional[float] = None, **args) -> None:
        """An instantaneous live-ops event (swap refuse, restart, chaos kill
        point, quarantine, shed, giveup)."""
        self.tracer.instant(name, cat="ops", track=actor, ts=ts, **args)
        self.metrics.counter(f"ops_{name.split()[0]}").inc()

    def ops_span(self, name: str, t0: float, t1: float, *,
                 actor: str = "ops", **args) -> None:
        """A finished live-ops span (swap stage, flip wait, replay,
        checkpoint restore, supervisor backoff)."""
        self.tracer.complete(name, t0, t1, cat="ops", track=actor, **args)
        self.metrics.histogram(f"ops_{name.split()[0]}_s").observe(t1 - t0)

    def measurement(self, key: tuple, us: float, *, cached: bool) -> None:
        """One autotuner candidate measurement (``repro_torch.tune.measure``)."""
        self.metrics.counter(
            "tune_measure_hits" if cached else "tune_measure_misses").inc()
        if not cached:
            now = timing.clock()
            f, k, n, bw, ba, p, mode = key[:7]
            self.tracer.complete(
                f"measure {mode} p={p} [{f}x{k}]", now - us * 1e-6, now,
                cat="tune", track="tune.measure", n=n, bw=bw, ba=ba, us=us)

    # --- engine gauges ----------------------------------------------------

    def scrape(self, engine) -> dict:
        """Scrape engine-level gauges from existing structures — slot count,
        sync/swap counters, the active :class:`repro_torch.tune.ModelPlan`'s
        per-layer mode/p mix — into the registry (and return them).  Pure
        host-side reads; the optional stream buffer-hit ratios come from the
        *planner* (``stream_stats_for(plan_only=True)``), never a GEMM."""
        from repro_torch.obs.metrics import scrape_engine

        return scrape_engine(engine, metrics=self.metrics)

    # --- SLO derivation ---------------------------------------------------

    def request_records(self) -> list[dict]:
        """Per-request lifecycle timestamps, submission order."""
        return [dict(r, key=list(k)) for k, r in sorted(self.requests.items())]

    def slo(self) -> dict:
        """Derived SLO stats over every request observed so far — TTFT,
        TPOT, queue wait percentiles and goodput.  See
        :func:`repro_torch.obs.metrics.slo_stats`."""
        from repro_torch.obs.metrics import slo_stats

        return slo_stats(self.request_records())
