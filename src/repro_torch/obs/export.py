"""Exporters: Perfetto ``trace_event`` JSON, JSONL events, text snapshots
(port of ``repro.obs.export``; the same bytes for the same events, so the
two packages' exports compare byte for byte).

* :func:`perfetto_trace` / :func:`write_perfetto` — the Chrome/Perfetto
  ``trace_event`` format (the JSON object form, ``{"traceEvents": [...]}``)
  that loads in ``chrome://tracing`` / ``ui.perfetto.dev``.  One process,
  one thread per :attr:`repro_torch.obs.trace.Event.track` (``slot 0`` …
  ``slot B-1``, ``supervisor``, ``swap``, ``tune.measure``, ``engine``),
  named by ``thread_name`` metadata events.  Timestamps convert from the
  :func:`repro_torch.timing.clock` seconds domain to microseconds.
* :func:`write_jsonl` — one JSON object per line.
* :func:`snapshot_text` — the human-readable snapshot: counters, gauges,
  histogram summaries and the derived SLO block.

Every event arg must be a Python scalar (or a list / dict of them): a numpy
or torch scalar makes ``json.dumps`` raise, so recording sites convert what
they take from an array (``int(...)``) before they pass it.

**Write discipline** — both file writers are atomic the way prepared
checkpoints are (:mod:`repro_torch.ckpt`): serialize to
``<path>.tmp.<pid>``, flush + fsync, then ``os.replace`` onto the
destination.  A process killed mid-export leaves either the previous
complete file or the new one, never a torn trace; a serialization error
leaves the previous file and no tmp file.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.obs.trace import Event, Observer, Tracer


def _as_events(source) -> list[Event]:
    if isinstance(source, Observer):
        return source.tracer.events()
    if isinstance(source, Tracer):
        return source.events()
    return list(source)


def _atomic_write_text(path: str, text: str) -> None:
    """tmp + fsync + rename: the ckpt write discipline applied to traces."""
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):    # serialization failed before the rename
            os.remove(tmp)


def perfetto_trace(source, *, process_name: str = "repro.serve") -> dict:
    """Render events as a ``chrome://tracing``-loadable trace object.

    Deterministic track ids: tracks are numbered by first appearance, with
    ``thread_name`` metadata so the UI shows ``slot 0`` / ``supervisor`` /
    … instead of bare tids."""
    events = _as_events(source)
    pid = 1
    tids: dict[str, int] = {}
    out: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    body: list[dict] = []
    for ev in events:
        tid = tids.get(ev.track)
        if tid is None:
            tid = tids[ev.track] = len(tids) + 1
            out.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": ev.track},
            })
        rec = {
            "name": ev.name, "cat": ev.cat, "ph": ev.ph,
            "ts": ev.ts * 1e6, "pid": pid, "tid": tid,
        }
        if ev.ph == "X":
            rec["dur"] = ev.dur * 1e6
        if ev.ph == "C":
            rec["args"] = {"value": ev.args.get("value", 0)}
        elif ev.args:
            rec["args"] = dict(ev.args)
        if ev.ph == "i":
            rec["s"] = "t"          # instant scope: thread
        body.append(rec)
    return {"traceEvents": out + body, "displayTimeUnit": "ms"}


def write_perfetto(source, path: str, *,
                   process_name: str = "repro.serve") -> str:
    """Atomically write the Perfetto trace JSON; returns ``path``."""
    trace = perfetto_trace(source, process_name=process_name)
    _atomic_write_text(path, json.dumps(trace) + "\n")
    return str(path)


def write_jsonl(source, path: str) -> str:
    """Atomically write one JSON object per event; returns ``path``."""
    events = _as_events(source)
    lines = "".join(
        json.dumps(ev.to_dict(), separators=(",", ":")) + "\n"
        for ev in events
    )
    _atomic_write_text(path, lines)
    return str(path)


def metrics_records(obs: Observer, *, extra: Optional[dict] = None) -> list[dict]:
    """The metrics surface as JSON-ready records: one ``snapshot`` record
    (counters/gauges/histograms), one ``slo`` record, one ``request`` record
    per observed request, plus ``extra`` when given."""
    recs: list[dict] = [
        {"t": "snapshot", **obs.metrics.snapshot()},
        {"t": "slo", **obs.slo()},
    ]
    recs.extend({"t": "request", **r} for r in obs.request_records())
    if extra:
        recs.append({"t": "extra", **extra})
    return recs


def write_metrics_jsonl(obs: Observer, path: str, *,
                        extra: Optional[dict] = None) -> str:
    """Atomically write :func:`metrics_records` as JSONL."""
    recs = metrics_records(obs, extra=extra)
    _atomic_write_text(
        path,
        "".join(json.dumps(r, separators=(",", ":")) + "\n" for r in recs),
    )
    return str(path)


def _fmt_seconds(v: float) -> str:
    if v != v:                       # NaN
        return "-"
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.1f}ms"
    return f"{v * 1e6:.0f}us"


def snapshot_text(obs: Observer, *, title: str = "repro.obs") -> str:
    """The human-readable periodic snapshot (``launch/serve.py --metrics``
    prints it; a long-running server would emit it on an interval)."""
    snap = obs.metrics.snapshot()
    slo = obs.slo()
    lines = [f"== {title} =="]
    if snap["counters"]:
        lines.append("counters:")
        lines.extend(f"  {k:<28} {v:g}" for k, v in snap["counters"].items())
    if snap["gauges"]:
        lines.append("gauges:")
        lines.extend(f"  {k:<28} {v:g}" for k, v in snap["gauges"].items())
    if snap["histograms"]:
        lines.append("histograms (count/mean/max):")
        for k, h in snap["histograms"].items():
            mx = h["max"] if h["max"] is not None else float("nan")
            fmt = _fmt_seconds if k.endswith("_s") else lambda v: f"{v:g}"
            lines.append(
                f"  {k:<28} {h['count']:>6}  {fmt(h['mean']):>9}  "
                f"{fmt(mx):>9}"
            )
    lines.append(
        f"slo: {slo['completed']}/{slo['requests']} completed, "
        f"ttft p50={_fmt_seconds(slo['ttft']['p50_s'])} "
        f"p99={_fmt_seconds(slo['ttft']['p99_s'])}, "
        f"tpot p50={_fmt_seconds(slo['tpot']['p50_s'])} "
        f"p99={_fmt_seconds(slo['tpot']['p99_s'])}, "
        f"queue p99={_fmt_seconds(slo['queue_wait']['p99_s'])}, "
        f"goodput={slo['goodput']['tokens_per_s']:.1f} tok/s"
    )
    tr = obs.tracer
    lines.append(f"trace: {len(tr)} events buffered, {tr.dropped} dropped "
                 f"(capacity {tr.capacity})")
    return "\n".join(lines)
