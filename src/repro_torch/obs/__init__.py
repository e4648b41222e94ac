"""``repro_torch.obs``: zero-sync tracing and metrics for the port's serving
stack (port of ``repro.obs``).

:class:`Observer` bundles a ring-buffered :class:`Tracer` and a
:class:`MetricsRegistry`; ``ServeEngine(obs=...)`` records request-lifecycle
and per-wave spans only at its existing host syncs (tokens, ``host_syncs``
and ``admissions`` are those of an untraced run);
:mod:`repro_torch.obs.export` renders the stream as Chrome/Perfetto
``trace_event`` JSON, JSONL or a text snapshot, in the reference's format.
"""

from repro_torch.obs.export import (
    metrics_records,
    perfetto_trace,
    snapshot_text,
    write_jsonl,
    write_metrics_jsonl,
    write_perfetto,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile,
    scrape_engine,
    slo_stats,
)
from repro_torch.obs.trace import Event, Observer, Tracer

__all__ = [
    "Counter",
    "Event",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Observer",
    "metrics_records",
    "Tracer",
    "percentile",
    "perfetto_trace",
    "scrape_engine",
    "slo_stats",
    "snapshot_text",
    "write_jsonl",
    "write_metrics_jsonl",
    "write_perfetto",
]
