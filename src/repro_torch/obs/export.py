"""Exporters: registry/tracer state -> JSON snapshot, Prometheus text,
``spans.jsonl``.

Three consumers, three formats:

* ``snapshot()`` -- one schema-versioned JSON document of every metric
  (counters, gauges + change timelines, histograms + derived
  p50/p90/p99), the JAX package's schema.  Embedded in the serve
  smoke's ``repro.bench/v1`` record and validated there
  (``validate_snapshot``).  ``registry_from_snapshot`` rebuilds a
  ``MetricsRegistry`` from a snapshot, so documents from several
  processes can be merged and re-exported.
* ``to_prom_text()`` -- Prometheus exposition format (text/plain
  version 0.0.4): counters, gauges, and cumulative ``_bucket{le=...}``
  histogram series, ready for a scrape endpoint or a pushgateway.
* ``dump_spans()`` -- the tracer's ring of finished query traces as
  flat JSON-lines (one span per line; see ``trace.Span.to_dict``).
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .trace import TraceStore, Tracer, get_tracer

SNAPSHOT_SCHEMA = "repro.obs.snapshot/v1"

#: Metric names every instrumented process is expected to expose (they
#: are pre-registered by ``EngineBase`` / ``SpmdEngine`` construction,
#: before any query runs).  The serve smoke validates its snapshot
#: against this list -- a missing name means an engine stopped feeding
#: the registry.  The JAX package's list, name for name.
REQUIRED_METRICS = (
    "repro_queries_total",
    "repro_result_rows_total",
    "repro_comm_bytes_total",
    "repro_response_time_seconds_total",
    "repro_query_latency_seconds",
    "repro_hook_errors_total",
    # SPMD counters, pre-registered at SpmdEngine construction
    "repro_capacity_retries_total",
    "repro_overflow_events_total",
    "repro_gather_steps_total",
    "repro_edge_shipped_steps_total",
    "repro_skipped_gathers_total",
    "repro_comm_bytes_saved_total",
    "repro_edge_cache_hits_total",
    "repro_batch_shape_hits_total",
)

#: Additional names a process running the serving front door
#: (``repro_torch.serve.FrontDoor``) exposes -- pre-registered at
#: FrontDoor construction, before any request is admitted.  Kept
#: separate from ``REQUIRED_METRICS`` because engine-only processes
#: never build a front door; the serve smoke validates against
#: ``REQUIRED_METRICS + REQUIRED_SERVE_METRICS``.
REQUIRED_SERVE_METRICS = (
    "repro_serve_admitted_total",
    "repro_serve_completed_total",
    "repro_serve_failed_total",
    "repro_serve_shed_queue_full_total",
    "repro_serve_shed_breaker_total",
    "repro_serve_deadline_expired_total",
    "repro_serve_batches_total",
    "repro_serve_batch_fallbacks_total",
    "repro_serve_breaker_opens_total",
    "repro_serve_queue_depth",
    "repro_serve_breaker_state",
    "repro_serve_latency_seconds",
    "repro_serve_queue_wait_seconds",
    "repro_serve_batch_size",
)


# ----------------------------------------------------------------------
# JSON snapshot
# ----------------------------------------------------------------------

def snapshot(registry: Optional[MetricsRegistry] = None,
             tracer: Optional[Tracer] = None) -> Dict[str, Any]:
    """Serialize the registry (default: process registry) and, when a
    tracer is given (or the process default is enabled), the trace
    store's occupancy, into one JSON-ready document."""
    registry = registry if registry is not None else get_registry()
    doc: Dict[str, Any] = {"schema": SNAPSHOT_SCHEMA,
                           "counters": [], "gauges": [], "histograms": []}
    for name, labels, m in registry.collect():
        entry: Dict[str, Any] = {"name": name, "labels": dict(labels)}
        if isinstance(m, Counter):
            entry["value"] = m.value
            doc["counters"].append(entry)
        elif isinstance(m, Gauge):
            entry["value"] = m.value
            entry["history"] = [list(p) for p in m.history]
            doc["gauges"].append(entry)
        else:
            entry.update(histogram_summary(m))
            doc["histograms"].append(entry)
    if tracer is None and get_tracer().enabled:
        tracer = get_tracer()
    if tracer is not None:
        doc["traces"] = {"finished_total": tracer.store.finished_total,
                         "buffered": len(tracer.store),
                         "capacity": tracer.store.capacity}
    return doc


def histogram_summary(h: Histogram) -> Dict[str, Any]:
    """JSON-ready view of one histogram: raw buckets/counts plus the
    derived percentiles the capacity model reads."""
    return {"buckets": list(h.buckets), "counts": list(h.counts),
            "sum": h.sum, "count": h.count,
            "p50": h.percentile(0.50), "p90": h.percentile(0.90),
            "p99": h.percentile(0.99)}


def registry_from_snapshot(doc: Dict[str, Any]) -> MetricsRegistry:
    """Rebuild a ``MetricsRegistry`` from a ``snapshot()`` document
    (gauge timelines are restored; derived percentiles are recomputed
    from the bucket counts, so a round-trip is exact)."""
    if doc.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(f"unknown snapshot schema {doc.get('schema')!r} "
                         f"(expected {SNAPSHOT_SCHEMA})")
    reg = MetricsRegistry()
    for e in doc.get("counters", ()):
        reg.counter(e["name"], **e["labels"]).value = float(e["value"])
    for e in doc.get("gauges", ()):
        g = reg.gauge(e["name"], **e["labels"])
        g.value = float(e["value"])
        for seq, v in e.get("history", ()):
            g.history.append((int(seq), float(v)))
            g._seq = max(g._seq, int(seq))
    for e in doc.get("histograms", ()):
        h = reg.histogram(e["name"], buckets=e["buckets"], **e["labels"])
        h.counts = [int(c) for c in e["counts"]]
        h.sum = float(e["sum"])
        h.count = int(e["count"])
    return reg


def validate_snapshot(doc: Dict[str, Any],
                      required: Sequence[str] = REQUIRED_METRICS) -> None:
    """Raise ``ValueError`` unless ``doc`` is a well-formed snapshot
    exposing every metric name in ``required``.  The serve smoke runs
    this against its embedded snapshot so a silently-dropped metric
    fails the run instead of flatlining a dashboard."""
    if not isinstance(doc, dict) or doc.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(f"not a {SNAPSHOT_SCHEMA} document: "
                         f"schema={doc.get('schema') if isinstance(doc, dict) else type(doc)!r}")
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(doc.get(section), list):
            raise ValueError(f"snapshot section {section!r} missing or "
                             f"not a list")
    present = {e["name"] for section in ("counters", "gauges", "histograms")
               for e in doc[section]}
    missing = [name for name in required if name not in present]
    if missing:
        raise ValueError(
            f"snapshot is missing pre-registered metrics: {missing} "
            f"(present: {sorted(present)})")
    for e in doc["histograms"]:
        if len(e["counts"]) != len(e["buckets"]) + 1:
            raise ValueError(f"histogram {e['name']!r}: counts/buckets "
                             f"length mismatch")
        if sum(e["counts"]) != e["count"]:
            raise ValueError(f"histogram {e['name']!r}: bucket counts do "
                             f"not sum to count")


# ----------------------------------------------------------------------
# Prometheus exposition format
# ----------------------------------------------------------------------

def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    items = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        items.append(extra)
    return "{" + ",".join(items) + "}" if items else ""


def _prom_num(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if v != int(v) else str(int(v))


def to_prom_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in the Prometheus text exposition format
    (histograms as cumulative ``_bucket{le=...}`` + ``_sum`` +
    ``_count`` series)."""
    registry = registry if registry is not None else get_registry()
    lines: List[str] = []
    typed: set = set()
    for name, labels, m in registry.collect():
        ld = dict(labels)
        if name not in typed:
            lines.append(f"# TYPE {name} {m.kind}")
            typed.add(name)
        if isinstance(m, (Counter, Gauge)):
            lines.append(f"{name}{_prom_labels(ld)} {_prom_num(m.value)}")
        else:
            cum = 0
            bounds = list(m.buckets) + [math.inf]
            for bound, c in zip(bounds, m.counts):
                cum += c
                le = _prom_labels(ld, f'le="{_prom_num(bound)}"')
                lines.append(f"{name}_bucket{le} {cum}")
            lines.append(f"{name}_sum{_prom_labels(ld)} {_prom_num(m.sum)}")
            lines.append(f"{name}_count{_prom_labels(ld)} {m.count}")
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# Trace dump
# ----------------------------------------------------------------------

def dump_spans(target: Union[Tracer, TraceStore, None], path: str) -> int:
    """Write the finished traces of ``target`` (a tracer, a store, or
    ``None`` for the process default tracer) to ``path`` as JSON-lines.
    Returns the number of span lines written."""
    if target is None:
        target = get_tracer()
    store = target.store if isinstance(target, Tracer) else target
    return store.to_jsonl(path)
