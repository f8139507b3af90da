"""Telemetry layer: span-level query tracing, process-wide metrics,
and exporters -- the §8 evaluation surface as a first-class subsystem.

The span model, the metric names and the snapshot schema are the JAX
package's (``docs/observability.md``), so snapshots and span dumps of
the two packages read, compare and merge alike.  Three modules, one
pipeline:

* ``trace``   -- ``Tracer`` / ``Span`` / ring-buffered ``TraceStore``:
  one root span per executed query, with structured per-join-step
  communication records on the SPMD engine (reconciling exactly with
  the byte ledger).
* ``metrics`` -- ``MetricsRegistry`` of counters, gauges (with change
  timelines), and fixed-bucket latency histograms (p50/p90/p99 derived
  from bucket counts, merge-able across engines).  Fed by
  ``EngineBase._bump``/``_finish`` so every ``stats().extra`` key is a
  named metric.
* ``export``  -- ``snapshot()`` JSON documents, ``to_prom_text()``
  Prometheus exposition, and ``dump_spans()`` / ``spans.jsonl``.
"""
from .export import (REQUIRED_METRICS, SNAPSHOT_SCHEMA, dump_spans,
                     histogram_summary, registry_from_snapshot, snapshot,
                     to_prom_text, validate_snapshot)
from .metrics import (BYTES_BUCKETS, LATENCY_BUCKETS_SEC, Counter, Gauge,
                      Histogram, MetricsRegistry, get_registry, set_registry)
from .trace import (NULL_TRACER, Span, TraceStore, Tracer, enable_tracing,
                    get_tracer, set_tracer)

__all__ = [
    "Tracer", "Span", "TraceStore", "NULL_TRACER",
    "get_tracer", "set_tracer", "enable_tracing",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "get_registry", "set_registry",
    "LATENCY_BUCKETS_SEC", "BYTES_BUCKETS",
    "snapshot", "histogram_summary", "registry_from_snapshot",
    "validate_snapshot", "to_prom_text", "dump_spans",
    "SNAPSHOT_SCHEMA", "REQUIRED_METRICS",
]
