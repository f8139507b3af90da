"""The ``Engine`` surface shared by the execution backends: one query,
a stream of queries, cumulative counters and post-execute observers.

``EngineBase`` keeps the counters under the names the reference
engines use and publishes them through the telemetry layer
(``repro_torch.obs``): every counter is mirrored into the metrics
registry as ``repro_<name>_total``, each query observes the latency
histogram and refreshes the ``_stats_extra`` gauges, and ``execute``
wraps each query in a root ``"query"`` span when tracing is on.
Concrete engines call ``_init_engine_base()`` in ``__init__`` and
funnel every finished query through ``_finish(query, result)``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (TYPE_CHECKING, Any, Callable, Dict, List, Sequence)

from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..obs.metrics import MetricsRegistry
    from ..obs.trace import Tracer
    from .executor import QueryResult
    from .query import QueryGraph


@dataclasses.dataclass
class EngineStats:
    """Cumulative execution counters, uniform across backends.

    Attributes:
        queries: queries executed through this engine.
        result_rows: total result rows returned.
        comm_bytes: total data-plane bytes shipped between sites
            (intermediate binding rows / edge rows; control scalars are
            not ledgered).
        response_time: summed per-query response time (seconds).
        backend / strategy: provenance, stamped by ``Session.stats()``.
        extra: backend-specific counters and gauges.
    """
    queries: int = 0
    result_rows: int = 0
    comm_bytes: int = 0
    response_time: float = 0.0
    backend: str = ""
    strategy: str = ""
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)


class EngineBase:
    """Shared counter/hook/telemetry plumbing and a batched
    ``execute_many`` (sequential unless the backend overrides
    ``_execute_batch``).

    ``_init_engine_base`` binds the process-default tracer and metrics
    registry (``repro_torch.obs``); both are swappable afterwards via
    ``set_tracer`` / ``set_metrics_registry`` (``Session`` exposes them
    as constructor knobs).
    """

    #: short backend label stamped on spans and metric series
    trace_name: str = "engine"

    def _init_engine_base(self) -> None:
        self.post_execute_hooks: List[Callable[[Any, Any], None]] = []
        self._n_queries = 0
        self._n_rows = 0
        self._n_comm_bytes = 0
        self._t_response = 0.0
        self._counters: Dict[str, float] = {}
        self.tracer: "Tracer" = _obs_trace.get_tracer()
        self.metrics: "MetricsRegistry" = _obs_metrics.get_registry()
        self._metric_cache: Dict[str, Any] = {}
        self._hook_warned = False
        self._bump("hook_errors", 0)

    # -- telemetry wiring ----------------------------------------------
    def set_tracer(self, tracer: "Tracer") -> None:
        """Route this engine's spans through ``tracer``."""
        self.tracer = tracer

    def set_metrics_registry(self, registry: "MetricsRegistry") -> None:
        """Route this engine's metrics into ``registry``.  Counters
        pre-registered at construction are re-registered so the new
        registry exposes them immediately."""
        self.metrics = registry
        self._metric_cache = {}
        for name in self._counters:
            registry.counter(f"repro_{name}_total",
                             backend=self.trace_name)

    def _metric(self, kind: str, name: str, **kw):
        """Per-engine cache over registry lookups (one dict hit on the
        hot path instead of a labels sort)."""
        m = self._metric_cache.get(name)
        if m is None:
            factory = getattr(self.metrics, kind)
            m = factory(name, backend=self.trace_name, **kw)
            self._metric_cache[name] = m
        return m

    def _bump(self, name: str, amount: float = 1.0) -> None:
        """Accumulate a named backend counter; it surfaces in
        ``stats().extra`` and as the ``repro_<name>_total`` counter of
        the metrics registry.  Bump with ``amount=0`` at construction to
        pre-register a counter so it is present before it fires."""
        self._counters[name] = self._counters.get(name, 0.0) + amount
        self._metric("counter", f"repro_{name}_total").inc(amount)

    def execute(self, query: "QueryGraph") -> "QueryResult":
        """Answer one query exactly (the backend's ``_execute``),
        wrapped in a root ``"query"`` span when tracing is enabled."""
        tracer = self.tracer
        if not tracer.enabled:
            return self._execute(query)
        with tracer.span("query", backend=self.trace_name):
            return self._execute(query)

    def _execute(self, query: "QueryGraph") -> "QueryResult":
        raise NotImplementedError

    def _finish(self, query: "QueryGraph", result: "QueryResult"
                ) -> "QueryResult":
        """Record counters and metrics, annotate the query span, and run
        observers; every ``_execute`` ends here.  A raising observer is
        counted (``hook_errors``) and warned about once, never allowed
        to abort the query."""
        st = result.stats
        self._n_queries += 1
        self._n_rows += result.num_rows
        self._n_comm_bytes += st.comm_bytes
        self._t_response += st.response_time
        self._metric("counter", "repro_queries_total").inc()
        self._metric("counter", "repro_result_rows_total").inc(
            result.num_rows)
        self._metric("counter", "repro_comm_bytes_total").inc(st.comm_bytes)
        self._metric("counter",
                     "repro_response_time_seconds_total").inc(
            st.response_time)
        self._metric("histogram", "repro_query_latency_seconds").observe(
            st.response_time)
        for name, val in self._stats_extra().items():
            g = self._metric_cache.get(f"_g_{name}")
            if g is None:
                g = self.metrics.gauge(f"repro_{name}",
                                       backend=self.trace_name)
                self._metric_cache[f"_g_{name}"] = g
            g.set(val)
        if self.tracer.enabled:
            self.tracer.annotate(rows=result.num_rows,
                                 comm_bytes=st.comm_bytes,
                                 response_time=st.response_time)
        for hook in self.post_execute_hooks:
            try:
                hook(query, result)
            except Exception as exc:  # noqa: BLE001 -- observer isolation
                self._bump("hook_errors")
                if not self._hook_warned:
                    self._hook_warned = True
                    warnings.warn(
                        f"post_execute_hook {hook!r} raised "
                        f"{type(exc).__name__}: {exc}; counting as "
                        f"hook_errors and continuing (warning once per "
                        f"engine)", RuntimeWarning, stacklevel=2)
        return result

    def execute_many(self, queries: Sequence["QueryGraph"],
                     batch_size: int = 64) -> List["QueryResult"]:
        """Execute a query stream in batches of ``batch_size`` (at least
        1).  Results come back in input order; backends override
        ``_execute_batch`` to exploit structure inside a batch."""
        bs = max(int(batch_size), 1)
        out: List["QueryResult"] = []
        for i in range(0, len(queries), bs):
            out.extend(self._execute_batch(list(queries[i:i + bs])))
        return out

    def _execute_batch(self, batch: List["QueryGraph"]
                       ) -> List["QueryResult"]:
        return [self.execute(q) for q in batch]

    def stats(self) -> EngineStats:
        """Cumulative counters since construction: the named counters
        bumped through ``_bump`` merged with the backend's derived
        ``_stats_extra`` gauges."""
        extra = dict(self._counters)
        extra.update(self._stats_extra())
        return EngineStats(self._n_queries, self._n_rows,
                           self._n_comm_bytes, self._t_response,
                           extra=extra)

    def _stats_extra(self) -> Dict[str, float]:
        return {}
