"""The ``Engine`` surface shared by the execution backends: one query,
a stream of queries, cumulative counters and post-execute observers.

``EngineBase`` keeps the counters as plain numbers under the same names
the reference engines use; the metrics registry and span tracing are
ported in a later slice.  Concrete engines call ``_init_engine_base()``
in ``__init__`` and funnel every finished query through
``_finish(query, result)``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (TYPE_CHECKING, Any, Callable, Dict, List, Sequence)

if TYPE_CHECKING:  # pragma: no cover - typing only
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
    """Shared counter/hook plumbing and a batched ``execute_many``
    (sequential unless the backend overrides ``_execute_batch``)."""

    def _init_engine_base(self) -> None:
        self.post_execute_hooks: List[Callable[[Any, Any], None]] = []
        self._n_queries = 0
        self._n_rows = 0
        self._n_comm_bytes = 0
        self._t_response = 0.0
        self._counters: Dict[str, float] = {}
        self._hook_warned = False
        self._bump("hook_errors", 0)

    def _bump(self, name: str, amount: float = 1.0) -> None:
        """Accumulate a named backend counter (surfaced in
        ``stats().extra``).  Bump with ``amount=0`` at construction to
        pre-register a counter so it is present before it fires."""
        self._counters[name] = self._counters.get(name, 0.0) + amount

    def execute(self, query: "QueryGraph") -> "QueryResult":
        """Answer one query exactly (the backend's ``_execute``)."""
        return self._execute(query)

    def _execute(self, query: "QueryGraph") -> "QueryResult":
        raise NotImplementedError

    def _finish(self, query: "QueryGraph", result: "QueryResult"
                ) -> "QueryResult":
        """Record counters and run observers; every ``_execute`` ends
        here.  A raising observer is counted (``hook_errors``) and
        warned about once, never allowed to abort the query."""
        self._n_queries += 1
        self._n_rows += result.num_rows
        self._n_comm_bytes += result.stats.comm_bytes
        self._t_response += result.stats.response_time
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
