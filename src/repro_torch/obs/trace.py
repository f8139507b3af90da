"""Span-level query tracing: the per-query half of the telemetry layer.

The paper's evaluation (§8) is an observability exercise -- crossing
matches, communication cost, response time *per query shape* -- but
cumulative counters (``EngineStats``) can only answer aggregate
questions.  A **trace** answers the per-query ones: which join step of
this query shipped what, which capacity tier it ran at, which sites its
subqueries matched on.

Model
-----

* ``Span`` -- one timed operation: name, start/end (seconds on the
  tracer's clock), attributes (small scalars), ``records`` (a list of
  structured dicts -- the SPMD engine attaches one per join step), and
  child spans.  A span with no parent is a *root* span; every engine
  query produces exactly one root span named ``"query"``.
* ``Tracer`` -- hands out spans as context managers and maintains the
  open-span stack, so spans opened while another is open nest under it
  (the front door's ``"serve_batch"`` span holds the engine's
  ``"query"`` spans).  The clock is injectable (any ``() ->
  float`` monotonic callable) so tests drive deterministic timings.
* ``TraceStore`` -- ring buffer of *finished root* spans.  The ring
  caps memory regardless of stream length (``capacity`` roots; older
  traces fall off); ``finished_total`` still counts everything.

Cost discipline: a disabled tracer (``Tracer(enabled=False)``, the
process default) returns a shared no-op span from ``span()`` and makes
``add_record``/``annotate`` single-branch no-ops.  Nothing here ever
touches the card: records are built on the host from vectors the
engine has already read back (the SPMD engine's per-attempt decision
and shipped-row vectors), so tracing adds no device work and no host
read, and cannot change what runs on the device.

Typical use::

    tracer = Tracer(enabled=True)
    with tracer.span("query", backend="spmd") as sp:
        ...
        tracer.add_record({"step": 1, "decision": "gather", "bytes": 96})
        sp.set("rows", 12)
    tracer.store.to_jsonl("spans.jsonl")
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, Iterator, List, Optional,
                    Tuple)

Clock = Callable[[], float]


@dataclasses.dataclass
class Span:
    """One timed operation inside a trace (see module docstring)."""
    name: str
    span_id: int
    trace_id: int
    parent_id: Optional[int] = None
    start: float = 0.0
    end: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    records: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def duration(self) -> float:
        """Seconds between start and end (0.0 while still open)."""
        return (self.end - self.start) if self.end is not None else 0.0

    def set(self, key: str, value: Any) -> None:
        """Attach/overwrite one attribute."""
        self.attrs[key] = value

    def walk(self) -> Iterator["Span"]:
        """This span, then every descendant, depth-first in start
        order."""
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> List["Span"]:
        """Every span named ``name`` in this subtree."""
        return [s for s in self.walk() if s.name == name]

    def to_dict(self) -> Dict[str, Any]:
        """Flat JSON form (children referenced by ``parent_id``, not
        nested -- the ``spans.jsonl`` row format)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start": self.start, "end": self.end,
                "duration": self.duration, "attrs": dict(self.attrs),
                "records": list(self.records)}


class _NullSpan:
    """Shared no-op stand-in a disabled tracer hands out: supports the
    same surface as ``Span`` where it matters, allocates nothing per
    call."""
    __slots__ = ()
    name = ""
    attrs: Dict[str, Any] = {}
    records: List[Dict[str, Any]] = []
    children: List[Span] = []

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, key: str, value: Any) -> None:
        return None


NULL_SPAN = _NullSpan()


class TraceStore:
    """Ring buffer of finished root spans (one per query).

    ``capacity`` bounds memory for arbitrarily long query streams: when
    full, the oldest trace is dropped.  ``finished_total`` counts every
    root span ever finished, dropped or not.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"TraceStore capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self._ring: Deque[Span] = deque(maxlen=self.capacity)
        self.finished_total = 0

    def add(self, span: Span) -> None:
        self._ring.append(span)
        self.finished_total += 1

    def spans(self) -> List[Span]:
        """Buffered root spans, oldest first."""
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def to_jsonl(self, path: str) -> int:
        """Dump every buffered trace as one flat JSON object per span
        (roots first within each trace, then descendants depth-first).
        Returns the number of span lines written."""
        n = 0
        with open(path, "w") as f:
            for root in self._ring:
                for span in root.walk():
                    f.write(json.dumps(span.to_dict(),
                                       sort_keys=True) + "\n")
                    n += 1
        return n


class _SpanCtx:
    """Context manager binding one live ``Span`` to its tracer's
    stack."""
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, *exc) -> None:
        self._tracer._pop(self._span)


class Tracer:
    """Hands out nesting spans; finished roots land in ``store``.

    Args:
        enabled: a disabled tracer is a no-op (shared ``NULL_SPAN``,
            nothing stored) -- the process-wide default.
        clock: monotonic ``() -> float`` (seconds); defaults to
            ``time.perf_counter``.  Injectable for deterministic tests.
        capacity: ring size of the backing ``TraceStore``.

    Not thread-safe: one tracer serves one query stream (the engines
    execute queries sequentially on the host).
    """

    def __init__(self, enabled: bool = True, clock: Optional[Clock] = None,
                 capacity: int = 256):
        self.enabled = bool(enabled)
        self.clock: Clock = clock or time.perf_counter
        self.store = TraceStore(capacity)
        self._stack: List[Span] = []
        self._next_span_id = 0
        self._next_trace_id = 0

    # ------------------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Open a span as a context manager.  Nested calls build the
        tree; a span opened with no span on the stack becomes a root
        and is stored when it closes."""
        if not self.enabled:
            return NULL_SPAN
        parent = self._stack[-1] if self._stack else None
        self._next_span_id += 1
        if parent is None:
            self._next_trace_id += 1
            trace_id = self._next_trace_id
        else:
            trace_id = parent.trace_id
        sp = Span(name=name, span_id=self._next_span_id, trace_id=trace_id,
                  parent_id=parent.span_id if parent is not None else None,
                  start=self.clock(), attrs=dict(attrs))
        return _SpanCtx(self, sp)

    def _push(self, span: Span) -> None:
        self._stack.append(span)

    def _pop(self, span: Span) -> None:
        span.end = self.clock()
        # tolerate exceptions unwinding through inner spans: pop until
        # (and including) this span so the stack never corrupts
        while self._stack:
            top = self._stack.pop()
            if top is span:
                break
            if top.end is None:
                top.end = span.end
        if span.parent_id is None:
            self.store.add(span)
        else:
            parent = self._stack[-1] if self._stack else None
            if parent is not None and parent.span_id == span.parent_id:
                parent.children.append(span)

    # ------------------------------------------------------------------
    @property
    def current(self) -> Optional[Span]:
        """The innermost open span, or ``None``."""
        return self._stack[-1] if self._stack else None

    def annotate(self, **attrs: Any) -> None:
        """Merge attributes into the innermost open span (no-op when
        disabled or no span is open)."""
        if not self.enabled or not self._stack:
            return
        self._stack[-1].attrs.update(attrs)

    def add_record(self, record: Dict[str, Any]) -> None:
        """Append one structured record (e.g. an SPMD per-join-step
        communication record) to the innermost open span."""
        if not self.enabled or not self._stack:
            return
        self._stack[-1].records.append(record)


# ----------------------------------------------------------------------
# Process-wide default: disabled unless a caller opts in.  Engines bind
# the default at construction, so enable *before* building the Session
# or pass Session(tracer=...).
# ----------------------------------------------------------------------

NULL_TRACER = Tracer(enabled=False, capacity=1)
_default_tracer: Tracer = NULL_TRACER


def get_tracer() -> Tracer:
    """The process-wide default tracer engines bind at construction."""
    return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process default; returns the previous
    one (so tests can restore it)."""
    global _default_tracer
    prev = _default_tracer
    _default_tracer = tracer
    return prev


def enable_tracing(capacity: int = 1024, clock: Optional[Clock] = None
                   ) -> Tracer:
    """Convenience: install and return a fresh enabled default tracer."""
    return_tracer = Tracer(enabled=True, clock=clock, capacity=capacity)
    set_tracer(return_tracer)
    return return_tracer
