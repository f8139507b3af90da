"""The serving front door: admission control, circuit breaking,
deadlines, and shape-keyed micro-batch dispatch over any ``Engine``.

Every backend in this repo is a library call; a service that survives
sustained concurrent load needs the protective layer in front of it
(the RFC-003 breaking-point discipline: know where each tier saturates
and shed *explicitly* there instead of collapsing).  The ``FrontDoor``
owns the request lifecycle:

1. **Admission.**  ``submit`` is the only entry point.  A request is
   rejected immediately -- never silently dropped -- when the bounded
   admission queue is full (``QueueFullError``: queue-depth
   backpressure / load shedding) or the circuit breaker is open
   (``BreakerOpenError``).  Admitted requests get a ``ServeFuture``.
2. **Micro-batching.**  Admitted requests land in the shape-keyed
   ``ShapeBatcher`` (``batcher.py``): same normalized pattern shape =>
   same bucket => one ``execute_many`` dispatch, which the SPMD
   engine's batch override serves from a single match-loop run.
3. **Deadlines.**  Each request carries an absolute deadline (default
   ``FrontDoorConfig.default_deadline_s``).  A request still queued
   when its deadline passes completes exceptionally with
   ``DeadlineExceededError`` and never reaches the engine -- under
   overload, work that can no longer be useful is not executed.
4. **Circuit breaking.**  Every batch dispatch reports an outcome into
   a rolling window.  Too many backend failures open the breaker
   (shed everything instantly, give the backend air); after a cooldown
   it half-opens and admits a bounded number of probe requests; enough
   probe successes close it again, any probe failure re-opens it.
5. **Failure isolation.**  A batch whose ``execute_many`` raises is
   retried per-request, so one poison query fails alone instead of
   taking its whole bucket down with it.

Threading model: clients call ``submit`` from any thread; all engine
execution happens on ONE dispatcher thread (``start``/``close``), so
the engines themselves (and the span tracer) stay single-threaded --
only the metrics registry is touched concurrently, and it is
thread-safe.  Tests drive the same state machine without threads:
construct with ``start=False`` and an injectable fake ``clock``, then
call ``pump()`` / ``drain()`` manually.

On the card the dispatcher thread first makes the engine's card its
current device (``torch.cuda.current_device()`` is per thread: a rank
whose shard lives on ``cuda:2`` must allocate there), then launches the
engine's kernels on its own current CUDA stream, which is the default
stream unless the caller set one inside the engine call.  Over a
``Session`` that leads a process group (``Session.lead()``) every
engine call the door makes is announced to the other ranks from this
thread; a swap must then be a call of the session's
(``request_swap(lambda: session.swap_store(...))``), whose arguments
can be announced.  The kernel libraries build and load at
first use, so warm the engine with direct ``execute`` calls before the
door starts; and read the kernels' launch counters only after
``close()``, since the dispatcher bumps them.  The door only calls the
engine it was given: it never moves work to the CPU or to a kernel's
plain version.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import torch

from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from .batcher import Batch, ShapeBatcher

#: batch-size histogram buckets: powers of two up to a generous cap
BATCH_SIZE_BUCKETS = tuple(float(1 << i) for i in range(11))


class ShedError(RuntimeError):
    """Base of every explicit load-shedding rejection."""


class QueueFullError(ShedError):
    """Admission queue at capacity: request rejected at submit time."""


class BreakerOpenError(ShedError):
    """Circuit breaker open (backend unhealthy): request rejected at
    submit time."""


class DeadlineExceededError(ShedError):
    """The request's deadline passed while it waited in the queue; it
    was dropped before reaching the engine."""


@dataclasses.dataclass
class FrontDoorConfig:
    """Knobs of the serving front door (catalogued in
    ``docs/serving.md``).

    Attributes:
        max_queue: bound on requests admitted but not yet completed
            (queued + in flight).  At the bound, ``submit`` sheds with
            ``QueueFullError``.
        default_deadline_s: per-request deadline when ``submit`` is not
            given one; measured from admission.
        max_batch: micro-batch flush bound -- a shape bucket reaching
            this many requests dispatches immediately.
        max_delay_ms: micro-batch age bound -- a bucket whose oldest
            request has waited this long dispatches even if short.
        breaker_window: rolling window of recent dispatch outcomes the
            breaker trips on.
        breaker_min_events: minimum outcomes in the window before the
            failure ratio is evaluated (no tripping on the first blip).
        breaker_failure_ratio: open when
            ``failures / window_len >= ratio``.
        breaker_cooldown_s: how long the breaker stays open before
            half-opening.
        breaker_probes: requests admitted in half-open state; that many
            consecutive successes close the breaker, any failure
            re-opens it.
    """
    max_queue: int = 256
    default_deadline_s: float = 30.0
    max_batch: int = 16
    max_delay_ms: float = 2.0
    breaker_window: int = 32
    breaker_min_events: int = 8
    breaker_failure_ratio: float = 0.5
    breaker_cooldown_s: float = 1.0
    breaker_probes: int = 2

    def __post_init__(self) -> None:
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if not 0.0 < self.breaker_failure_ratio <= 1.0:
            raise ValueError("breaker_failure_ratio must be in (0, 1], got "
                             f"{self.breaker_failure_ratio}")
        if self.breaker_probes < 1:
            raise ValueError(f"breaker_probes must be >= 1, "
                             f"got {self.breaker_probes}")


# breaker states (also exported as the repro_serve_breaker_state gauge)
BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN = "closed", "half_open", "open"
_BREAKER_GAUGE = {BREAKER_CLOSED: 0.0, BREAKER_HALF_OPEN: 1.0,
                  BREAKER_OPEN: 2.0}


class CircuitBreaker:
    """Rolling-window circuit breaker (closed -> open -> half-open ->
    closed), clock-injected and synchronous -- the front door calls it
    under its own lock.

    Outcomes are per *dispatch* (one engine call), not per request:
    the breaker protects the backend, and the backend is touched once
    per batch.  Because the micro-batcher can collapse several admitted
    probes into ONE dispatch, a successful half-open dispatch must
    credit every probe it carried (``record(..., n=...)``) -- otherwise
    the probe budget drains faster than successes accrue and the
    breaker wedges half-open, shedding forever.  ``refund`` returns the
    slot of an admitted probe that will never produce an outcome
    (shed, or deadline-dropped before dispatch), and as a backstop
    ``allow`` re-opens a half-open breaker whose probes have been out
    for a full cooldown with no resolution, so a leaked slot costs one
    extra cooldown instead of permanent shed.  Sheds and deadline drops
    are load signals, not backend failures, and are never recorded
    here.
    """

    def __init__(self, window: int = 32, min_events: int = 8,
                 failure_ratio: float = 0.5, cooldown_s: float = 1.0,
                 probes: int = 2):
        self.state = BREAKER_CLOSED
        self.min_events = int(min_events)
        self.failure_ratio = float(failure_ratio)
        self.cooldown_s = float(cooldown_s)
        self.probes = int(probes)
        self._outcomes: Deque[bool] = deque(maxlen=int(window))
        self._opened_at = 0.0
        self._half_opened_at = 0.0
        self._probe_budget = 0
        self._probe_successes = 0
        self.opens_total = 0

    def allow(self, now: float) -> bool:
        """May a new request be admitted at time ``now``?  Transitions
        open -> half-open once the cooldown has elapsed; in half-open,
        admits at most ``probes`` requests until their outcomes come
        back."""
        if self.state == BREAKER_CLOSED:
            return True
        if self.state == BREAKER_OPEN:
            if now - self._opened_at < self.cooldown_s:
                return False
            self.state = BREAKER_HALF_OPEN
            self._half_opened_at = now
            self._probe_budget = self.probes
            self._probe_successes = 0
        # half-open: bounded probe admissions
        if self._probe_budget <= 0:
            # stall backstop: if the outstanding probes have produced
            # no resolution for a full cooldown (outcome lost, probe
            # hung), re-open so the next cooldown mints fresh budget
            # instead of shedding forever
            if now - self._half_opened_at >= self.cooldown_s:
                self._trip(now)
            return False
        self._probe_budget -= 1
        return True

    def record(self, ok: bool, now: float, n: int = 1) -> None:
        """Feed one dispatch outcome.  ``n`` is the number of admitted
        probe slots this dispatch resolves (a half-open micro-batch can
        carry several probes in one engine call); every successful
        half-open dispatch credits at least one."""
        if self.state == BREAKER_HALF_OPEN:
            if not ok:
                self._trip(now)
            else:
                self._probe_successes += max(int(n), 1)
                if self._probe_successes >= self.probes:
                    self.state = BREAKER_CLOSED
                    self._outcomes.clear()
            return
        self._outcomes.append(ok)
        if self.state == BREAKER_CLOSED \
                and len(self._outcomes) >= self.min_events:
            failures = sum(1 for o in self._outcomes if not o)
            if failures / len(self._outcomes) >= self.failure_ratio:
                self._trip(now)

    def refund(self, n: int = 1) -> None:
        """Return ``n`` probe slots whose requests were admitted in
        half-open but will never produce a dispatch outcome (shed
        before reaching the engine, or deadline-dropped in queue), so
        later submissions can probe instead of being shed on an
        exhausted budget."""
        if self.state == BREAKER_HALF_OPEN:
            self._probe_budget = min(self._probe_budget + max(int(n), 0),
                                     self.probes)

    def _trip(self, now: float) -> None:
        self.state = BREAKER_OPEN
        self._opened_at = now
        self._outcomes.clear()
        self.opens_total += 1


class ServeFuture:
    """Completion handle for one admitted request.

    ``result(timeout)`` blocks until the request completes and returns
    the ``QueryResult``, or raises the failure
    (``DeadlineExceededError``, or whatever the engine raised).
    ``outcome`` is one of ``"pending"`` / ``"completed"`` /
    ``"deadline"`` / ``"failed"``.
    """
    __slots__ = ("_event", "_result", "_error", "outcome", "latency_s")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self.outcome = "pending"
        self.latency_s: Optional[float] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not completed within timeout")
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result, outcome: str,
                  error: Optional[BaseException] = None,
                  latency_s: Optional[float] = None) -> None:
        self._result = result
        self._error = error
        self.outcome = outcome
        self.latency_s = latency_s
        self._event.set()


@dataclasses.dataclass
class _Request:
    query: Any
    enqueued_at: float
    deadline: float
    future: ServeFuture
    #: admitted against a half-open probe slot; its slot must be either
    #: resolved by a dispatch outcome or refunded if dropped first
    probe: bool = False


class FrontDoor:
    """Production request front door over one backend engine (see the
    module docstring for the lifecycle).

    Args:
        engine: anything speaking the ``Engine`` protocol --
            typically a ``Session`` (``session.serve()`` builds one of
            these), but any backend engine works.
        config: ``FrontDoorConfig`` knobs; default-constructed when
            omitted.
        clock: monotonic ``() -> float``; injectable so unit tests
            drive deadlines, batch-age flushes and breaker cooldowns
            deterministically.  Defaults to the tracer-independent
            ``time.monotonic``.
        registry: ``MetricsRegistry`` for the serve metrics; defaults
            to the engine's registry so the front door and its backend
            export through one surface.
        tracer: span tracer for the admission -> batch -> execute
            chain; defaults to the engine's tracer, so engine query
            spans nest under the front door's ``serve_batch`` spans.
        start: spawn the dispatcher thread immediately.  ``False``
            leaves the door in manual-pump mode (tests, or callers
            embedding it in their own loop).
    """

    def __init__(self, engine, config: Optional[FrontDoorConfig] = None, *,
                 clock=None, registry=None, tracer=None,
                 start: bool = False):
        import time
        self.engine = engine
        self.config = config or FrontDoorConfig()
        self.clock = clock or time.monotonic
        self.tracer = tracer if tracer is not None else getattr(
            engine, "tracer", None) or _obs_trace.get_tracer()
        self.metrics = registry if registry is not None else getattr(
            engine, "metrics", None) or _obs_metrics.get_registry()
        cfg = self.config
        # route-aware bucket keys: requests only batch together when
        # they would execute on the same replica route (a no-op for
        # engines without routing -- route_key is absent or None)
        self.batcher = ShapeBatcher(cfg.max_batch, cfg.max_delay_ms / 1e3,
                                    route_key=getattr(engine, "route_key",
                                                      None))
        self.breaker = CircuitBreaker(
            cfg.breaker_window, cfg.breaker_min_events,
            cfg.breaker_failure_ratio, cfg.breaker_cooldown_s,
            cfg.breaker_probes)
        self._cond = threading.Condition()
        self._inflight = 0
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        # engine cut-over requests (plan lifecycle hot swap): callables
        # the dispatcher runs *between* batch dispatches -- the only
        # point where no engine call is in flight, so a swap never
        # races a running execute_many.  Plain attribute counter, not a
        # serve metric (REQUIRED_SERVE_METRICS is a closed set).
        self._pending_swaps: List[Any] = []
        self.swaps_applied = 0
        # -- telemetry: pre-register every serve series so snapshots
        # expose them before the first request (REQUIRED_SERVE_METRICS)
        self._counters: Dict[str, Any] = {}
        for name in ("admitted", "completed", "failed",
                     "shed_queue_full", "shed_breaker", "deadline_expired",
                     "batches", "batch_fallbacks", "breaker_opens"):
            self._counters[name] = self.metrics.counter(
                f"repro_serve_{name}_total", backend="serve")
        self._g_depth = self.metrics.gauge("repro_serve_queue_depth",
                                           backend="serve")
        self._g_breaker = self.metrics.gauge("repro_serve_breaker_state",
                                             backend="serve")
        self._h_latency = self.metrics.histogram(
            "repro_serve_latency_seconds", backend="serve")
        self._h_wait = self.metrics.histogram(
            "repro_serve_queue_wait_seconds", backend="serve")
        self._h_batch = self.metrics.histogram(
            "repro_serve_batch_size", buckets=BATCH_SIZE_BUCKETS,
            backend="serve")
        if start:
            self.start()

    # -- admission -----------------------------------------------------
    def submit(self, query, deadline_s: Optional[float] = None
               ) -> ServeFuture:
        """Admit one query (or shed it, loudly).

        Args:
            query: a ``QueryGraph``.
            deadline_s: seconds from now this request stays worth
                executing; ``None`` uses the config default.

        Returns:
            A ``ServeFuture`` resolving to the ``QueryResult``.

        Raises:
            QueueFullError: the admission queue is at ``max_queue``.
            BreakerOpenError: the circuit breaker is open.
        """
        now = self.clock()
        with self._cond:
            # capacity first: a queue-full shed must not consume a
            # half-open probe slot (its outcome would never be
            # recorded, wedging the breaker on an empty budget)
            depth = self.batcher.depth + self._inflight
            if depth >= self.config.max_queue:
                self._counters["shed_queue_full"].inc()
                raise QueueFullError(
                    f"admission queue full ({depth}/"
                    f"{self.config.max_queue} requests pending), "
                    f"request shed")
            opens_before = self.breaker.opens_total
            allowed = self.breaker.allow(now)
            if self.breaker.opens_total > opens_before:
                # the half-open stall backstop re-opened the breaker
                self._counters["breaker_opens"].inc()
            if not allowed:
                self._counters["shed_breaker"].inc()
                self._g_breaker.set(_BREAKER_GAUGE[self.breaker.state])
                raise BreakerOpenError(
                    f"circuit breaker {self.breaker.state}: backend "
                    f"marked unhealthy, request shed")
            self._g_breaker.set(_BREAKER_GAUGE[self.breaker.state])
            fut = ServeFuture()
            ttl = (deadline_s if deadline_s is not None
                   else self.config.default_deadline_s)
            self.batcher.add(_Request(
                query, now, now + ttl, fut,
                probe=self.breaker.state == BREAKER_HALF_OPEN))
            self._counters["admitted"].inc()
            self._g_depth.set(self.batcher.depth + self._inflight)
            self._cond.notify()
        return fut

    def execute(self, query, deadline_s: Optional[float] = None,
                timeout: Optional[float] = None):
        """Convenience: ``submit`` + block on the future.  Only useful
        with the dispatcher thread running (``start=True``)."""
        return self.submit(query, deadline_s).result(timeout)

    # -- engine cut-over (plan lifecycle) ------------------------------
    def request_swap(self, fn) -> None:
        """Enqueue an engine cut-over to run on the dispatcher thread
        between batch dispatches (e.g. ``lambda: engine.swap_store(...)``
        or rebinding ``self.engine`` entirely via a callable that
        mutates it).  In-flight requests finish on the old engine
        state; every batch dispatched after the swap is applied runs on
        the new one.  Thread-safe; with a running dispatcher the swap
        applies promptly, in manual-pump mode at the next ``pump()`` /
        ``drain()``."""
        with self._cond:
            self._pending_swaps.append(fn)
            self._cond.notify()

    def _apply_swaps(self) -> None:
        """Run queued cut-overs (dispatcher context only: callers of
        ``pump``/``drain`` own the engine's single thread)."""
        with self._cond:
            swaps, self._pending_swaps = self._pending_swaps, []
        for fn in swaps:
            fn()
            self.swaps_applied += 1

    # -- dispatch ------------------------------------------------------
    def pump(self, now: Optional[float] = None) -> int:
        """Dispatch every batch due at ``now`` (manual-pump mode; the
        dispatcher thread calls the same path).  Returns the number of
        batches executed."""
        self._apply_swaps()
        now = self.clock() if now is None else now
        with self._cond:
            batches = self.batcher.take_ready(now)
            self._inflight += sum(len(b.requests) for b in batches)
            self._g_depth.set(self.batcher.depth + self._inflight)
        for batch in batches:
            self._dispatch(batch)
        return len(batches)

    def drain(self) -> int:
        """Flush and dispatch everything still queued, due or not.
        Returns the number of batches executed."""
        self._apply_swaps()
        with self._cond:
            batches = self.batcher.flush_all()
            self._inflight += sum(len(b.requests) for b in batches)
            self._g_depth.set(self.batcher.depth + self._inflight)
        for batch in batches:
            self._dispatch(batch)
        return len(batches)

    def _dispatch(self, batch: Batch) -> None:
        """Execute one flushed shape bucket: expire stale requests,
        run the rest through the engine as ONE ``execute_many`` call
        under a ``serve_batch`` span, settle futures, feed the
        breaker."""
        now = self.clock()
        live: List[_Request] = []
        dropped_probes = 0
        for r in batch.requests:
            if now >= r.deadline:
                self._counters["deadline_expired"].inc()
                dropped_probes += r.probe
                r.future._complete(
                    None, "deadline",
                    DeadlineExceededError(
                        f"deadline passed after {now - r.enqueued_at:.3f}s "
                        f"in queue; request dropped before execution"))
            else:
                live.append(r)
        if dropped_probes:
            # dropped probes never reach the engine, so their outcomes
            # never resolve their half-open slots: refund them
            with self._cond:
                self.breaker.refund(dropped_probes)
        try:
            if live:
                self._execute_live(live, batch)
        finally:
            with self._cond:
                self._inflight -= len(batch.requests)
                self._g_depth.set(self.batcher.depth + self._inflight)
                self._g_breaker.set(_BREAKER_GAUGE[self.breaker.state])
                self._cond.notify()

    def _execute_live(self, live: List[_Request], batch: Batch) -> None:
        self._counters["batches"].inc()
        self._h_batch.observe(len(live))
        tracer = self.tracer
        queries = [r.query for r in live]
        with tracer.span("serve_batch", backend="serve",
                         batch=len(live), flush=batch.reason,
                         shape_edges=len(live[0].query.normalize().edges)):
            now = self.clock()
            for r in live:
                wait = now - r.enqueued_at
                self._h_wait.observe(wait)
                tracer.add_record({"kind": "admission",
                                   "queue_wait_s": wait})
            n_probes = sum(1 for r in live if r.probe)
            try:
                # one dispatch for the whole same-shape bucket: the
                # SPMD engine's batch override runs the match loop
                # once and reuses its output for every member
                results = self.engine.execute_many(
                    queries, batch_size=len(queries))
            except Exception as exc:
                self._record_outcome(ok=False)
                if len(live) == 1:
                    # retrying an identical single-query execution is
                    # pointless; fail its future with the real error
                    self._counters["failed"].inc()
                    live[0].future._complete(None, "failed", exc)
                    return
                # poison-query isolation: retry per request so one bad
                # query does not fail its whole bucket
                self._counters["batch_fallbacks"].inc()
                tracer.annotate(fallback=True)
                for r in live:
                    self._fail_one(r)
                return
            # a successful dispatch resolves every probe it carried
            # (micro-batching can collapse all of them into this one
            # engine call); any success in half-open counts at least 1
            self._record_outcome(ok=True, probes=n_probes)
            done = self.clock()
            for r, res in zip(live, results):
                self._counters["completed"].inc()
                lat = done - r.enqueued_at
                self._h_latency.observe(lat)
                r.future._complete(res, "completed", latency_s=lat)

    def _fail_one(self, r: _Request) -> None:
        """Per-request fallback execution (after a multi-request batch
        dispatch failed): run it alone; settle its future either way.
        Each fallback run is a real backend dispatch, so it feeds the
        breaker too.  The deadline is re-checked first: the failed
        batch dispatch may have been slow, and work that can no longer
        be useful is not executed."""
        now = self.clock()
        if now >= r.deadline:
            self._counters["deadline_expired"].inc()
            if r.probe:
                with self._cond:
                    self.breaker.refund(1)
            r.future._complete(
                None, "deadline",
                DeadlineExceededError(
                    f"deadline passed after {now - r.enqueued_at:.3f}s "
                    f"(batch dispatch failed slowly); request dropped "
                    f"before fallback execution"))
            return
        try:
            res = self.engine.execute_many([r.query], batch_size=1)[0]
        except Exception as exc:
            self._record_outcome(ok=False)
            self._counters["failed"].inc()
            r.future._complete(None, "failed", exc)
            return
        self._record_outcome(ok=True, probes=1 if r.probe else 0)
        lat = self.clock() - r.enqueued_at
        self._counters["completed"].inc()
        self._h_latency.observe(lat)
        r.future._complete(res, "completed", latency_s=lat)

    def _record_outcome(self, ok: bool, probes: int = 1) -> None:
        with self._cond:
            before = self.breaker.opens_total
            self.breaker.record(ok, self.clock(), n=probes)
            if self.breaker.opens_total > before:
                self._counters["breaker_opens"].inc()
            self._g_breaker.set(_BREAKER_GAUGE[self.breaker.state])

    # -- dispatcher thread ---------------------------------------------
    def start(self) -> "FrontDoor":
        """Spawn the single dispatcher thread (idempotent)."""
        with self._cond:
            if self._thread is not None:
                return self
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, name="repro-serve-dispatcher",
                daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        dev = getattr(self.engine, "device", None)
        # a numbered card (a rank's); a bare "cuda" is the current one
        if isinstance(dev, torch.device) and dev.type == "cuda" \
                and dev.index is not None:
            torch.cuda.set_device(dev)
        while True:
            with self._cond:
                if self._stopping:
                    return
                now = self.clock()
                due = self.batcher.next_due()
                # a pending engine cut-over falls through to pump()
                # even with nothing due -- request_swap's notify woke
                # this thread precisely to apply it
                if not self._pending_swaps:
                    if due is None:
                        self._cond.wait()
                        continue
                    if due > now:
                        self._cond.wait(timeout=due - now)
                        continue
            self.pump()

    def close(self, drain: bool = True) -> None:
        """Stop the dispatcher thread; with ``drain=True`` (default)
        every still-queued request is dispatched first, so no admitted
        future is left pending.  If the dispatcher fails to exit
        (engine call hung), the drain is skipped with a warning: the
        caller draining alongside a live dispatcher would run two
        threads through a single-threaded engine."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=30)
            if thread.is_alive():
                warnings.warn(
                    "front-door dispatcher thread did not exit within "
                    "30s (engine call hung?); skipping drain to keep "
                    "the engine single-threaded -- pending futures stay "
                    "unresolved", RuntimeWarning, stacklevel=2)
                return
            self._thread = None
        if drain:
            self.drain()

    # -- introspection -------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Requests admitted but not yet completed (queued + in
        flight)."""
        with self._cond:
            return self.batcher.depth + self._inflight

    @property
    def breaker_state(self) -> str:
        return self.breaker.state

    def stats(self) -> Dict[str, float]:
        """Front-door counters as a plain dict (the exported metric
        names without the ``repro_serve_`` / ``_total`` affixes)."""
        out = {name: c.value for name, c in self._counters.items()}
        out["queue_depth"] = float(self.queue_depth)
        out["breaker_state"] = _BREAKER_GAUGE[self.breaker.state]
        return out

    def __enter__(self) -> "FrontDoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
