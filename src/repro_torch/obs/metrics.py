"""Process-wide metrics: counters, gauges, fixed-bucket histograms.

The aggregate half of the telemetry layer (traces are the per-query
half, ``repro_torch.obs.trace``).  Every engine feeds the registry through
``EngineBase``: ``_bump`` mirrors each named backend counter into a
``Counter`` (``repro_<name>_total``), and ``_finish`` observes the
per-query latency histogram and refreshes the derived ``_stats_extra``
gauges -- so every key of ``stats().extra`` is also a named,
exportable metric (catalogue: ``docs/observability.md``).

Design points:

* **Fixed-bucket histograms.**  ``Histogram`` keeps one count per
  configured upper bound (plus +Inf), a running sum and total count --
  p50/p90/p99 are *derived* from the bucket counts (linear
  interpolation inside the crossing bucket, Prometheus-style), so the
  memory cost is constant regardless of how many observations stream
  through, and two histograms with the same buckets ``merge`` exactly
  (across engines or processes).
* **Labels.**  Metrics are keyed by (name, sorted label items); the
  same name with different labels (``backend="spmd"`` vs ``"serve"``)
  is a family of independent series, rendered as such by the
  Prometheus exposition in ``repro_torch.obs.export``.
* **Gauge timelines.**  ``Gauge.set`` keeps the last value and a
  bounded change-history ``(seq, value)`` so slow-moving series (the
  store generation, the compiled-shape count) form a queryable
  timeline without unbounded growth.

The default registry is process-wide (``get_registry``) so several
engines aggregate into one exportable surface; tests install a fresh
one via ``set_registry``.

Thread safety: the serving front door (``repro_torch.serve``) updates these
series from its dispatcher thread while client threads submit and
exporters scrape, so every mutation (``inc`` / ``set`` / ``observe`` /
registry ``_get``/``merge``/``reset``) and every multi-field read
(``collect``, ``percentile``) takes the instance's lock.  The locks are
per-metric, so unrelated hot series never contend.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import threading
from collections import deque
from typing import (Any, Deque, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

LabelItems = Tuple[Tuple[str, str], ...]

# Default latency buckets (seconds): log-ish spacing from 10us to 10s
# (the JAX package's, so histograms of the two packages merge).
LATENCY_BUCKETS_SEC: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Default byte-size buckets: powers of 4 from 64B to ~1GB.
BYTES_BUCKETS: Tuple[float, ...] = tuple(64.0 * 4 ** i for i in range(13))


def _label_items(labels: Dict[str, Any]) -> LabelItems:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count (``inc``).  Thread-safe: ``+=``
    on a Python float is a read-modify-write that loses increments
    under concurrency, so it runs under the instance lock."""
    kind = "counter"
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def merge(self, other: "Counter") -> None:
        with self._lock:
            self.value += other.value


class Gauge:
    """Last-value metric with a bounded change timeline.

    ``set`` records ``(seq, value)`` into ``history`` only when the
    value changed, so per-query refreshes of a slow-moving series (an
    epoch counter, a drift distance) cost nothing between changes and
    the timeline stays readable.
    """
    kind = "gauge"
    __slots__ = ("value", "history", "_seq", "_lock")

    def __init__(self, history_len: int = 512) -> None:
        self.value = 0.0
        self.history: Deque[Tuple[int, float]] = deque(maxlen=history_len)
        self._seq = 0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._seq += 1
            if not self.history or self.history[-1][1] != value:
                self.history.append((self._seq, value))
            self.value = value

    def merge(self, other: "Gauge") -> None:
        # last writer wins; timelines are per-process and not merged
        with self._lock:
            self.value = other.value


class Histogram:
    """Fixed-bucket histogram: constant memory, derivable percentiles,
    exact merge across instances with identical buckets.

    ``buckets`` are the finite upper bounds (ascending); an implicit
    +Inf bucket catches the rest.  ``counts[i]`` is the number of
    observations ``v <= buckets[i]`` that fell in bucket ``i``
    (non-cumulative; the Prometheus renderer accumulates).
    """
    kind = "histogram"
    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS_SEC):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram buckets must be non-empty and "
                             f"strictly ascending, got {b}")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)          # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) from the bucket counts.

        Prometheus-style: rank ``q * count`` is located in the first
        bucket whose cumulative count reaches it, then linearly
        interpolated between the bucket's lower and upper bound.  An
        empty histogram returns 0.0; ranks landing in the +Inf bucket
        return the largest finite bound (the honest answer under
        fixed buckets: "at least this much").
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:               # consistent (counts, count) view
            counts, count = list(self.counts), self.count
        if count == 0:
            return 0.0
        rank = q * count
        cum = 0
        for i, c in enumerate(counts[:-1]):
            prev = cum
            cum += c
            if cum >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                if c == 0:
                    return hi
                frac = (rank - prev) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.buckets[-1]

    def merge(self, other: "Histogram") -> None:
        if other.buckets != self.buckets:
            raise ValueError("cannot merge histograms with different "
                             f"buckets: {self.buckets} vs {other.buckets}")
        with other._lock:              # consistent source view
            counts, osum, ocount = list(other.counts), other.sum, other.count
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.sum += osum
            self.count += ocount


Metric = Any  # Counter | Gauge | Histogram


class MetricsRegistry:
    """Name+labels -> metric instance; the process-wide aggregation
    surface the exporters (``repro_torch.obs.export``) read."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelItems], Metric] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _get(self, name: str, labels: Dict[str, Any], factory) -> Metric:
        key = (name, _label_items(labels))
        # check-then-insert must be atomic, or two threads racing on a
        # new series each get their own instance and one side's
        # increments silently vanish
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        """Fetch-or-create the counter ``name{labels}``."""
        m = self._get(name, labels, Counter)
        if not isinstance(m, Counter):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}")
        return m

    def gauge(self, name: str, **labels: Any) -> Gauge:
        """Fetch-or-create the gauge ``name{labels}``."""
        m = self._get(name, labels, Gauge)
        if not isinstance(m, Gauge):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}")
        return m

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_SEC,
                  **labels: Any) -> Histogram:
        """Fetch-or-create the histogram ``name{labels}``.  ``buckets``
        only applies on first creation; a later fetch with different
        buckets raises (series would stop merging)."""
        m = self._get(name, labels, lambda: Histogram(buckets))
        if not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}")
        if tuple(float(b) for b in buckets) != m.buckets \
                and buckets is not LATENCY_BUCKETS_SEC:
            raise ValueError(f"histogram {name!r} exists with buckets "
                             f"{m.buckets}; refusing silent rebucket")
        return m

    # ------------------------------------------------------------------
    def collect(self) -> Iterator[Tuple[str, LabelItems, Metric]]:
        """Every (name, labels, metric), sorted by name then labels
        (iterates a stable key snapshot, so concurrent registration
        cannot invalidate the walk)."""
        with self._lock:
            keys = sorted(self._metrics)
        for (name, labels) in keys:
            yield name, labels, self._metrics[(name, labels)]

    def names(self) -> List[str]:
        """Distinct metric names (label sets collapsed)."""
        with self._lock:
            return sorted({name for name, _ in self._metrics})

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other`` into this registry (same-typed series merge;
        new series are adopted by reference-free copy)."""
        for name, labels, m in other.collect():
            if m.kind == "counter":
                self.counter(name, **dict(labels)).merge(m)
            elif m.kind == "gauge":
                self.gauge(name, **dict(labels)).merge(m)
            else:
                self.histogram(name, buckets=m.buckets,
                               **dict(labels)).merge(m)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)


# ----------------------------------------------------------------------
# Process-wide default registry
# ----------------------------------------------------------------------

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry engines bind at
    construction."""
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Install ``registry`` as the process default; returns the
    previous one (so tests can restore it)."""
    global _default_registry
    prev = _default_registry
    _default_registry = registry
    return prev
