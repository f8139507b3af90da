"""Seeded open-loop load generation and the measured capacity model.

Open-loop is the honest way to measure a serving system: arrivals
follow their own schedule (here a seeded Poisson process -- exponential
interarrival gaps) regardless of how fast the system drains, so
overload actually *builds up* instead of the generator politely slowing
down to match the server (the closed-loop coordinated-omission trap).
Under overload the front door must shed, and the shed rate is part of
the measurement, not an error.

The capacity model follows the RFC-003 breaking-point discipline: pick
a measured base rate (what one sequential client achieves), then offer
multiples of it (1x / 4x / 16x) and record, per tier, the achieved
throughput, the p50/p99 admission-to-completion latency, and the shed
rate.  The interesting output is *where* the knee is -- the tier at
which latency and sheds take off -- not a single peak-qps number.

Determinism: the arrival schedule is fully determined by ``seed`` and
the offered rate; wall-clock jitter only shifts when requests are
submitted, never which requests or how many.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .frontdoor import (BreakerOpenError, FrontDoor, QueueFullError,
                        ShedError)


def arrival_offsets(qps: float, duration_s: float, seed: int,
                    ) -> np.ndarray:
    """Poisson arrival schedule: offsets (seconds from start) of every
    arrival in ``[0, duration_s)`` at offered rate ``qps``."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    rng = np.random.default_rng(seed)
    # draw in chunks until the schedule covers the duration
    gaps: List[np.ndarray] = []
    total = 0.0
    chunk = max(16, int(qps * duration_s * 1.25) + 1)
    while total < duration_s:
        g = rng.exponential(1.0 / qps, size=chunk)
        gaps.append(g)
        total += float(g.sum())
    offsets = np.cumsum(np.concatenate(gaps))
    return offsets[offsets < duration_s]


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample (0.0 when
    empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return float(sorted_vals[idx])


@dataclasses.dataclass
class LoadgenReport:
    """Everything one open-loop run measured (one capacity-model
    tier)."""
    offered_qps: float
    duration_s: float
    offered_multiplier: float = 1.0
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    shed_queue_full: int = 0
    shed_breaker: int = 0
    deadline_expired: int = 0
    failed: int = 0
    achieved_qps: float = 0.0
    p50_latency_s: float = 0.0
    p99_latency_s: float = 0.0

    @property
    def shed_rate(self) -> float:
        """Fraction of submitted requests rejected or expired before
        execution."""
        if self.submitted == 0:
            return 0.0
        dropped = (self.shed_queue_full + self.shed_breaker
                   + self.deadline_expired)
        return dropped / self.submitted

    def to_row(self) -> Dict[str, float]:
        """Flat dict for bench emission (``repro.bench/v1`` rows)."""
        return {"offered_multiplier": self.offered_multiplier,
                "offered_qps": round(self.offered_qps, 3),
                "duration_s": round(self.duration_s, 3),
                "submitted": self.submitted,
                "admitted": self.admitted,
                "completed": self.completed,
                "shed_queue_full": self.shed_queue_full,
                "shed_breaker": self.shed_breaker,
                "deadline_expired": self.deadline_expired,
                "failed": self.failed,
                "achieved_qps": round(self.achieved_qps, 3),
                "p50_latency_s": round(self.p50_latency_s, 6),
                "p99_latency_s": round(self.p99_latency_s, 6),
                "shed_rate": round(self.shed_rate, 4)}


def run_open_loop(door: FrontDoor, queries: Sequence[Any], qps: float,
                  duration_s: float, seed: int = 0, *,
                  deadline_s: Optional[float] = None,
                  clock: Callable[[], float] = time.monotonic,
                  sleep: Callable[[float], None] = time.sleep,
                  result_timeout_s: float = 30.0) -> LoadgenReport:
    """Offer ``qps`` of load to a *running* front door (dispatcher
    thread started) for ``duration_s``, round-robining over
    ``queries``, then wait for every admitted request to settle.

    Returns a ``LoadgenReport``; sheds and deadline expiries are
    measurements, not errors.  ``clock``/``sleep`` are injectable for
    tests that fake time.
    """
    if not queries:
        raise ValueError("run_open_loop needs at least one query")
    offsets = arrival_offsets(qps, duration_s, seed)
    report = LoadgenReport(offered_qps=qps, duration_s=duration_s)
    futures = []
    t0 = clock()
    for i, off in enumerate(offsets):
        delay = (t0 + float(off)) - clock()
        if delay > 0:
            sleep(delay)
        report.submitted += 1
        try:
            futures.append(door.submit(queries[i % len(queries)],
                                       deadline_s=deadline_s))
        except QueueFullError:
            report.shed_queue_full += 1
        except BreakerOpenError:
            report.shed_breaker += 1
        except ShedError:                      # future shed subtypes
            report.shed_queue_full += 1
    report.admitted = len(futures)
    # settle every admitted request (the door keeps draining)
    latencies: List[float] = []
    for fut in futures:
        try:
            fut.result(timeout=result_timeout_s)
        except Exception:
            pass
        if fut.outcome == "completed":
            report.completed += 1
            if fut.latency_s is not None:
                latencies.append(fut.latency_s)
        elif fut.outcome == "deadline":
            report.deadline_expired += 1
        else:
            report.failed += 1
    elapsed = max(clock() - t0, 1e-9)
    report.achieved_qps = report.completed / elapsed
    latencies.sort()
    report.p50_latency_s = _percentile(latencies, 0.50)
    report.p99_latency_s = _percentile(latencies, 0.99)
    return report


def measure_capacity(make_door: Callable[[], FrontDoor],
                     queries: Sequence[Any], base_qps: float,
                     multipliers: Sequence[float] = (1.0, 4.0, 16.0),
                     duration_s: float = 1.0, seed: int = 0, *,
                     deadline_s: Optional[float] = None
                     ) -> List[LoadgenReport]:
    """The RFC-003 capacity sweep: offer ``base_qps * m`` for each
    multiplier, a fresh front door per tier (so one tier's backlog and
    breaker history cannot bleed into the next), and return the
    per-tier reports."""
    reports = []
    for i, m in enumerate(multipliers):
        door = make_door()
        door.start()
        try:
            rep = run_open_loop(
                door, queries, base_qps * m, duration_s,
                seed=seed + i, deadline_s=deadline_s)
        finally:
            door.close(drain=False)
        rep.offered_multiplier = float(m)
        reports.append(rep)
    return reports
