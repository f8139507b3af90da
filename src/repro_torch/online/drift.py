"""Workload drift detection: is the live query stream still the one the
current fragmentation was designed for?

Two complementary signals, both cheap against the monitor's decayed
state:

* **total-variation distance** between the live edge-level property
  distribution and the distribution at design time -- catches popularity
  shifts between structural classes (star-heavy vs chain-heavy phases
  touch different property mixes);
* **coverage loss**: the paper's Benefit (Def. 8/9) gives each query the
  single largest selected FAP embedded in it; live coverage is the
  decayed-mass-weighted mean of ``max_p |E(p)| / |E(Q)|`` over the
  monitor's shape table.  When newly-hot shapes have no large selected
  pattern, coverage drops below its design-time value and queries
  decompose into many subqueries -> cross-site joins -> shipped bytes.

The detector fires when either signal crosses its threshold, after a
warm-up mass so a handful of queries cannot trigger a re-partition.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core.query import QueryGraph, is_subgraph_of
from .monitor import WorkloadMonitor


@dataclasses.dataclass
class DriftReport:
    tv_distance: float
    coverage: float          # live weighted mean coverage in [0, 1]
    ref_coverage: float      # coverage at design time
    fired: bool
    reason: str              # "", "tv", "coverage", or "tv+coverage"
    effective_weight: float  # decayed query mass behind the decision

    def to_metrics(self) -> dict:
        """Gauge-ready view of the report (``repro_epoch_*`` names are
        prefixed by the adaptive loop; see ``docs/observability.md``)."""
        return {"tv_distance": self.tv_distance,
                "coverage": self.coverage,
                "coverage_loss": self.ref_coverage - self.coverage,
                "effective_weight": self.effective_weight}


def pattern_coverage(shapes: Sequence[QueryGraph], weights: np.ndarray,
                     patterns: Sequence[QueryGraph]) -> float:
    """Weighted mean of max_p |E(p)|/|E(Q)| over query shapes -- the
    normalized Benefit of the selected FAP set on this distribution."""
    if len(shapes) == 0 or len(patterns) == 0:
        return 0.0
    by_size = sorted(patterns, key=lambda p: -p.num_edges)
    num = 0.0
    den = 0.0
    for q, w in zip(shapes, weights):
        best = 0
        for p in by_size:
            if p.num_edges <= best:
                break               # sorted: no larger match possible
            if p.num_edges <= q.num_edges and is_subgraph_of(p, q):
                best = p.num_edges
        num += float(w) * best / max(q.num_edges, 1)
        den += float(w)
    return num / max(den, 1e-12)


class DriftDetector:
    """Compares the monitor's live distribution against the design-time
    reference and fires a re-partition trigger."""

    def __init__(self, tv_threshold: float = 0.15,
                 coverage_drop_threshold: float = 0.10,
                 min_effective_weight: float = 50.0):
        self.tv_threshold = tv_threshold
        self.coverage_drop_threshold = coverage_drop_threshold
        self.min_effective_weight = min_effective_weight
        self.ref_prop_dist: Optional[np.ndarray] = None
        self.ref_patterns: List[QueryGraph] = []
        self.ref_coverage: float = 1.0

    # ------------------------------------------------------------------
    def set_reference(self, monitor: WorkloadMonitor,
                      selected_patterns: Sequence[QueryGraph]) -> None:
        """Anchor the reference at the distribution the *current*
        fragmentation was mined from (call right after (re)partitioning)."""
        self.ref_prop_dist = monitor.property_distribution().copy()
        self.ref_patterns = list(selected_patterns)
        uniq, w = monitor.snapshot()
        self.ref_coverage = pattern_coverage(uniq, w, self.ref_patterns)

    # ------------------------------------------------------------------
    def check(self, monitor: WorkloadMonitor) -> DriftReport:
        if self.ref_prop_dist is None:
            raise RuntimeError("set_reference() before check()")
        live = monitor.property_distribution()
        n = max(len(live), len(self.ref_prop_dist))
        a = np.zeros(n)
        a[:len(live)] = live
        b = np.zeros(n)
        b[:len(self.ref_prop_dist)] = self.ref_prop_dist
        tv = 0.5 * float(np.abs(a - b).sum())

        uniq, w = monitor.snapshot()
        cov = pattern_coverage(uniq, w, self.ref_patterns)

        eff = monitor.effective_weight()
        warm = eff >= self.min_effective_weight
        reasons = []
        if warm and tv > self.tv_threshold:
            reasons.append("tv")
        if warm and (self.ref_coverage - cov) > self.coverage_drop_threshold:
            reasons.append("coverage")
        return DriftReport(tv, cov, self.ref_coverage, bool(reasons),
                           "+".join(reasons), eff)
