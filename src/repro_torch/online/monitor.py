"""Streaming workload monitor: exponentially-decayed query-shape and
property frequency statistics, O(1) per executed query.

Design (AdPart-style incremental monitoring, arXiv:1505.02728):

* every executed ``QueryGraph`` is normalized and folded into a bounded
  *shape table* keyed by canonical DFS code, holding a decayed mass per
  shape.  The table is the live analogue of ``Workload.dedup_normalized``
  -- real logs collapse onto a few hundred shapes (97% of DBpedia onto
  163), so a small capacity captures essentially all mass;
* overflow shapes spill into a count-min sketch, so a shape that later
  turns hot is re-admitted with (a conservative overestimate of) the mass
  it accumulated while evicted -- classic SpaceSaving + CM hybrid;
* decayed per-property masses (edge-level for drift detection,
  query-incidence for the Def. 5 hot/cold split) ride along as dense
  vectors;
* a bounded reservoir sample of *raw* queries (constants intact) feeds
  horizontal re-fragmentation's minterm predicate mining (§5.2).

Decay uses the scaled-accumulator trick: a global ``_scale`` multiplies
into every stored mass, so one float update decays the entire state;
masses renormalize in O(capacity) only when the scale risks overflow
(amortized O(1)).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Tuple

import numpy as np

from ..core.query import QueryGraph
from ..core.workload import Workload


def sketch_key(code: Tuple, seed: int = 0) -> int:
    """Stable int64 sketch key for a canonical DFS code.

    Seeded blake2b (the same construction ``core.routing`` uses for
    rendezvous hashing) -- NOT Python's ``hash()``, which is salted per
    process (PYTHONHASHSEED): monitor state serialized by the plan
    lifecycle layer must round-trip across restarts, and a salted key
    would silently lose every evicted shape's sketch mass on
    re-admission in the new process.
    """
    digest = hashlib.blake2b(f"{seed}|{code!r}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big", signed=True)


class CountMinSketch:
    """Conservative-update count-min sketch over int64 keys."""

    def __init__(self, width: int = 512, depth: int = 4, seed: int = 0):
        self.width = width
        self.depth = depth
        self.table = np.zeros((depth, width), dtype=np.float64)
        rng = np.random.default_rng(seed)
        # odd multipliers for multiply-shift hashing
        self._a = rng.integers(1, 2**61, size=depth, dtype=np.int64) | 1

    def _slots(self, key: int) -> np.ndarray:
        h = (self._a * np.int64(key)) % np.int64(2**61 - 1)
        return (h % self.width).astype(np.int64)

    def add(self, key: int, amount: float) -> None:
        rows = np.arange(self.depth)
        slots = self._slots(key)
        cur = self.table[rows, slots]
        # conservative update: only raise cells below the new estimate
        est = cur.min() + amount
        self.table[rows, slots] = np.maximum(cur, est)

    def estimate(self, key: int) -> float:
        return float(self.table[np.arange(self.depth),
                                self._slots(key)].min())

    def scale(self, factor: float) -> None:
        self.table *= factor


@dataclasses.dataclass
class _ShapeStat:
    rep: QueryGraph       # normalized representative
    mass: float           # decayed multiplicity (in scaled units)
    sketch_base: float    # portion of mass inherited from the sketch at
                          # admission; on evict only mass - sketch_base is
                          # spilled (the sketch already holds the base, so
                          # re-spilling it would compound every cycle)


class WorkloadMonitor:
    """Folds executed queries into decayed workload statistics."""

    def __init__(self, num_properties: int, decay: float = 0.995,
                 capacity: int = 512, reservoir_size: int = 512,
                 sketch_width: int = 512, seed: int = 0):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay = decay
        self.capacity = capacity
        self.num_properties = num_properties
        self.shapes: Dict[Tuple, _ShapeStat] = {}
        self.sketch = CountMinSketch(width=sketch_width, seed=seed)
        # dense decayed property masses (scaled units)
        self.edge_prop_mass = np.zeros(num_properties, dtype=np.float64)
        self.query_prop_mass = np.zeros(num_properties, dtype=np.float64)
        self.total_mass = 0.0          # decayed query count (scaled units)
        self.queries_seen = 0          # raw count, undecayed
        # decayed per-site heat (scaled units), fed from each executed
        # query's ``ExecStats.sites_touched`` -- with routed SPMD
        # execution only the route's members heat up, so the gauges
        # separate genuinely hot sites from mesh-wide broadcast noise.
        # Keyed (not dense): the site count is a plan property the
        # monitor does not need to know up front.
        self.site_mass: Dict[int, float] = {}
        # reservoir sample of raw queries for predicate mining
        self.reservoir_size = reservoir_size
        self.reservoir: List[QueryGraph] = []
        self._rng = np.random.default_rng(seed + 1)
        self._scale = 1.0              # stored * ... actually: unit weight
        self._unit = 1.0               # weight of the *next* observation

    # ------------------------------------------------------------------
    def observe(self, query: QueryGraph, sites=None) -> None:
        """Fold one executed query in.  O(|query| + depth) = O(1).

        ``sites`` (optional iterable of site ids, e.g.
        ``ExecStats.sites_touched``) additionally heats the per-site
        gauges -- see ``site_heat`` / ``hot_sites``."""
        self.queries_seen += 1
        # decay everyone by bumping the unit weight of new arrivals
        self._unit /= self.decay
        u = self._unit
        norm = query.normalize()
        code = norm.canonical_code()
        stat = self.shapes.get(code)
        if stat is not None:
            stat.mass += u
        else:
            # re-admit with whatever mass the sketch remembers (0 if new)
            base = self.sketch.estimate(sketch_key(code))
            self.shapes[code] = _ShapeStat(norm, base + u, base)
            if len(self.shapes) > self.capacity:
                self._evict()
        for p in norm.properties():
            if 0 <= p < self.num_properties:
                self.edge_prop_mass[p] += u
        for p in set(norm.properties()):
            if 0 <= p < self.num_properties:
                self.query_prop_mass[p] += u
        if sites is not None:
            for j in sites:
                j = int(j)
                self.site_mass[j] = self.site_mass.get(j, 0.0) + u
        self.total_mass += u
        self._reservoir_add(query)
        if self._unit > 1e12:
            self._renormalize()

    def bulk_load(self, workload: Workload) -> None:
        """Seed the monitor from an offline workload (build time)."""
        for q in workload.queries:
            self.observe(q)

    # ------------------------------------------------------------------
    def _evict(self) -> None:
        code, stat = min(self.shapes.items(), key=lambda kv: kv[1].mass)
        self.sketch.add(sketch_key(code),
                        max(stat.mass - stat.sketch_base, 0.0))
        del self.shapes[code]

    def _reservoir_add(self, query: QueryGraph) -> None:
        if len(self.reservoir) < self.reservoir_size:
            self.reservoir.append(query)
        else:
            # exponentially-biased reservoir: overwrite a random slot with
            # probability reservoir_size/queries_seen would be uniform; we
            # want recency bias to track drift, so use a fixed probability
            j = int(self._rng.integers(0, self.reservoir_size * 4))
            if j < self.reservoir_size:
                self.reservoir[j] = query

    def _renormalize(self) -> None:
        inv = 1.0 / self._unit
        for stat in self.shapes.values():
            stat.mass *= inv
            stat.sketch_base *= inv
        self.sketch.scale(inv)
        self.edge_prop_mass *= inv
        self.query_prop_mass *= inv
        for j in self.site_mass:
            self.site_mass[j] *= inv
        self.total_mass *= inv
        self._unit = 1.0

    # ------------------------------------------------------------------
    # snapshots for drift detection / re-fragmentation
    # ------------------------------------------------------------------
    def property_distribution(self) -> np.ndarray:
        """Decayed edge-level property distribution (sums to 1)."""
        tot = self.edge_prop_mass.sum()
        if tot <= 0:
            return np.zeros_like(self.edge_prop_mass)
        return self.edge_prop_mass / tot

    def effective_weight(self) -> float:
        """Decayed total query mass in current-time units."""
        return self.total_mass / self._unit

    def snapshot(self, min_mass_fraction: float = 1e-4
                 ) -> Tuple[List[QueryGraph], np.ndarray]:
        """Deduped (shapes, weights) in the format mining consumes.

        Weights are decayed masses rounded to ints (mining's support
        arithmetic is integral); shapes below ``min_mass_fraction`` of
        the total are dropped as noise.
        """
        items = sorted(self.shapes.items(), key=lambda kv: -kv[1].mass)
        floor = self.total_mass * min_mass_fraction
        uniq: List[QueryGraph] = []
        weights: List[int] = []
        for _, stat in items:
            if stat.mass < floor:
                continue
            w = max(int(round(stat.mass / self._unit)), 1)
            uniq.append(stat.rep)
            weights.append(w)
        return uniq, np.asarray(weights, dtype=np.int64)

    def hot_properties(self, theta_fraction: float) -> List[int]:
        """Live Def. 5: properties in >= theta_fraction of decayed query
        mass."""
        theta = max(self.total_mass * theta_fraction, 1e-12)
        return sorted(int(p) for p in
                      np.nonzero(self.query_prop_mass >= theta)[0])

    def site_heat(self) -> Dict[int, float]:
        """Decayed per-site load shares (sum to 1 over the observed
        sites; empty before any ``observe(..., sites=...)``).  A
        routed query heats only its route members, so the shares are
        the live analogue of the §6 allocation's balance objective."""
        tot = sum(self.site_mass.values())
        if tot <= 0:
            return {}
        return {j: m / tot for j, m in sorted(self.site_mass.items())}

    def hot_sites(self, factor: float = 2.0) -> List[int]:
        """Sites whose decayed load share exceeds ``factor`` times the
        fair share (1 / #observed sites) -- the AdPart-style trigger
        for flagging shards to split or rebalance."""
        heat = self.site_heat()
        if not heat:
            return []
        fair = 1.0 / len(heat)
        return sorted(j for j, h in heat.items() if h > factor * fair)

    def raw_sample(self) -> Workload:
        """Recency-biased raw-query sample (constants intact) for §5.2
        minterm predicate mining during re-fragmentation."""
        return Workload(list(self.reservoir))

    # ------------------------------------------------------------------
    # state round-trip (plan lifecycle layer: the monitor restarts with
    # the serving process, not from scratch)
    # ------------------------------------------------------------------
    def state(self) -> Dict[str, np.ndarray]:
        """Checkpoint-friendly snapshot: flat numpy arrays only, so it
        rides ``repro_torch.checkpoint`` as one more pytree.  Everything the
        decayed statistics need round-trips -- shape table, sketch
        (table + multipliers; keys are the stable ``sketch_key``
        digests, so a restored process re-admits evicted-shape mass),
        property/site masses, reservoir, and the decay unit.  The
        reservoir-replacement RNG restarts fresh (sampling noise, not
        state)."""
        from ..core.plan import encode_queries
        items = list(self.shapes.items())
        site_ids = np.asarray(sorted(self.site_mass), np.int64)
        return {
            "meta": np.asarray(
                [self.decay, float(self.capacity),
                 float(self.num_properties), float(self.reservoir_size),
                 self.total_mass, float(self.queries_seen), self._unit,
                 float(self.sketch.depth)], np.float64),
            "shape_reps": encode_queries([st.rep for _, st in items]),
            "shape_mass": np.asarray([st.mass for _, st in items],
                                     np.float64),
            "shape_base": np.asarray([st.sketch_base for _, st in items],
                                     np.float64),
            "sketch_table": np.asarray(self.sketch.table, np.float64),
            "sketch_a": np.asarray(self.sketch._a, np.int64),
            "edge_prop_mass": np.asarray(self.edge_prop_mass, np.float64),
            "query_prop_mass": np.asarray(self.query_prop_mass, np.float64),
            "site_ids": site_ids,
            "site_mass": np.asarray(
                [self.site_mass[int(j)] for j in site_ids], np.float64),
            "reservoir": encode_queries(self.reservoir),
        }

    @classmethod
    def from_state(cls, arrays: Dict[str, np.ndarray]) -> "WorkloadMonitor":
        """Rebuild a monitor from ``state()`` output (possibly in a
        different process: sketch keys are process-stable digests, so
        evicted-shape mass survives the restart)."""
        from ..core.plan import decode_queries
        meta = np.asarray(arrays["meta"], np.float64)
        table = np.asarray(arrays["sketch_table"], np.float64)
        m = cls(num_properties=int(meta[2]), decay=float(meta[0]),
                capacity=int(meta[1]), reservoir_size=int(meta[3]),
                sketch_width=int(table.shape[1]))
        m.sketch.depth = int(meta[7])
        m.sketch.table = table.copy()
        m.sketch._a = np.asarray(arrays["sketch_a"], np.int64).copy()
        reps = decode_queries(np.asarray(arrays["shape_reps"], np.int64))
        mass = np.asarray(arrays["shape_mass"], np.float64)
        base = np.asarray(arrays["shape_base"], np.float64)
        m.shapes = {rep.canonical_code(): _ShapeStat(rep, float(mv),
                                                     float(bv))
                    for rep, mv, bv in zip(reps, mass, base)}
        m.edge_prop_mass = np.asarray(arrays["edge_prop_mass"],
                                      np.float64).copy()
        m.query_prop_mass = np.asarray(arrays["query_prop_mass"],
                                       np.float64).copy()
        m.site_mass = {int(j): float(v)
                       for j, v in zip(arrays["site_ids"],
                                       arrays["site_mass"])}
        m.reservoir = decode_queries(np.asarray(arrays["reservoir"],
                                                np.int64))
        m.total_mass = float(meta[4])
        m.queries_seen = int(meta[5])
        m._unit = float(meta[6])
        return m
