"""Baseline fragmentation strategies re-implemented for comparison (§8.1):

* SHAPE [14]: semantic hash partitioning -- subject-object-based triple
  groups.  Each vertex's group = its incident edges; groups land on the
  site of hash(center vertex).  Every edge lands in two groups (subject's
  and object's), giving SHAPE its ~2-3x redundancy (Table 1).  Star
  queries are answerable locally at every site; anything else does
  cross-site joins, and every query touches all sites.

* WARP [8]: min-cut partitioning (METIS in the paper; here an iterative
  label-propagation/greedy-refinement stand-in -- METIS is not available
  offline) + replication of workload-pattern matches that cross parts, so
  FAP-shaped queries run locally per site.  Still touches all sites.

``BaselineEngine`` is the §8 baseline simulator: it matches and joins
in numpy on the host, as the reference's does, and keeps its byte and
cost-model ledger there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .engine import EngineBase
from .executor import (CostModel, ExecStats, QueryResult, _dedup_rows,
                       _nrows, join_bindings)
from .graph import RDFGraph
from .matching import _PropIndex, match_edge_ids, match_pattern
from .query import QueryGraph
from .workload import Workload


# ----------------------------------------------------------------------
# Graph partitioning stand-in for METIS: greedy label propagation with
# balance constraint, then edge assignment by subject part.
# ----------------------------------------------------------------------

def label_propagation_partition(graph: RDFGraph, num_parts: int,
                                rounds: int = 5, seed: int = 0) -> np.ndarray:
    """vertex -> part, approximately balanced, low edge cut."""
    rng = np.random.default_rng(seed)
    part = rng.integers(0, num_parts, size=graph.num_vertices).astype(np.int64)
    cap = int(np.ceil(graph.num_vertices / num_parts * 1.1))
    for _ in range(rounds):
        # count neighbor parts per vertex via bincount over edges
        votes = np.zeros((graph.num_vertices, num_parts), dtype=np.int32)
        np.add.at(votes, (graph.s, part[graph.o]), 1)
        np.add.at(votes, (graph.o, part[graph.s]), 1)
        new = votes.argmax(axis=1)
        has_n = votes.max(axis=1) > 0
        cand = np.where(has_n, new, part)
        # apply moves while respecting capacity (greedy, random order)
        counts = np.bincount(part, minlength=num_parts)
        order = rng.permutation(graph.num_vertices)
        for v in order:
            t = cand[v]
            f = part[v]
            if t != f and counts[t] < cap:
                counts[f] -= 1
                counts[t] += 1
                part[v] = t
    return part


def edge_cut(graph: RDFGraph, part: np.ndarray) -> int:
    return int((part[graph.s] != part[graph.o]).sum())


# ----------------------------------------------------------------------
# SHAPE
# ----------------------------------------------------------------------

@dataclasses.dataclass
class BaselineFragmentation:
    site_edges: List[np.ndarray]     # edge ids per site
    name: str

    def redundancy_ratio(self, graph: RDFGraph) -> float:
        return sum(len(e) for e in self.site_edges) / max(graph.num_edges, 1)


def shape_fragmentation(graph: RDFGraph, num_sites: int) -> BaselineFragmentation:
    """Subject-object-based triple groups, hashed by center vertex."""
    site_sets: List[List[np.ndarray]] = [[] for _ in range(num_sites)]
    eids = np.arange(graph.num_edges, dtype=np.int64)
    # subject-centered groups
    s_site = graph.s.astype(np.int64) % num_sites
    o_site = graph.o.astype(np.int64) % num_sites
    for j in range(num_sites):
        own = eids[(s_site == j) | (o_site == j)]
        site_sets[j].append(own)
    site_edges = [np.unique(np.concatenate(g)) for g in site_sets]
    return BaselineFragmentation(site_edges, "SHAPE")


def warp_fragmentation(graph: RDFGraph, num_sites: int,
                       patterns: Sequence[QueryGraph],
                       seed: int = 0) -> Tuple[BaselineFragmentation, np.ndarray]:
    """Min-cut parts + replication of pattern matches that cross parts."""
    part = label_propagation_partition(graph, num_sites, seed=seed)
    base = [np.nonzero(part[graph.s] == j)[0].astype(np.int64)
            for j in range(num_sites)]
    extra: List[List[np.ndarray]] = [[] for _ in range(num_sites)]
    idx = _PropIndex(graph)
    for pat in patterns:
        if pat.num_edges < 2:
            continue
        res = match_pattern(graph, pat, index=idx, max_rows=1_000_000)
        if res.num_rows == 0:
            continue
        rows = res.rows()                      # (n, vars)
        home = part[rows[:, 0].astype(np.int64)]
        # matches whose vertices straddle parts -> replicate into home part
        straddle = np.zeros(res.num_rows, dtype=bool)
        for c in range(rows.shape[1]):
            straddle |= part[rows[:, c].astype(np.int64)] != home
        if not straddle.any():
            continue
        sub = type(res)({v: col[straddle] for v, col in res.columns.items()},
                        int(straddle.sum()))
        eids = match_edge_ids(graph, pat, result=sub, index=idx)
        home_sub = home[straddle]
        # assign replicated edges to the home of each match: recompute per
        # match edges cheaply by re-deriving triples per pattern edge
        for j in range(num_sites):
            m = home_sub == j
            if not m.any():
                continue
            sel = type(res)({v: col[straddle][m] for v, col in res.columns.items()},
                            int(m.sum()))
            ej = match_edge_ids(graph, pat, result=sel, index=idx)
            extra[j].append(ej)
    site_edges = []
    for j in range(num_sites):
        parts = [base[j]] + extra[j]
        site_edges.append(np.unique(np.concatenate(parts)))
    return BaselineFragmentation(site_edges, "WARP"), part


# ----------------------------------------------------------------------
# Baseline execution engine (shared by SHAPE and WARP)
# ----------------------------------------------------------------------

def _star_decomposition(query: QueryGraph) -> List[List[int]]:
    """Greedy rooted-star edge partition (SHAPE's local unit)."""
    edges = list(query.edges)
    remaining = set(range(len(edges)))
    stars: List[List[int]] = []
    while remaining:
        # pick the vertex covering most remaining edges as a star center
        deg: Dict[int, int] = {}
        for i in remaining:
            deg[edges[i].src] = deg.get(edges[i].src, 0) + 1
        center = max(deg, key=lambda v: deg[v])
        grp = [i for i in remaining if edges[i].src == center]
        if not grp:  # fall back: single edge
            grp = [next(iter(remaining))]
        stars.append(grp)
        remaining -= set(grp)
    return stars


class BaselineEngine(EngineBase):
    """SHAPE/WARP-style engine: every query touches all sites; local
    matching per site; cross-site joins between local units.

    The local-unit granularity depends on what the fragmentation
    guarantees: SHAPE co-locates every edge incident to a vertex, and
    WARP's base partition assigns edges by subject part, so both answer
    subject-rooted *stars* locally.  An arbitrary (plan-derived)
    fragmentation only guarantees edge coverage, so any other
    ``frag.name`` falls back to edge-at-a-time units -- exact over any
    covering site assignment.  It computes in numpy on the host, as the
    reference's does (the §8 baseline simulator)."""

    trace_name = "baseline"

    def __init__(self, graph: RDFGraph, frag: BaselineFragmentation,
                 local_patterns: Optional[Sequence[QueryGraph]] = None,
                 cost: Optional[CostModel] = None):
        self._init_engine_base()
        self.graph = graph
        self.frag = frag
        self.cost = cost or CostModel()
        self.local_patterns = {p.normalize().canonical_code()
                               for p in (local_patterns or [])}
        self._site_graphs: List[RDFGraph] = [graph.subgraph(e)
                                             for e in frag.site_edges]
        self._site_index: List[_PropIndex] = [_PropIndex(g)
                                              for g in self._site_graphs]

    @property
    def num_sites(self) -> int:
        return len(self.frag.site_edges)

    def _units(self, query: QueryGraph) -> List[List[int]]:
        if self.frag.name == "WARP":
            code = query.normalize().canonical_code()
            if code in self.local_patterns:
                return [list(range(query.num_edges))]  # replication covers it
        if self.frag.name in ("SHAPE", "WARP"):
            return _star_decomposition(query)
        return [[i] for i in range(query.num_edges)]

    def _execute(self, query: QueryGraph) -> QueryResult:
        cm = self.cost
        tr = self.tracer
        units = self._units(query)
        busy: Dict[int, float] = {}
        comm_bytes = 0
        n_msgs = 0

        unit_results: List[Dict[int, np.ndarray]] = []
        for ui, grp in enumerate(units):
            sq = QueryGraph(tuple(query.edges[i] for i in sorted(grp)))
            merged: Optional[Dict[int, np.ndarray]] = None
            with tr.span("unit_match", unit=ui, edges=len(grp)) as sp:
                for site in range(self.num_sites):
                    g, idx = self._site_graphs[site], self._site_index[site]
                    res = match_pattern(g, sq, index=idx)
                    busy[site] = busy.get(site, 0.0) + (
                        g.num_edges * cm.sec_per_edge_scan +
                        res.num_rows * cm.sec_per_result_row)
                    cols = dict(res.columns)
                    merged = cols if merged is None else {
                        v: np.concatenate([merged[v], cols[v]])
                        for v in merged}
                merged = _dedup_rows(merged or {})
                sp.set("rows", _nrows(merged))
            unit_results.append(merged)

        # order by ascending cardinality, join left-deep
        unit_results.sort(key=_nrows)
        acc = unit_results[0] if unit_results else {}
        join_time = 0.0
        for nxt in unit_results[1:]:
            rows_a, rows_b = _nrows(acc), _nrows(nxt)
            # gather to coordinator: ship both sides' shards
            comm_bytes += int((min(rows_a, rows_b)) * 4 *
                              max(len(nxt), len(acc)))
            n_msgs += self.num_sites
            acc = join_bindings(acc, nxt)
            join_time += (_nrows(acc) + rows_a + rows_b) * cm.join_sec_per_row

        local = max(busy.values()) if busy else 0.0
        comm = comm_bytes / cm.network_bytes_per_sec + n_msgs * cm.network_latency_sec
        rt = local + comm + join_time
        stats = ExecStats(rt, comm_bytes, set(range(self.num_sites)), busy,
                          _nrows(acc), len(units))
        return self._finish(query, QueryResult(acc, _nrows(acc), stats))
