"""Subgraph (homomorphism) matching of patterns over RDF graphs.

Answering a SPARQL query = finding all homomorphic matches of its query
graph (paper §2.1, [31]).  This module is the exact host-side engine
used for fragment construction (|[[p]]_G| drives Algorithm 1's storage
terms) and as the oracle for the distributed executor.

Strategy: edge-at-a-time worst-case join over predicate-partitioned
sorted edge tables (searchsorted expansion).  Pure numpy; the device
path is ``repro_torch.core.spmd`` over the kernels in
``repro_torch.kernels``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import RDFGraph
from .query import QueryGraph, _connected_edge_order


@dataclasses.dataclass
class MatchResult:
    """Binding table: columns[v] -> int32 array of vertex ids per match."""
    columns: Dict[int, np.ndarray]
    num_rows: int
    truncated: bool = False

    def rows(self) -> np.ndarray:
        keys = sorted(self.columns)
        if not keys:
            return np.zeros((self.num_rows, 0), np.int32)
        return np.stack([self.columns[k] for k in keys], axis=1)


class _PropIndex:
    """Per-property edge tables sorted by subject and by object."""

    def __init__(self, graph: RDFGraph):
        self.graph = graph
        self._by_s: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._by_o: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._pair: Dict[int, np.ndarray] = {}

    def by_subject(self, pid: int) -> Tuple[np.ndarray, np.ndarray]:
        if pid not in self._by_s:
            _, s, o = self.graph.edges_with_property(pid)
            self._by_s[pid] = (s, o)  # already sorted by s
        return self._by_s[pid]

    def by_object(self, pid: int) -> Tuple[np.ndarray, np.ndarray]:
        if pid not in self._by_o:
            _, s, o = self.graph.edges_with_property(pid)
            order = np.argsort(o, kind="stable")
            self._by_o[pid] = (o[order], s[order])
        return self._by_o[pid]

    def pair_keys(self, pid: int) -> np.ndarray:
        if pid not in self._pair:
            s, o = self.by_subject(pid)
            nv = self.graph.num_vertices + 1
            self._pair[pid] = np.sort(s.astype(np.int64) * nv + o.astype(np.int64))
        return self._pair[pid]

    def count(self, pid: int) -> int:
        return len(self.by_subject(pid)[0])


def _expand(values: np.ndarray, sorted_keys: np.ndarray,
            payload: np.ndarray, limit: Optional[int] = None
            ) -> Tuple[np.ndarray, np.ndarray, int]:
    """For each v in values, find all payload entries whose key == v.

    Returns (row_index, payload_value, full row count) of the expanded
    join.  With ``limit`` only the first ``limit`` rows are built --
    exactly the rows that truncating the full expansion would keep --
    so a join through a hub vertex never materializes rows that are cut
    anyway.
    """
    lo = np.searchsorted(sorted_keys, values, side="left")
    hi = np.searchsorted(sorted_keys, values, side="right")
    counts = hi - lo
    csum = np.cumsum(counts)
    total = int(csum[-1]) if len(csum) else 0
    if limit is not None and total > limit:
        cut = int(np.searchsorted(csum, limit, side="left"))
        counts = counts[:cut + 1].copy()
        counts[cut] -= int(csum[cut]) - limit
        lo = lo[:cut + 1]
    row_idx = np.repeat(np.arange(len(counts)), counts)
    if len(row_idx) == 0:
        return row_idx, np.zeros(0, payload.dtype), total
    # positions within each run
    starts = np.repeat(lo, counts)
    offs = np.arange(len(starts)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    return row_idx, payload[starts + offs], total


def match_pattern(graph: RDFGraph, pattern: QueryGraph,
                  index: Optional[_PropIndex] = None,
                  max_rows: int = 5_000_000) -> MatchResult:
    """All homomorphic matches of ``pattern`` over ``graph``.

    Pattern vertices < 0 are variables; >= 0 are constants.  Property
    variables (prop < 0) match every property (rare; handled by
    concatenating all predicate tables).  Past ``max_rows`` the binding
    table is truncated to its first ``max_rows`` rows (``truncated``).
    """
    idx = index or _PropIndex(graph)
    order = _connected_edge_order(pattern)
    edges = pattern.edges

    cols: Dict[int, np.ndarray] = {}
    nrows = 1
    truncated = False

    for k in order:
        e = edges[k]
        s_bound = e.src in cols or e.src >= 0
        d_bound = e.dst in cols or e.dst >= 0

        def col_of(v: int) -> np.ndarray:
            if v >= 0:
                return np.full(nrows, v, dtype=np.int32)
            return cols[v]

        if e.prop < 0:
            tbl_s = np.argsort(graph.s, kind="stable")
            table_by_s = (graph.s[tbl_s], graph.o[tbl_s])
        else:
            table_by_s = None

        if s_bound and d_bound:
            # semi-join filter on (s, o) pairs
            nv = graph.num_vertices + 1
            keys = col_of(e.src).astype(np.int64) * nv + col_of(e.dst).astype(np.int64)
            if e.prop >= 0:
                pair = idx.pair_keys(e.prop)
            else:
                pair = np.sort(graph.s.astype(np.int64) * nv + graph.o.astype(np.int64))
            pos = np.searchsorted(pair, keys)
            pos = np.clip(pos, 0, max(len(pair) - 1, 0))
            keep = (pair[pos] == keys) if len(pair) else np.zeros(len(keys), bool)
            cols = {v: c[keep] for v, c in cols.items()}
            nrows = int(keep.sum())
        elif s_bound:
            keys, payload = (idx.by_subject(e.prop) if e.prop >= 0 else table_by_s)
            # a constant destination filters after the expansion, so only a
            # variable one may stop at max_rows
            row_idx, new_vals, total = _expand(
                col_of(e.src), keys, payload,
                max_rows if e.dst < 0 else None)
            truncated |= total > max_rows and e.dst < 0
            cols = {v: c[row_idx] for v, c in cols.items()}
            if e.dst < 0:
                cols[e.dst] = new_vals
                nrows = len(new_vals)
            else:  # dst constant: filter
                keep = new_vals == e.dst
                cols = {v: c[keep] for v, c in cols.items()}
                nrows = int(keep.sum())
        elif d_bound:
            if e.prop >= 0:
                keys, payload = idx.by_object(e.prop)
            else:
                tbl_o = np.argsort(graph.o, kind="stable")
                keys, payload = graph.o[tbl_o], graph.s[tbl_o]
            row_idx, new_vals, total = _expand(
                col_of(e.dst), keys, payload,
                max_rows if e.src < 0 else None)
            truncated |= total > max_rows and e.src < 0
            cols = {v: c[row_idx] for v, c in cols.items()}
            if e.src < 0:
                cols[e.src] = new_vals
                nrows = len(new_vals)
            else:
                keep = new_vals == e.src
                cols = {v: c[keep] for v, c in cols.items()}
                nrows = int(keep.sum())
        else:
            # first edge (or disconnected component): scan the whole table
            if e.prop >= 0:
                s_vals, o_vals = idx.by_subject(e.prop)
            else:
                s_vals, o_vals = graph.s, graph.o
            s_vals = s_vals.astype(np.int32)
            o_vals = o_vals.astype(np.int32)
            # constants / repeated variable filters on the fresh edge table
            keep = np.ones(len(s_vals), dtype=bool)
            if e.src >= 0:
                keep &= s_vals == e.src
            if e.dst >= 0:
                keep &= o_vals == e.dst
            if e.src < 0 and e.src == e.dst:
                keep &= s_vals == o_vals
            s_vals, o_vals = s_vals[keep], o_vals[keep]
            if cols:
                # cartesian with existing bindings (disconnected pattern)
                reps = len(s_vals)
                cols = {v: np.repeat(c, reps) for v, c in cols.items()}
                s_vals = np.tile(s_vals, nrows)
                o_vals = np.tile(o_vals, nrows)
            if e.src < 0:
                cols[e.src] = s_vals
            if e.dst < 0 and e.dst != e.src:
                cols[e.dst] = o_vals
            nrows = len(s_vals)
        if nrows > max_rows:
            cols = {v: c[:max_rows] for v, c in cols.items()}
            nrows = max_rows
            truncated = True
        if nrows == 0:
            cols = {v: np.zeros(0, np.int32) for v in cols}
            # still record remaining variables as empty
            for ee in edges:
                for v in (ee.src, ee.dst):
                    if v < 0 and v not in cols:
                        cols[v] = np.zeros(0, np.int32)
            return MatchResult(cols, 0, truncated)

    for v in pattern.vertices():
        if v < 0 and v not in cols:
            cols[v] = np.zeros(nrows, np.int32)  # shouldn't happen (connected)
    return MatchResult(cols, nrows, truncated)


def match_edge_ids(graph: RDFGraph, pattern: QueryGraph,
                   result: Optional[MatchResult] = None,
                   index: Optional[_PropIndex] = None,
                   max_rows: int = 5_000_000) -> np.ndarray:
    """Distinct graph edge ids touched by any match of ``pattern``
    (the vertical fragment of Def. 10 is exactly this edge set)."""
    res = result or match_pattern(graph, pattern, index=index, max_rows=max_rows)
    if res.num_rows == 0:
        return np.zeros(0, np.int64)
    eids: List[np.ndarray] = []
    for e in pattern.edges:
        sv = (res.columns[e.src] if e.src < 0
              else np.full(res.num_rows, e.src, np.int32))
        dv = (res.columns[e.dst] if e.dst < 0
              else np.full(res.num_rows, e.dst, np.int32))
        if e.prop >= 0:
            pv = np.full(res.num_rows, e.prop, np.int32)
            got = graph.edge_ids_for_triples(sv, pv, dv)
        else:
            # property variable: try all properties (rare path)
            got = np.full(res.num_rows, -1, np.int64)
            for pid in range(graph.num_properties):
                pv = np.full(res.num_rows, pid, np.int32)
                cand = graph.edge_ids_for_triples(sv, pv, dv)
                got = np.where(got < 0, cand, got)
        eids.append(got[got >= 0])
    return np.unique(np.concatenate(eids))


def count_matches(graph: RDFGraph, pattern: QueryGraph,
                  index: Optional[_PropIndex] = None,
                  max_rows: int = 5_000_000) -> int:
    return match_pattern(graph, pattern, index=index, max_rows=max_rows).num_rows
