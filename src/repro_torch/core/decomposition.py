"""Query decomposition (§7.2, Algorithm 3).

A decomposition D = {q_1..q_t} partitions the query's edges into
connected subqueries; valid (Def. 15) iff every subquery is either
(a) isomorphic (after normalization) to a selected frequent access
pattern, or (b) made entirely of cold edges.

Queries have <= ~10 edges (paper §7.2) so exact enumeration of edge
partitions with connectivity + validity pruning is affordable; we
memoize on edge subsets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .dictionary import DataDictionary
from .query import QueryEdge, QueryGraph


@dataclasses.dataclass
class Decomposition:
    subqueries: List[QueryGraph]
    pattern_ids: List[Optional[int]]   # selected-pattern idx or None (cold)
    cost: float


def _subgraph_from(query: QueryGraph, edge_idxs: Sequence[int]) -> QueryGraph:
    return QueryGraph(tuple(query.edges[i] for i in sorted(edge_idxs)))


def _connected_subsets_containing(query: QueryGraph, anchor: int,
                                  avail: FrozenSet[int], max_size: int
                                  ) -> List[FrozenSet[int]]:
    """All connected edge subsets that contain ``anchor`` (lowest-index
    rule kills duplicate partitions), drawn from ``avail``."""
    edges = query.edges
    out: List[FrozenSet[int]] = []

    def touches(ei: int, verts: Set[int]) -> bool:
        return edges[ei].src in verts or edges[ei].dst in verts

    def rec(cur: FrozenSet[int], verts: Set[int], frontier: List[int]) -> None:
        out.append(cur)
        if len(cur) >= max_size:
            return
        cand = sorted(i for i in avail
                      if i not in cur and i > anchor and touches(i, verts))
        for k, ei in enumerate(cand):
            nv = set(verts) | {edges[ei].src, edges[ei].dst}
            rec(cur | {ei}, nv, [])

    rec(frozenset([anchor]), {edges[anchor].src, edges[anchor].dst}, [])
    return sorted(set(out), key=lambda s: (len(s), sorted(s)))


def valid_components(query: QueryGraph, dictionary: DataDictionary,
                     cold_props: Set[int], max_pattern_edges: int = 8
                     ) -> Dict[FrozenSet[int], Optional[int]]:
    """Map each connected edge subset that forms a *valid* subquery to
    its pattern id (or None for an all-cold subquery)."""
    n = query.num_edges
    valid: Dict[FrozenSet[int], Optional[int]] = {}
    all_idx = frozenset(range(n))
    for anchor in range(n):
        for sub in _connected_subsets_containing(query, anchor, all_idx,
                                                 max_pattern_edges):
            if sub in valid:
                continue
            sq = _subgraph_from(query, sub)
            pid = dictionary.lookup_pattern(sq)
            if pid is not None:
                valid[sub] = pid
            elif all(query.edges[i].prop in cold_props or query.edges[i].prop < 0
                     for i in sub):
                valid[sub] = None
    return valid


def enumerate_decompositions(query: QueryGraph, dictionary: DataDictionary,
                             cold_props: Set[int], limit: int = 20000
                             ) -> List[Decomposition]:
    """Algorithm 3's candidate space: all valid decompositions."""
    n = query.num_edges
    comp = valid_components(query, dictionary, cold_props)
    # group components by their lowest edge index for canonical recursion
    by_anchor: Dict[int, List[FrozenSet[int]]] = {}
    for sub in comp:
        by_anchor.setdefault(min(sub), []).append(sub)

    out: List[Decomposition] = []

    def rec(remaining: FrozenSet[int], acc: List[FrozenSet[int]]) -> None:
        if len(out) >= limit:
            return
        if not remaining:
            subs = [_subgraph_from(query, s) for s in acc]
            pids = [comp[s] for s in acc]
            out.append(Decomposition(subs, pids, 0.0))
            return
        anchor = min(remaining)
        for sub in by_anchor.get(anchor, []):
            if sub <= remaining:
                rec(remaining - sub, acc + [sub])

    rec(frozenset(range(n)), [])
    return out


def decompose(query: QueryGraph, dictionary: DataDictionary,
              cold_props: Set[int]) -> Decomposition:
    """Algorithm 3: pick the valid decomposition with the smallest
    cost(D) = Π card(q_i) (§7.2 worst-case cost model)."""
    cands = enumerate_decompositions(query, dictionary, cold_props)
    if not cands:
        raise ValueError(
            "no valid decomposition -- Algorithm 1's integrity seed "
            "guarantees one exists; did you drop 1-edge patterns?")
    best: Optional[Decomposition] = None
    for d in cands:
        cost = 1.0
        for sq in d.subqueries:
            cost *= dictionary.estimate_card(sq)
        d.cost = cost
        # tie-break: fewer subqueries (fewer distributed joins)
        if best is None or (cost, len(d.subqueries)) < (best.cost, len(best.subqueries)):
            best = d
    return best
