"""Frequent access pattern mining (§4) -- gSpan-lite pattern growth.

Mines all patterns p with acc(p) = Σ_Q use(Q, p) >= minSup over the
normalized, deduplicated workload.  Queries are tiny, so we use
embedding-list pattern growth (FSG/gSpan hybrid): each frequent pattern
carries its supporting query set; candidates are generated only from
edges adjacent to actual embeddings, then canonicalized via min DFS code
and support-counted exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .query import (QueryEdge, QueryGraph, all_embeddings,
                    is_subgraph_of)
from .workload import Workload


@dataclasses.dataclass
class FrequentPattern:
    pattern: QueryGraph
    support: int                 # acc(p), weighted by query multiplicity
    supporting: Set[int]         # indices into the deduped query list

    @property
    def num_edges(self) -> int:
        return self.pattern.num_edges


def mine_frequent_patterns(workload: Workload, min_sup: int,
                           max_edges: int = 6) -> List[FrequentPattern]:
    """Return all frequent access patterns with acc(p) >= min_sup."""
    uniq, weights = workload.dedup_normalized()
    return mine_frequent_patterns_deduped(uniq, weights, min_sup, max_edges)


def mine_frequent_patterns_deduped(uniq: Sequence[QueryGraph],
                                   weights: np.ndarray, min_sup: int,
                                   max_edges: int = 6) -> List[FrequentPattern]:
    # --- level 1: single-edge patterns (one per property label present) ---
    prop_support: Dict[int, Set[int]] = {}
    for qi, q in enumerate(uniq):
        for e in q.edges:
            prop_support.setdefault(e.prop, set()).add(qi)

    level: List[FrequentPattern] = []
    results: List[FrequentPattern] = []
    seen_codes: Set[Tuple] = set()
    for prop, sup_set in sorted(prop_support.items()):
        sup = int(weights[sorted(sup_set)].sum())
        if sup >= min_sup:
            pat = QueryGraph.make([(-1, -2, prop)])
            fp = FrequentPattern(pat, sup, sup_set)
            level.append(fp)
            results.append(fp)
            seen_codes.add(pat.canonical_code())

    # --- pattern growth ---
    size = 1
    while level and size < max_edges:
        nxt: Dict[Tuple, FrequentPattern] = {}
        for fp in level:
            cand_codes: Set[Tuple] = set()
            cands: Dict[Tuple, QueryGraph] = {}
            cand_support: Dict[Tuple, Set[int]] = {}
            for qi in fp.supporting:
                q = uniq[qi]
                for emb in all_embeddings(fp.pattern, q):
                    used_q_edges = _embedded_edges(fp.pattern, q, emb)
                    inv = {qv: pv for pv, qv in emb.items()}
                    for qe_idx, qe in enumerate(q.edges):
                        if qe_idx in used_q_edges:
                            continue
                        s_in = qe.src in inv
                        d_in = qe.dst in inv
                        if not (s_in or d_in):
                            continue  # keep patterns connected
                        new_src = inv[qe.src] if s_in else _fresh_var(fp.pattern, 0)
                        new_dst = inv[qe.dst] if d_in else _fresh_var(fp.pattern, 0)
                        if s_in and d_in and new_src == new_dst and qe.src != qe.dst:
                            continue
                        cand = QueryGraph(fp.pattern.edges +
                                          (QueryEdge(new_src, new_dst, qe.prop),))
                        code = cand.canonical_code()
                        if code in seen_codes:
                            continue
                        if code not in cands:
                            cands[code] = cand
                            cand_support[code] = set()
                        cand_support[code].add(qi)
            for code, cand in cands.items():
                # exact support count restricted to the parent's support set
                sup_set = {qi for qi in cand_support[code]
                           if is_subgraph_of(cand, uniq[qi])}
                # embedding-derived candidates are by construction subgraphs
                # of their source query, but different embeddings can vote
                # for the same code; recheck is cheap and exact.
                sup = int(weights[sorted(sup_set)].sum())
                if sup >= min_sup and code not in nxt:
                    nxt[code] = FrequentPattern(cand, sup, sup_set)
        level = list(nxt.values())
        for fp in level:
            seen_codes.add(fp.pattern.canonical_code())
        results.extend(level)
        size += 1
    return results


def _fresh_var(g: QueryGraph, ofs: int) -> int:
    return min([v for v in g.vertices() if v < 0], default=0) - 1 - ofs


def _embedded_edges(pattern: QueryGraph, query: QueryGraph,
                    emb: Dict[int, int]) -> Set[int]:
    """Query edge indices covered by an embedding (injective on edges)."""
    used: Set[int] = set()
    for pe in pattern.edges:
        qs, qd = emb[pe.src], emb[pe.dst]
        for qi, qe in enumerate(query.edges):
            if qi in used:
                continue
            if qe.src == qs and qe.dst == qd and qe.prop == pe.prop:
                used.add(qi)
                break
    return used


def frequent_properties(workload: Workload, theta: int) -> List[int]:
    """Def. 5: properties occurring in >= theta queries of the workload."""
    counts: Dict[int, int] = {}
    for q in workload.queries:
        for prop in set(q.properties()):
            counts[prop] = counts.get(prop, 0) + 1
    return sorted(p for p, c in counts.items() if c >= theta and p >= 0)


def usage_matrix(patterns: Sequence[QueryGraph], uniq: Sequence[QueryGraph]
                 ) -> np.ndarray:
    """U[q, i] = use(uniq[q], patterns[i]) (Def. 7). Feeds selection and
    affinity (Def. 13) as dense matrix ops."""
    U = np.zeros((len(uniq), len(patterns)), dtype=np.int8)
    for i, p in enumerate(patterns):
        for qi, q in enumerate(uniq):
            if is_subgraph_of(p, q):
                U[qi, i] = 1
    return U
