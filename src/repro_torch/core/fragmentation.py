"""Vertical (§5.1, Def. 10) and horizontal (§5.2, Def. 12) fragmentation.

A Fragment is a set of graph edge ids plus metadata (source pattern /
minterm predicate, match cardinality).  Overlap between fragments is
allowed (Def. 3 only requires edge/vertex coverage); the integrity seed
of Algorithm 1 guarantees every hot edge appears somewhere, and the cold
graph is carried as hash-partitioned black-box fragments (§3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import RDFGraph
from .matching import MatchResult, _PropIndex, match_edge_ids, match_pattern
from .mining import FrequentPattern, frequent_properties
from .query import QueryGraph
from .workload import Workload


# ----------------------------------------------------------------------
# Structural simple / minterm predicates (§5.2.1)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimplePredicate:
    """sp: p(var_i) θ Value with θ ∈ {=, ≠}."""
    var: int        # pattern variable id
    value: int      # constant vertex id
    equal: bool     # True: '=', False: '≠'

    def negate(self) -> "SimplePredicate":
        return SimplePredicate(self.var, self.value, not self.equal)


@dataclasses.dataclass(frozen=True)
class MintermPredicate:
    """Conjunction of simple predicates over one pattern's variables."""
    pattern_idx: int
    terms: Tuple[SimplePredicate, ...]

    def mask(self, result: MatchResult) -> np.ndarray:
        m = np.ones(result.num_rows, dtype=bool)
        for t in self.terms:
            col = result.columns[t.var]
            m &= (col == t.value) if t.equal else (col != t.value)
        return m


@dataclasses.dataclass
class Fragment:
    edge_ids: np.ndarray            # int64 ids into the base graph
    pattern_idx: int                # -1 for cold fragments
    minterm: Optional[MintermPredicate] = None
    card: int = 0                   # # matches materialized in the fragment
    kind: str = "vertical"          # vertical | horizontal | cold

    @property
    def size(self) -> int:
        return int(len(self.edge_ids))


@dataclasses.dataclass
class Fragmentation:
    fragments: List[Fragment]
    patterns: List[QueryGraph]       # selected patterns, index-aligned
    kind: str                        # "vertical" | "horizontal"
    cold_fragments: List[Fragment]

    def redundancy_ratio(self, graph: RDFGraph) -> float:
        """Table 1 metric: Σ fragment edges / |E(G)|."""
        tot = sum(f.size for f in self.fragments) + \
            sum(f.size for f in self.cold_fragments)
        return tot / max(graph.num_edges, 1)

    def coverage_ok(self, graph: RDFGraph) -> bool:
        """Def. 3 invariant: every edge of G appears in some fragment."""
        seen = np.zeros(graph.num_edges, dtype=bool)
        for f in self.fragments + self.cold_fragments:
            seen[f.edge_ids] = True
        return bool(seen.all())


# ----------------------------------------------------------------------
# Vertical fragmentation
# ----------------------------------------------------------------------

def vertical_fragmentation(graph: RDFGraph, patterns: Sequence[QueryGraph],
                           cold_edge_ids: Optional[np.ndarray] = None,
                           num_cold_parts: int = 1,
                           index: Optional[_PropIndex] = None,
                           max_rows: int = 5_000_000) -> Fragmentation:
    """One fragment per selected pattern = edges of [[p]]_G (Def. 10)."""
    idx = index or _PropIndex(graph)
    frags: List[Fragment] = []
    for i, pat in enumerate(patterns):
        res = match_pattern(graph, pat, index=idx, max_rows=max_rows)
        eids = match_edge_ids(graph, pat, result=res, index=idx)
        frags.append(Fragment(eids, i, None, res.num_rows, "vertical"))
    cold = _cold_fragments(graph, cold_edge_ids, num_cold_parts)
    return Fragmentation(frags, list(patterns), "vertical", cold)


# ----------------------------------------------------------------------
# Horizontal fragmentation
# ----------------------------------------------------------------------

def mine_simple_predicates(patterns: Sequence[QueryGraph],
                           workload: Workload, per_pattern: int = 2,
                           min_freq: int = 2) -> Dict[int, List[SimplePredicate]]:
    """Collect the most frequent (variable = constant) constraints per
    pattern from workload queries containing the pattern (Example 2).

    Returns the '=' forms; minterm enumeration adds the negations.
    """
    from .query import find_embedding

    counts: Dict[int, Dict[Tuple[int, int], int]] = {i: {} for i in range(len(patterns))}
    for q in workload.queries:
        nq = q.normalize()
        consts = q.constant_bindings()   # normalized var -> constant
        if not consts:
            continue
        for i, pat in enumerate(patterns):
            emb = find_embedding(pat, nq)
            if emb is None:
                continue
            for pv, qv in emb.items():
                if qv in consts:
                    key = (pv, consts[qv])
                    counts[i][key] = counts[i].get(key, 0) + 1
    out: Dict[int, List[SimplePredicate]] = {}
    for i, cmap in counts.items():
        top = sorted(cmap.items(), key=lambda kv: -kv[1])[:per_pattern]
        out[i] = [SimplePredicate(var, val, True)
                  for (var, val), c in top if c >= min_freq]
    return out


def enumerate_minterms(pattern_idx: int,
                       simple: Sequence[SimplePredicate]) -> List[MintermPredicate]:
    """All 2^y sign combinations of the simple predicates (§5.2.1)."""
    if not simple:
        return [MintermPredicate(pattern_idx, ())]
    out: List[MintermPredicate] = []
    y = len(simple)
    for bits in range(1 << y):
        terms = tuple(sp if (bits >> k) & 1 else sp.negate()
                      for k, sp in enumerate(simple))
        out.append(MintermPredicate(pattern_idx, terms))
    return out


def horizontal_fragmentation(graph: RDFGraph, patterns: Sequence[QueryGraph],
                             workload: Workload,
                             cold_edge_ids: Optional[np.ndarray] = None,
                             num_cold_parts: int = 1,
                             per_pattern_predicates: int = 2,
                             index: Optional[_PropIndex] = None,
                             max_rows: int = 5_000_000) -> Fragmentation:
    """Def. 12: fragments = matches of each pattern split by minterm
    predicates.  Predicates with zero matching rows are dropped (they
    correspond to minterms with negligible access frequency, which the
    paper prunes)."""
    idx = index or _PropIndex(graph)
    simple = mine_simple_predicates(patterns, workload,
                                    per_pattern=per_pattern_predicates)
    frags: List[Fragment] = []
    for i, pat in enumerate(patterns):
        res = match_pattern(graph, pat, index=idx, max_rows=max_rows)
        minterms = enumerate_minterms(i, simple.get(i, []))
        for mt in minterms:
            mask = mt.mask(res)
            n = int(mask.sum())
            if n == 0 and len(minterms) > 1:
                continue
            sub = MatchResult({v: c[mask] for v, c in res.columns.items()}, n)
            eids = match_edge_ids(graph, pat, result=sub, index=idx)
            frags.append(Fragment(eids, i, mt, n, "horizontal"))
    cold = _cold_fragments(graph, cold_edge_ids, num_cold_parts)
    return Fragmentation(frags, list(patterns), "horizontal", cold)


# ----------------------------------------------------------------------

def _cold_fragments(graph: RDFGraph, cold_edge_ids: Optional[np.ndarray],
                    num_parts: int) -> List[Fragment]:
    """Cold graph as a black box (§3): hash-partition cold edges by
    subject (any existing approach is admissible; hashing is SHAPE-like)."""
    if cold_edge_ids is None or len(cold_edge_ids) == 0:
        return []
    cold_edge_ids = np.asarray(cold_edge_ids, dtype=np.int64)
    if num_parts <= 1:
        return [Fragment(cold_edge_ids, -1, None, 0, "cold")]
    part = graph.s[cold_edge_ids] % num_parts
    return [Fragment(cold_edge_ids[part == j], -1, None, 0, "cold")
            for j in range(num_parts) if (part == j).any()]


def build_fragmentation(graph: RDFGraph, workload: Workload,
                        selected_patterns: Sequence[QueryGraph],
                        theta: int, kind: str = "vertical",
                        num_cold_parts: int = 1,
                        per_pattern_predicates: int = 2,
                        max_rows: int = 5_000_000) -> Fragmentation:
    """End-to-end: hot/cold split + the chosen strategy over hot graph."""
    fprops = frequent_properties(workload, theta)
    _, cold_ids = graph.hot_cold_split(fprops)
    if kind == "vertical":
        return vertical_fragmentation(graph, selected_patterns, cold_ids,
                                      num_cold_parts, max_rows=max_rows)
    elif kind == "horizontal":
        return horizontal_fragmentation(
            graph, selected_patterns, workload, cold_ids, num_cold_parts,
            per_pattern_predicates, max_rows=max_rows)
    raise ValueError(f"unknown fragmentation kind: {kind}")
