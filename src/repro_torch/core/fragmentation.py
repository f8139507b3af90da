"""Vertical fragmentation (§5.1, Def. 10).

A Fragment is a set of graph edge ids plus metadata (source pattern,
match cardinality).  Overlap between fragments is allowed (Def. 3 only
requires edge/vertex coverage); the integrity seed of Algorithm 1
guarantees every hot edge appears somewhere, and the cold graph is
carried as hash-partitioned black-box fragments (§3).  The horizontal
strategy (§5.2, minterm predicates) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .graph import RDFGraph
from .matching import _PropIndex, match_edge_ids, match_pattern
from .mining import frequent_properties
from .query import QueryGraph
from .workload import Workload


@dataclasses.dataclass
class Fragment:
    edge_ids: np.ndarray            # int64 ids into the base graph
    pattern_idx: int                # -1 for cold fragments
    card: int = 0                   # # matches materialized in the fragment
    kind: str = "vertical"          # vertical | cold

    @property
    def size(self) -> int:
        return int(len(self.edge_ids))


@dataclasses.dataclass
class Fragmentation:
    fragments: List[Fragment]
    patterns: List[QueryGraph]       # selected patterns, index-aligned
    kind: str                        # "vertical"
    cold_fragments: List[Fragment]

    def redundancy_ratio(self, graph: RDFGraph) -> float:
        """Table 1 metric: Σ fragment edges / |E(G)|."""
        tot = sum(f.size for f in self.fragments) + \
            sum(f.size for f in self.cold_fragments)
        return tot / max(graph.num_edges, 1)


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
        frags.append(Fragment(eids, i, res.num_rows, "vertical"))
    cold = _cold_fragments(graph, cold_edge_ids, num_cold_parts)
    return Fragmentation(frags, list(patterns), "vertical", cold)


def _cold_fragments(graph: RDFGraph, cold_edge_ids: Optional[np.ndarray],
                    num_parts: int) -> List[Fragment]:
    """Cold graph as a black box (§3): hash-partition cold edges by
    subject (any existing approach is admissible; hashing is SHAPE-like)."""
    if cold_edge_ids is None or len(cold_edge_ids) == 0:
        return []
    cold_edge_ids = np.asarray(cold_edge_ids, dtype=np.int64)
    if num_parts <= 1:
        return [Fragment(cold_edge_ids, -1, 0, "cold")]
    part = graph.s[cold_edge_ids] % num_parts
    return [Fragment(cold_edge_ids[part == j], -1, 0, "cold")
            for j in range(num_parts) if (part == j).any()]


def build_fragmentation(graph: RDFGraph, workload: Workload,
                        selected_patterns: Sequence[QueryGraph],
                        theta: int, num_cold_parts: int = 1,
                        max_rows: int = 5_000_000) -> Fragmentation:
    """End-to-end: hot/cold split + vertical fragmentation of the hot
    graph."""
    fprops = frequent_properties(workload, theta)
    _, cold_ids = graph.hot_cold_split(fprops)
    return vertical_fragmentation(graph, selected_patterns, cold_ids,
                                  num_cold_parts, max_rows=max_rows)
