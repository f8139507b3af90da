"""Data dictionary (§7.1): global metadata for distributed processing.

Keyed by the min-DFS-code canonical label of each frequent access
pattern (hashed, as in the paper which hashes DFS codes [26]); stores
fragment definitions, sizes, match cardinalities, site mappings and
per-property statistics used by the cost model of §7.2.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .allocation import Allocation
from .fragmentation import Fragment, Fragmentation
from .graph import RDFGraph
from .query import QueryGraph


@dataclasses.dataclass
class FragmentStats:
    fragment_idx: int
    pattern_idx: int
    site: int
    size_edges: int
    card: int
    kind: str


@dataclasses.dataclass
class DataDictionary:
    patterns: List[QueryGraph]
    pattern_hash: Dict[int, List[int]]       # hash(code) -> pattern indices
    frag_stats: List[FragmentStats]
    frags_of_pattern: Dict[int, List[int]]   # pattern idx -> fragment idxs
    prop_counts: np.ndarray                  # per-property edge counts
    cold_sites: List[int]                    # sites holding cold fragments
    num_sites: int
    avg_out_degree: float

    # ------------------------------------------------------------------
    @staticmethod
    def build(graph: RDFGraph, frag: Fragmentation, alloc: Allocation,
              num_sites: int) -> "DataDictionary":
        pattern_hash: Dict[int, List[int]] = {}
        for i, p in enumerate(frag.patterns):
            h = hash(p.canonical_code())
            pattern_hash.setdefault(h, []).append(i)
        stats: List[FragmentStats] = []
        frags_of: Dict[int, List[int]] = {}
        for fi, f in enumerate(frag.fragments):
            site = int(alloc.site_of[fi])
            stats.append(FragmentStats(fi, f.pattern_idx, site, f.size,
                                       f.card, f.kind))
            frags_of.setdefault(f.pattern_idx, []).append(fi)
        # cold fragments ride along round-robin after the hot ones
        cold_sites: List[int] = []
        for k, f in enumerate(frag.cold_fragments):
            site = k % num_sites
            cold_sites.append(site)
            stats.append(FragmentStats(len(frag.fragments) + k, -1, site,
                                       f.size, 0, "cold"))
        counts = graph.property_counts()
        deg = graph.num_edges / max(graph.num_vertices, 1)
        return DataDictionary(list(frag.patterns), pattern_hash, stats,
                              frags_of, counts, cold_sites, num_sites, deg)

    # ------------------------------------------------------------------
    def lookup_pattern(self, q: QueryGraph) -> Optional[int]:
        """Exact-isomorphism lookup via the DFS-code hash table (§7.1)."""
        code = q.normalize().canonical_code()
        for i in self.pattern_hash.get(hash(code), []):
            if self.patterns[i].canonical_code() == code:
                return i
        return None

    def estimate_card(self, q: QueryGraph) -> float:
        """card(q) for the cost model (§7.2).

        Hot subqueries isomorphic to pattern p: use the materialized
        match count of p's fragment(s), scaled by constant selectivity
        (each bound constant divides by the average adjacency -- the
        classic System-R 1/V(attr) guess).
        Cold subqueries: independence estimate from property counts.
        """
        pi = self.lookup_pattern(q)
        n_consts = len(q.constants())
        if pi is not None:
            card = float(sum(self.frag_stats[fi].card if fi < len(self.frag_stats)
                             else 0 for fi in self.frags_of_pattern.get(pi, [])))
            card = max(card, 1.0)
            for _ in range(n_consts):
                card = max(card / max(self.avg_out_degree * 4.0, 2.0), 1.0)
            return card
        # cold / unknown: independence over edges
        card = 1.0
        for prop in q.properties():
            c = float(self.prop_counts[prop]) if 0 <= prop < len(self.prop_counts) \
                else float(self.prop_counts.sum())
            card *= max(c, 1.0) / max(self.avg_out_degree, 1.0)
        card *= max(self.avg_out_degree, 1.0)  # one join chain discount
        for _ in range(n_consts):
            card = max(card / max(self.avg_out_degree * 4.0, 2.0), 1.0)
        return max(card, 1.0)

    def sites_of_pattern(self, pattern_idx: int) -> List[int]:
        return sorted({self.frag_stats[fi].site
                       for fi in self.frags_of_pattern.get(pattern_idx, [])})
