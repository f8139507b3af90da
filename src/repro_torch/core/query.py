"""SPARQL query graphs (Def. 2), normalization, canonical DFS codes and
subgraph isomorphism.

Vertex encoding: ids >= 0 are constants (RDF graph vertex ids); ids < 0
are variables (-1, -2, ...).  Property encoding: >= 0 constant property
id; -1 a property variable (wildcard label in pattern space).

Queries in real workloads are tiny (<= ~10 edges, paper §7.2), so the
combinatorial pieces (canonical codes, isomorphism) are exact
backtracking searches -- they are metadata-scale, never data-scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

PROP_VAR = -1  # wildcard property label


@dataclasses.dataclass(frozen=True)
class QueryEdge:
    src: int
    dst: int
    prop: int


@dataclasses.dataclass(frozen=True)
class QueryGraph:
    """A connected SPARQL basic-graph-pattern as a directed labeled graph."""

    edges: Tuple[QueryEdge, ...]

    @staticmethod
    def make(edges: Iterable[Tuple[int, int, int]]) -> "QueryGraph":
        return QueryGraph(tuple(QueryEdge(s, d, p) for s, d, p in edges))

    # ------------------------------------------------------------------
    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def vertices(self) -> List[int]:
        out: List[int] = []
        seen = set()
        for e in self.edges:
            for v in (e.src, e.dst):
                if v not in seen:
                    seen.add(v)
                    out.append(v)
        return out

    def variables(self) -> List[int]:
        return [v for v in self.vertices() if v < 0]

    def constants(self) -> List[int]:
        return [v for v in self.vertices() if v >= 0]

    def properties(self) -> List[int]:
        return [e.prop for e in self.edges]

    def is_connected(self) -> bool:
        vs = self.vertices()
        if not vs:
            return True
        adj: Dict[int, List[int]] = {v: [] for v in vs}
        for e in self.edges:
            adj[e.src].append(e.dst)
            adj[e.dst].append(e.src)
        stack, seen = [vs[0]], {vs[0]}
        while stack:
            v = stack.pop()
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return len(seen) == len(vs)

    # ------------------------------------------------------------------
    def normalization_map(self) -> Dict[int, int]:
        """Original vertex id -> normalized variable id, in edge/endpoint
        traversal order.  THE canonical traversal: ``normalize`` and
        ``constant_bindings`` are defined in terms of it, and the SPMD
        engine uses it to re-apply constants after matching a normalized
        pattern."""
        mapping: Dict[int, int] = {}
        nxt = -1
        for e in self.edges:
            for v in (e.src, e.dst):
                if v not in mapping:
                    mapping[v] = nxt
                    nxt -= 1
        return mapping

    def normalize(self) -> "QueryGraph":
        """§4: replace every constant subject/object with a fresh variable
        (generalized representation).  Properties are kept -- they are the
        labels the whole technique keys on.  FILTERs were never modeled."""
        m = self.normalization_map()
        return QueryGraph(tuple(QueryEdge(m[e.src], m[e.dst], e.prop)
                                for e in self.edges))

    def constant_bindings(self) -> Dict[int, int]:
        """Map normalized-variable id -> original constant (for minterm
        predicate mining, §5.2)."""
        return {nv: v for v, nv in self.normalization_map().items()
                if v >= 0}

    # ------------------------------------------------------------------
    def canonical_code(self) -> Tuple:
        """Minimum DFS code (gSpan [26]) -- canonical label usable as a
        dictionary key (§7.1).  Exact for the small graphs we handle."""
        return min_dfs_code(self)

    def __hash__(self) -> int:  # hash by canonical structure
        return hash(self.canonical_code())

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, QueryGraph):
            return NotImplemented
        return self.canonical_code() == other.canonical_code()


# ======================================================================
# Minimum DFS code (canonical form)
# ======================================================================
# A DFS code is a sequence of tuples (i, j, li, lp, lj): discovery indices
# of the two endpoints, vertex labels, edge label, plus the direction bit.
# Vertex label: 0 for variables, 1 + constant id for constants (normalized
# patterns are all-variable so labels collapse to 0).  We enumerate all
# DFS traversals with pruning and keep the lexicographically smallest.

def _vlabel(v: int) -> int:
    return 0 if v < 0 else 1 + v


def _edge_components(g: QueryGraph) -> List[List[int]]:
    """Edge indices grouped by connected component."""
    parent: Dict[int, int] = {}

    def find(v: int) -> int:
        parent.setdefault(v, v)
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    for e in g.edges:
        ra, rb = find(e.src), find(e.dst)
        if ra != rb:
            parent[ra] = rb
    groups: Dict[int, List[int]] = {}
    for i, e in enumerate(g.edges):
        groups.setdefault(find(e.src), []).append(i)
    return list(groups.values())


def min_dfs_code(g: QueryGraph) -> Tuple:
    edges = g.edges
    n = len(edges)
    if n == 0:
        return ()
    # Disconnected graphs (paper §2.1 treats components separately):
    # canonical form = sorted tuple of per-component codes.
    comps = _edge_components(g)
    if len(comps) > 1:
        parts = sorted(min_dfs_code(QueryGraph(tuple(edges[i] for i in c)))
                       for c in comps)
        return tuple(("|",) + p for p in parts)
    # adjacency: vertex -> list of (edge_idx, other, direction) dir=0 out,1 in
    adj: Dict[int, List[Tuple[int, int, int]]] = {}
    for idx, e in enumerate(edges):
        adj.setdefault(e.src, []).append((idx, e.dst, 0))
        adj.setdefault(e.dst, []).append((idx, e.src, 1))

    # Self-loops break gSpan's minimal-extension pruning: a loop is only
    # consumable (as a backward edge) while its vertex is rightmost, so
    # always following the minimal extension can dead-end before the loop
    # is emitted.  With a loop present we branch on *every* extension --
    # still exact (prefix-pruned against the incumbent), and the min over
    # all traversals is the same canonical form.
    has_loop = any(e.src == e.dst for e in edges)

    best: List[Optional[Tuple]] = [None]

    def rec(code: List[Tuple], disc: Dict[int, int], used: FrozenSet[int],
            rightmost_path: List[int]) -> None:
        if best[0] is not None and tuple(code) > best[0][: len(code)]:
            return
        if len(code) == n:
            cand = tuple(code)
            if best[0] is None or cand < best[0]:
                best[0] = cand
            return
        # candidate extensions: backward edges from rightmost vertex first,
        # then forward edges from vertices on the rightmost path (gSpan order)
        ext: List[Tuple[Tuple, int, Optional[int]]] = []
        rm = rightmost_path[-1]
        for eidx, other, direction in adj.get(rm, []):
            if eidx in used:
                continue
            if other in disc:  # backward edge
                t = (disc[rm], disc[other], _vlabel(rm), edges[eidx].prop,
                     _vlabel(other), direction)
                ext.append((t, eidx, None))
        for v in reversed(rightmost_path):  # forward edges
            for eidx, other, direction in adj.get(v, []):
                if eidx in used or other in disc:
                    continue
                t = (disc[v], len(disc), _vlabel(v), edges[eidx].prop,
                     _vlabel(other), direction)
                ext.append((t, eidx, other))
        if not ext:
            return
        tmin = min(t for t, _, _ in ext)
        for t, eidx, newv in ext:
            if t != tmin and not has_loop:
                continue
            code.append(t)
            if newv is not None:
                disc2 = dict(disc)
                disc2[newv] = len(disc)
                src_disc = t[0]
                # new rightmost path: prefix of old path up to src + newv
                idx = next(i for i, u in enumerate(rightmost_path)
                           if disc[u] == src_disc)
                rmp2 = rightmost_path[: idx + 1] + [newv]
                rec(code, disc2, used | {eidx}, rmp2)
            else:
                rec(code, disc, used | {eidx}, rightmost_path)
            code.pop()

    for start in set([e.src for e in edges] + [e.dst for e in edges]):
        rec([], {start: 0}, frozenset(), [start])
    if best[0] is None:
        raise RuntimeError("canonical DFS-code search found no code "
                           "(disconnected or malformed pattern?)")
    return best[0]


# ======================================================================
# Subgraph isomorphism (pattern -> query), VF2-style backtracking
# ======================================================================

def _props_compatible(pat_prop: int, q_prop: int) -> bool:
    return pat_prop == q_prop


def is_subgraph_of(pattern: QueryGraph, query: QueryGraph,
                   induced: bool = False) -> bool:
    """use(Q, p) (Def. 7): is ``pattern`` edge-subgraph-isomorphic to
    ``query``?  Vertices of both are variables (normalized); edge labels
    (properties) must match exactly; direction respected.  Injective on
    vertices AND edges."""
    return find_embedding(pattern, query) is not None


def find_embedding(pattern: QueryGraph, query: QueryGraph) -> Optional[Dict[int, int]]:
    pe = pattern.edges
    if len(pe) > len(query.edges):
        return None
    qe = query.edges
    # order pattern edges for connectivity (DFS over pattern)
    order = _connected_edge_order(pattern)
    used_q: List[Optional[int]] = [None] * len(pe)

    def rec(k: int, vmap: Dict[int, int], used: FrozenSet[int]) -> Optional[Dict[int, int]]:
        if k == len(order):
            return dict(vmap)
        pidx = order[k]
        p_edge = pe[pidx]
        for qidx, q_edge in enumerate(qe):
            if qidx in used or not _props_compatible(p_edge.prop, q_edge.prop):
                continue
            ms, md = vmap.get(p_edge.src), vmap.get(p_edge.dst)
            if ms is not None and ms != q_edge.src:
                continue
            if md is not None and md != q_edge.dst:
                continue
            vmap2 = dict(vmap)
            if ms is None:
                # injective vertex mapping
                if q_edge.src in vmap2.values():
                    continue
                vmap2[p_edge.src] = q_edge.src
            if vmap2.get(p_edge.dst) is None:
                if q_edge.dst in vmap2.values():
                    continue
                vmap2[p_edge.dst] = q_edge.dst
            elif vmap2[p_edge.dst] != q_edge.dst:
                continue
            r = rec(k + 1, vmap2, used | {qidx})
            if r is not None:
                return r
        return None

    return rec(0, {}, frozenset())


def _connected_edge_order(g: QueryGraph) -> List[int]:
    """Order edge indices so every prefix is connected (first edge free)."""
    edges = g.edges
    if not edges:
        return []
    order = [0]
    bound = {edges[0].src, edges[0].dst}
    remaining = set(range(1, len(edges)))
    while remaining:
        nxt = None
        for i in remaining:
            if edges[i].src in bound or edges[i].dst in bound:
                nxt = i
                break
        if nxt is None:  # disconnected -- just append
            nxt = next(iter(remaining))
        order.append(nxt)
        bound.add(edges[nxt].src)
        bound.add(edges[nxt].dst)
        remaining.remove(nxt)
    return order


def all_embeddings(pattern: QueryGraph, query: QueryGraph) -> List[Dict[int, int]]:
    """All injective embeddings of pattern into query (for mining growth)."""
    pe = pattern.edges
    qe = query.edges
    order = _connected_edge_order(pattern)
    out: List[Dict[int, int]] = []

    def rec(k: int, vmap: Dict[int, int], used: FrozenSet[int]) -> None:
        if k == len(order):
            out.append(dict(vmap))
            return
        pidx = order[k]
        p_edge = pe[pidx]
        for qidx, q_edge in enumerate(qe):
            if qidx in used or not _props_compatible(p_edge.prop, q_edge.prop):
                continue
            ms, md = vmap.get(p_edge.src), vmap.get(p_edge.dst)
            if ms is not None and ms != q_edge.src:
                continue
            if md is not None and md != q_edge.dst:
                continue
            vmap2 = dict(vmap)
            if ms is None:
                if q_edge.src in vmap2.values():
                    continue
                vmap2[p_edge.src] = q_edge.src
            if vmap2.get(p_edge.dst) is None:
                if q_edge.dst in vmap2.values():
                    continue
                vmap2[p_edge.dst] = q_edge.dst
            elif vmap2[p_edge.dst] != q_edge.dst:
                continue
            rec(k + 1, vmap2, used | {qidx})

    rec(0, {}, frozenset())
    return out
