"""The plain reference: basic graph patterns over the whole graph in
NumPy.

``GraphIndex`` sorts each property's edges by subject and by object;
``match`` answers a query as the distinct rows of its variables, in
sorted variable order, by joining one edge at a time onto a table of
bindings (an edge whose ends are both bound filters the table, one with
one bound end expands it through the sorted index).  ``pattern_peak``
counts, without listing them, the matches of every connected part of a
tree-shaped query, the most that any binding table of an exact engine
must hold.  It imports nothing of the program.
"""
from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int, int]


class GraphIndex:
    """Per-property sorted edge columns of one graph (or of one site's
    share of it)."""

    def __init__(self, s: np.ndarray, p: np.ndarray, o: np.ndarray,
                 num_vertices: int, num_properties: int):
        s = np.asarray(s, np.int64)
        p = np.asarray(p, np.int64)
        o = np.asarray(o, np.int64)
        self.num_vertices = int(num_vertices)
        self.num_properties = int(num_properties)
        by_s = np.lexsort((o, s, p))
        by_o = np.lexsort((s, o, p))
        bounds = np.searchsorted(p[by_s], np.arange(num_properties + 1))
        self._s = [(s[by_s[a:b]], o[by_s[a:b]])
                   for a, b in zip(bounds[:-1], bounds[1:])]
        self._o = [(o[by_o[a:b]], s[by_o[a:b]])
                   for a, b in zip(bounds[:-1], bounds[1:])]
        base = self.num_vertices + 1
        self._pairs = [np.sort(ks * base + vs) for ks, vs in self._s]

    def edges(self, prop: int) -> Tuple[np.ndarray, np.ndarray]:
        """(subjects, objects) of ``prop``, by subject."""
        if not 0 <= prop < self.num_properties:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return self._s[prop]

    def expand(self, prop: int, keys: np.ndarray, forward: bool
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(row of ``keys`` each match came from, the other end): the
        objects of subjects ``keys`` (``forward``) or the subjects of
        objects ``keys``."""
        if not 0 <= prop < self.num_properties:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        ks, vs = (self._s if forward else self._o)[prop]
        lo = np.searchsorted(ks, keys, "left")
        cnt = np.searchsorted(ks, keys, "right") - lo
        rows = np.repeat(np.arange(len(keys)), cnt)
        start = np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
        return rows, vs[start + np.arange(len(rows))]

    def has_pairs(self, prop: int, s: np.ndarray, o: np.ndarray
                  ) -> np.ndarray:
        """Whether each (s, o) is an edge of ``prop``."""
        if not 0 <= prop < self.num_properties:
            return np.zeros(len(s), bool)
        table = self._pairs[prop]
        key = np.asarray(s, np.int64) * (self.num_vertices + 1) + o
        pos = np.clip(np.searchsorted(table, key), 0, max(len(table) - 1, 0))
        return (table[pos] == key) if len(table) else np.zeros(len(s), bool)


def _order(edges: Sequence[Edge]) -> List[int]:
    """Join order: start at an edge with a constant end where there is
    one, then take the edges that touch what is bound, those with both
    ends bound first."""
    left = list(range(len(edges)))
    start = next((i for i in left if edges[i][0] >= 0 or edges[i][1] >= 0),
                 0)
    order = [start]
    left.remove(start)
    bound = {v for v in edges[start][:2]}
    while left:
        both = [i for i in left
                if edges[i][0] in bound and edges[i][1] in bound]
        one = [i for i in left
               if edges[i][0] in bound or edges[i][1] in bound
               or edges[i][0] >= 0 or edges[i][1] >= 0]
        nxt = (both or one or left)[0]
        order.append(nxt)
        left.remove(nxt)
        bound.update(edges[nxt][:2])
    return order


def match(index: GraphIndex, edges: Sequence[Edge]
          ) -> Tuple[List[int], np.ndarray]:
    """(variables in sorted order, distinct rows of their bindings) of
    the query ``edges`` over ``index``'s graph."""
    edges = [tuple(int(x) for x in e) for e in edges]
    cols: Dict[int, np.ndarray] = {}
    n = 1                      # rows of the table (one empty row to start)

    def value(v: int, rows_n: int) -> np.ndarray:
        return cols[v] if v < 0 else np.full(rows_n, v, np.int64)

    for i in _order(edges):
        s, d, prop = edges[i]
        s_known = s >= 0 or s in cols
        d_known = d >= 0 or d in cols
        if s_known and d_known:
            keep = index.has_pairs(prop, value(s, n), value(d, n))
            if s < 0 and s == d:
                keep &= True
            cols = {v: c[keep] for v, c in cols.items()}
            n = int(keep.sum())
        elif s_known or d_known:
            rows, other = index.expand(prop, value(s if s_known else d, n),
                                       forward=s_known)
            cols = {v: c[rows] for v, c in cols.items()}
            cols[d if s_known else s] = other
            n = len(rows)
        else:
            es, eo = index.edges(prop)
            if s == d:
                sel = es == eo
                es, eo = es[sel], eo[sel]
            rows = np.repeat(np.arange(n), len(es))
            cols = {v: c[rows] for v, c in cols.items()}
            cols[s] = np.tile(es, n)
            if d != s:
                cols[d] = np.tile(eo, n)
            n = len(rows)
        if n == 0:
            break
    variables = sorted(v for e in edges for v in e[:2] if v < 0)
    variables = sorted(set(variables))
    if n == 0:
        return variables, np.zeros((0, len(variables)), np.int64)
    rows = np.stack([cols[v] for v in variables], 1)
    return variables, np.unique(rows, axis=0)


def rows_of(bindings: Dict[int, np.ndarray]) -> Tuple[List[int], np.ndarray]:
    """(variables in sorted order, distinct rows) of an answer given as
    variable -> column."""
    variables = sorted(int(v) for v in bindings)
    if not variables:
        return variables, np.zeros((0, 0), np.int64)
    rows = np.stack([np.asarray(bindings[v], np.int64) for v in variables],
                    1)
    return variables, (np.unique(rows, axis=0) if len(rows) else
                       rows.reshape(0, len(variables)))


def same_answer(a: Tuple[List[int], np.ndarray],
                b: Tuple[List[int], np.ndarray]) -> bool:
    """Equal variables and equal sets of rows."""
    return a[0] == b[0] and a[1].shape == b[1].shape \
        and bool(np.array_equal(a[1], b[1]))


def normalized(edges: Sequence[Edge]) -> Tuple[Edge, ...]:
    """The query with every constant replaced by a fresh variable, in
    edge order: the pattern an engine that filters constants last must
    hold."""
    names: Dict[int, int] = {}
    out = []
    for s, d, p in edges:
        for v in (s, d):
            if v not in names:
                names[v] = -(len(names) + 1)
        out.append((names[s], names[d], p))
    return tuple(out)


def _tree_count(index: GraphIndex, edges: Sequence[Edge]) -> Optional[float]:
    """Matches of a connected, constant-free query whose edges form a
    tree (no cycle, no self-loop), counted by passing counts from the
    leaves to a root; ``None`` for any other shape."""
    vs = sorted({v for e in edges for v in e[:2]})
    if any(s == d for s, d, _ in edges) or len(edges) != len(vs) - 1:
        return None
    adj: Dict[int, List[Tuple[int, int, bool]]] = {v: [] for v in vs}
    for i, (s, d, _p) in enumerate(edges):
        adj[s].append((i, d, True))
        adj[d].append((i, s, False))
    nv = index.num_vertices

    def down(v: int, parent_edge: int) -> np.ndarray:
        f = np.ones(nv, np.float64)
        for i, w, forward in adj[v]:
            if i == parent_edge:
                continue
            g = down(w, i)
            es, eo = index.edges(edges[i][2])
            near, far = (es, eo) if forward else (eo, es)
            f *= np.bincount(near, weights=g[far], minlength=nv)[:nv]
        return f

    return float(down(vs[0], -1).sum())


def pattern_peak(index: GraphIndex, edges: Sequence[Edge]
                 ) -> Optional[float]:
    """The largest match count over the connected parts of the
    normalized query (each non-empty connected subset of its edges):
    an exact engine whose binding tables hold ``cap`` rows can answer
    the query whenever this is at most ``cap``.  ``None`` when a part
    is not a tree."""
    norm = normalized(edges)
    best = 0.0
    for k in range(1, len(norm) + 1):
        for subset in combinations(norm, k):
            vs = {v for e in subset for v in e[:2]}
            if not _connected(subset, vs):
                continue
            c = _tree_count(index, subset)
            if c is None:
                return None
            best = max(best, c)
    return best


def _connected(edges: Sequence[Edge], vs: set) -> bool:
    seen = {next(iter(vs))}
    grew = True
    while grew:
        grew = False
        for s, d, _p in edges:
            if (s in seen) != (d in seen):
                seen.update((s, d))
                grew = True
    return seen == vs
