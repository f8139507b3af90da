"""RDF graph substrate: dictionary-encoded tensor edge tables.

The paper (Def. 1) models RDF data as a directed edge-labeled graph
G = (V, E, L).  We store G as three parallel int32 arrays (s, p, o) --
one row per triple -- plus a CSR-style index grouped by property, which
is the access path every algorithm in the paper uses ("give me all edges
with property p").  Predicate partitions are dense sorted tables that
the GPU join kernels binary-search, in place of gStore's VS-tree.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..constants import MAX_PROPERTY_ID, MAX_VERTEX_ID


@dataclasses.dataclass
class RDFGraph:
    """Dictionary-encoded RDF graph.

    s, p, o: int32 arrays of equal length (one entry per triple/edge).
    num_vertices / num_properties: sizes of the id spaces.
    vertex_names / property_names: optional decoded terms (tests, demos).
    """

    s: np.ndarray
    p: np.ndarray
    o: np.ndarray
    num_vertices: int
    num_properties: int
    vertex_names: Optional[List[str]] = None
    property_names: Optional[List[str]] = None

    # --- derived indexes (built lazily) ---
    _prop_order: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    _prop_offsets: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    _triple_key_order: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.s = np.asarray(self.s, dtype=np.int32)
        self.p = np.asarray(self.p, dtype=np.int32)
        self.o = np.asarray(self.o, dtype=np.int32)
        if not (len(self.s) == len(self.p) == len(self.o)):
            raise ValueError("s/p/o must have equal length")
        # Sentinel-collision guard: the blocked-join machinery pads key
        # columns with INT32_MAX and row padding with -1, which is only
        # sound while every real id stays inside the documented 21-bit
        # bound.  Reject out-of-range ids here -- at or near the
        # sentinel they would silently corrupt semijoin masks and edge
        # tables instead of failing.
        for name, arr, hi in (("s", self.s, MAX_VERTEX_ID),
                              ("o", self.o, MAX_VERTEX_ID),
                              ("p", self.p, MAX_PROPERTY_ID)):
            if arr.size and (int(arr.min()) < 0 or int(arr.max()) > hi):
                raise ValueError(
                    f"RDFGraph.{name} ids must lie in [0, {hi}] (21-bit "
                    f"id space; got range [{int(arr.min())}, "
                    f"{int(arr.max())}]): ids beyond the bound can "
                    f"collide with the INT32_MAX/-1 pad sentinels of "
                    f"the blocked join kernels")

    # ------------------------------------------------------------------
    @property
    def num_edges(self) -> int:
        return int(len(self.s))

    def _build_prop_index(self) -> None:
        if self._prop_order is not None:
            return
        # Sort edge ids by (p, s, o) so each property's edges are contiguous
        # and sorted by subject -- enables searchsorted joins.
        order = np.lexsort((self.o, self.s, self.p))
        self._prop_order = order.astype(np.int64)
        counts = np.bincount(self.p, minlength=self.num_properties)
        self._prop_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def edges_with_property(self, pid: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (edge_ids, subjects, objects) for property ``pid``.

        subjects are sorted ascending (ties broken by object).
        """
        self._build_prop_index()
        lo = self._prop_offsets[pid]
        hi = self._prop_offsets[pid + 1]
        eids = self._prop_order[lo:hi]
        return eids, self.s[eids], self.o[eids]

    def property_counts(self) -> np.ndarray:
        return np.bincount(self.p, minlength=self.num_properties)

    # ------------------------------------------------------------------
    def edge_ids_for_triples(self, s: np.ndarray, p: np.ndarray, o: np.ndarray) -> np.ndarray:
        """Map (s,p,o) triples back to edge ids (first matching row).

        Used by fragmentation to turn pattern-match bindings into edge-id
        sets.  Triples not present map to -1.
        """
        self._build_prop_index()
        if self._triple_key_order is None:
            key = (self.p.astype(np.int64) * (self.num_vertices + 1) + self.s.astype(np.int64)
                   ) * (self.num_vertices + 1) + self.o.astype(np.int64)
            order = np.argsort(key, kind="stable")
            self._triple_key_order = order
            self._triple_key_sorted = key[order]
        qkey = (np.asarray(p, np.int64) * (self.num_vertices + 1) + np.asarray(s, np.int64)
                ) * (self.num_vertices + 1) + np.asarray(o, np.int64)
        pos = np.searchsorted(self._triple_key_sorted, qkey)
        pos = np.clip(pos, 0, len(self._triple_key_sorted) - 1)
        found = self._triple_key_sorted[pos] == qkey
        eids = np.where(found, self._triple_key_order[pos], -1)
        return eids.astype(np.int64)

    # ------------------------------------------------------------------
    def hot_cold_split(self, frequent_props: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Def. 5/6: split edge ids into (hot, cold) by property frequency."""
        mask = np.zeros(self.num_properties, dtype=bool)
        mask[np.asarray(list(frequent_props), dtype=np.int64)] = True
        hot = np.nonzero(mask[self.p])[0]
        cold = np.nonzero(~mask[self.p])[0]
        return hot, cold

    # ------------------------------------------------------------------
    def subgraph(self, edge_ids: np.ndarray) -> "RDFGraph":
        edge_ids = np.asarray(edge_ids, dtype=np.int64)
        return RDFGraph(
            s=self.s[edge_ids], p=self.p[edge_ids], o=self.o[edge_ids],
            num_vertices=self.num_vertices, num_properties=self.num_properties,
            vertex_names=self.vertex_names, property_names=self.property_names,
        )

    # ------------------------------------------------------------------
    def apply_delta(self, added_edges: Optional[Sequence] = None,
                    removed_edges: Optional[Sequence] = None) -> "RDFGraph":
        """Return a new graph with ``removed_edges`` dropped and
        ``added_edges`` appended (streaming ingestion, RDF set
        semantics).

        Both arguments are (s, p, o) triples -- any array-like of shape
        (n, 3).  Removals match by value; triples not present are
        ignored.  Additions are deduped against the survivors and each
        other (a graph is a *set* of triples) and appended after all
        surviving edges, so surviving edges keep their relative order
        and added edges occupy the id tail -- the property the delta
        fragment materializer relies on.  The vertex id space grows to
        cover new ids; property ids must already be in range (the
        property universe is plan state, not delta state).
        """
        def _cols(edges):
            arr = np.asarray(edges, dtype=np.int64)
            if arr.size == 0:
                return (np.empty(0, np.int64),) * 3
            arr = arr.reshape(-1, 3)
            return arr[:, 0], arr[:, 1], arr[:, 2]

        a_s, a_p, a_o = _cols(added_edges if added_edges is not None else [])
        r_s, r_p, r_o = _cols(removed_edges if removed_edges is not None
                              else [])
        if a_p.size and (a_p.min() < 0 or a_p.max() >= self.num_properties):
            raise ValueError(
                f"added property ids must lie in [0, "
                f"{self.num_properties - 1}]: the property universe is "
                f"fixed plan state (got range [{int(a_p.min())}, "
                f"{int(a_p.max())}])")
        num_vertices = self.num_vertices
        for col in (a_s, a_o):
            if col.size:
                num_vertices = max(num_vertices, int(col.max()) + 1)

        base = np.int64(num_vertices + 1)

        def _key(s, p, o):
            return (np.asarray(p, np.int64) * base
                    + np.asarray(s, np.int64)) * base + np.asarray(o,
                                                                   np.int64)

        keep = np.ones(self.num_edges, dtype=bool)
        if r_s.size:
            keep &= ~np.isin(_key(self.s, self.p, self.o),
                             _key(r_s, r_p, r_o))
        s, p, o = self.s[keep], self.p[keep], self.o[keep]
        if a_s.size:
            akey = _key(a_s, a_p, a_o)
            _, first = np.unique(akey, return_index=True)
            first.sort()
            fresh = ~np.isin(akey[first], _key(s, p, o))
            first = first[fresh]
            s = np.concatenate([s, a_s[first].astype(np.int32)])
            p = np.concatenate([p, a_p[first].astype(np.int32)])
            o = np.concatenate([o, a_o[first].astype(np.int32)])
        return RDFGraph(s, p, o, num_vertices, self.num_properties,
                        self.vertex_names, self.property_names)


# ======================================================================
# Dataset generators
# ======================================================================

def example_graph() -> RDFGraph:
    """A small graph in the spirit of the paper's Fig. 1 running example
    (philosophers, books, influences).  Used by unit tests and docs."""
    V = ["Aristotle", "Plato", "Socrates", "Ethics", "Politics", "Republic",
         "Philosopher", "Book", "Stagira", "Athens", "Greece", "img1", "tpl1",
         "Kant", "Critique", "Hegel"]
    P = ["type", "influencedBy", "author", "mainInterest", "birthPlace",
         "country", "imageSkyline", "wikiPageUsesTemplate", "notableIdea"]
    vi = {v: i for i, v in enumerate(V)}
    pi = {p: i for i, p in enumerate(P)}
    triples = [
        ("Aristotle", "type", "Philosopher"),
        ("Plato", "type", "Philosopher"),
        ("Socrates", "type", "Philosopher"),
        ("Kant", "type", "Philosopher"),
        ("Hegel", "type", "Philosopher"),
        ("Ethics", "type", "Book"),
        ("Politics", "type", "Book"),
        ("Republic", "type", "Book"),
        ("Critique", "type", "Book"),
        ("Aristotle", "influencedBy", "Plato"),
        ("Plato", "influencedBy", "Socrates"),
        ("Kant", "influencedBy", "Aristotle"),
        ("Hegel", "influencedBy", "Kant"),
        ("Aristotle", "author", "Ethics"),
        ("Aristotle", "author", "Politics"),
        ("Plato", "author", "Republic"),
        ("Kant", "author", "Critique"),
        ("Aristotle", "mainInterest", "Ethics"),
        ("Aristotle", "birthPlace", "Stagira"),
        ("Plato", "birthPlace", "Athens"),
        ("Stagira", "country", "Greece"),
        ("Athens", "country", "Greece"),
        ("Athens", "imageSkyline", "img1"),
        ("Aristotle", "wikiPageUsesTemplate", "tpl1"),
        ("Plato", "notableIdea", "Republic"),
    ]
    s = np.array([vi[a] for a, _, _ in triples], np.int32)
    p = np.array([pi[b] for _, b, _ in triples], np.int32)
    o = np.array([vi[c] for _, _, c in triples], np.int32)
    return RDFGraph(s, p, o, len(V), len(P), V, P)


@dataclasses.dataclass
class WatDivSchema:
    """Schema of the WatDiv-like generator: entity classes and properties
    with (src_class, dst_class, out_degree distribution)."""
    classes: List[str]
    class_sizes: List[int]
    properties: List[Tuple[str, int, int, float]]  # name, src_cls, dst_cls, mean out-degree


def default_watdiv_schema(scale: int = 1000) -> WatDivSchema:
    """WatDiv models an e-commerce domain: users, products, retailers,
    reviews, ... We mirror its flavor (typed entities, star+path shapes,
    correlated attributes)."""
    classes = ["User", "Product", "Retailer", "Review", "City", "Genre",
               "Website", "Language"]
    sizes = [scale, scale // 2, max(scale // 20, 4), scale,
             max(scale // 50, 4), max(scale // 100, 4), max(scale // 20, 4),
             max(scale // 200, 2)]
    props = [
        ("follows",      0, 0, 2.0),
        ("likes",        0, 1, 3.0),
        ("purchased",    0, 1, 1.5),
        ("makesReview",  0, 3, 1.0),
        ("reviewOf",     3, 1, 1.0),
        ("rating",       3, 5, 1.0),   # rating -> Genre ids reused as grades
        ("sells",        2, 1, 8.0),
        ("homepage",     2, 6, 1.0),
        ("hasGenre",     1, 5, 1.5),
        ("language",     1, 7, 1.0),
        ("locatedIn",    0, 4, 1.0),
        ("cityOf",       4, 4, 0.5),
        ("friendOf",     0, 0, 1.0),
        ("dislikes",     0, 1, 0.5),   # infrequent in workloads -> cold
        ("caption",      1, 6, 0.3),   # cold
        ("tag",          3, 5, 0.4),   # cold
    ]
    return WatDivSchema(classes, sizes, props)


def generate_watdiv(num_triples: int, seed: int = 0,
                    schema: Optional[WatDivSchema] = None) -> RDFGraph:
    """Generate a WatDiv-like RDF graph with ~num_triples triples.

    Entities are laid out class-major; property edges connect classes per
    the schema with Zipf-ish in-degree on destinations (real RDF data has
    heavy-tailed degree distributions -- this drives the paper's
    redundancy/scalability behaviour).
    """
    if schema is None:
        schema = default_watdiv_schema(scale=max(num_triples // 12, 64))
    rng = np.random.default_rng(seed)

    # vertex id layout: class-major blocks
    offsets = np.concatenate([[0], np.cumsum(schema.class_sizes)]).astype(np.int64)
    num_vertices = int(offsets[-1])

    total_mean = sum(schema.class_sizes[sc] * deg for _, sc, _, deg in schema.properties)
    scale_fix = num_triples / max(total_mean, 1)

    ss, pp, oo = [], [], []
    for pid, (name, sc, dc, deg) in enumerate(schema.properties):
        n_src = schema.class_sizes[sc]
        n_dst = schema.class_sizes[dc]
        n_edges = int(n_src * deg * scale_fix)
        if n_edges <= 0:
            continue
        src = rng.integers(offsets[sc], offsets[sc] + n_src, size=n_edges)
        # zipf-ish destination popularity
        ranks = rng.zipf(1.7, size=n_edges) % n_dst
        dst = offsets[dc] + ranks
        ss.append(src)
        pp.append(np.full(n_edges, pid, dtype=np.int64))
        oo.append(dst)

    s = np.concatenate(ss)
    p = np.concatenate(pp)
    o = np.concatenate(oo)
    # dedupe exact duplicate triples (RDF is a set of triples)
    key = (p * (num_vertices + 1) + s) * (num_vertices + 1) + o
    _, keep = np.unique(key, return_index=True)
    keep.sort()
    pnames = [pr[0] for pr in schema.properties]
    return RDFGraph(s[keep].astype(np.int32), p[keep].astype(np.int32),
                    o[keep].astype(np.int32), num_vertices,
                    len(schema.properties), None, pnames)
