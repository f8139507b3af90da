"""The benchmark's frozen WatDiv-like generators.

A copy of the program's graph and query generators, kept here so that a
later change to the program cannot move the yardstick: the graph
(``generate_watdiv``), the 13 L/S/F/C templates (``watdiv_templates``),
the design workload (``generate_workload``) and the class-weighted
template popularity (``class_template_probs``) reproduce the program's
at the same arguments (``tests/test_rdfbench_generators.py``).  A query
is a tuple of ``(src, dst, prop)`` edges; ids >= 0 are constants, < 0
variables.  Nothing here imports the program.

The benchmark's own: ``relabel`` maps a graph and its queries through a
permutation of the vertices, so that every seed serves the same graph
in another order; ``stratified_queries`` is the request stream: each
block of requests holds every template, cold property, bound variable
and checked share in fixed counts (the largest remainders of its
shares), shuffled by the seed, and each bound variable takes a constant
drawn uniformly from ``positions``: the vertices that take that
variable's place in some match of the template in the data, as WatDiv's
query generator fills a placeholder from the entities that fit it.  The
constants are drawn apart from the seed, so every seed sends the same
requests in another order, and every bound request has an answer.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int, int]
Query = Tuple[Edge, ...]

PROPERTIES = ["follows", "likes", "purchased", "makesReview", "reviewOf",
              "rating", "sells", "homepage", "hasGenre", "language",
              "locatedIn", "cityOf", "friendOf", "dislikes", "caption", "tag"]
PROP = {name: i for i, name in enumerate(PROPERTIES)}
COLD_PROPS = (PROP["dislikes"], PROP["caption"], PROP["tag"])
TEMPLATE_CLASS = ["L", "L", "L", "S", "S", "S", "S", "F", "F", "C", "C",
                  "S", "S"]


def V(i: int) -> int:
    """Variable ``i`` (``V(0) = -1``)."""
    return -(i + 1)


def schema(scale: int) -> Tuple[List[int], List[Tuple[str, int, int, float]]]:
    """(class sizes, properties as (name, source class, destination
    class, mean out-degree)) of the e-commerce schema: users, products,
    retailers, reviews, cities, genres, websites, languages."""
    sizes = [scale, scale // 2, max(scale // 20, 4), scale,
             max(scale // 50, 4), max(scale // 100, 4), max(scale // 20, 4),
             max(scale // 200, 2)]
    props = [("follows", 0, 0, 2.0), ("likes", 0, 1, 3.0),
             ("purchased", 0, 1, 1.5), ("makesReview", 0, 3, 1.0),
             ("reviewOf", 3, 1, 1.0), ("rating", 3, 5, 1.0),
             ("sells", 2, 1, 8.0), ("homepage", 2, 6, 1.0),
             ("hasGenre", 1, 5, 1.5), ("language", 1, 7, 1.0),
             ("locatedIn", 0, 4, 1.0), ("cityOf", 4, 4, 0.5),
             ("friendOf", 0, 0, 1.0), ("dislikes", 0, 1, 0.5),
             ("caption", 1, 6, 0.3), ("tag", 3, 5, 0.4)]
    return sizes, props


def generate_watdiv(num_triples: int, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """(s, p, o, num_vertices, num_properties) of a WatDiv-like graph of
    about ``num_triples`` drawn triples, exact duplicates removed.
    Entities lie class-major; each property joins its classes with
    Zipf(1.7) object popularity."""
    sizes, props = schema(max(num_triples // 12, 64))
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    nv = int(offsets[-1])
    total_mean = sum(sizes[sc] * deg for _, sc, _, deg in props)
    scale_fix = num_triples / max(total_mean, 1)
    ss, pp, oo = [], [], []
    for pid, (_name, sc, dc, deg) in enumerate(props):
        n_src, n_dst = sizes[sc], sizes[dc]
        n_edges = int(n_src * deg * scale_fix)
        if n_edges <= 0:
            continue
        src = rng.integers(offsets[sc], offsets[sc] + n_src, size=n_edges)
        ranks = rng.zipf(1.7, size=n_edges) % n_dst
        ss.append(src)
        pp.append(np.full(n_edges, pid, dtype=np.int64))
        oo.append(offsets[dc] + ranks)
    s, p, o = np.concatenate(ss), np.concatenate(pp), np.concatenate(oo)
    key = (p * (nv + 1) + s) * (nv + 1) + o
    _, keep = np.unique(key, return_index=True)
    keep.sort()
    return (s[keep].astype(np.int32), p[keep].astype(np.int32),
            o[keep].astype(np.int32), nv, len(props))


def watdiv_templates() -> List[Query]:
    """The 13 templates: linear paths, stars, snowflakes, complex shapes
    and two single-edge lookups (``TEMPLATE_CLASS`` gives each one's
    class)."""
    P = PROP
    return [
        ((V(0), V(1), P["follows"]), (V(1), V(2), P["likes"])),
        ((V(0), V(1), P["purchased"]), (V(1), V(2), P["hasGenre"])),
        ((V(0), V(1), P["makesReview"]), (V(1), V(2), P["reviewOf"]),
         (V(2), V(3), P["hasGenre"])),
        ((V(0), V(1), P["likes"]), (V(0), V(2), P["locatedIn"])),
        ((V(0), V(1), P["sells"]), (V(0), V(2), P["homepage"])),
        ((V(0), V(1), P["likes"]), (V(0), V(2), P["purchased"]),
         (V(0), V(3), P["follows"])),
        ((V(0), V(1), P["hasGenre"]), (V(0), V(2), P["language"])),
        ((V(0), V(1), P["makesReview"]), (V(1), V(2), P["reviewOf"]),
         (V(2), V(3), P["hasGenre"]), (V(2), V(4), P["language"])),
        ((V(0), V(1), P["sells"]), (V(1), V(2), P["hasGenre"]),
         (V(0), V(3), P["homepage"])),
        ((V(0), V(1), P["follows"]), (V(1), V(2), P["likes"]),
         (V(0), V(3), P["likes"]), (V(3), V(4), P["hasGenre"]),
         (V(2), V(5), P["hasGenre"])),
        ((V(0), V(1), P["purchased"]), (V(1), V(2), P["hasGenre"]),
         (V(3), V(1), P["sells"]), (V(3), V(4), P["homepage"])),
        ((V(0), V(1), P["likes"]),),
        ((V(0), V(1), P["follows"]),),
    ]


def variables(query: Query) -> List[int]:
    """The query's variables in edge order."""
    out: List[int] = []
    for s, d, _p in query:
        for v in (s, d):
            if v < 0 and v not in out:
                out.append(v)
    return out


def zipf_probs(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def class_template_probs(class_weights: Dict[str, float],
                         base: float = 0.05) -> np.ndarray:
    """Template probabilities from structural-class weights; every
    template keeps the floor weight ``base``."""
    w = np.array([base + class_weights.get(c, 0.0) for c in TEMPLATE_CLASS],
                 dtype=np.float64)
    return w / w.sum()


def _bind(tmpl: Query, rng: np.random.Generator,
          const_pool: np.ndarray) -> Query:
    """``tmpl`` with one variable, drawn uniformly, bound to a constant
    drawn Zipf(1.8) from ``const_pool``."""
    vs = variables(tmpl)
    var = int(vs[int(rng.integers(0, len(vs)))])
    cst = int(const_pool[int(rng.zipf(1.8)) % len(const_pool)])
    return tuple((cst if s == var else s, cst if d == var else d, p)
                 for s, d, p in tmpl)


def generate_workload(nv: int, num_queries: int, seed: int = 0,
                      zipf_a: float = 1.3, cold_fraction: float = 0.03,
                      constant_fraction: float = 0.5,
                      template_probs: Optional[Sequence[float]] = None
                      ) -> Tuple[List[Query], List[int]]:
    """(queries, template ids, -1 for a cold lookup) drawn as the
    program's ``generate_workload`` draws them over a graph of ``nv``
    vertices."""
    templates = watdiv_templates()
    rng = np.random.default_rng(seed)
    pops = (zipf_probs(len(templates), zipf_a) if template_probs is None
            else np.asarray(template_probs, np.float64)
            / np.sum(template_probs))
    const_pool = rng.integers(0, nv, size=32)
    queries: List[Query] = []
    tids: List[int] = []
    for _ in range(num_queries):
        if rng.random() < cold_fraction:
            queries.append(((V(0), V(1), int(rng.choice(COLD_PROPS))),))
            tids.append(-1)
            continue
        ti = int(rng.choice(len(templates), p=pops))
        q = templates[ti]
        if rng.random() < constant_fraction:
            q = _bind(q, rng, const_pool)
        queries.append(q)
        tids.append(ti)
    return queries, tids


def relabel(perm: np.ndarray, s: np.ndarray, o: np.ndarray,
            queries: Sequence[Query]
            ) -> Tuple[np.ndarray, np.ndarray, List[Query]]:
    """The graph's subjects and objects and the queries' constants under
    the vertex relabelling ``perm``: an isomorphic copy, whose every
    match count, degree and answer size is the original's."""
    def v(x: int) -> int:
        return int(perm[x]) if x >= 0 else x
    return (perm[s], perm[o],
            [tuple((v(a), v(b), q) for a, b, q in e) for e in queries])


def largest_remainder(shares: np.ndarray, n: int) -> np.ndarray:
    """Whole counts summing to ``n`` in proportion to ``shares``."""
    exact = np.asarray(shares, np.float64) / np.sum(shares) * n
    counts = np.floor(exact).astype(np.int64)
    short = n - int(counts.sum())
    if short:
        counts[np.argsort(-(exact - counts), kind="stable")[:short]] += 1
    return counts


def category_shares(template_probs: np.ndarray, cold_fraction: float
                    ) -> np.ndarray:
    """Shares of the categories of a stream: the templates, then each
    cold property alike."""
    cold = np.full(len(COLD_PROPS), cold_fraction / len(COLD_PROPS))
    return np.concatenate([(1.0 - cold_fraction) * template_probs, cold])


def positions(s: np.ndarray, p: np.ndarray, o: np.ndarray, nv: int,
              templates: Sequence[Query]) -> List[Dict[int, np.ndarray]]:
    """For each template, each variable's vertices that take its place
    in at least one match over the graph (s, p, o): the arc-consistent
    domains, exact for the templates' tree shapes."""
    s = np.asarray(s, np.int64)
    o = np.asarray(o, np.int64)
    order = np.argsort(p, kind="stable")
    bounds = np.searchsorted(np.asarray(p)[order],
                             np.arange(int(np.max(p, initial=-1)) + 2))
    by_prop = [(s[order[a:b]], o[order[a:b]])
               for a, b in zip(bounds[:-1], bounds[1:])]
    out: List[Dict[int, np.ndarray]] = []
    for tmpl in templates:
        dom = {v: np.ones(nv, dtype=bool) for v in variables(tmpl)}
        changed = True
        while changed:
            changed = False
            for a, b, prop in tmpl:
                es, eo = (by_prop[prop] if prop < len(by_prop) else
                          (np.zeros(0, np.int64), np.zeros(0, np.int64)))
                live = dom[a][es] & dom[b][eo]
                for v, ends in ((a, es), (b, eo)):
                    seen = np.zeros(nv, dtype=bool)
                    seen[ends[live]] = True
                    new = dom[v] & seen
                    if new.sum() != dom[v].sum():
                        dom[v] = new
                        changed = True
        out.append({v: np.flatnonzero(m) for v, m in dom.items()})
    return out


def stratified_queries(domains: Sequence[Dict[int, np.ndarray]],
                       rng: np.random.Generator,
                       template_probs: np.ndarray, cold_fraction: float,
                       constant_fraction: float, block: int,
                       check_share: float = 0.0, bind_seed: int = 0,
                       label: Optional[np.ndarray] = None
                       ) -> Iterator[Tuple[Query, int, bool]]:
    """Endless stream of (query, template id or -1, checked): blocks of
    ``block`` requests, each with the categories of ``category_shares``
    in fixed counts; of each template's requests a fixed share bound to
    one constant, its variables bound in turn, and of each category's a
    fixed share, at least one, marked for checking when ``check_share``
    > 0.  Block ``b``'s constants are drawn from ``bind_seed`` and ``b``
    alone, uniformly from each variable's ``domains`` (``positions``),
    and served as ``label[constant]``: every ``rng`` sends the same
    requests, in another order and with others checked.  A variable
    with an empty domain (no match in the data) leaves its requests
    unbound."""
    templates = watdiv_templates()
    n_t = len(templates)
    counts = largest_remainder(
        category_shares(np.asarray(template_probs, np.float64),
                        cold_fraction), block)
    cats = np.repeat(np.arange(len(counts)), counts)
    b = 0
    while True:
        brng = np.random.default_rng([int(bind_seed), b])
        b += 1
        binds: List[List[Query]] = []
        for c in range(n_t):
            vs = variables(templates[c])
            qs = []
            for j in range(int(round(counts[c] * constant_fraction))):
                var = vs[j % len(vs)]
                dom = domains[c][var]
                if not len(dom):
                    continue
                cst = int(dom[int(brng.integers(0, len(dom)))])
                cst = int(label[cst]) if label is not None else cst
                qs.append(tuple((cst if x == var else x,
                                 cst if y == var else y, prop)
                                for x, y, prop in templates[c]))
            binds.append(qs)
        order = rng.permutation(block)
        check = np.zeros(block, dtype=bool)
        if check_share > 0:
            for c, n in enumerate(counts):
                if n > 0:
                    pos = np.flatnonzero(cats[order] == c)
                    k = max(1, int(round(n * check_share)))
                    check[rng.choice(pos, size=k, replace=False)] = True
        seen = np.zeros(n_t, dtype=np.int64)
        for k, c in enumerate(cats[order]):
            c = int(c)
            if c >= n_t:
                yield ((V(0), V(1), COLD_PROPS[c - n_t]),), -1, bool(check[k])
                continue
            j = int(seen[c])
            seen[c] += 1
            q = binds[c][j] if j < len(binds[c]) else templates[c]
            yield q, c, bool(check[k])
