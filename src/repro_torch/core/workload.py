"""Query workload model + WatDiv-style template-driven workload generator.

The paper's workloads: (a) the DBpedia 2012 query log (8.1M queries, 97%
isomorphic to 163 frequent patterns when minSup = 0.1%) and (b) WatDiv
template instantiations (20 templates, 2000 queries).  Neither raw asset
is available offline, so we generate workloads that reproduce the shape
statistics the paper's method keys on: a small number of structural
templates, Zipf template popularity, constants drawn from data, and a
long tail of one-off queries involving cold properties.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import RDFGraph
from .query import QueryGraph

V = lambda i: -(i + 1)  # variable helper: V(0) = -1, V(1) = -2, ...


@dataclasses.dataclass
class Workload:
    queries: List[QueryGraph]
    # template id of each query (for diagnostics; -1 = ad-hoc/cold)
    template_ids: Optional[List[int]] = None

    def __len__(self) -> int:
        return len(self.queries)

    def normalized(self) -> List[QueryGraph]:
        return [q.normalize() for q in self.queries]

    def dedup_normalized(self) -> Tuple[List[QueryGraph], np.ndarray]:
        """Unique normalized query graphs + multiplicity weights.
        Mining and selection run on the deduped set -- this is what makes
        the paper's approach tractable (97% of DBpedia queries collapse
        onto 163 shapes)."""
        uniq: Dict[Tuple, int] = {}
        reps: List[QueryGraph] = []
        weights: List[int] = []
        for q in self.queries:
            n = q.normalize()
            key = n.canonical_code()
            if key in uniq:
                weights[uniq[key]] += 1
            else:
                uniq[key] = len(reps)
                reps.append(n)
                weights.append(1)
        return reps, np.asarray(weights, dtype=np.int64)


# ----------------------------------------------------------------------
# Templates over the default WatDiv-like schema (property ids match
# graph.default_watdiv_schema ordering).
# ----------------------------------------------------------------------
PROP = {name: i for i, name in enumerate(
    ["follows", "likes", "purchased", "makesReview", "reviewOf", "rating",
     "sells", "homepage", "hasGenre", "language", "locatedIn", "cityOf",
     "friendOf", "dislikes", "caption", "tag"])}


def watdiv_templates() -> List[QueryGraph]:
    """~WatDiv's L/S/F/C classes: linear paths, stars, snowflakes, complex."""
    P = PROP
    t: List[QueryGraph] = []
    # --- linear (L) ---
    t.append(QueryGraph.make([(V(0), V(1), P["follows"]),
                              (V(1), V(2), P["likes"])]))
    t.append(QueryGraph.make([(V(0), V(1), P["purchased"]),
                              (V(1), V(2), P["hasGenre"])]))
    t.append(QueryGraph.make([(V(0), V(1), P["makesReview"]),
                              (V(1), V(2), P["reviewOf"]),
                              (V(2), V(3), P["hasGenre"])]))
    # --- star (S) ---
    t.append(QueryGraph.make([(V(0), V(1), P["likes"]),
                              (V(0), V(2), P["locatedIn"])]))
    t.append(QueryGraph.make([(V(0), V(1), P["sells"]),
                              (V(0), V(2), P["homepage"])]))
    t.append(QueryGraph.make([(V(0), V(1), P["likes"]),
                              (V(0), V(2), P["purchased"]),
                              (V(0), V(3), P["follows"])]))
    t.append(QueryGraph.make([(V(0), V(1), P["hasGenre"]),
                              (V(0), V(2), P["language"])]))
    # --- snowflake (F) ---
    t.append(QueryGraph.make([(V(0), V(1), P["makesReview"]),
                              (V(1), V(2), P["reviewOf"]),
                              (V(2), V(3), P["hasGenre"]),
                              (V(2), V(4), P["language"])]))
    t.append(QueryGraph.make([(V(0), V(1), P["sells"]),
                              (V(1), V(2), P["hasGenre"]),
                              (V(0), V(3), P["homepage"])]))
    # --- complex (C) ---
    t.append(QueryGraph.make([(V(0), V(1), P["follows"]),
                              (V(1), V(2), P["likes"]),
                              (V(0), V(3), P["likes"]),
                              (V(3), V(4), P["hasGenre"]),
                              (V(2), V(5), P["hasGenre"])]))
    t.append(QueryGraph.make([(V(0), V(1), P["purchased"]),
                              (V(1), V(2), P["hasGenre"]),
                              (V(3), V(1), P["sells"]),
                              (V(3), V(4), P["homepage"])]))
    # single-edge lookups (very frequent in real logs)
    t.append(QueryGraph.make([(V(0), V(1), P["likes"])]))
    t.append(QueryGraph.make([(V(0), V(1), P["follows"])]))
    return t


TEMPLATE_CLASS = ["L", "L", "L", "S", "S", "S", "S", "F", "F", "C", "C",
                  "S", "S"]  # structural class per template above


def make_shape_queries(next_prop, k: int = 3) -> Dict[str, QueryGraph]:
    """One star / chain / cycle query of ``k`` edges each -- the
    canonical shapes of the SPMD differential harness and the
    communication benches (one definition, so bench and tests cannot
    diverge).

    Args:
        next_prop: zero-arg callable returning the property id for the
            next edge (uniform over properties, frequency-weighted over
            edges, whatever the caller wants).
        k: edges per query (>= 2 for a meaningful cycle).

    Returns:
        ``{"star": ..., "chain": ..., "cycle": ...}``.
    """
    star = QueryGraph.make(
        [(-1, -(i + 2), next_prop()) for i in range(k)])
    chain = QueryGraph.make(
        [(-(i + 1), -(i + 2), next_prop()) for i in range(k)])
    cycle = QueryGraph.make(
        [(-(i + 1), -(i + 2), next_prop()) for i in range(k - 1)]
        + [(-k, -1, next_prop())])
    return {"star": star, "chain": chain, "cycle": cycle}


def generate_workload(graph: RDFGraph, num_queries: int, seed: int = 0,
                      templates: Optional[List[QueryGraph]] = None,
                      zipf_a: float = 1.3, cold_fraction: float = 0.03,
                      constant_fraction: float = 0.5,
                      template_probs: Optional[Sequence[float]] = None
                      ) -> Workload:
    """Instantiate templates with actual graph terms (WatDiv §8.1 style).

    - template popularity ~ Zipf (the '80/20' rule of §3), or an explicit
      ``template_probs`` vector (the drifting-workload generator below
      uses this to shift popularity mass between structural classes);
    - ``constant_fraction`` of queries bind one variable to a constant
      drawn from the data (feeds §5.2 minterm predicate mining; drawn
      Zipf so that the same constants recur across queries);
    - ``cold_fraction`` of queries touch infrequent/cold properties.
    """
    if templates is None:
        templates = watdiv_templates()
    rng = np.random.default_rng(seed)
    n_t = len(templates)
    if template_probs is not None:
        pops = np.asarray(template_probs, dtype=np.float64)
        if len(pops) != n_t:
            raise ValueError(f"template_probs has {len(pops)} entries for "
                             f"{n_t} templates")
        pops = pops / pops.sum()
    else:
        pops = 1.0 / np.arange(1, n_t + 1) ** zipf_a
        pops /= pops.sum()

    cold_props = [PROP["dislikes"], PROP["caption"], PROP["tag"]]

    queries: List[QueryGraph] = []
    tids: List[int] = []
    # popular constants per class of object position: reuse a tiny pool so
    # minterm predicates have measurable access frequencies
    const_pool = rng.integers(0, graph.num_vertices, size=32)

    for _ in range(num_queries):
        if rng.random() < cold_fraction:
            pid = int(rng.choice(cold_props))
            q = QueryGraph.make([(V(0), V(1), pid)])
            queries.append(q)
            tids.append(-1)
            continue
        ti = int(rng.choice(n_t, p=pops))
        tmpl = templates[ti]
        edges = [(e.src, e.dst, e.prop) for e in tmpl.edges]
        if rng.random() < constant_fraction:
            # bind one variable to a constant (prefer a leaf object)
            variables = tmpl.variables()
            var = int(variables[int(rng.integers(0, len(variables)))])
            cst = int(const_pool[int(rng.zipf(1.8)) % len(const_pool)])
            edges = [(cst if s == var else s, cst if d == var else d, p)
                     for s, d, p in edges]
        queries.append(QueryGraph.make(edges))
        tids.append(ti)
    return Workload(queries, tids)


def class_template_probs(class_weights: Dict[str, float],
                         base: float = 0.05) -> np.ndarray:
    """Template-probability vector from structural-class weights, e.g.
    ``{"S": 8.0}`` makes the workload star-heavy.  ``base`` is the floor
    weight every template keeps so no shape disappears entirely."""
    w = np.array([base + class_weights.get(cls, 0.0)
                  for cls in TEMPLATE_CLASS], dtype=np.float64)
    return w / w.sum()


def generate_drifting_workload(graph: RDFGraph,
                               phases: Sequence[Tuple[int, Dict[str, float]]],
                               seed: int = 0,
                               cold_fraction: float = 0.03,
                               constant_fraction: float = 0.5) -> Workload:
    """Concatenate workload phases with different template popularity --
    the drift stream the online subsystem (repro_torch.online) adapts to.

    ``phases``: list of (num_queries, class_weights); class weights of
    ``{}`` mean uniform popularity over all templates.
    """
    queries: List[QueryGraph] = []
    tids: List[int] = []
    for k, (n, cw) in enumerate(phases):
        probs = (class_template_probs(cw) if cw
                 else np.ones(len(TEMPLATE_CLASS)))   # uniform phase
        wl = generate_workload(
            graph, n, seed=seed + 7919 * k,
            cold_fraction=cold_fraction,
            constant_fraction=constant_fraction,
            template_probs=probs)
        queries.extend(wl.queries)
        tids.extend(wl.template_ids or [-1] * len(wl.queries))
    return Workload(queries, tids)
