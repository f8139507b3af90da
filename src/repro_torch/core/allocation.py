"""Fragment allocation (§6): affinity metric, allocation graph, and the
PNN-variant greedy clustering of Algorithm 2 -- plus the beyond-paper
budgeted **replication pass** that makes the allocator target
shard-completeness instead of leaving it to chance.

aff(F, F') = Σ_k use(Q_k, p) · use(Q_k, p')  (Def. 13) -- computed as one
matmul U^T diag(w) U over the deduped usage matrix.

Replication (``plan_replication``): the SPMD communication planner skips
a join step's collective entirely when the step's property is
*shard-complete* (every site holds every resident edge of it).  §6
minimizes crossing matches but shard-completeness used to be an accident
of allocation; following AdPart's hot-data replication and Partout's
workload-driven placement, the pass ranks properties by workload heat
(FAP/selection frequencies mined from the design workload) per byte of
replicated edge rows and replicates the hottest ones to every site under
a byte budget, so their join steps ship nothing at all.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .fragmentation import Fragment, Fragmentation


@dataclasses.dataclass
class Allocation:
    """A = {A_1..A_m}: partition of fragment indices onto m sites (Def. 4)."""
    site_of: np.ndarray           # fragment index -> site id
    num_sites: int

    def groups(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(self.num_sites)]
        for fi, s in enumerate(self.site_of):
            out[int(s)].append(fi)
        return out

    def is_partition(self, num_fragments: int) -> bool:
        """Def. 4 invariants: total, disjoint (by construction), non-neg."""
        return (len(self.site_of) == num_fragments
                and (self.site_of >= 0).all()
                and (self.site_of < self.num_sites).all())


def affinity_matrix(usage: np.ndarray, weights: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    """aff between all pattern pairs: U^T diag(w) U (Def. 13)."""
    U = usage.astype(np.float64)
    if weights is not None:
        U = U * np.sqrt(weights.astype(np.float64))[:, None]
    return U.T @ U


def fragment_affinity(frag: Fragmentation, usage: np.ndarray,
                      weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Lift pattern-level affinity to fragments.  Vertical fragments map
    1:1 to patterns; horizontal fragments inherit their pattern's
    affinities (minterm usage refines pattern usage; queries that use the
    same pattern with compatible constants co-access the minterms)."""
    pat_aff = affinity_matrix(usage, weights)
    pidx = np.array([f.pattern_idx for f in frag.fragments], dtype=np.int64)
    A = pat_aff[np.ix_(pidx, pidx)]
    if frag.kind == "horizontal":
        # distinct minterms of the same pattern are accessed *instead of*
        # each other for point queries -> damp their mutual affinity
        same = pidx[:, None] == pidx[None, :]
        A = np.where(same, A * 0.5, A)
    np.fill_diagonal(A, 0.0)
    return A


# ----------------------------------------------------------------------
# Algorithm 2 (PNN variant)
# ----------------------------------------------------------------------

def allocate(A: np.ndarray, num_sites: int,
             sizes: Optional[np.ndarray] = None,
             balance_factor: float = 0.0) -> Allocation:
    """Algorithm 2: start with singleton clusters; repeatedly merge the
    pair with the highest merge weight (density of the merged cluster)
    until m clusters remain.

    Incremental PNN: cross-cluster weights W[a,b], internal weights and
    sizes are maintained across merges, so each step is O(n) update +
    O(n^2) argmax -- O(n^3) total with a vectorized inner loop.

    ``balance_factor`` > 0 adds a beyond-paper size-balancing penalty
    (density - bf * merged_size/total_size); 0 = faithful to the paper.
    """
    n = A.shape[0]
    if num_sites >= n:
        return Allocation(np.arange(n, dtype=np.int64), max(num_sites, n))
    clusters: List[List[int]] = [[i] for i in range(n)]
    csize = (sizes.astype(np.float64).copy() if sizes is not None
             else np.ones(n))
    total_size = float(csize.sum())
    W = A.astype(np.float64).copy()          # cross-cluster weight
    np.fill_diagonal(W, 0.0)
    internal = np.zeros(n)                    # internal weight per cluster
    count = np.ones(n)                        # member count per cluster
    alive = np.ones(n, dtype=bool)

    def merge_score() -> np.ndarray:
        # density of every candidate merged pair, vectorized
        mi = internal[:, None] + internal[None, :] + W
        mc = count[:, None] + count[None, :]
        dens = mi / (mc * (mc - 1) / 2.0)
        if balance_factor > 0.0:
            dens = dens - balance_factor * (csize[:, None] + csize[None, :]) / total_size
        dens = np.where(alive[:, None] & alive[None, :], dens, -np.inf)
        np.fill_diagonal(dens, -np.inf)
        return dens

    remaining = n
    while remaining > num_sites:
        dens = merge_score()
        a, b = np.unravel_index(int(np.argmax(dens)), dens.shape)
        a, b = int(min(a, b)), int(max(a, b))
        clusters[a] = clusters[a] + clusters[b]
        internal[a] = internal[a] + internal[b] + W[a, b]
        count[a] += count[b]
        csize[a] += csize[b]
        W[a, :] += W[b, :]
        W[:, a] += W[:, b]
        W[a, a] = 0.0
        alive[b] = False
        W[b, :] = 0.0
        W[:, b] = 0.0
        remaining -= 1

    site_of = np.zeros(n, dtype=np.int64)
    sid = 0
    for ci in range(n):
        if alive[ci]:
            site_of[clusters[ci]] = sid
            sid += 1
    return Allocation(site_of, num_sites)


def allocate_fragments(frag: Fragmentation, usage: np.ndarray,
                       weights: np.ndarray, num_sites: int,
                       balance_factor: float = 0.0) -> Allocation:
    """End-to-end §6 for a Fragmentation; cold fragments are appended
    round-robin (black box)."""
    A = fragment_affinity(frag, usage, weights)
    sizes = np.array([f.size for f in frag.fragments], dtype=np.float64)
    return allocate(A, num_sites, sizes, balance_factor)


# ----------------------------------------------------------------------
# Budgeted replication (beyond-paper; AdPart/Partout direction)
# ----------------------------------------------------------------------

# int32 (s, p, o) per replicated edge row -- the default pricing unit,
# the same default as the migration planner's fragment-shipping unit
# (online.migration.BYTES_PER_EDGE); online callers with a configured
# unit pass theirs through ``bytes_per_edge`` so replica diffs and
# fragment moves compete in one currency
REPLICA_BYTES_PER_EDGE = 12


@dataclasses.dataclass
class ReplicationPlan:
    """Output of the budgeted replication pass.

    ``props`` lists the chosen properties hottest-first; ``heat`` and
    ``cost_bytes`` cover every *candidate* property (chosen or not) so
    the online migration planner can re-rank diffs, and ``spent_bytes``
    is what the chosen set costs against ``budget_bytes``.
    """
    props: List[int]
    heat: Dict[int, float]          # candidate property -> workload heat
    cost_bytes: Dict[int, int]      # candidate property -> replica bytes
    budget_bytes: int
    spent_bytes: int

    @property
    def prop_set(self) -> Set[int]:
        return set(self.props)

    def within_budget(self) -> bool:
        return self.spent_bytes <= self.budget_bytes


def workload_property_heat(queries: Sequence, weights: Optional[np.ndarray],
                           num_properties: int) -> np.ndarray:
    """Selection-frequency heat per property: summed (deduped) query
    multiplicity of every query whose pattern touches the property --
    Partout's 'how often does the workload read this data' signal."""
    heat = np.zeros(num_properties, dtype=np.float64)
    for i, q in enumerate(queries):
        w = float(weights[i]) if weights is not None else 1.0
        for prop in q.properties():
            if 0 <= prop < num_properties:
                heat[prop] += w
    return heat


def fap_property_heat(patterns: Sequence, usage: np.ndarray,
                      weights: np.ndarray, num_properties: int) -> np.ndarray:
    """FAP-frequency heat per property: each selected pattern
    contributes its workload-weighted usage mass (Σ_i w_i · use(Q_i, p))
    to every property on its edges -- the §4 mining output re-read as a
    per-property temperature."""
    heat = np.zeros(num_properties, dtype=np.float64)
    if usage.size == 0:
        return heat
    pat_mass = weights.astype(np.float64) @ usage.astype(np.float64)
    for j, pat in enumerate(patterns):
        for prop in pat.properties():
            if 0 <= prop < num_properties:
                heat[prop] += float(pat_mass[j])
    return heat


def plan_replication(graph, num_sites: int, budget_bytes: int,
                     prop_heat: np.ndarray,
                     bytes_per_edge: float = REPLICA_BYTES_PER_EDGE
                     ) -> ReplicationPlan:
    """Greedy knapsack over properties: replicate the hottest properties
    per byte of replicated edge rows to every site, while the cumulative
    replica bytes fit ``budget_bytes``.

    The cost of replicating property ``p`` is its full edge table shipped
    to the ``num_sites - 1`` sites beyond the one canonical copy
    (``rows(p) * bytes_per_edge * (num_sites - 1)``); heat-zero or
    edge-less properties are never candidates.  A candidate that does
    not fit is skipped, not a stopping point (later, cheaper properties
    may still fit).

    Args:
        graph: the ``RDFGraph`` (per-property row counts come from it).
        num_sites: cluster width the replicas fan out to.
        budget_bytes: total replica bytes allowed (0 disables).
        prop_heat: per-property workload heat
            (``workload_property_heat`` / ``fap_property_heat``).
        bytes_per_edge: wire bytes per replicated edge row.

    Returns:
        A ``ReplicationPlan``; ``props`` is empty when the budget is 0.
    """
    n_props = int(graph.num_properties)
    heat = np.zeros(n_props, dtype=np.float64)
    k = min(len(prop_heat), n_props)
    heat[:k] = np.asarray(prop_heat, dtype=np.float64)[:k]
    rows = np.bincount(np.asarray(graph.p), minlength=n_props)[:n_props]
    cost = (rows.astype(np.float64) * float(bytes_per_edge)
            * max(num_sites - 1, 0)).astype(np.int64)

    cand = [p for p in range(n_props) if heat[p] > 0.0 and rows[p] > 0]
    heat_d = {p: float(heat[p]) for p in cand}
    cost_d = {p: int(cost[p]) for p in cand}
    chosen: List[int] = []
    spent = 0
    # on one site every candidate costs 0 and replication is meaningless
    # (everything already lives together) -- keep the provenance honest
    if budget_bytes > 0 and num_sites > 1:
        # hottest per byte first; ties broken by raw heat then prop id
        # for determinism
        cand.sort(key=lambda p: (-heat[p] / max(cost[p], 1), -heat[p], p))
        for p in cand:
            if spent + cost_d[p] <= budget_bytes:
                chosen.append(p)
                spent += cost_d[p]
    return ReplicationPlan(chosen, heat_d, cost_d, int(budget_bytes), spent)


def replicated_edge_ids(graph, props: Set[int]) -> np.ndarray:
    """Edge ids of every replicated property -- what each site's storage
    gains (sorted, unique by construction: one id per graph edge)."""
    if not props:
        return np.zeros(0, np.int64)
    mask = np.isin(np.asarray(graph.p), np.fromiter(props, dtype=np.int64))
    return np.nonzero(mask)[0].astype(np.int64)


def property_site_map(graph, site_edge_ids: Sequence[np.ndarray]
                      ) -> Dict[int, Tuple[int, ...]]:
    """The fragment->site map folded to property granularity: for each
    property with resident edges, the sorted sites holding at least one
    of them.  This is what the routing layer consumes
    (``core.routing``): a query only needs the union of its
    properties' holder sets, so everything else can be masked out of
    its execution.  Properties replicated everywhere
    (``ReplicationPlan.props``) map to every site; a property with no
    resident edges is absent from the map."""
    p = np.asarray(graph.p)
    out: Dict[int, set] = {}
    for j, eids in enumerate(site_edge_ids):
        eids = np.asarray(eids, np.int64)
        for prop in np.unique(p[eids]) if len(eids) else ():
            out.setdefault(int(prop), set()).add(j)
    return {prop: tuple(sorted(sites))
            for prop, sites in sorted(out.items())}


# ----------------------------------------------------------------------
# Bridge: expert placement for MoE architectures
# ----------------------------------------------------------------------

def allocate_experts(coactivation: np.ndarray, num_shards: int,
                     balance_factor: float = 0.25) -> np.ndarray:
    """Cluster experts by token co-activation (Def. 13 with tokens as
    queries and experts as fragments) onto shards.  Balanced by default:
    expert shards must hold equal parameter bytes.

    Returns expert -> shard assignment with exactly E/num_shards experts
    per shard (round-robin rebalance after Algorithm 2 clustering).
    """
    E = coactivation.shape[0]
    A = coactivation.astype(np.float64).copy()
    np.fill_diagonal(A, 0.0)
    alloc = allocate(A, num_shards, sizes=np.ones(E),
                     balance_factor=balance_factor)
    # enforce exact balance: move overflow experts (lowest internal
    # affinity first) to underfull shards
    per = E // num_shards
    groups = alloc.groups()
    overflow: List[int] = []
    for g in groups:
        while len(g) > per:
            # evict the member with least affinity to the rest of g
            aff_in = [(float(A[e, g].sum()), e) for e in g]
            aff_in.sort()
            e = aff_in[0][1]
            g.remove(e)
            overflow.append(e)
    out = np.zeros(E, dtype=np.int64)
    for sid, g in enumerate(groups):
        for e in g:
            out[e] = sid
    for sid, g in enumerate(groups):
        while len(g) < per and overflow:
            e = overflow.pop()
            g.append(e)
            out[e] = sid
    return out
