"""Replica- and load-aware query routing: per-query site subsets.

The paper's §7 online phase sends every query to every site; Partout's
global query optimizer instead routes each (sub)query to the minimal
site subset that can answer it, and AdPart balances replicated work
across the replica holders (PAPERS.md).  This module computes that
route as a trace-time constant from the ``SiteStore`` residency
metadata -- the same per-property row/distinct tables the
communication planner reads -- so the SPMD matcher can mask
non-resident devices out of a query entirely:

* **membership** -- the route is the union, over the query's
  mesh-incomplete properties, of the devices holding at least one edge
  of them.  Every edge a match can touch that is *not* replicated
  everywhere lives on a member, so devices outside the route hold zero
  valid binding rows at every join step and the broadcast-join
  collectives only carry data for ``width`` devices: the comm ledger
  scales with the route width, not the mesh width.
* **rendezvous pick** -- a query whose every property is replicated
  everywhere (mesh-complete) could run anywhere; routing it to the
  whole mesh would make every device duplicate the whole query.  Such
  queries are pinned to a single device chosen by
  highest-random-weight (rendezvous) hashing of the normalized edge
  structure, so repeated shapes stick to their device (compile-cache
  friendly) while distinct shapes spread across the mesh.
* **seed balancing** -- when step 0's property is *route-complete*
  (every member holds its full resident edge set) and duplicate-free
  per member, the seed rows are striped across the members in
  rendezvous-score order: replicated seed storage becomes balanced
  partitioned work over exactly the replica holders, not the whole
  mesh (``plan_seed_decimation`` generalized from mesh-complete to
  route-complete).
* **capacity tier** -- a decimated seed step over ``r`` route members
  starts the retry ladder ``ceil(log2(m / r))`` tiers below the
  configured capacity (floored so the striped seed rows statically
  fit), cutting recompiles for narrow routes
  (``SpmdEngine._start_capacity``).

Exactness: masking devices that hold no edges of the query's
non-replicated properties never drops a match -- any binding row such
a device could produce from replicated-everywhere seeds exists
identically on every member -- so routed answers are bit-identical to
whole-mesh execution (``Session(spmd_routing=False)``), which the
exactness/fuzz harnesses assert backend-vs-backend.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence, Tuple

from .query import QueryGraph, _connected_edge_order


def _hrw_score(seed: int, key: str, device: int) -> int:
    """Highest-random-weight (rendezvous) score of ``device`` for
    ``key``: deterministic across processes and runs (blake2b, not
    ``hash()`` which is salted per process)."""
    digest = hashlib.blake2b(f"{seed}|{key}|{device}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big")


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """Trace-time routing constants for one normalized pattern over one
    ``SiteStore`` (pure function of both, so it shares the engine's
    per-edge-structure caches).

    members:          sorted mesh devices the query runs on;
    mesh_width:       total devices on the mesh axis (``m``);
    seed_ranks:       per mesh device, its stripe rank within the
                      route's rendezvous order, or -1 for non-members
                      (the step-0 mask/decimation vector);
    decimate:         stripe step-0 seeds across members (step 0's
                      property is route-complete and duplicate-free on
                      every member);
    rendezvous:       the route is a rendezvous singleton (every query
                      property is mesh-complete);
    p0_mesh_complete: step 0's property is complete on the *whole*
                      mesh (the legacy decimation precondition; when
                      true the configured capacity already assumes
                      m-way striping, so no tier lowering applies);
    seed_rows:        per-member striped seed rows when decimating
                      (``ceil(union_rows[p0] / width)``), else 0.
    """
    members: Tuple[int, ...]
    mesh_width: int
    seed_ranks: Tuple[int, ...]
    decimate: bool
    rendezvous: bool
    p0_mesh_complete: bool
    seed_rows: int

    @property
    def width(self) -> int:
        return len(self.members)

    @property
    def whole_mesh(self) -> bool:
        return self.width == self.mesh_width

    @property
    def member_set(self) -> frozenset:
        return frozenset(self.members)


def route_prop_complete(store, prop: int,
                        members: Sequence[int]) -> bool:
    """Every route member holds every resident edge of ``prop`` (the
    route-local generalization of ``SiteStore.prop_shard_complete``:
    completeness is only required of the devices the query actually
    runs on).  Properties outside the metadata range are trivially
    complete."""
    if store.prop_dev_distinct is None:
        return False
    if not (0 <= prop < store.prop_union_rows.shape[0]):
        return True
    union = store.prop_union_rows[prop]
    return all(store.prop_dev_distinct[j, prop] == union for j in members)


def _prop_dup_free(store, prop: int, members: Sequence[int]) -> bool:
    """Stored rows == distinct edge ids of ``prop`` on every member
    (striping ranks over duplicated rows could drop a seed, same caveat
    as ``plan_seed_decimation``)."""
    if store.prop_dev_rows is None:
        return False
    if not (0 <= prop < store.prop_dev_rows.shape[1]):
        return True
    return all(store.prop_dev_rows[j, prop]
               == store.prop_dev_distinct[j, prop] for j in members)


def plan_route(store, pattern: QueryGraph, *,
               seed: int = 0) -> RoutePlan:
    """Compute the ``RoutePlan`` for matching ``pattern`` over
    ``store`` (see module docstring for the membership / rendezvous /
    seed-balancing rules).  Falls back to the whole mesh -- routing as
    a no-op -- when residency metadata is unavailable or the pattern
    carries wildcard properties."""
    m = int(store.num_sites)
    key = repr(tuple(pattern.edges))
    props = [e.prop for e in pattern.edges]
    if (store.prop_dev_rows is None or not props
            or any(p < 0 for p in props)):
        members = tuple(range(m))
        ranks = tuple(range(m))
        return RoutePlan(members, m, ranks, False, False, False, 0)

    incomplete = [p for p in sorted(set(props))
                  if not store.prop_shard_complete(p)]
    holders = set()
    for p in incomplete:
        holders.update(
            j for j in range(m) if store.prop_dev_rows[j, p] > 0)
    if holders:
        members = tuple(sorted(holders))
        rendezvous = False
    else:
        # every property replicated everywhere: rendezvous-pick one
        # device so the mesh doesn't duplicate the whole query m times
        pick = max(range(m),
                   key=lambda j: (_hrw_score(seed, key, j), j))
        members = (pick,)
        rendezvous = True

    order = _connected_edge_order(pattern)
    p0 = pattern.edges[order[0]].prop
    p0_mesh_complete = bool(store.prop_shard_complete(p0))
    decimate = (route_prop_complete(store, p0, members)
                and _prop_dup_free(store, p0, members))

    # stripe ranks in rendezvous-score order: which member takes stripe
    # 0 rotates per query shape, so replicated seed work spreads across
    # the replica holders instead of always loading member 0
    by_score = sorted(members,
                      key=lambda j: (-_hrw_score(seed, key, j), j))
    rank_of = {j: r for r, j in enumerate(by_score)}
    seed_ranks = tuple(rank_of.get(j, -1) for j in range(m))

    seed_rows = 0
    if decimate and store.prop_union_rows is not None \
            and 0 <= p0 < store.prop_union_rows.shape[0]:
        union = int(store.prop_union_rows[p0])
        seed_rows = -(-union // max(len(members), 1))
    return RoutePlan(members, m, seed_ranks, decimate, rendezvous,
                     p0_mesh_complete, seed_rows)
