"""Cost-bounded live migration planning: diff the old and new
allocations (and replication sets) and realize the highest-value part
of the new placement within a byte budget.

The planner works at fragment granularity.  A new fragment is matched to
an old one by identity key (pattern canonical code + minterm signature +
kind); a matched fragment is *resident* at its old site and moving it is
optional, an unmatched fragment (newly selected pattern / new minterm
split) is *mandatory* -- it must be materialized at some site or the new
fragmentation would strand it (Def. 3 coverage would break).

Moves are ranked by affinity gain per byte: the gain of moving fragment
F from its resident site to its desired site is the difference in summed
co-access affinity (Def. 13, the same matrix Algorithm 2 clusters on)
between the two sites' desired populations -- one matmul against the
site indicator matrix.  Mandatory materializations run first; optional
relocations then consume the remaining budget greedily.  Deferred
fragments simply stay where they are: every fragment always has exactly
one owning site, before, during and after the plan.

Replica diffs (the allocation-aware replication pass of
``core.allocation.plan_replication``) ride the same budget: properties
replicated both before and after cost nothing (the copies are already
everywhere), dropped ones cost nothing (a delete), and *newly*
replicated properties must ship their edge rows to every site -- those
bytes are optional, ranked by workload heat per byte between the
mandatory materializations and the optional relocations (replication
eliminates whole collectives, so it outranks affinity polish).  A
deferred replication simply is not realized this epoch -- replication is
an optimization, never a correctness requirement, so nothing strands.

The emitted plan converts to ``distributed.straggler.WorkItem``s so the
actual shipping is scheduled through the same work-stealing queue as
query subtasks (a migration epoch's makespan comes from the same
discrete-event model, and stragglers get the same mitigation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.allocation import Allocation, ReplicationPlan
from ..core.fragmentation import Fragment, Fragmentation
from ..distributed.straggler import WorkItem, WorkQueue

# int32 (s, p, o) per edge -- what a fragment shipment serializes to
BYTES_PER_EDGE = 12.0


def fragment_key(frag: Fragmentation, f: Fragment) -> Tuple:
    """Identity of a fragment across re-fragmentations."""
    code = (frag.patterns[f.pattern_idx].canonical_code()
            if 0 <= f.pattern_idx < len(frag.patterns) else None)
    mt = (tuple(sorted((t.var, t.value, t.equal) for t in f.minterm.terms))
          if f.minterm is not None else None)
    return (code, mt, f.kind)


@dataclasses.dataclass
class Move:
    frag_idx: int               # index into the NEW fragmentation
    src_site: Optional[int]     # None = not resident anywhere (mandatory)
    dst_site: int
    nbytes: int
    gain: float                 # affinity gain of dst over src
    mandatory: bool


@dataclasses.dataclass
class MigrationPlan:
    final_site_of: np.ndarray   # per new fragment; realized placement
    applied: List[Move]
    deferred: List[Move]        # kept at src_site this epoch
    moved_bytes: int            # fragment + replica bytes shipped
    budget_bytes: int
    # realized replication state after this epoch (old kept copies +
    # newly shipped ones); replica_ships lists the new shipments (one
    # Move per (property, receiving site), frag_idx = -1 - prop)
    replicated_props: Set[int] = dataclasses.field(default_factory=set)
    replica_ships: List[Move] = dataclasses.field(default_factory=list)
    deferred_replications: List[int] = dataclasses.field(default_factory=list)
    replica_bytes: int = 0      # subset of moved_bytes spent on replicas

    @property
    def num_moves(self) -> int:
        return len(self.applied)

    def within_budget(self) -> bool:
        return self.moved_bytes <= self.budget_bytes

    def strands_none(self, num_fragments: int, num_sites: int) -> bool:
        """Def. 3/4 integrity: every fragment owned by exactly one valid
        site."""
        return (len(self.final_site_of) == num_fragments
                and bool((self.final_site_of >= 0).all())
                and bool((self.final_site_of < num_sites).all()))


def plan_migration(old_frag: Fragmentation, old_alloc: Allocation,
                   new_frag: Fragmentation, desired_alloc: Allocation,
                   affinity: np.ndarray, budget_bytes: int,
                   bytes_per_edge: float = BYTES_PER_EDGE,
                   old_replicated: Optional[Set[int]] = None,
                   desired_replication: Optional[ReplicationPlan] = None
                   ) -> MigrationPlan:
    """Cost-bounded diff of old vs. new placement.

    ``affinity`` is the fragment-level affinity matrix of the *new*
    fragmentation (``core.allocation.fragment_affinity``).  The byte
    budget bounds optional relocations; mandatory materializations (new
    fragments with no resident copy) always run -- deferring those would
    strand them -- so the effective relocation budget is what remains
    after the mandatory bytes.

    ``old_replicated`` / ``desired_replication`` diff the replication
    sets: newly desired properties ship their replica rows (heat per
    byte, within the same budget, after the mandatory moves), carried
    copies and drops are free, and replications that do not fit are
    deferred (dropped from the realized set -- never a stranding).
    """
    n = len(new_frag.fragments)
    num_sites = desired_alloc.num_sites
    old_site: Dict[Tuple, int] = {}
    for fi, f in enumerate(old_frag.fragments):
        old_site.setdefault(fragment_key(old_frag, f),
                            int(old_alloc.site_of[fi]))

    # per-site summed affinity under the desired placement: one matmul
    onehot = np.zeros((n, num_sites), dtype=np.float64)
    onehot[np.arange(n), desired_alloc.site_of] = 1.0
    site_aff = affinity @ onehot                    # (n, num_sites)

    final = np.asarray(desired_alloc.site_of, dtype=np.int64).copy()
    mandatory: List[Move] = []
    optional: List[Move] = []
    for i, f in enumerate(new_frag.fragments):
        dst = int(desired_alloc.site_of[i])
        src = old_site.get(fragment_key(new_frag, f))
        nbytes = int(f.size * bytes_per_edge)
        if src is None:
            mandatory.append(Move(i, None, dst, nbytes, 0.0, True))
        elif src != dst:
            gain = float(site_aff[i, dst] - site_aff[i, src])
            optional.append(Move(i, src, dst, nbytes, gain, False))
        # src == dst: resident copy already in place, zero bytes

    applied: List[Move] = []
    deferred: List[Move] = []
    moved = 0
    for mv in mandatory:                 # must run; counts against budget
        applied.append(mv)
        moved += mv.nbytes

    # --- replica diffs: heat/byte greedy within the remaining budget ---
    old_rep = set(old_replicated or ())
    desired_rep = (desired_replication.prop_set
                   if desired_replication is not None else set())
    realized_rep = old_rep & desired_rep       # copies already everywhere
    replica_ships: List[Move] = []
    deferred_rep: List[int] = []
    replica_bytes = 0
    if desired_replication is not None:
        # ``props`` already carries plan_replication's heat-per-byte
        # ranking -- reuse it so offline pass and online diff realize
        # the same subset under a tight budget
        new_props = [p for p in desired_replication.props
                     if p not in old_rep]
        per_site = max(num_sites - 1, 1)
        for pr in new_props:
            nbytes = int(desired_replication.cost_bytes.get(pr, 0))
            if moved + nbytes <= budget_bytes:
                realized_rep.add(pr)
                moved += nbytes
                replica_bytes += nbytes
                # one shipment per receiving site beyond the canonical
                # copy (site 0 stands in for "already resident
                # somewhere"); remainder bytes spread so the work items
                # sum exactly to the budgeted cost
                base, rem = divmod(nbytes, per_site)
                for k, site in enumerate(range(1, num_sites)):
                    replica_ships.append(Move(
                        -1 - pr, None, site, base + (1 if k < rem else 0),
                        desired_replication.heat.get(pr, 0.0), False))
            else:
                deferred_rep.append(pr)

    # highest affinity-gain-per-byte first; non-positive gains never move
    optional.sort(key=lambda m: -m.gain / max(m.nbytes, 1))
    for mv in optional:
        if mv.gain > 0.0 and moved + mv.nbytes <= budget_bytes:
            applied.append(mv)
            moved += mv.nbytes
        else:
            deferred.append(mv)
            final[mv.frag_idx] = mv.src_site
    return MigrationPlan(final, applied, deferred, moved, budget_bytes,
                         realized_rep, replica_ships, deferred_rep,
                         replica_bytes)


# ----------------------------------------------------------------------
# Scheduling the shipment through the straggler-aware work queue
# ----------------------------------------------------------------------

def migration_work_items(plan: MigrationPlan,
                         link_bytes_per_sec: float = 1.0e9
                         ) -> List[WorkItem]:
    """One work item per applied move and per replica shipment, homed on
    the destination site (the receiver drives the fetch), costed at link
    transfer time.  Replica items carry negative ids (``-1 - prop``
    offset per receiving site) so they never collide with fragment
    indices."""
    items = [WorkItem(mv.frag_idx, mv.dst_site,
                      mv.nbytes / link_bytes_per_sec, payload=mv)
             for mv in plan.applied]
    n_sites = max((mv.dst_site for mv in plan.replica_ships), default=0) + 1
    for mv in plan.replica_ships:
        items.append(WorkItem(mv.frag_idx * n_sites - mv.dst_site,
                              mv.dst_site,
                              mv.nbytes / link_bytes_per_sec, payload=mv))
    return items


def schedule_migration(plan: MigrationPlan, num_sites: int,
                       link_bytes_per_sec: float = 1.0e9,
                       site_speed: Optional[List[float]] = None) -> float:
    """Run the shipment plan through the work-stealing queue; returns
    the migration epoch's makespan in seconds."""
    items = migration_work_items(plan, link_bytes_per_sec)
    if not items:
        return 0.0
    wq = WorkQueue(num_sites, steal=True, site_speed=site_speed)
    wq.submit(items)
    makespan, _ = wq.run()
    return makespan
