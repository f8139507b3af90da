"""Straggler mitigation for the distributed query/serving path.

SPMD training is bulk-synchronous (the slowest device gates the step;
the mitigation there is overlapping compute with communication).  The
RDF engine's subquery execution, by contrast, is task-parallel: per-site
work items (subquery x fragment) go through a work queue with

  * work stealing -- idle sites pull from the tail of the busiest site's
    queue (fragments are replicated per Def. 3 overlap, or fetchable);
  * deadline-based backup tasks -- an item running longer than
    ``backup_factor`` x the running median is re-issued to the fastest
    idle site; first completion wins (classic speculative execution).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class WorkItem:
    item_id: int
    site: int                 # preferred (data-local) site
    est_cost: float
    payload: object = None


@dataclasses.dataclass
class CompletedItem:
    item_id: int
    site: int                 # site that actually ran it
    start: float
    finish: float
    speculative: bool = False


class WorkQueue:
    """Deterministic discrete-event simulation of per-site queues with
    stealing -- used by tests and by the executor's makespan model."""

    def __init__(self, num_sites: int, steal: bool = True,
                 site_speed: Optional[List[float]] = None,
                 cost_fn: Optional[Callable[[WorkItem, int], float]] = None):
        """``cost_fn(item, site) -> seconds`` overrides the default
        ``est_cost / speed[site]`` duration model (e.g. deterministic
        test schedules, or per-link cost models where an item's duration
        depends on which site runs it)."""
        self.num_sites = num_sites
        self.steal = steal
        self.speed = site_speed or [1.0] * num_sites
        self.cost_fn = cost_fn
        self.queues: List[List[WorkItem]] = [[] for _ in range(num_sites)]

    def submit(self, items: List[WorkItem]) -> None:
        for it in items:
            self.queues[it.site % self.num_sites].append(it)

    def run(self) -> Tuple[float, List[CompletedItem]]:
        """Returns (makespan, completion log)."""
        site_time = [0.0] * self.num_sites
        done: List[CompletedItem] = []
        pending = [list(q) for q in self.queues]
        while any(pending):
            if self.steal:
                # next free site; steals from the busiest tail if idle
                s = min(range(self.num_sites), key=lambda j: site_time[j])
                if pending[s]:
                    it = pending[s].pop(0)
                else:
                    victim = max(range(self.num_sites),
                                 key=lambda j: sum(w.est_cost
                                                   for w in pending[j]))
                    if not pending[victim]:
                        break
                    it = pending[victim].pop()   # steal from the tail
            else:
                # no stealing: next free site AMONG those with local work
                s = min((j for j in range(self.num_sites) if pending[j]),
                        key=lambda j: site_time[j])
                it = pending[s].pop(0)
            dur = (self.cost_fn(it, s) if self.cost_fn is not None
                   else it.est_cost / self.speed[s])
            done.append(CompletedItem(it.item_id, s, site_time[s],
                                      site_time[s] + dur))
            site_time[s] += dur
        return max(site_time), done


class StragglerMitigator:
    """Speculative re-execution: duplicate items that overrun the
    deadline (backup_factor x running median) onto idle sites."""

    def __init__(self, backup_factor: float = 2.0):
        self.backup_factor = backup_factor

    def plan_backups(self, inflight: Dict[int, float], now: float,
                     median_cost: float) -> List[int]:
        """Item ids whose elapsed time exceeds the deadline."""
        deadline = self.backup_factor * max(median_cost, 1e-9)
        return [iid for iid, started in inflight.items()
                if now - started > deadline]

    def simulate(self, costs: List[float], num_sites: int,
                 slow_site: int = 0, slow_factor: float = 5.0
                 ) -> Tuple[float, float]:
        """Makespan (no mitigation, with mitigation) for a site set where
        ``slow_site`` runs ``slow_factor``x slower."""
        speed = [1.0] * num_sites
        speed[slow_site] = 1.0 / slow_factor
        items = [WorkItem(i, i % num_sites, c) for i, c in enumerate(costs)]

        base = WorkQueue(num_sites, steal=False, site_speed=speed)
        base.submit(items)
        t_base, _ = base.run()

        mit = WorkQueue(num_sites, steal=True, site_speed=speed)
        mit.submit(items)
        t_mit, _ = mit.run()
        return t_base, t_mit
