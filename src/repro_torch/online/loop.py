"""The adaptive control loop: monitor -> drift -> refragment -> migrate.

``AdaptiveEngine`` wraps the exact host engine (``core.executor``): every
executed query feeds the workload monitor through the executor's
post-execute hook, and between query *epochs* (every ``epoch_len``
queries) the drift detector compares the live distribution against the
one the current fragmentation was designed for.  When it fires (and the
cooldown has passed), the engine

1. re-mines + re-selects on the monitor snapshot, warm-started from the
   incumbent FAP set (``online.refragment``);
2. plans a cost-bounded migration realizing the new allocation within
   ``migration_budget_bytes`` (``online.migration``), scheduling the
   shipment through the straggler-aware work queue;
3. swaps in the new fragmentation at the *realized* (post-budget)
   placement: a fresh ``DistributedEngine`` on the default local data
   plane, or -- with ``AdaptiveConfig(serve_backend="spmd")`` -- a hot
   ``SiteStore`` swap into the *running* ``SpmdEngine``
   (``SpmdEngine.swap_store``), so SPMD serving continues through the
   re-partition without an engine restart, every query on the GPU's
   join kernels before and after the swap.

The control plane itself (monitor, drift, re-fragmentation, migration
planning) is numpy on the host, as in the JAX package, so the same
stream gives the same epochs, plans and ledger.

With ``mesh=`` a ``SiteMesh`` of a process group (SPMD data plane only)
every rank serves its block of the sites and every rank closes each
epoch at the same query, but the control plane runs on rank 0 alone:
the monitor observes there, and there the drift check, re-fragmentation
and migration plan run.  Rank 0 then broadcasts the epoch's outcome
once on the group -- the drift report and the ledger, and after a
re-partition the new fragmentation, realized allocation, patterns,
replicated properties and data dictionary -- and every rank installs it
and swaps its own shard.  So every rank ends with the same epoch
reports, plan and counters.  A direct ``end_epoch()`` on a leading
session's rank 0 is announced to the followers first
(``core/group.py``).

Every epoch is accounted: shipped query bytes, response time, migrated
bytes, migration makespan -- the before/after communication-cost ledger
the adaptive-vs-static benchmark reads.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Union

import torch

from ..core.allocation import Allocation, fragment_affinity
from ..core.dictionary import DataDictionary
from ..core.engine import EngineBase
from ..core.executor import CostModel, DistributedEngine, QueryResult
from ..core.fragmentation import Fragmentation
from ..core.graph import RDFGraph
from ..core.group import broadcast_from_leader
from ..core.plan import PartitionConfig, PartitionPlan
from ..core.query import QueryGraph
from ..device import resolve_device
from .drift import DriftDetector, DriftReport
from .migration import (BYTES_PER_EDGE, MigrationPlan, plan_migration,
                        schedule_migration)
from .monitor import WorkloadMonitor
from .refragment import RefragmentResult, refragment


@dataclasses.dataclass
class AdaptiveConfig:
    """Knobs of the adaptive control loop.

    ``epoch_len`` queries close an epoch; the monitor decays per query
    by ``decay`` and spills to a sketch past ``monitor_capacity``
    shapes.  Drift fires past ``tv_threshold`` (total-variation on
    property mass) or ``coverage_drop_threshold`` (FAP coverage loss),
    but only once ``min_effective_weight`` queries of evidence exist
    and ``cooldown_epochs`` have passed since the last re-partition.
    Each migration ships at most ``migration_budget_bytes``
    (``bytes_per_edge`` per edge) over ``link_bytes_per_sec`` links.

    ``serve_backend`` picks the data plane under the control loop:
    ``"local"`` (default) answers on the exact host
    ``DistributedEngine`` (rebuilt at each re-partition); ``"spmd"``
    answers on an ``SpmdEngine`` whose folded ``SiteStore`` is
    *hot-swapped* in place at each re-partition -- same engine object,
    same matcher machinery, no restart (the lifecycle layer's
    serve-through-a-repartition path).
    """
    epoch_len: int = 200                  # queries per epoch
    decay: float = 0.995                  # monitor half-life ~ 138 queries
    monitor_capacity: int = 512
    tv_threshold: float = 0.15
    coverage_drop_threshold: float = 0.10
    min_effective_weight: float = 50.0
    cooldown_epochs: int = 1              # epochs between re-partitions
    migration_budget_bytes: int = 4_000_000
    bytes_per_edge: float = BYTES_PER_EDGE
    link_bytes_per_sec: float = 1.0e9
    serve_backend: str = "local"          # "local" | "spmd"

    def __post_init__(self) -> None:
        if self.serve_backend not in ("local", "spmd"):
            raise ValueError(
                f"serve_backend must be 'local' or 'spmd', got "
                f"{self.serve_backend!r}")


@dataclasses.dataclass
class EpochReport:
    """One closed epoch of the before/after ledger: what was executed,
    what it shipped, whether drift fired, and what the migration moved
    (``deferred_moves`` stayed put under the byte budget)."""
    epoch: int
    queries: int
    comm_bytes: int                       # query shipping this epoch
    response_time: float                  # summed simulated wall-clock
    drift: Optional[DriftReport]
    repartitioned: bool
    moved_bytes: int
    deferred_moves: int
    migration_makespan_sec: float


class AdaptiveEngine(EngineBase):
    """Self-re-fragmenting distributed engine (control plane over
    ``DistributedEngine``).  Takes a ``PartitionPlan`` (the legacy
    ``WorkloadPartitioner`` is accepted via its ``.plan``).

    Telemetry: the tracer and metrics registry propagate to the wrapped
    host engine (and survive engine swaps at re-partition), so a traced
    adaptive query shows the inner ``"query"`` span of the host engine
    nested under the adaptive root span.  Every closed epoch publishes
    its ledger as ``repro_epoch_*`` gauges -- drift TV distance,
    coverage loss, migration bytes, replica ships -- whose bounded
    change-history gives the epoch ledger a queryable timeline (see
    ``docs/observability.md``)."""

    trace_name = "adaptive"

    def __init__(self, plan,
                 config: Optional[AdaptiveConfig] = None,
                 cost: Optional[CostModel] = None, *,
                 device: Union[str, torch.device] = "cuda",
                 mesh=None):
        """``device`` is where the SPMD data plane's store lives and its
        joins run ("cuda" by default, raising without CUDA; "cpu" runs
        the kernels' plain versions); the local data plane computes on
        the host but keeps the same rule.  ``mesh`` (a ``SiteMesh``)
        folds the SPMD data plane's sites onto its slots; on a process
        group, rank 0 runs the control plane for every rank."""
        self._init_engine_base()
        plan = getattr(plan, "plan", plan)   # legacy WorkloadPartitioner
        if plan is None:
            raise RuntimeError(
                "partitioner has no plan yet -- call run() first")
        if not isinstance(plan, PartitionPlan):
            raise TypeError(f"expected a PartitionPlan (or a run "
                            f"WorkloadPartitioner), got {type(plan)!r}")
        if plan.frag is None:
            raise ValueError(
                f"adaptive execution needs a workload-driven plan with a "
                f"fragment dictionary; strategy {plan.strategy!r} only "
                f"provides site-partitioned storage")
        if plan.design_workload is None:
            raise ValueError("plan carries no design workload to seed the "
                             "drift reference")
        self.plan = plan
        self.graph: RDFGraph = plan.graph
        self.pcfg: PartitionConfig = plan.config
        self.cfg = config or AdaptiveConfig()
        self.cost = cost
        self.frag: Fragmentation = plan.frag
        self.alloc: Allocation = plan.alloc
        self.selected_patterns: List[QueryGraph] = \
            list(plan.selected_patterns)
        self.cold_props: Set[int] = set(plan.cold_props)
        # live replication state (allocation-aware replication pass);
        # re-ranked on the monitor heat at every re-partition, diffs
        # shipped within the migration budget.  The wrapped host engine
        # does not read it (replication pays off on the SPMD backend);
        # it is kept current so the adapted placement can be served by
        # an SPMD rebuild -- the ROADMAP's adaptive-SPMD open item.
        self.replicated_props: Set[int] = set(plan.replicated_props)
        if mesh is not None and self.cfg.serve_backend != "spmd":
            raise ValueError("a mesh serves the spmd data plane: use "
                             "AdaptiveConfig(serve_backend=\"spmd\")")
        self.mesh = mesh
        # rank 0 of a process group, or no group: this engine decides
        self.controls = mesh is None or mesh.group is None or mesh.rank == 0
        # set by a leading Session: announces a direct end_epoch()
        self.lead_hook = None
        if self.cfg.serve_backend == "spmd":
            self.engine = plan.build_spmd_engine(device=device, cost=cost,
                                                 mesh=mesh)
        else:
            resolve_device(device)   # the host engine keeps the rule too
            self.engine = plan.build_local_engine(cost)

        self.monitor = WorkloadMonitor(self.graph.num_properties,
                                       decay=self.cfg.decay,
                                       capacity=self.cfg.monitor_capacity)
        # seed the monitor with the design workload so the drift
        # reference reflects what the fragmentation was built from
        self.monitor.bulk_load(plan.design_workload)
        self.detector = DriftDetector(
            tv_threshold=self.cfg.tv_threshold,
            coverage_drop_threshold=self.cfg.coverage_drop_threshold,
            min_effective_weight=self.cfg.min_effective_weight)
        self.detector.set_reference(self.monitor, self.selected_patterns)
        self._install_hook()

        self.epoch = 0
        self.epochs: List[EpochReport] = []
        self.total_comm_bytes = 0
        self.total_moved_bytes = 0
        self.total_replica_bytes = 0
        self.num_repartitions = 0
        self._epoch_queries = 0
        self._epoch_comm = 0
        self._epoch_rt = 0.0
        self._cooldown = 0

    # ------------------------------------------------------------------
    def _install_hook(self) -> None:
        # feed the per-site heat gauges from each result's touched
        # sites (routed SPMD execution reports only the route members);
        # only the rank that runs the control plane observes
        if self.controls:
            self.engine.post_execute_hooks.append(
                lambda q, r: self.monitor.observe(
                    q, sites=getattr(r.stats, "sites_touched", None)))
        # keep the wrapped engine on this engine's telemetry streams
        # (fresh inner engines are built at every re-partition)
        self.engine.set_tracer(self.tracer)
        self.engine.set_metrics_registry(self.metrics)

    def set_tracer(self, tracer) -> None:
        """Route the adaptive root spans *and* the wrapped host
        engine's child spans through ``tracer``."""
        self.tracer = tracer
        self.engine.set_tracer(tracer)

    def set_metrics_registry(self, registry) -> None:
        super().set_metrics_registry(registry)
        self.engine.set_metrics_registry(registry)

    def _epoch_gauge(self, name: str, value: float) -> None:
        self.metrics.gauge(f"repro_epoch_{name}",
                           backend=self.trace_name).set(value)

    @property
    def dict(self) -> DataDictionary:
        """Data dictionary of the *current* fragmentation (legacy
        attribute surface; swaps on re-partition)."""
        if hasattr(self.engine, "dict"):
            return self.engine.dict
        return self.plan.dictionary       # SPMD data plane

    @property
    def num_sites(self) -> int:
        """Logical cluster width (constant across re-partitions)."""
        return self.pcfg.num_sites

    @property
    def device(self) -> Optional[torch.device]:
        """The SPMD data plane's device (``None`` on the host one)."""
        return getattr(self.engine, "device", None)

    @property
    def _on_group(self) -> bool:
        return self.mesh is not None and self.mesh.group is not None

    # ------------------------------------------------------------------
    def _execute(self, query: QueryGraph) -> QueryResult:
        """Answer one query on the current fragmentation, feed the
        workload monitor, and close the epoch (drift check + possible
        re-partition) once ``epoch_len`` queries have accumulated.

        Args:
            query: the pattern to answer.

        Returns:
            The exact ``QueryResult`` from the underlying host engine.
        """
        r = self.engine.execute(query)
        self._epoch_queries += 1
        self._epoch_comm += r.stats.comm_bytes
        self._epoch_rt += r.stats.response_time
        self.total_comm_bytes += r.stats.comm_bytes
        if self._epoch_queries >= self.cfg.epoch_len:
            self._close_epoch()
        return self._finish(query, r)

    def _stats_extra(self):
        return {"epochs": float(self.epoch),
                "repartitions": float(self.num_repartitions),
                "moved_bytes": float(self.total_moved_bytes),
                "replicated_props": float(len(self.replicated_props)),
                "replica_bytes": float(self.total_replica_bytes)}

    # ------------------------------------------------------------------
    def end_epoch(self) -> EpochReport:
        """Close the current epoch (callable early, e.g. from a
        scheduler): compare the live workload distribution against the
        design reference and, if drift fired and the cooldown passed,
        re-mine/re-select/migrate within budget.  On a leading
        session's rank 0 the call is announced to the followers first.

        Returns:
            The ``EpochReport`` appended to ``self.epochs``.
        """
        if self.lead_hook is not None:
            return self.lead_hook("end_epoch", None, self._close_epoch)
        return self._close_epoch()

    def _decide(self) -> dict:
        """The control plane's decision for the closing epoch: the drift
        check and, if it fired, the re-partition (installed here)."""
        out = {"drift": None, "change": None, "moved": 0, "deferred": 0,
               "replica_ships": 0, "replica_bytes": 0, "makespan": 0.0}
        if self._cooldown > 0:
            self._cooldown -= 1
        else:
            out["drift"] = self.detector.check(self.monitor)
            if out["drift"].fired:
                plan = self._repartition()
                out.update(change=self._change, moved=plan.moved_bytes,
                           deferred=len(plan.deferred),
                           replica_ships=len(plan.replica_ships),
                           replica_bytes=plan.replica_bytes,
                           makespan=schedule_migration(
                               plan, self.pcfg.num_sites,
                               self.cfg.link_bytes_per_sec))
                self._cooldown = self.cfg.cooldown_epochs
        out["cooldown"] = self._cooldown
        out["response_time"] = self._epoch_rt
        return out

    def _close_epoch(self) -> EpochReport:
        if not self._on_group:
            d = self._decide()
        elif self.controls:
            try:
                d = self._decide()
            except BaseException as exc:
                # the followers wait for this epoch's outcome: end them
                # too, then end this rank
                broadcast_from_leader(
                    {"failed": f"{type(exc).__name__}: {exc}"}, self.mesh)
                raise
            broadcast_from_leader(d, self.mesh)
        else:
            d = broadcast_from_leader(None, self.mesh)
            if "failed" in d:
                raise RuntimeError(f"rank 0's control plane failed at "
                                   f"epoch {self.epoch}: {d['failed']}")
            if d["change"] is not None:
                self._install(d["change"])
            self._cooldown = d["cooldown"]
            # the epoch's response time as rank 0 measured it, so that
            # every rank's report is the same
            self._epoch_rt = d["response_time"]
        drift, repartitioned = d["drift"], d["change"] is not None
        moved, deferred, makespan = d["moved"], d["deferred"], d["makespan"]
        report = EpochReport(self.epoch, self._epoch_queries,
                             self._epoch_comm, self._epoch_rt, drift,
                             repartitioned, moved, deferred, makespan)
        self.epochs.append(report)
        # publish the closed epoch's ledger as gauges: the registry keeps
        # a bounded change-history per gauge, so the sequence of epochs
        # stays queryable from a metrics snapshot alone
        self._epoch_gauge("index", float(self.epoch))
        self._epoch_gauge("queries", float(self._epoch_queries))
        self._epoch_gauge("comm_bytes", float(self._epoch_comm))
        self._epoch_gauge("response_time_seconds", self._epoch_rt)
        self._epoch_gauge("repartitioned", 1.0 if repartitioned else 0.0)
        self._epoch_gauge("moved_bytes", float(moved))
        self._epoch_gauge("deferred_moves", float(deferred))
        self._epoch_gauge("replica_ships", float(d["replica_ships"]))
        self._epoch_gauge("replica_bytes", float(d["replica_bytes"]))
        self._epoch_gauge("migration_makespan_seconds", makespan)
        if drift is not None:
            for k, v in drift.to_metrics().items():
                self._epoch_gauge(k, v)
        self.epoch += 1
        self._epoch_queries = 0
        self._epoch_comm = 0
        self._epoch_rt = 0.0
        return report

    # ------------------------------------------------------------------
    def _repartition(self) -> MigrationPlan:
        """Re-fragment on the monitor's snapshot, plan the migration
        within budget and install the realized placement; the installed
        change is kept in ``self._change`` for the other ranks."""
        res: RefragmentResult = refragment(
            self.graph, self.monitor, self.pcfg, self.selected_patterns,
            replica_bytes_per_edge=self.cfg.bytes_per_edge)
        aff = fragment_affinity(res.frag, res.sel_usage, res.weights)
        plan = plan_migration(self.frag, self.alloc, res.frag,
                              res.desired_alloc, aff,
                              self.cfg.migration_budget_bytes,
                              self.cfg.bytes_per_edge,
                              old_replicated=self.replicated_props,
                              desired_replication=res.desired_replication)
        realized = Allocation(plan.final_site_of, self.pcfg.num_sites)
        self._change = {
            "frag": res.frag, "site_of": realized.site_of,
            "dictionary": DataDictionary.build(
                self.graph, res.frag, realized, self.pcfg.num_sites),
            "selected_patterns": res.selected_patterns,
            "cold_props": res.cold_props,
            "replicated_props": set(plan.replicated_props),
            "sel_usage": res.sel_usage, "weights": res.weights,
            "replication": res.desired_replication,
            "moved_bytes": plan.moved_bytes,
            "replica_bytes": plan.replica_bytes}
        self._install(self._change)
        self.detector.set_reference(self.monitor, self.selected_patterns)
        return plan

    def _install(self, change: dict) -> None:
        """Adopt a re-partition's realized placement (every rank of a
        group runs this with rank 0's ``change``)."""
        realized = Allocation(change["site_of"], self.pcfg.num_sites)
        self.frag = change["frag"]
        self.alloc = realized
        self.selected_patterns = change["selected_patterns"]
        self.cold_props = change["cold_props"]
        self.replicated_props = set(change["replicated_props"])
        # refresh the plan *artifact* to the realized placement: the
        # lifecycle layer publishes successive versions of it, and both
        # data planes derive their storage view from its
        # ``site_edge_ids``.  The design workload carries over from the
        # incumbent (provenance: what the original fragmentation was
        # designed from; the live distribution lives in the monitor).
        self.plan = PartitionPlan(
            strategy=self.pcfg.kind, config=self.pcfg, graph=self.graph,
            selected_patterns=change["selected_patterns"],
            frag=change["frag"], alloc=realized,
            dictionary=change["dictionary"],
            cold_props=change["cold_props"],
            design_workload=self.plan.design_workload,
            sel_usage=change["sel_usage"], weights=change["weights"],
            replicated_props=set(change["replicated_props"]),
            replication=change["replication"])
        if self.cfg.serve_backend == "spmd":
            # hot swap: same engine object (matchers, telemetry
            # streams, and the monitor hook survive -- re-installing the
            # hook here would double-observe every query), new folded
            # store for the realized placement (on a mesh, this rank's
            # shard)
            self.engine.swap_store(self.plan.site_edge_ids(),
                                   replicated_props=self.replicated_props)
        else:
            self.engine = DistributedEngine(
                self.graph, change["frag"], realized, change["dictionary"],
                change["cold_props"], self.cost)
            self._install_hook()
        self.total_moved_bytes += change["moved_bytes"]
        self.total_replica_bytes += change["replica_bytes"]
        self.num_repartitions += 1
