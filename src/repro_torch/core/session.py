"""``Session``: the query-facing entry point over a ``PartitionPlan``.

A ``PartitionPlan`` says *where the data lives*; a ``Session`` says *how
queries run against it*.  The same plan can be served by three backends
through the one ``Engine`` protocol:

* ``"spmd"``     -- the plan's sites in lock step on one device, or
                    in blocks across the ranks of a process group with
                    ``mesh=`` (``repro_torch.core.spmd``), the join
                    kernels in the match loop;
* ``"local"``    -- the paper's exact host ``DistributedEngine`` over
                    the fragment allocation (Algorithms 3+4);
* ``"baseline"`` -- the gather-all ``BaselineEngine`` over the plan's
                    per-site storage (the SHAPE/WARP execution model);
* ``"adaptive"`` -- the online ``AdaptiveEngine`` control plane
                    (monitor -> drift -> refragment -> migrate)
                    wrapping the local engine, or the SPMD engine with
                    hot ``SiteStore`` swaps at each re-partition via
                    ``AdaptiveConfig(serve_backend="spmd")``.

The local and baseline engines compute in numpy on the host, as the
reference's do: they are the paper's host engine and its §8 baseline
simulator, not a stand-in for the SPMD backend, which never gives way
to them.

Typical use::

    plan = build_plan(graph, workload, PartitionConfig(num_sites=4))
    session = Session(plan, backend="spmd")          # on the GPU
    results = session.execute_many(queries)
    with session.serve(max_batch=16, max_delay_ms=2.0) as door:
        result = door.submit(query, deadline_s=1.0).result()

On a process group (``mesh=`` a ``SiteMesh`` of the group, one
session on every rank) every rank must make the same engine calls.
Either every rank runs the same calling code, or rank 0 *leads* and the
others *follow* (``core/group.py``)::

    session = Session(plan, backend="spmd", mesh=mesh)   # every rank
    if mesh.rank == 0:
        with session.lead():                 # announce every engine call
            with session.serve() as door:    # admission on rank 0 only
                result = door.submit(query).result()
    else:
        session.follow()                     # until rank 0 leaves lead()
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from .engine import EngineStats
from .executor import CostModel, QueryResult
from .graph import RDFGraph
from .group import Followed, Leader, follow, group_mesh
from .plan import PartitionPlan
from .query import QueryGraph

BACKENDS = ("local", "baseline", "spmd", "adaptive")


class Session:
    """Engine facade over a ``PartitionPlan`` + backend choice."""

    def __init__(self, plan: PartitionPlan, backend: str = "spmd", *,
                 device: Union[str, torch.device] = "cuda",
                 cost: Optional[CostModel] = None,
                 adaptive_config=None,
                 spmd_devices: Optional[int] = None,
                 spmd_capacity: int = 4096,
                 spmd_max_capacity: Optional[int] = None,
                 spmd_comm_plan: bool = True,
                 spmd_routing: bool = True,
                 mesh=None,
                 trace: bool = False,
                 tracer=None,
                 metrics_registry=None):
        """Build the backend engine for ``plan``.

        Args:
            plan: the ``PartitionPlan`` to serve.
            backend: one of ``BACKENDS`` -- ``"spmd"`` (default),
                ``"local"``, ``"baseline"`` or ``"adaptive"``.
            device: "cuda" by default, raising if CUDA is missing, for
                every backend; "cpu" only when asked.  The spmd store
                (also the adaptive backend's with ``serve_backend=
                "spmd"``) lives and its joins run there ("cpu" runs the
                kernels' plain versions); the local and baseline
                engines compute on the host either way.
            cost: optional ``CostModel`` for the ledger, shared by
                every backend.
            adaptive_config: ``AdaptiveConfig`` for the adaptive
                backend (epoch length, drift thresholds, budget, data
                plane).
            spmd_devices: width of the site axis the logical sites fold
                onto (default: one slot per logical site).
            spmd_capacity: starting per-site binding-table rows.
            spmd_max_capacity: overflow retry-ladder ceiling.
            spmd_comm_plan: size-aware per-join-step communication
                planning (default on); ``False`` gathers the binding
                tables before every join step.
            spmd_routing: per-query site routing (default on; inactive
                without the planner).
            mesh: a ``repro_torch.launch.mesh.SiteMesh`` for the spmd
                backend (and the adaptive backend's spmd data plane), in
                place of ``spmd_devices``: the sites fold onto its
                slots, and on a process group every rank serves its
                shard; every rank makes the same calls, or rank 0
                ``lead()``s and the others ``follow()``.
            trace: ``True`` builds a private enabled ``Tracer`` for this
                session (a root span per query with its ``comm_step``
                records).
            tracer: explicit ``obs.trace.Tracer`` to use instead
                (overrides ``trace``); default is the process tracer
                (``obs.trace.get_tracer()``, disabled unless
                ``obs.trace.enable_tracing()`` ran).
            metrics_registry: explicit ``obs.metrics.MetricsRegistry``
                for this session's counters, gauges and histograms;
                default is the process registry.

        Raises:
            ValueError: an unknown backend, a plan that cannot serve
                the requested backend, or a ``mesh`` for a host backend.
            RuntimeError: ``device`` is CUDA and there is none.
        """
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"choose one of {list(BACKENDS)}")
        if mesh is not None and backend in ("local", "baseline"):
            raise ValueError(f"the {backend!r} backend computes on the host "
                             f"and takes no mesh")
        self.plan = plan
        self.backend = backend
        self.mesh = mesh
        self._leader: Optional[Leader] = None
        if backend == "spmd":
            self.engine = plan.build_spmd_engine(
                device=device, num_devices=spmd_devices,
                capacity=spmd_capacity, cost=cost,
                max_capacity=spmd_max_capacity, comm_plan=spmd_comm_plan,
                routing=spmd_routing, mesh=mesh)
        elif backend == "adaptive":
            # lazy import: online imports core, not the other way round
            from ..online.loop import AdaptiveEngine
            self.engine = AdaptiveEngine(plan, adaptive_config, cost,
                                         device=device, mesh=mesh)
        else:
            resolve_device(device)   # the host engines keep the rule too
            self.engine = (plan.build_local_engine(cost)
                           if backend == "local"
                           else plan.build_baseline_engine(cost))
        if tracer is None and trace:
            from ..obs.trace import Tracer
            tracer = Tracer(enabled=True)
        if tracer is not None:
            self.engine.set_tracer(tracer)
        if metrics_registry is not None:
            self.engine.set_metrics_registry(metrics_registry)

    @property
    def post_execute_hooks(self) -> List[Callable[[QueryGraph, QueryResult],
                                                  None]]:
        """Observers called as ``hook(query, result)`` after every
        executed query."""
        return self.engine.post_execute_hooks

    @property
    def num_sites(self) -> int:
        """Logical cluster width the plan was built for."""
        return self.engine.num_sites

    def route_key(self, query: QueryGraph):
        """The backend's routing token for ``query`` (the SPMD route's
        member sites), or ``None`` on backends without routing.  The
        serving layer folds it into its shape-bucket keys so
        micro-batches stay route-coherent."""
        rk = getattr(self.engine, "route_key", None)
        return rk(query) if rk is not None else None

    @property
    def tracer(self):
        """The ``obs.trace.Tracer`` the engine reports to
        (``tracer.store.spans()`` holds the finished root spans)."""
        return self.engine.tracer

    @property
    def metrics(self):
        """The ``obs.metrics.MetricsRegistry`` the engine publishes its
        counters, gauges and histograms into."""
        return self.engine.metrics

    @property
    def device(self) -> Optional[torch.device]:
        """Where the store lives and the joins run (``None`` for the
        host engines)."""
        return getattr(self.engine, "device", None)

    def _call(self, name: str, args: Callable[[], Any],
              fn: Callable[[], Any]) -> Any:
        """``fn()``; while leading, announced first with ``args()``."""
        leader = self._leader
        return fn() if leader is None else leader.call(name, args(), fn)

    def execute(self, query: QueryGraph) -> QueryResult:
        """Answer one query exactly: ``bindings`` (variable -> int32
        column), ``num_rows`` and per-query ``stats``."""
        return self._call("execute", lambda: _edges(query),
                          lambda: self.engine.execute(query))

    def execute_many(self, queries: Sequence[QueryGraph],
                     batch_size: int = 64) -> List[QueryResult]:
        """Answer a query stream (results in input order)."""
        return self._call(
            "execute_many",
            lambda: ([_edges(q) for q in queries], int(batch_size)),
            lambda: self.engine.execute_many(queries, batch_size=batch_size))

    def swap_store(self, site_edge_ids: Sequence, replicated_props=None,
                   graph: Optional[RDFGraph] = None) -> int:
        """Hot-swap the spmd engine's store to a new placement (and a
        new graph, after ``ingest_delta``): ``SpmdEngine.swap_store``,
        announced by its arguments while leading, so that every rank
        rebuilds its own shard.  Returns the new store generation."""
        swap = getattr(self.engine, "swap_store", None)
        if swap is None:
            raise ValueError(f"the {self.backend!r} backend has no store "
                             f"to swap")

        def args():
            rep = None if replicated_props is None else sorted(
                int(p) for p in replicated_props)
            cols = None if graph is None else (
                graph.s, graph.p, graph.o, int(graph.num_vertices),
                int(graph.num_properties))
            return ([np.asarray(e, np.int64) for e in site_edge_ids], rep,
                    cols)
        return self._call(
            "swap_store", args,
            lambda: swap(site_edge_ids, replicated_props=replicated_props,
                         graph=graph))

    def end_epoch(self):
        """Close the adaptive backend's epoch now
        (``AdaptiveEngine.end_epoch``; announced while leading)."""
        if self.backend != "adaptive":
            raise ValueError(f"the {self.backend!r} backend has no epochs")
        return self.engine.end_epoch()

    # -- leading and following a process group ---------------------------
    @contextlib.contextmanager
    def lead(self) -> Iterator["Session"]:
        """On rank 0 of the mesh's group: announce every engine call
        this session makes (``execute``, ``execute_many``,
        ``swap_store``, ``end_epoch``, also from a ``FrontDoor`` over
        it) until the block ends, then release the followers.  Close
        any door inside the block.  A block that raises releases no
        one: the error ends the rank, and ``launch`` the group.

        Raises:
            ValueError: no process-group mesh, or not rank 0.
            RuntimeError: the session already leads.
        """
        mesh = group_mesh(self.mesh, "lead()")
        if self._leader is not None:
            raise RuntimeError("this session already leads its group")
        leader = Leader(mesh)
        self._leader = leader
        if self.backend == "adaptive":
            self.engine.lead_hook = leader.call
        done = False
        try:
            yield self
            done = True
        finally:
            self._leader = None
            if self.backend == "adaptive":
                self.engine.lead_hook = None
            if done:
                leader.release()

    def follow(self) -> List[Followed]:
        """On every rank but 0: make each call rank 0's leading session
        announces, in order, until it releases the group.  An error
        every rank raises alike (``spmd.rank_symmetric``: overflow past
        ``spmd_max_capacity``, a wildcard property) is recorded, as the
        leader's own is; a different outcome than the leader's raises
        ``GroupDivergedError``, and any other error propagates.

        Returns:
            One ``Followed`` record per call: its name and the error it
            recorded.
        """
        return follow(group_mesh(self.mesh, "follow()"), self._follow_call)

    def _follow_call(self, name: str, args: Any) -> Any:
        eng = self.engine
        if name == "execute":
            return eng.execute(QueryGraph.make(args))
        if name == "execute_many":
            edges, batch_size = args
            return eng.execute_many([QueryGraph.make(e) for e in edges],
                                    batch_size=batch_size)
        if name == "swap_store":
            site_edge_ids, rep, cols = args
            return eng.swap_store(
                site_edge_ids, replicated_props=None if rep is None
                else set(rep), graph=None if cols is None
                else RDFGraph(*cols))
        if name == "end_epoch":
            return eng.end_epoch()
        raise ValueError(f"unknown announced call {name!r}")

    def serve(self, config=None, *, start: bool = False, **kw):
        """Build a serving front door (``repro_torch.serve.FrontDoor``)
        over this session's engine: bounded admission, load shedding,
        per-request deadlines, circuit breaking, and shape-keyed
        micro-batching.  It runs the engine this session built, on the
        session's device, and builds none of its own.

        Args:
            config: a ``repro_torch.serve.FrontDoorConfig``; built from
                ``**kw`` (``max_queue=...``, ``max_batch=...``, ...)
                when omitted.
            start: spawn the dispatcher thread immediately (the door
                also works as a context manager: ``with session.serve()
                as door: ...``).
            **kw: ``FrontDoorConfig`` fields, used only when ``config``
                is ``None``.

        Returns:
            A ``FrontDoor`` bound to this session's engine, tracer, and
            metrics registry.
        """
        # lazy import: serve imports core, not the other way round
        from ..serve.frontdoor import FrontDoor, FrontDoorConfig
        if config is None:
            config = FrontDoorConfig(**kw)
        elif kw:
            raise ValueError(f"pass either config or field overrides, "
                             f"not both (got config and {sorted(kw)})")
        return FrontDoor(self, config, start=start)

    def stats(self) -> EngineStats:
        """Cumulative counters, stamped with backend and strategy."""
        s = self.engine.stats()
        s.backend = self.backend
        s.strategy = self.plan.strategy
        return s

    def __repr__(self) -> str:
        return (f"Session(strategy={self.plan.strategy!r}, "
                f"backend={self.backend!r}, sites={self.num_sites})")


def _edges(query: QueryGraph) -> tuple:
    """A query's edges as plain ints, the form an announcement takes."""
    return tuple((int(e.src), int(e.dst), int(e.prop)) for e in query.edges)
