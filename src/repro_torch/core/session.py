"""``Session``: the query-facing entry point over a ``PartitionPlan``.

Only the ``"spmd"`` backend is ported so far: the plan's sites run in
lock step on one device (``repro_torch.core.spmd``).  The host
``"local"`` and ``"baseline"`` engines and the ``"adaptive"`` control
plane come in later slices.

Typical use::

    plan = build_plan(graph, workload, PartitionConfig(num_sites=4))
    session = Session(plan, backend="spmd")          # on the GPU
    results = session.execute_many(queries)
    with session.serve(max_batch=16, max_delay_ms=2.0) as door:
        result = door.submit(query, deadline_s=1.0).result()
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch

from .engine import EngineStats
from .executor import CostModel, QueryResult
from .plan import PartitionPlan
from .query import QueryGraph

BACKENDS = ("spmd",)


class Session:
    """Engine facade over a ``PartitionPlan`` + backend choice."""

    def __init__(self, plan: PartitionPlan, backend: str = "spmd", *,
                 device: Union[str, torch.device] = "cuda",
                 cost: Optional[CostModel] = None,
                 spmd_devices: Optional[int] = None,
                 spmd_capacity: int = 4096,
                 spmd_max_capacity: Optional[int] = None,
                 spmd_comm_plan: bool = True,
                 spmd_routing: bool = True,
                 trace: bool = False,
                 tracer=None,
                 metrics_registry=None):
        """Build the backend engine for ``plan``.

        Args:
            plan: the ``PartitionPlan`` to serve.
            backend: ``"spmd"`` (the only backend ported so far).
            device: where the store lives and the joins run ("cuda" by
                default, raising if CUDA is missing; "cpu" runs the
                kernels' plain versions).
            cost: optional ``CostModel`` for the ledger.
            spmd_devices: width of the site axis the logical sites fold
                onto (default: one slot per logical site).
            spmd_capacity: starting per-site binding-table rows.
            spmd_max_capacity: overflow retry-ladder ceiling.
            spmd_comm_plan: size-aware per-join-step communication
                planning (default on); ``False`` gathers the binding
                tables before every join step.
            spmd_routing: per-query site routing (default on; inactive
                without the planner).
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
            ValueError: a backend that is not ported.
        """
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not ported; "
                             f"available: {list(BACKENDS)}")
        self.plan = plan
        self.backend = backend
        self.engine = plan.build_spmd_engine(
            device=device, num_devices=spmd_devices, capacity=spmd_capacity,
            cost=cost, max_capacity=spmd_max_capacity,
            comm_plan=spmd_comm_plan, routing=spmd_routing)
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
        """The engine's routing token for ``query`` (the route's member
        sites, or ``None``).  The serving layer folds it into its
        shape-bucket keys so micro-batches stay route-coherent."""
        return self.engine.route_key(query)

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

    def execute(self, query: QueryGraph) -> QueryResult:
        """Answer one query exactly: ``bindings`` (variable -> int32
        column), ``num_rows`` and per-query ``stats``."""
        return self.engine.execute(query)

    def execute_many(self, queries: Sequence[QueryGraph],
                     batch_size: int = 64) -> List[QueryResult]:
        """Answer a query stream (results in input order)."""
        return self.engine.execute_many(queries, batch_size=batch_size)

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
