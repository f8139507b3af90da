"""Deprecated compatibility layer over the plan/session API.

The offline pipeline moved to ``repro_torch.core.plan`` (``build_plan``
-> ``PartitionPlan``) and engines are built through
``repro_torch.core.session`` (``Session(plan, backend=...)``).
``WorkloadPartitioner`` remains as a thin shim so existing imports keep
working; new code should call ``build_plan`` directly.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Set

from .executor import CostModel, DistributedEngine
from .plan import (OfflineStats, PartitionConfig,  # noqa: F401 (re-export)
                   PartitionPlan, build_plan)
from .graph import RDFGraph
from .query import QueryGraph
from .workload import Workload

__all__ = ["PartitionConfig", "OfflineStats", "WorkloadPartitioner"]


class WorkloadPartitioner:
    """Deprecated: use ``build_plan`` + ``Session`` instead.

    ``run()`` now just builds a ``PartitionPlan`` (exposed as ``.plan``);
    the legacy attributes (``frag``, ``alloc``, ``dict``, ``stats``, ...)
    read through to it.
    """

    def __init__(self, graph: RDFGraph, workload: Workload,
                 config: Optional[PartitionConfig] = None):
        warnings.warn(
            "WorkloadPartitioner is deprecated; use "
            "repro_torch.core.build_plan(graph, workload, config) and "
            "repro_torch.core.Session(plan, backend=...)",
            DeprecationWarning, stacklevel=2)
        self.graph = graph
        self.workload = workload
        self.cfg = config or PartitionConfig()
        self.plan: Optional[PartitionPlan] = None

    # ------------------------------------------------------------------
    def run(self) -> "WorkloadPartitioner":
        self.plan = build_plan(self.graph, self.workload, self.cfg)
        return self

    def _plan(self) -> PartitionPlan:
        if self.plan is None:
            raise RuntimeError(
                "WorkloadPartitioner.run() has not been called yet")
        return self.plan

    # -- legacy attribute surface ---------------------------------------
    @property
    def stats(self):
        return self._plan().stats

    @property
    def frag(self):
        return self._plan().frag

    @property
    def alloc(self):
        return self._plan().alloc

    @property
    def dict(self):
        return self._plan().dictionary

    @property
    def selected_patterns(self) -> List[QueryGraph]:
        return self._plan().selected_patterns

    @property
    def cold_props(self) -> Set[int]:
        return self._plan().cold_props

    @property
    def selection(self):
        return self._plan().selection

    # ------------------------------------------------------------------
    def engine(self, cost: Optional[CostModel] = None) -> DistributedEngine:
        if self.plan is None:
            raise RuntimeError(
                "WorkloadPartitioner.run() must be called before engine()")
        return self.plan.build_local_engine(cost)
