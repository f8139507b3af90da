"""Distributed runtime utilities: elastic re-planning after a failure
(mesh shapes, the site mesh of the survivors and the RDF allocation
over the surviving sites), straggler mitigation and the work-stealing
queue the migration planner schedules through."""
from .elastic import (ElasticMeshManager, MeshPlan, plan_mesh,
                      replan_allocation)
from .straggler import CompletedItem, StragglerMitigator, WorkItem, WorkQueue

__all__ = ["ElasticMeshManager", "MeshPlan", "plan_mesh", "replan_allocation",
           "StragglerMitigator", "CompletedItem", "WorkItem", "WorkQueue"]
