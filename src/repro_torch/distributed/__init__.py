"""Distributed runtime utilities: straggler mitigation and the
work-stealing queue the migration planner schedules through.  (The
JAX package's elastic re-meshing belongs to training and is not
ported yet.)"""
from .straggler import CompletedItem, StragglerMitigator, WorkItem, WorkQueue

__all__ = ["StragglerMitigator", "CompletedItem", "WorkItem", "WorkQueue"]
