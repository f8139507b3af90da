"""Offline planning (numpy) and the SPMD serving engine (torch)."""
from .graph import RDFGraph, generate_watdiv
from .matching import match_pattern
from .plan import PartitionConfig, PartitionPlan, build_plan
from .query import QueryGraph
from .session import Session
from .spmd import SpmdEngine
from .workload import (Workload, generate_workload, make_shape_queries,
                       watdiv_templates)

__all__ = ["PartitionConfig", "PartitionPlan", "QueryGraph", "RDFGraph",
           "Session", "SpmdEngine", "Workload", "build_plan",
           "generate_watdiv", "generate_workload", "make_shape_queries",
           "match_pattern", "watdiv_templates"]
