"""Offline planning (numpy) and the execution backends: the SPMD
serving engine (torch, on the GPU) and the paper's host engines.

Pipeline (offline):
    graph, workload
      -> mining.mine_frequent_patterns        (§4)
      -> selection.select_patterns            (§4.1, Algorithm 1)
      -> fragmentation.build_fragmentation    (§5, vertical | horizontal)
      -> allocation.allocate_fragments        (§6, Algorithm 2)
      -> dictionary.DataDictionary.build      (§7.1)
    (or the §8 baselines: baselines.shape_fragmentation /
    warp_fragmentation), bundled by ``build_plan`` into a
    ``PartitionPlan`` (strategies registered in ``STRATEGIES``).
Online, through ``Session`` over one ``Engine`` protocol:
    "spmd"      spmd.SpmdEngine                (the sites on one GPU or
                                               across a process group)
    "local"     executor.DistributedEngine     (§7.2-7.3, Algorithms 3+4)
    "baseline"  baselines.BaselineEngine       (SHAPE/WARP model)
    "adaptive"  online.AdaptiveEngine          (drift -> refragment ->
                                               migrate, over "local" or
                                               "spmd")
"""
from .graph import RDFGraph, example_graph, generate_watdiv
from .query import QueryGraph, find_embedding, is_subgraph_of
from .workload import (Workload, class_template_probs,
                       generate_drifting_workload, generate_workload,
                       make_shape_queries, watdiv_templates)
from .mining import (FrequentPattern, frequent_properties,
                     mine_frequent_patterns, usage_matrix)
from .matching import match_pattern
from .selection import SelectionResult, select_patterns
from .fragmentation import (Fragment, Fragmentation, build_fragmentation,
                            horizontal_fragmentation, vertical_fragmentation)
from .allocation import (Allocation, ReplicationPlan, affinity_matrix,
                         allocate, allocate_experts, allocate_fragments,
                         fap_property_heat,
                         plan_replication, replicated_edge_ids,
                         workload_property_heat)
from .dictionary import DataDictionary
from .decomposition import Decomposition, decompose
from .optimizer import JoinPlan, optimize
from .engine import Engine, EngineBase, EngineStats
from .executor import (CostModel, DistributedEngine, ExecStats, QueryResult,
                       simulate_throughput)
from .baselines import (BaselineEngine, BaselineFragmentation,
                        shape_fragmentation, warp_fragmentation)
from .plan import (PartitionConfig, PartitionPlan, STRATEGIES,
                   StrategyRegistry, build_plan, register_strategy)
from .session import BACKENDS, Session
from .spmd import SpmdEngine
from .pipeline import WorkloadPartitioner

__all__ = [
    "RDFGraph", "example_graph", "generate_watdiv",
    "QueryGraph", "is_subgraph_of", "find_embedding",
    "Workload", "generate_workload", "watdiv_templates",
    "class_template_probs", "generate_drifting_workload",
    "make_shape_queries",
    "FrequentPattern", "mine_frequent_patterns", "frequent_properties",
    "usage_matrix",
    "match_pattern", "SelectionResult", "select_patterns",
    "Fragment", "Fragmentation", "build_fragmentation",
    "vertical_fragmentation", "horizontal_fragmentation",
    "Allocation", "affinity_matrix", "allocate", "allocate_fragments",
    "allocate_experts",
    "ReplicationPlan", "plan_replication",
    "fap_property_heat", "workload_property_heat", "replicated_edge_ids",
    "DataDictionary", "Decomposition", "decompose",
    "JoinPlan", "optimize", "CostModel", "DistributedEngine", "ExecStats",
    "QueryResult",
    "simulate_throughput", "BaselineEngine", "BaselineFragmentation",
    "shape_fragmentation", "warp_fragmentation",
    "Engine", "EngineBase", "EngineStats",
    "PartitionConfig", "PartitionPlan", "build_plan", "STRATEGIES",
    "StrategyRegistry", "register_strategy", "BACKENDS", "Session",
    "SpmdEngine", "WorkloadPartitioner",
]
