"""PyTorch/CUDA port of the query-workload-driven RDF fragmentation and
allocation engine.

Host-side planning (mining, selection, fragmentation, allocation) is
numpy, as in the JAX package; the SPMD serving path runs the plan's
sites in lock step on one GPU through hand-written CUDA join kernels
(``repro_torch.kernels``).  Entry points default to ``device="cuda"``;
``device="cpu"`` runs the kernels' plain PyTorch versions.
"""
from .core import (PartitionConfig, PartitionPlan, RDFGraph, Session,
                   build_plan, generate_watdiv, generate_workload)

__all__ = ["PartitionConfig", "PartitionPlan", "RDFGraph", "Session",
           "build_plan", "generate_watdiv", "generate_workload"]
