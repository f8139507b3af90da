"""Elastic re-planning after a failure, the host-side (numpy) half of
the JAX package's ``distributed/elastic.py``.

  * mesh shapes are *derived* from the live device count, never
    hard-coded: on failure or preemption, shrink to the largest
    (data' x model) grid the survivors support, keeping the model axis
    intact (TP groups must stay whole -- losing one chip of a TP group
    kills the group);
  * for the RDF engine, fragment allocation is *re-clustered* with
    Algorithm 2 at m' = surviving site count (the paper's allocator is
    cheap: metadata-scale).

The JAX package's ``ElasticMeshManager`` builds jax meshes over the
live devices; its counterpart waits for a multi-process backend behind
``SiteAxis``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..core.allocation import allocate


@dataclasses.dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    devices_used: int


def plan_mesh(num_devices: int, model_parallel: int,
              pods: int = 1) -> MeshPlan:
    """Largest (pods, data, model) grid supported by ``num_devices``.

    Keeps ``model_parallel`` fixed (TP groups are whole or dead) and
    flexes the data axis; drops the pod axis when survivors < 2 pods.
    """
    if model_parallel > num_devices:
        raise ValueError("fewer devices than one TP group")
    if pods > 1:
        per_pod = num_devices // pods
        data = per_pod // model_parallel
        if data >= 1:
            return MeshPlan((pods, data, model_parallel),
                            ("pod", "data", "model"),
                            pods * data * model_parallel)
    data = num_devices // model_parallel
    return MeshPlan((data, model_parallel), ("data", "model"),
                    data * model_parallel)


def replan_allocation(affinity: np.ndarray, surviving_sites: int,
                      sizes: Optional[np.ndarray] = None,
                      balance_factor: float = 0.25) -> np.ndarray:
    """Re-run the paper's Algorithm 2 for a shrunken site set (RDF
    engine elastic path).  Returns fragment -> new site."""
    return allocate(affinity, surviving_sites, sizes, balance_factor).site_of
