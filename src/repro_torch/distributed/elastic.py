"""Elastic scaling and failure recovery.

  * mesh shapes are *derived* from the live device count, never
    hard-coded: on failure or preemption, shrink to the largest
    (data' x model) grid the survivors support, keeping the model axis
    intact (TP groups must stay whole -- losing one chip of a TP group
    kills the group);
  * state is re-placed onto the new devices (``reshard``: checkpoint
    leaves are whole tensors, so re-placing is a move per leaf);
  * for the RDF engine, fragment allocation is *re-clustered* with
    Algorithm 2 at m' = surviving site count (the paper's allocator is
    cheap: metadata-scale), and the engine is rebuilt on a site mesh of
    the survivors (``ElasticMeshManager.make_mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.allocation import allocate
from ..device import resolve_device
from ..launch.mesh import SiteMesh
from ..tree import tree_map


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


class ElasticMeshManager:
    """Tracks the live device set and rebuilds site meshes after
    failures.

    ``devices`` defaults to every CUDA device (raising when there is
    none).  ``fail(devices)`` simulates losing devices (tests); a
    deployment would learn it from its group's heartbeat.
    """

    def __init__(self, model_parallel: int, pods: int = 1,
                 devices: Optional[Sequence[torch.device]] = None):
        if devices is None:
            first = resolve_device("cuda")
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if first.type == "cuda" else [first])
        self._all = list(devices)
        self._dead: set = set()
        self.model_parallel = model_parallel
        self.pods = pods
        self.generation = 0

    @property
    def live(self) -> List[torch.device]:
        return [d for d in self._all if id(d) not in self._dead]

    def fail(self, devices: Sequence[torch.device]) -> None:
        for d in devices:
            self._dead.add(id(d))
        self.generation += 1

    def recover(self) -> None:
        self._dead.clear()
        self.generation += 1

    def current_plan(self) -> MeshPlan:
        return plan_mesh(len(self.live), self.model_parallel, self.pods)

    @property
    def rank_devices(self) -> List[torch.device]:
        """The current plan's devices: rank r of a survivors' group runs
        on the r-th (pass them as ``launch(..., devices=)``)."""
        return self.live[:self.current_plan().devices_used]

    def make_mesh(self, group: Optional[Any] = None) -> SiteMesh:
        """A site mesh of ``rank_devices``, one slot each: over
        ``group``, whose rank r runs on the r-th of them (the group holds
        the survivors, launched on them), or, without a group, the
        one-process axis on the first of them."""
        used = self.rank_devices
        if group is None:
            return SiteMesh(len(used), (used[0],))
        if dist.get_world_size(group) != len(used):
            raise ValueError(f"a group of {dist.get_world_size(group)} "
                             f"ranks for {len(used)} live devices")
        return SiteMesh(len(used), tuple(used), group)

    def reshard(self, tree: Any, devices: Any) -> Any:
        """Re-place a (restored) state tree onto the new placement:
        ``devices`` is a tree of ``tree``'s structure naming each
        tensor's device."""
        return tree_map(lambda t, d: t.to(torch.device(d)), tree, devices)


def replan_allocation(affinity: np.ndarray, surviving_sites: int,
                      sizes: Optional[np.ndarray] = None,
                      balance_factor: float = 0.25) -> np.ndarray:
    """Re-run the paper's Algorithm 2 for a shrunken site set (RDF
    engine elastic path).  Returns fragment -> new site."""
    return allocate(affinity, surviving_sites, sizes, balance_factor).site_of
