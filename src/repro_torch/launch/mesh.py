"""Site meshes and the process launcher of the SPMD engine.

The JAX package's ``launch/mesh.py`` builds jax meshes over devices that
one Python process drives.  Here a ``SiteMesh`` describes the site axis
the plan's logical sites fold onto (``slots`` wide) and where its parts
run:

* without a process group, the one-process axis: every slot in this
  process, on one device (the engine's default);
* on a ``torch.distributed`` process group, a block of the axis per
  rank: rank r owns the contiguous slots ``[r*k, (r+1)*k)``, k =
  slots / world, on its own device (``cuda:r`` on one host, NCCL; the
  CPU with gloo only when asked).  An all-gather across the ranks in
  rank order then gives the rows in slot order, as the one-process
  axis concatenates them.

The process-group axis is multi-controller: every rank runs the same
calling code and calls ``execute`` / ``execute_many`` on the same
queries in the same order, as a ``torchrun`` script would.

``launch`` starts such a group: ``world`` processes by the ``spawn``
start method, each initialising the group from a ``FileStore`` with a
timeout and calling one module-level function; it returns every rank's
result, or terminates every rank and raises when one raises, dies or
the deadline passes.

The LM substrate shards over a ``DeviceMesh`` of named axes instead
(``torch.distributed.device_mesh``, over the default group):
``make_production_mesh`` gives the reference's production shapes,
(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model"), and
``make_grid_mesh`` any other shape (the tests' (2, 2), the card's
(1, 1)).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import time
import traceback
import uuid
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.common import mesh_sizes


@dataclasses.dataclass(frozen=True)
class SiteMesh:
    """The site axis: ``slots`` wide, ``devices`` one per rank of
    ``group`` (one device and no group for the one-process axis)."""
    slots: int
    rank_devices: Tuple[torch.device, ...]
    group: Optional[Any] = None
    axis: str = "sites"

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"a site axis needs at least one slot, got "
                             f"{self.slots}")
        if len(self.rank_devices) != self.world:
            raise ValueError(f"{len(self.rank_devices)} devices for "
                             f"{self.world} ranks")
        if self.slots % self.world:
            raise ValueError(f"{self.slots} slots do not split into equal "
                             f"blocks over {self.world} ranks")
        if self.group is not None:
            backend = dist.get_backend(self.group)
            want = "nccl" if self.device.type == "cuda" else "gloo"
            if backend != want:
                raise ValueError(f"a site axis on {self.device.type} runs "
                                 f"over {want}, not {backend}")
            # NCCL and new tensors use the current card: it must be the
            # one this rank's shard lives on
            if self.device.type == "cuda" \
                    and torch.cuda.current_device() != self.device.index:
                raise ValueError(
                    f"rank {self.rank}'s slots are on {self.device} but "
                    f"cuda:{torch.cuda.current_device()} is current: "
                    f"launch the ranks with these devices")

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.rank_devices[self.rank]

    @property
    def devices(self) -> np.ndarray:
        """Every rank's device, in rank order."""
        out = np.empty(len(self.rank_devices), dtype=object)
        out[:] = self.rank_devices
        return out

    @property
    def local_slots(self) -> range:
        """The slots this rank owns."""
        k = self.slots // self.world
        return range(self.rank * k, (self.rank + 1) * k)


def _rank_device(device: Union[str, torch.device], rank: int
                ) -> torch.device:
    """Rank ``rank``'s device on one host: ``cuda:<rank>`` for
    ``"cuda"``, the CPU for ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if dev.index is not None:
        raise ValueError(f"name the device type, not {dev}: rank r of a "
                         f"group runs on cuda:r")
    if rank >= torch.cuda.device_count():
        raise ValueError(f"rank {rank} has no card: "
                         f"{torch.cuda.device_count()} on this host")
    return torch.device("cuda", rank)


def make_host_mesh(num_sites: int = 1, axis: str = "sites", *,
                   group: Optional[Any] = None,
                   device: Union[str, torch.device] = "cuda") -> SiteMesh:
    """A site axis of ``num_sites`` slots: in this process on ``device``
    without a ``group``, or split over the ranks of ``group`` with rank
    r on ``_rank_device(device, r)``."""
    if group is None:
        return SiteMesh(num_sites, (resolve_device(device),), None, axis)
    return SiteMesh(num_sites,
                    tuple(_rank_device(device, r)
                          for r in range(dist.get_world_size(group))),
                    group, axis)


def mesh_axis_sizes(mesh: Any) -> dict:
    """Axis name -> size of a ``SiteMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, SiteMesh):
        return {mesh.axis: mesh.slots}
    return mesh_sizes(mesh)


def make_grid_mesh(shape: Sequence[int], axes: Sequence[str], *,
                   device: Union[str, torch.device] = "cuda") -> Any:
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group, rank r at the row-major coordinate r (as
    ``jax.sharding.Mesh`` lays out ``devices().reshape(shape)``).  The
    group must be initialised with exactly ``prod(shape)`` ranks; each
    rank's device type is ``device``'s ("cuda" over NCCL, each rank on
    its current card; "cpu" over gloo, or the "fake" backend's
    dry run)."""
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} has {len(shape)} "
                         f"axes, names {tuple(axes)}")
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(f"need {n} ranks for a {tuple(shape)} mesh, have "
                           f"{have}; start a process group of {n} ranks "
                           f"(launch/dryrun.py runs on the fake backend)")
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "cuda") -> Any:
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks).

    Axes: ("data", "model") / ("pod", "data", "model").  "pod" is the
    cross-pod data/FSDP axis.  The default group must have that many
    ranks: a ``launch``ed group, or the "fake" backend of the dry run
    (``launch/dryrun.py``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_grid_mesh(shape, axes, device=device)


# ----------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------

def launch_device(backend: str, rank: int,
                  devices: Optional[Sequence[Any]] = None
                  ) -> Optional[torch.device]:
    """The card rank ``rank`` of a launched group makes current:
    ``devices[rank]`` when given, else ``cuda:<rank>``; none on gloo."""
    if backend != "nccl":
        return None
    dev = (torch.device(devices[rank]) if devices is not None
           else torch.device("cuda", rank))
    if dev.type != "cuda" or dev.index is None:
        raise ValueError(f"an NCCL rank runs on a numbered card, not {dev}")
    return dev


def _rank_main(fn: Callable, rank: int, world: int, store_path: str,
               backend: str, timeout_s: float, args: Sequence[Any],
               results, device: Optional[torch.device]) -> None:
    """One rank: its card current first (NCCL), the group from the
    file store and a barrier (no rank runs ``fn``, or tears the group
    down after it, while a peer is still connecting), ``fn(*args)``,
    its pickled result or its traceback on ``results``, then the group
    torn down."""
    started = False
    try:
        if device is not None:
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        started = True
        dist.barrier(device_ids=None if device is None else [device.index])
        out = pickle.dumps(fn(*args))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    else:
        results.put((rank, True, out))
    finally:
        if started:
            dist.destroy_process_group()


def launch(fn: Callable, world: int, store_dir: Union[str, os.PathLike], *,
           backend: str = "nccl", args: Sequence[Any] = (),
           devices: Optional[Sequence[Any]] = None,
           timeout_s: float = 120.0, deadline_s: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks of a new process group and
    return their results in rank order.

    ``fn`` is a module-level function (the ranks import its module) and
    its result must pickle.  The group (``backend`` "nccl", rank r on
    ``devices[r]``, by default ``cuda:r`` as ``make_host_mesh`` places
    it; or "gloo") rendezvouses through a ``FileStore`` under
    ``store_dir``; its collectives time out after ``timeout_s``.  When
    a rank raises or dies, or ``deadline_s`` passes before every rank
    has answered, every rank is terminated and a ``RuntimeError`` (a
    ``TimeoutError`` for the deadline) names it."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if devices is not None and (backend != "nccl" or len(devices) != world):
        raise ValueError(f"devices name one card for each of the {world} "
                         f"ranks of an NCCL group, got {list(devices)} on "
                         f"{backend}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store_path = os.path.join(os.fspath(store_dir),
                              f"group-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store_path, backend, timeout_s,
                               tuple(args), results,
                               launch_device(backend, r, devices)))
             for r in range(world)]
    end = time.monotonic() + deadline_s
    got: dict = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(got))} gave no "
                    f"result within {deadline_s} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                # a rank's result is in the pipe before its process ends
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead and results.empty():
                    raise RuntimeError(f"ranks exited without a result "
                                       f"(rank, exit code): {dead}")
                continue
            if not ok:
                # a failure makes its peers fail in their collectives:
                # report every failure that arrives within a second
                failed = {rank: val}
                grace = time.monotonic() + 1.0
                while time.monotonic() < grace:
                    try:
                        r, ok, v = results.get(timeout=0.1)
                    except queue_mod.Empty:
                        continue
                    if not ok:
                        failed[r] = v
                raise RuntimeError("".join(
                    f"rank {r} of {world} failed:\n{v}"
                    for r, v in sorted(failed.items())))
            got[rank] = pickle.loads(val)
        for p in procs:
            p.join(max(end - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if os.path.exists(store_path):
            os.remove(store_path)
    return [got[r] for r in range(world)]
