"""One front door and one control plane over a process group: rank 0
leads, the other ranks follow.

On a ``SiteMesh`` built on a ``torch.distributed`` group every rank
serves its block of the site axis, and every rank must make the same
engine calls in the same order (``launch/mesh.py``).  A ``Session``
that *leads* (``with session.lead(): ...`` on rank 0) announces each
engine call it makes -- ``execute``, ``execute_many``, ``swap_store``
and the adaptive backend's ``end_epoch`` -- to the other ranks before
it runs it; a session that *follows* (``session.follow()`` on every
other rank) takes each announcement and makes the same call on its own
session, until the leader releases it.  So a ``FrontDoor`` over the
leading session (its admission, shedding, deadlines and breaker on rank
0 alone) drives the whole group, and a request that never reaches the
engine is never announced.

An announcement is one object broadcast from rank 0 on the mesh's group
(``dist.broadcast_object_list``: NCCL on cards, gloo on the CPU), made
by the thread that then issues the call's collectives.  It carries the
call, its arguments as plain values (query edges, ``batch_size``; for a
swap the per-site edge ids, the replicated properties and, with a new
graph, its columns) and the outcome of the leader's previous call.

Errors stay symmetric.  An error decided from values equal on every
rank (marked by ``spmd.rank_symmetric``: overflow past
``max_capacity``, a wildcard property) is raised by every rank at the
same point; a follower records it and stays in step, so the leader's
front door can retry a failed batch per request.  A follower whose outcome differs
from the leader's raises ``GroupDivergedError``, and any other error
ends the follower: on a group started by ``launch`` the launcher then
terminates every rank and raises.  Nothing here catches anything
else.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, List, Optional, Tuple

import torch.distributed as dist

from ..launch.mesh import SiteMesh
from .spmd import COLLECTIVES, is_rank_symmetric

#: the announcement that ends a follower's loop
RELEASE = "release"

Outcome = Optional[Tuple[str, str]]     # None, or (error type, message)


class GroupDivergedError(RuntimeError):
    """A following rank's outcome of a call differs from the leader's:
    the group is no longer in step."""


@dataclasses.dataclass
class Followed:
    """One call a follower made: its name and the rank-symmetric error
    it recorded (``None`` when it returned)."""
    call: str
    error: Outcome


def group_mesh(mesh: Optional[SiteMesh], what: str) -> SiteMesh:
    """``mesh`` if it spans a process group, else a ``ValueError``
    naming ``what`` needed one."""
    if mesh is None or mesh.group is None:
        raise ValueError(f"{what} needs a session on a SiteMesh of a "
                         f"process group (Session(..., mesh=...))")
    return mesh


def broadcast_from_leader(obj: Any, mesh: SiteMesh) -> Any:
    """Rank 0's ``obj`` on every rank of ``mesh``'s group (the argument
    is ignored elsewhere), through the rank's device: the card on
    NCCL, the CPU on gloo."""
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(mesh.group, 0),
                               group=mesh.group, device=mesh.device)
    COLLECTIVES["broadcast"] += 1
    return box[0]


def outcome_of(exc: BaseException) -> Tuple[str, str]:
    return type(exc).__name__, str(exc)


class Leader:
    """Rank 0's side: announces each call, then runs it.  Calls from
    several threads (a door's dispatcher, the caller's own) take a lock
    around announcement and call, so the order of announcements is the
    order of the calls."""

    def __init__(self, mesh: SiteMesh):
        if mesh.rank != 0:
            raise ValueError(f"rank {mesh.rank} cannot lead: rank 0 leads, "
                             f"the other ranks follow")
        self.mesh = mesh
        self._lock = threading.RLock()
        self._last: Outcome = None

    def call(self, name: str, args: Any, fn: Callable[[], Any]) -> Any:
        """Announce ``name(args)``, then return ``fn()``."""
        with self._lock:
            broadcast_from_leader((self._last, name, args), self.mesh)
            self._last = None
            try:
                return fn()
            except BaseException as exc:
                # the followers compare it with their own outcome at the
                # next announcement
                self._last = outcome_of(exc)
                raise

    def release(self) -> None:
        """End the followers' loops (with the last call's outcome)."""
        with self._lock:
            broadcast_from_leader((self._last, RELEASE, None), self.mesh)


def follow(mesh: SiteMesh, run: Callable[[str, Any], Any]
           ) -> List[Followed]:
    """A follower's loop: ``run(name, args)`` for each announcement
    until the leader releases the group; returns the calls it made."""
    if mesh.rank == 0:
        raise ValueError("rank 0 leads a group; the other ranks follow")
    log: List[Followed] = []
    mine: Outcome = None
    while True:
        theirs, name, args = broadcast_from_leader(None, mesh)
        if theirs != mine:
            raise GroupDivergedError(
                f"rank {mesh.rank} of {mesh.world}: the call before "
                f"{name!r} ended with {mine or 'success'} here and with "
                f"{theirs or 'success'} on the leader")
        if name == RELEASE:
            return log
        mine = None
        try:
            run(name, args)
        except (RuntimeError, NotImplementedError) as exc:
            if not is_rank_symmetric(exc):
                raise
            mine = outcome_of(exc)
        log.append(Followed(name, mine))
