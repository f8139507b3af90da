"""Shape-keyed micro-batching: bucket concurrent requests by the SPMD
engine's matcher key and flush whole buckets.

The SPMD engine binds one match loop per *normalized pattern shape*
(``core/spmd.py``: constants are stripped by ``QueryGraph.normalize``
and re-applied as a filter, so the matcher cache is keyed by
``query.normalize().edges``).  ``shape_key`` here is exactly that key --
two requests land in the same bucket **iff** they would hit the same
matcher entry, which is also the condition under which
``SpmdEngine._execute_batch`` can serve the whole bucket from a single
run of the match loop on the device.  Micro-batching therefore
amortizes that run across *users*, not just across one caller's
stream.

Flush rules (the classic two-knob micro-batcher):

* ``max_batch``  -- a bucket that reaches ``max_batch`` requests is
  moved to the ready list immediately (dispatch at the next pump);
* ``max_delay_s`` -- a bucket whose **oldest** request has waited
  ``max_delay_s`` is flushed even if short, so a lone request's latency
  overhead is bounded by the delay knob.

The batcher is a plain synchronous container: no locks, no threads, no
clock of its own -- every method takes ``now`` explicitly.  The
``FrontDoor`` serializes access under its own lock and injects its
clock, which is what makes the fake-clock unit tests deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

ShapeKey = Tuple  # tuple of normalized QueryEdge, hashable


def shape_key(query) -> ShapeKey:
    """The micro-batching bucket key for ``query``: its normalized edge
    structure -- the same key the SPMD engine's shape-keyed matcher
    cache uses, so one bucket == one matcher entry."""
    return query.normalize().edges


@dataclasses.dataclass
class Batch:
    """One flushed bucket: same-shape requests plus flush provenance."""
    key: ShapeKey
    requests: List[Any]
    reason: str          # "full" | "delay" | "drain"


class ShapeBatcher:
    """Buckets of pending requests keyed by query shape (see module
    docstring for the flush semantics).

    Requests must expose ``query`` and ``enqueued_at`` attributes (the
    front door's ``_Request``); arrival order is preserved within a
    bucket, and ``depth`` counts every request not yet taken.

    ``route_key`` (optional callable ``query -> hashable | None``)
    appends a routing token to the bucket key, so requests only batch
    together when they would also execute on the same replica route
    (``SpmdEngine.route_key``).  The route is a pure function of the
    normalized shape, so same-shape requests always carry the same
    token -- the refinement never splits a shape's bucket, it only
    keeps the key honest about what a dispatch will touch.
    """

    def __init__(self, max_batch: int = 16, max_delay_s: float = 0.005,
                 route_key=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.route_key = route_key
        self._buckets: Dict[ShapeKey, List[Any]] = {}
        self._ready: List[Batch] = []
        self.depth = 0

    # ------------------------------------------------------------------
    def add(self, request) -> None:
        """Enqueue one admitted request into its shape bucket; a bucket
        reaching ``max_batch`` moves to the ready list immediately."""
        key = shape_key(request.query)
        if self.route_key is not None:
            key = (key, self.route_key(request.query))
        bucket = self._buckets.setdefault(key, [])
        bucket.append(request)
        self.depth += 1
        if len(bucket) >= self.max_batch:
            del self._buckets[key]
            self._ready.append(Batch(key, bucket, "full"))

    def take_ready(self, now: float) -> List[Batch]:
        """Every batch due for dispatch at time ``now``: buckets that
        filled to ``max_batch`` plus buckets whose oldest request has
        waited ``max_delay_s``.  Taken batches leave the batcher."""
        out, self._ready = self._ready, []
        for key in list(self._buckets):
            bucket = self._buckets[key]
            if now - bucket[0].enqueued_at >= self.max_delay_s:
                del self._buckets[key]
                out.append(Batch(key, bucket, "delay"))
        self.depth -= sum(len(b.requests) for b in out)
        return out

    def next_due(self) -> Optional[float]:
        """Earliest time a pending bucket becomes due (``-inf``-like
        immediate when a full bucket is already waiting; ``None`` when
        empty)."""
        if self._ready:
            return float("-inf")
        if not self._buckets:
            return None
        return min(b[0].enqueued_at for b in self._buckets.values()) \
            + self.max_delay_s

    def flush_all(self) -> List[Batch]:
        """Take everything, due or not (shutdown drain)."""
        out, self._ready = self._ready, []
        for key, bucket in self._buckets.items():
            out.append(Batch(key, bucket, "drain"))
        self._buckets.clear()
        self.depth = 0
        return out

    def __len__(self) -> int:
        return self.depth
