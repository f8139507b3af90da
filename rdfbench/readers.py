"""The per-layer readers' arithmetic; each ``metrics/<name>.py`` binds
one of these to its name.  A reader returns ``None`` where its run has
nothing to read, and the metric is then left out of the result."""
from __future__ import annotations

from typing import Optional

from . import roofline


def plan_s(run) -> Optional[float]:
    """Seconds of ``build_plan`` (host clock around the call)."""
    return run.plan_s


def door_batch_size(run) -> Optional[float]:
    """Requests the door dispatched per batch over the window
    (``FrontDoor.stats()``: completed and failed over batches)."""
    batches = run.door.get("batches", 0.0)
    if batches <= 0:
        return None
    return (run.door["completed"] + run.door["failed"]) / batches


def _per_query(run, *counters: str) -> Optional[float]:
    if run.completed <= 0:
        return None
    return sum(run.engine.get(c, 0.0) for c in counters) / run.completed


def capacity_retries_per_query(run) -> Optional[float]:
    """The engine's capacity retries over the window per request
    completed in it."""
    return _per_query(run, "capacity_retries")


def shipping_steps_per_query(run) -> Optional[float]:
    """Join steps that shipped bindings or edges between sites over the
    window, per request completed in it."""
    return _per_query(run, "gather_steps", "edge_shipped_steps")


def join_roofline_share(run) -> Optional[float]:
    """Percent: the join calls' bound time (their bytes at the card's
    memory bandwidth) over the join kernels' device time, in the traced
    part of the window."""
    bw = roofline.HBM_BYTES_PER_S.get(run.device_kind)
    if bw is None or run.trace is None or run.trace.join_device_s <= 0:
        return None
    return 100.0 * (run.join_bytes / bw) / run.trace.join_device_s


def device_idle_share(run) -> Optional[float]:
    """Percent of the traced part of the window in which no operation
    ran on the device."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
