"""What the profiler saw in the traced part of a window: device busy
time, time by device function, the join kernels' device time, and the
device's idle gaps named by what the host was doing in them.

``summarize`` takes plain (name, start, end, on device, thread) records,
so that the arithmetic is tested without a card; ``records`` builds them
from a ``torch.profiler`` session.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from . import roofline

#: (name, start s, end s, on the device, host thread id)
Record = Tuple[str, float, float, bool, int]


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    join_device_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def profiler(device: str):
    """A started ``torch.profiler.profile`` of the host operations of
    every thread (where this PyTorch can) and, on a card, of the device.
    It warms up, which takes a second or more, until the first
    ``step()`` starts its one recording cycle; the second ``step()``
    ends it."""
    import torch
    from torch.profiler import ProfilerActivity, schedule
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    kw = {"activities": acts, "acc_events": True,
          "schedule": schedule(wait=0, warmup=1, active=1, repeat=1)}
    try:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = torch.profiler.profile(**kw)
    prof.start()
    return prof


def records(prof) -> List[Record]:
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    out: List[Record] = []
    for e in prof.events():
        tr = e.time_range
        out.append((e.name, tr.start * 1e-6, tr.end * 1e-6,
                    e.device_type == DeviceType.CUDA, int(e.thread)))
    return out


def _union(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _short(name: str) -> str:
    """A device function's name without return type, arguments, template
    arguments and anonymous namespace."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    return (n.split("(", 1)[0].split("<", 1)[0].strip() or name)[:120]


def summarize(recs: Sequence[Record], mark: str, top: int = 10
              ) -> TraceSummary:
    """Over the host span named ``mark`` (the profiled part of the
    window; its length is ``window_s``), every interval clipped to it:
    busy seconds (the union of device intervals), the join kernels'
    device seconds, the ``top`` device functions by seconds, and the
    idle time between device intervals summed by the innermost host
    operation at each gap's middle (``host`` where none runs) on the
    thread that ran the most host operations: the door's dispatcher,
    which makes every engine call."""
    marks = [(a, b) for n, a, b, on_dev, _t in recs
             if n == mark and not on_dev]
    if not marks:
        return TraceSummary(0.0, 0.0, 0.0, [], [])
    lo, hi = marks[0]
    recs = [(n, max(a, lo), min(b, hi), on_dev, t)
            for n, a, b, on_dev, t in recs
            if n != mark and b > lo and a < hi]
    window_s = hi - lo
    dev = [(a, b) for _n, a, b, on_dev, _t in recs if on_dev and b > a]
    busy = _union(dev)
    by_name: Dict[str, float] = defaultdict(float)
    join_s = 0.0
    for n, a, b, on_dev, _t in recs:
        if on_dev and b > a:
            by_name[_short(n)] += b - a
            if roofline.is_join_kernel(n):
                join_s += b - a
    threads: Dict[int, int] = defaultdict(int)
    for _n, _a, _b, on_dev, t in recs:
        if not on_dev:
            threads[t] += 1
    main = max(threads, key=threads.get) if threads else None
    host = sorted((a, -b, n) for n, a, b, on_dev, t in recs
                  if not on_dev and t == main)
    gaps: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[float, str]] = []      # open host ops, outermost first
    k = 0
    for (_a0, b0), (a1, _b1) in zip(busy, busy[1:]):
        mid = 0.5 * (b0 + a1)
        while k < len(host) and host[k][0] <= mid:
            a, nb, n = host[k]
            while stack and stack[-1][0] < a:
                stack.pop()
            stack.append((-nb, n))
            k += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        gaps[stack[-1][1] if stack else "host"] += a1 - b0
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(window_s, sum(b - a for a, b in busy), join_s,
                        rank(by_name), rank(gaps))
