"""Find the knee of an open-loop cell: the highest offered rate at which
the door sheds nothing and its backlog does not grow over the window.

Sets the cell up once, then offers each ``--rates`` for ``--seconds``
(the cell's own mix, arrivals and seed handling, one window after the
other), and prints one JSON line per rate: offered and answered rates,
sheds and failures, latency from the due time (p50 / p90 / p95 / p99), and the
door's queue depth in the first and the last third of the window.  The
cell's ``rate_qps`` is then set to 0.8 of the knee by hand.  Run it on
the chip from the root of a checkout:

    python3 rdfbench/tools/knee.py --workload <cell> --seconds 20 \
        --rates 20 40 60 80
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import List

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from rdfbench import harness, traffic  # noqa: E402


@dataclasses.dataclass
class DepthProbe:
    """Samples the door's queue depth wherever the window keeps time."""
    door: object
    samples: List = dataclasses.field(default_factory=list)

    def tick(self, now: float) -> None:
        if now < float("inf"):
            self.samples.append((now, self.door.queue_depth))


def sweep(cell: harness.Cell, seed: int, seconds: float,
          rates: List[float], device: str) -> None:
    t_start = time.monotonic()
    system = harness.build_system(cell.config, seed, device)
    door = system.session.serve()
    door.start()
    harness.warm_up(system.session, door, cell.mix)
    harness.log(f"set-up {time.monotonic() - t_start:.1f} s")
    requests = traffic.Requests(cell.mix, system.graph_cols, system.perm,
                                seed)
    for k, rate in enumerate(rates):
        mix = dict(cell.mix, rate_qps=rate)
        offsets = traffic.arrivals(mix, seconds, seed + k)
        probe = DepthProbe(door)
        t0 = time.monotonic()
        reqs, late = harness.open_window(door, requests, offsets, seconds,
                                         probe, t0)
        t1 = t0 + seconds
        lat = sorted((r.done if r.outcome == "completed"
                      else t1 + harness.GRACE_S) - r.due for r in reqs)
        d = np.array([q for _t, q in probe.samples] or [0.0])
        third = max(len(d) // 3, 1)
        print(json.dumps({
            "offered_qps": rate, "arrivals": len(reqs),
            "answered_qps": sum(r.outcome == "completed" and r.done <= t1
                                for r in reqs) / seconds,
            "shed": sum(r.outcome == "shed" for r in reqs),
            "failed": sum(r.outcome == "failed" for r in reqs),
            "p50_ms": harness.percentile(lat, 0.50) * 1e3,
            "p90_ms": harness.percentile(lat, 0.90) * 1e3,
            "p95_ms": harness.percentile(lat, 0.95) * 1e3,
            "p99_ms": harness.percentile(lat, 0.99) * 1e3,
            "depth_first_third": float(d[:third].mean()),
            "depth_last_third": float(d[-third:].mean()),
            "late_p99_ms": float(np.percentile(late, 99) * 1e3)}),
            flush=True)
    door.close()


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="rdfbench/tools/knee.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    sweep(cell, args.seed, args.seconds, args.rates,
          harness.require_device(cell.chips))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
