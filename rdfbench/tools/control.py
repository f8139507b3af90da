"""The control's readings beside the program's, at a cell's own size.

For each seed: one run of the cell (set-up, a window of ``--seconds``),
then the comparison that decides ``correct``, once with the program's
answers and once with the control's (``control.Truncated``: the
reference's answers cut to the first capacity tier) in their place,
over the same requests.  The
program has to read 0 wrong outcomes and the control more.  It also
reads a fault at the cell's size: the program's own answers delivered
to the wrong requests, each checked answer handed to the next checked
request of the same shape, as a door that mixed up a batch's members
would.  Run it on the chip from the root of a checkout:

    python3 rdfbench/tools/control.py --workload <cell> --seconds 10 \
        --seeds 11 12 13
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from rdfbench import control, harness, reference  # noqa: E402


def swapped(reqs: List[harness.Req]) -> List[harness.Req]:
    """The checked, answered requests, each with the answer of the next
    one of the same shape (the query with its constants replaced by a
    marker), in a ring; a shape with one such request keeps its own."""
    groups: Dict = {}
    for r in reqs:
        if r.check and r.outcome == "completed":
            shape = tuple((a if a < 0 else "c", b if b < 0 else "c", p)
                          for a, b, p in r.edges)
            groups.setdefault(shape, []).append(r)
    out = []
    for members in groups.values():
        for k, r in enumerate(members):
            nxt = members[(k + 1) % len(members)]
            out.append(dataclasses.replace(r, answer=nxt.answer))
    return out


def readings(cell: harness.Cell, seed: int, seconds: float,
             device: str) -> Dict[str, int]:
    """The program's and the control's wrong outcomes on one seed."""
    t = time.monotonic()
    res = harness.execute(cell, seed, seconds, False, device, t)
    cap = int(cell.config["spmd_max_capacity"])
    index = reference.GraphIndex(*res.graph_cols)
    program = harness.judge(index, res.reqs, cap)
    truncated = control.Truncated(index, int(cell.config["spmd_capacity"]))
    ctrl = harness.judge(index, res.reqs, cap, answers=truncated.answer)
    swap = harness.judge(index, swapped(res.reqs), cap)
    return {"seed": seed, "program_wrong": program["wrong_outcomes"],
            "program_compared": program["compared"],
            "control_wrong": ctrl["wrong_outcomes"],
            "control_compared": ctrl["compared"],
            "swapped_wrong": swap["wrong_outcomes"],
            "swapped_compared": swap["compared"],
            "answer_rows": {str(t): [len(v), sum(n > 0 for n in v),
                                     int(np.median(v)), max(v)]
                            for t, v in sorted(program["sizes"].items())}}


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="rdfbench/tools/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = harness.require_device(cell.chips)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
