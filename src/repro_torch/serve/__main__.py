"""Serve smoke: ``python -m repro_torch.serve --smoke``.

A short, seeded end-to-end pass over the whole serving front door on
the port's SPMD engine, the JAX package's ``python -m repro.serve
--smoke`` on the card:

1. build a small WatDiv-like plan and an SPMD session on ``--device``
   (``cuda`` by default; it raises where there is none);
2. **parity** -- every query of the seeded star/chain/cycle workload
   is answered through the full admission -> micro-batch -> dispatch
   path and must be set-identical to direct ``Session.execute``;
3. **capacity** -- a seeded open-loop load sweep at 1x/4x/16x of the
   measured sequential base rate (``measure_capacity``);
4. **telemetry gate** -- the admission -> batch -> execute span chain
   must be present in the trace store, and the metrics snapshot must
   validate against ``REQUIRED_METRICS + REQUIRED_SERVE_METRICS``;
5. the capacity model is written as a ``repro.bench/v1`` record
   (default ``reports/serve_smoke.json``).

``--world N`` (1, 2 or 4) runs it on N ranks of a process group
started by ``repro_torch.launch.mesh.launch`` -- NCCL with rank r on
``cuda:r``, or gloo with ``--device cpu`` -- each rank serving its
block of the 4 sites: rank 0 leads and runs the gates, the other ranks
follow (the counterpart of the JAX smoke's 4-device mesh).

Exit code is non-zero on any parity mismatch, failed request or
validation failure.  Importing this module runs nothing.
"""
from __future__ import annotations

import argparse
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.serve",
        description="RDF query serving front door -- smoke runner "
                    "(the serving layer itself is a library: "
                    "Session.serve() / repro_torch.serve.FrontDoor)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the short seeded load-generator smoke")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the store lives and the joins run")
    ap.add_argument("--out", default="reports/serve_smoke.json",
                    metavar="PATH",
                    help="where to write the repro.bench/v1 capacity "
                         "record")
    ap.add_argument("--duration", type=float, default=0.6,
                    help="seconds of offered load per capacity tier")
    ap.add_argument("--triples", type=int, default=6_000,
                    help="size of the seeded WatDiv-like graph")
    ap.add_argument("--world", type=int, default=1, choices=(1, 2, 4),
                    help="ranks of a process group serving the 4 sites "
                         "(rank 0 leads; gloo with --device cpu, NCCL "
                         "on cards); 1 runs in this process")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.print_help()
        return 0

    from .smoke import log, run_smoke, smoke_rank
    if args.world == 1:
        return run_smoke(args)
    from ..launch.mesh import launch
    with tempfile.TemporaryDirectory(prefix="serve-smoke-") as d:
        rcs = launch(smoke_rank, args.world, d,
                     backend="nccl" if args.device == "cuda" else "gloo",
                     args=(vars(args),), timeout_s=300.0, deadline_s=900.0)
    log(f"{args.world} ranks: exit codes {rcs}")
    return rcs[0]


if __name__ == "__main__":
    sys.exit(main())
