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

Exit code is non-zero on any parity mismatch, failed request or
validation failure.  Importing this module runs nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BENCH_SCHEMA = "repro.bench/v1"


def _git_rev() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)),
            check=True).stdout.strip()
    except Exception:
        return "unknown"


def _answer_set(res):
    vars_sorted = sorted(res.bindings)
    cols = [list(map(int, res.bindings[v])) for v in vars_sorted]
    return tuple(vars_sorted), set(zip(*cols)) if cols else set()


def _log(msg: str) -> None:
    print(f"[repro_torch.serve] {msg}", file=sys.stderr, flush=True)


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
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.print_help()
        return 0

    import numpy as np

    from ..core import (PartitionConfig, Session, build_plan,
                        generate_watdiv, generate_workload,
                        make_shape_queries)
    from ..device import resolve_device
    from ..obs.export import (REQUIRED_METRICS, REQUIRED_SERVE_METRICS,
                              snapshot, validate_snapshot)
    from ..obs.metrics import MetricsRegistry
    from ..obs.trace import Tracer
    from . import FrontDoor, FrontDoorConfig, measure_capacity

    device = resolve_device(args.device)      # raises without CUDA
    t_start = time.perf_counter()
    _log(f"building plan + SPMD session on {device}")
    g = generate_watdiv(args.triples, seed=1)
    wl = generate_workload(g, 400, seed=2)
    plan = build_plan(g, wl, PartitionConfig(kind="vertical", num_sites=4))

    rng = np.random.default_rng(9)
    p = np.asarray(g.p)

    def rp() -> int:
        return int(p[rng.integers(0, len(p))])

    queries = []
    for _ in range(4):
        queries.extend(make_shape_queries(rp).values())

    registry = MetricsRegistry()
    tracer = Tracer(enabled=True, capacity=4096)
    sess = Session(plan, backend="spmd", device=device, tracer=tracer,
                   metrics_registry=registry)

    # ---- parity through the full serving path ------------------------
    # the direct pass also warms the engine: the kernel libraries build
    # and load here, on this thread, not inside the dispatcher
    direct = [sess.execute(q) for q in queries]
    with sess.serve(max_batch=8, max_delay_ms=2.0) as door:
        futs = [door.submit(q, deadline_s=120.0) for q in queries]
        served = [f.result(timeout=120) for f in futs]
    mismatches = sum(_answer_set(a) != _answer_set(b)
                     for a, b in zip(direct, served))
    failed = int(door.stats()["failed"] + door.stats()["batch_fallbacks"])
    _log(f"parity: {len(queries)} queries, {mismatches} mismatches, "
         f"{failed} failed or fallen back")

    # ---- span-chain gate: admission -> batch -> execute --------------
    batch_roots = [s for s in tracer.store.spans()
                   if s.name == "serve_batch"]
    chain_ok = bool(batch_roots) and all(
        s.find("query") and any(r.get("kind") == "admission"
                                for r in s.records)
        for s in batch_roots)
    _log(f"span chain: {len(batch_roots)} serve_batch roots, "
         f"chain_ok={chain_ok}")

    # ---- capacity model ----------------------------------------------
    t0 = time.perf_counter()
    for q in queries:
        sess.execute(q)
    base_qps = len(queries) / max(time.perf_counter() - t0, 1e-12)
    _log(f"measured sequential base rate: {base_qps:.1f} qps")
    reports = measure_capacity(
        lambda: FrontDoor(sess, FrontDoorConfig(
            max_queue=128, max_batch=8, max_delay_ms=2.0)),
        queries, base_qps, multipliers=(1.0, 4.0, 16.0),
        duration_s=args.duration, seed=7, deadline_s=5.0)
    # the cards this run used: the sites share one
    n_dev = 1
    rows = [{"bench": "serve_smoke", "variant": "parity",
             "metric": "parity_mismatches", "value": float(mismatches)},
            {"bench": "serve_smoke", "variant": "capacity",
             "metric": "base_qps", "value": base_qps}]
    for rep in reports:
        failed += rep.failed
        variant = f"load_{rep.offered_multiplier:g}x"
        row = rep.to_row()
        row["qps_per_device"] = round(rep.achieved_qps / n_dev, 3)
        rows.extend({"bench": "serve_smoke", "variant": variant,
                     "metric": k, "value": float(v)}
                    for k, v in row.items())
        _log(f"{variant}: offered={rep.offered_qps:.0f} "
             f"achieved={rep.achieved_qps:.0f} qps, "
             f"p50={rep.p50_latency_s * 1e3:.1f}ms "
             f"p99={rep.p99_latency_s * 1e3:.1f}ms "
             f"shed_rate={rep.shed_rate:.2%} failed={rep.failed}")

    # ---- snapshot gate -----------------------------------------------
    doc = snapshot(registry, tracer=tracer)
    validate_snapshot(doc,
                      required=tuple(REQUIRED_METRICS)
                      + tuple(REQUIRED_SERVE_METRICS))
    _log("metrics snapshot validated "
         f"({len(REQUIRED_METRICS) + len(REQUIRED_SERVE_METRICS)} "
         f"required names)")

    payload = {"schema": BENCH_SCHEMA, "git_rev": _git_rev(),
               "device": str(device), "device_count": n_dev, "rows": rows,
               "bench_seconds": {"serve_smoke":
                                 time.perf_counter() - t_start},
               "metrics": doc}
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    _log(f"wrote {len(rows)} rows to {args.out}")

    if mismatches or failed or not chain_ok:
        _log(f"FAILED (mismatches={mismatches}, failed={failed}, "
             f"chain_ok={chain_ok})")
        return 1
    _log("smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
