"""The body of ``python -m repro_torch.serve --smoke`` (``__main__``).

``run_smoke`` builds a small WatDiv-like plan and an SPMD session and
runs the gates: parity through the full admission -> micro-batch ->
dispatch path, the capacity sweep, the span chain and the metrics
snapshot; it writes the capacity record and returns the exit code.
With a ``SiteMesh`` of a process group (``--world N``), every rank
builds the same plan and its shard of the session: rank 0 leads and
runs the gates, the other ranks follow (``Session.lead`` /
``Session.follow``), so every engine call reaches every rank.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BENCH_SCHEMA = "repro.bench/v1"
SITES = 4                    # the smoke plan's sites, the mesh's slots


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


def log(msg: str) -> None:
    print(f"[repro_torch.serve] {msg}", file=sys.stderr, flush=True)


def run_smoke(args: argparse.Namespace, mesh=None) -> int:
    """The smoke on ``args.device``, in this process or (``mesh`` of a
    group) as one rank of it.  Returns the exit code (rank 0's on a
    group; 0 on the followers, whose errors raise)."""
    import numpy as np

    from ..core import (PartitionConfig, Session, build_plan,
                        generate_watdiv, generate_workload,
                        make_shape_queries)
    from ..device import resolve_device
    from ..obs.metrics import MetricsRegistry
    from ..obs.trace import Tracer

    device = resolve_device(args.device)      # raises without CUDA
    t_start = time.perf_counter()
    on_group = mesh is not None and mesh.group is not None
    if not on_group or mesh.rank == 0:
        log(f"building plan + SPMD session on {device}"
            + (f", {mesh.world} ranks, {mesh.slots} slots" if on_group
               else ""))
    g = generate_watdiv(args.triples, seed=1)
    wl = generate_workload(g, 400, seed=2)
    plan = build_plan(g, wl, PartitionConfig(kind="vertical",
                                             num_sites=SITES))

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
                   metrics_registry=registry, mesh=mesh)
    if not on_group:
        return _gates(args, sess, queries, registry, tracer, 1, t_start)
    if mesh.rank != 0:
        calls = sess.follow()
        log(f"rank {mesh.rank}: followed {len(calls)} calls")
        return 0
    with sess.lead():
        return _gates(args, sess, queries, registry, tracer, mesh.world,
                      t_start)


def _gates(args, sess, queries, registry, tracer, n_dev, t_start) -> int:
    from ..obs.export import (REQUIRED_METRICS, REQUIRED_SERVE_METRICS,
                              snapshot, validate_snapshot)
    from . import FrontDoor, FrontDoorConfig, measure_capacity

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
    log(f"parity: {len(queries)} queries, {mismatches} mismatches, "
        f"{failed} failed or fallen back")

    # ---- span-chain gate: admission -> batch -> execute --------------
    batch_roots = [s for s in tracer.store.spans()
                   if s.name == "serve_batch"]
    chain_ok = bool(batch_roots) and all(
        s.find("query") and any(r.get("kind") == "admission"
                                for r in s.records)
        for s in batch_roots)
    log(f"span chain: {len(batch_roots)} serve_batch roots, "
        f"chain_ok={chain_ok}")

    # ---- capacity model ----------------------------------------------
    t0 = time.perf_counter()
    for q in queries:
        sess.execute(q)
    base_qps = len(queries) / max(time.perf_counter() - t0, 1e-12)
    log(f"measured sequential base rate: {base_qps:.1f} qps")
    reports = measure_capacity(
        lambda: FrontDoor(sess, FrontDoorConfig(
            max_queue=128, max_batch=8, max_delay_ms=2.0)),
        queries, base_qps, multipliers=(1.0, 4.0, 16.0),
        duration_s=args.duration, seed=7, deadline_s=5.0)
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
        log(f"{variant}: offered={rep.offered_qps:.0f} "
            f"achieved={rep.achieved_qps:.0f} qps, "
            f"p50={rep.p50_latency_s * 1e3:.1f}ms "
            f"p99={rep.p99_latency_s * 1e3:.1f}ms "
            f"shed_rate={rep.shed_rate:.2%} failed={rep.failed}")

    # ---- snapshot gate -----------------------------------------------
    doc = snapshot(registry, tracer=tracer)
    validate_snapshot(doc,
                      required=tuple(REQUIRED_METRICS)
                      + tuple(REQUIRED_SERVE_METRICS))
    log("metrics snapshot validated "
        f"({len(REQUIRED_METRICS) + len(REQUIRED_SERVE_METRICS)} "
        f"required names)")

    payload = {"schema": BENCH_SCHEMA, "git_rev": _git_rev(),
               "device": str(sess.device), "device_count": n_dev,
               "rows": rows,
               "bench_seconds": {"serve_smoke":
                                 time.perf_counter() - t_start},
               "metrics": doc}
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    log(f"wrote {len(rows)} rows to {args.out}")

    if mismatches or failed or not chain_ok:
        log(f"FAILED (mismatches={mismatches}, failed={failed}, "
            f"chain_ok={chain_ok})")
        return 1
    log("smoke OK")
    return 0


def smoke_rank(opts: dict) -> int:
    """One rank of ``--world N``: the smoke on a ``SITES``-slot mesh of
    the whole group."""
    import torch
    import torch.distributed as dist

    from ..launch.mesh import make_host_mesh
    mesh = make_host_mesh(SITES, group=dist.group.WORLD,
                          device=opts["device"])
    if mesh.device.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.world))
    return run_smoke(argparse.Namespace(**opts), mesh)
