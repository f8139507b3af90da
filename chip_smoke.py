#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on any error or mismatch:

1. the card's name and power limit; build the CUDA join kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, started
   together).
2. offline phase at full width: ``generate_watdiv(9_000_000, seed=1)``
   (about 7.6M distinct triples, 1.98M vertices: the most the 21-bit id
   bound admits), ``generate_workload(graph, 400, seed=2)`` and a
   4-site vertical plan, served by ``Session(plan, backend="spmd")`` on
   the card.
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes (binding tables of 4 x 4096 up to 4 x 2^18
   rows, 2 to 6 columns, the store's largest property window) and on
   the edge cases of the reference's kernel tests; all comparisons are
   exact (int32 / bool).  Times: the wrapper, its plain version and,
   where one PyTorch call computes the same function, that call.
4. serve: launch counters reset, WatDiv template queries with one term
   bound to a data constant plus a star, a chain and a cycle, counters
   read; every answer set equals the same engine run on the plain
   versions, a subset equals the host ``match_pattern``, and every
   kernel of the path launched.
5. the kernels as one JSON line, the card line, and last the result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TRIPLES = 9_000_000
DESIGN_QUERIES = 400
SITES = 4
SERVED = 64                  # template queries, one constant each
HOST_CHECKED = 16            # of which also checked on the host
MAX_CAPACITY = 1 << 24       # per-site binding rows
# Template 10 joins purchased and sells through their object: both point
# at products with Zipf popularity, so its constant-free match (what the
# engine evaluates before re-applying the constant) grows quadratically
# with the hub product; no per-site capacity holds it at this size.
UNSERVED_TEMPLATES = (10,)
# star / chain / cycle of make_shape_queries (property names in order)
SHAPE_PROPS = ("follows", "locatedIn", "friendOf",
               "makesReview", "reviewOf", "hasGenre",
               "friendOf", "friendOf", "follows")

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12     # H100 SXM non-tensor 32-bit rate

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "join_count": ("src/repro_torch/kernels/csrc/join_count.cu",
                   "src/repro/kernels/semijoin.py:63"),
    "pair_semijoin": ("src/repro_torch/kernels/csrc/pair_semijoin.cu",
                      "src/repro/kernels/semijoin.py:80"),
    "dedup_rows": ("src/repro_torch/kernels/csrc/dedup_rows.cu",
                   "src/repro/kernels/semijoin.py:239"),
    "fused_join": ("src/repro_torch/kernels/csrc/fused_join.cu",
                   "src/repro/kernels/semijoin.py:270"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events,
    after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# Kernel phase
# ----------------------------------------------------------------------

def _sorted_rows(nb, nc, nv):
    from repro_torch.kernels.ref import lexsort
    rows = torch.cat([nb, nc[:, None]], 1)[nv]
    if rows.shape[0] == 0:
        return rows
    return rows[lexsort([rows[:, c] for c in range(rows.shape[1] - 1, -1,
                                                   -1)])]


def _max_err(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    if a.shape != b.shape:
        fail(f"{what}: shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    if err:
        fail(f"{what}: kernel differs from its plain version (max abs "
             f"error {err})")
    return err


def kernel_phase(store) -> Dict[str, dict]:
    """Every kernel against its plain version; returns per-kernel
    numbers for the JSON line."""
    from repro_torch.constants import INT32_SENTINEL
    from repro_torch.kernels import ops, ref
    dev = store.device
    gen = torch.Generator(device="cpu").manual_seed(0)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    # the store's largest property window: real sorted keys + payload
    windows = [store.prop_window(p) for p in range(store.csr_offs.shape[1] - 1)]
    prop = int(np.argmax(windows))
    T = windows[prop]
    j = int(np.argmax(store.prop_dev_rows[:, prop]))
    start, stop = int(store.csr_offs[j, prop]), int(store.csr_offs[j, prop + 1])
    live = torch.arange(T, device=dev) < stop - start
    keys = torch.where(live, store.csr_sub_s[j, start:start + T],
                       INT32_SENTINEL).contiguous()
    payload = torch.where(live, store.csr_sub_o[j, start:start + T],
                          -1).contiguous()
    objs = torch.where(live, store.csr_obj_o[j, start:start + T],
                       INT32_SENTINEL).contiguous()
    kmin, kmax = int(keys[0]), int(keys[stop - start - 1])
    print(f"kernel shapes: largest window T={T} (property {prop}, "
          f"site {j}, {stop - start} live rows)", flush=True)
    out = {name: {"max_abs_err": 0} for name in KERNELS}

    def rec(name, err):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)

    widths = {4096: 2, 1 << 14: 3, 1 << 16: 5, 1 << 18: 6}   # cap -> V
    sentinel_keys = torch.full((T,), INT32_SENTINEL, dtype=torch.int32,
                               device=dev)
    for cap, V in widths.items():
        C = SITES * cap
        # join_count: real key window, probes half drawn from it
        probe = torch.where(ints(0, 2, C) == 0,
                            keys[ints(0, stop - start, C).long()],
                            ints(kmin, kmax + 1, C))
        for k in (keys, sentinel_keys, keys[:0]):
            rec("join_count", _max_err(ops.join_count(probe, k),
                                       ref.join_count_ref(probe, k),
                                       f"join_count C={C} T={k.numel()}"))
        # pair_semijoin: (s, o) pairs of the window in object order
        pick = ints(0, stop - start, C).long()
        q_s = torch.where(ints(0, 2, C) == 0, keys[pick], ints(kmin, kmax + 1, C))
        q_o = payload[pick]
        t_s, t_o = store.csr_obj_s[j, start:start + T], objs
        for ts_, to_ in ((t_s, t_o), (sentinel_keys, sentinel_keys),
                         (t_s[:0], t_o[:0])):
            rec("pair_semijoin", _max_err(
                ops.pair_semijoin(q_s, q_o, ts_, to_),
                ref.pair_semijoin_ref(q_s, q_o, ts_, to_),
                f"pair_semijoin C={C} T={ts_.numel()}"))
        # dedup_rows and fused_join on gathered binding tables
        for style in ("dup_heavy", "random", "all_sentinel", "distinct"):
            if style == "dup_heavy":
                bind = ints(0, 3, C, V)
            elif style == "distinct":
                bind = torch.arange(C * V, dtype=torch.int32,
                                    device=dev).reshape(C, V)
            else:
                bind = ints(kmin, kmax + 1, C, V)
            valid = (ints(0, 10, C) < 7) if style != "all_sentinel" \
                else torch.zeros(C, dtype=torch.bool, device=dev)
            if style != "distinct":
                bind = torch.where(valid[:, None], bind, -1)
            rec("dedup_rows", _max_err(
                ops.dedup_rows(bind, valid), ref.dedup_rows_ref(bind, valid),
                f"dedup_rows C={C} V={V} {style}"))
            pb = bind[:, 0].contiguous()
            for k, p_ in ((keys, payload), (sentinel_keys, payload)):
                got = ops.fused_join(bind, valid, pb, k, p_, cap)
                want = ref.fused_join_ref(bind, valid, pb, k, p_, cap)
                what = f"fused_join C={C} V={V} cap={cap} {style}"
                rec("fused_join", _max_err(got[3], want[3], what + " overflow"))
                if int(got[3]) == 0:
                    rec("fused_join", _max_err(_sorted_rows(*got[:3]),
                                               _sorted_rows(*want[:3]), what))
    # overflow at capacity 1 / 4 / 16 on a duplicate-heavy table with
    # dense key collisions: the overflow counts agree
    bind = ints(0, 3, 512, 2)
    valid = ints(0, 10, 512) < 9
    dense = torch.sort(ints(0, 3, 64)).values
    pay = ints(0, 99, 64)
    for cap in (1, 4, 16):
        got = ops.fused_join(bind, valid, bind[:, 0].contiguous(), dense,
                             pay, cap)
        want = ref.fused_join_ref(bind, valid, bind[:, 0].contiguous(),
                                  dense, pay, cap)
        if int(want[3]) <= 0:
            fail("overflow case did not overflow")
        rec("fused_join", _max_err(got[3], want[3], f"overflow cap={cap}"))
    # wrap guard: a count above (2^31-1)/C reports capacity + 1
    C = 1 << 16
    bind = torch.zeros((C, 1), dtype=torch.int32, device=dev)
    valid = torch.zeros(C, dtype=torch.bool, device=dev)
    valid[:3] = True
    bind[:3, 0] = torch.tensor([5, 6, 7], dtype=torch.int32, device=dev)
    wkeys = torch.full((40000,), 5, dtype=torch.int32, device=dev)
    wpay = torch.arange(40000, dtype=torch.int32, device=dev)
    got = ops.fused_join(bind, valid, bind[:, 0].contiguous(), wkeys, wpay, 16)
    if int(got[3]) != 17:
        fail(f"wrap guard: overflow {int(got[3])}, expected 17")
    rec("fused_join", _max_err(got[3], ref.fused_join_ref(
        bind, valid, bind[:, 0].contiguous(), wkeys, wpay, 16)[3], "wrap"))
    torch.cuda.synchronize()

    # times at the main path's top tested shape: 4 sites x 2^18 rows
    cap = 1 << 18
    C, V = SITES * cap, 4
    lg = float(np.log2(max(T, 2)))
    probe = keys[ints(0, stop - start, C).long()]
    q_s, q_o = keys[ints(0, stop - start, C).long()], ints(kmin, kmax + 1, C)
    t_s = store.csr_obj_s[j, start:start + T].contiguous()
    bind = ints(kmin, kmax + 1, C, V)
    valid = ints(0, 10, C) < 7
    pb = keys[ints(0, stop - start, C).long()]
    bind[:, 0] = pb
    # survivors and their expansion, for the fused join's data-dependent
    # bytes: capacity rows written
    n_keep = int(ref.dedup_rows_ref(bind, valid).sum())
    cases = {
        "join_count": (lambda: ops.join_count(probe, keys),
                       lambda: ref.join_count_ref(probe, keys),
                       lambda: torch.searchsorted(keys, probe, right=True)
                       - torch.searchsorted(keys, probe),
                       (2 * C + T) * 4, C * 2 * lg),
        "pair_semijoin": (lambda: ops.pair_semijoin(q_s, q_o, t_s, objs),
                          lambda: ref.pair_semijoin_ref(q_s, q_o, t_s, objs),
                          None, (C + T) * 8 + C, (C * 2 + T * 2) * lg),
        "dedup_rows": (lambda: ops.dedup_rows(bind, valid),
                       lambda: ref.dedup_rows_ref(bind, valid), None,
                       C * V * 4 + 2 * C, C * 6 * V),
        "fused_join": (lambda: ops.fused_join(bind, valid, pb, keys, payload,
                                              cap),
                       lambda: ref.fused_join_ref(bind, valid, pb, keys,
                                                  payload, cap), None,
                       C * V * 4 + C * 5 + T * 8 + cap * (4 * V + 5) + 4,
                       C * 6 * V + n_keep * 2 * lg + cap * 2 * np.log2(C)),
    }
    for name, (kern, plain, lib, nbytes, nops) in cases.items():
        bms, by = bound(nbytes, nops)
        out[name].update(
            ms=cuda_ms(kern), plain_ms=cuda_ms(plain, reps=5),
            library_ms=cuda_ms(lib) if lib is not None else None,
            bound_ms=bms, bound_by=by)
        print(f"kernel {name}: kernel_ms={out[name]['ms']:.4f} "
              f"plain_ms={out[name]['plain_ms']:.4f} "
              f"library_ms={out[name]['library_ms']} "
              f"bound_ms={bms:.5f} ({by}) at C={C} V={V} T={T} cap={cap}",
              flush=True)
    return out


# ----------------------------------------------------------------------
# Serve phase
# ----------------------------------------------------------------------

def answer_rows(cols: Dict[int, np.ndarray]) -> np.ndarray:
    """An answer set (variable -> column) as lexsorted distinct rows over
    its variables in sorted order."""
    vs = sorted(cols)
    rows = np.stack([np.asarray(cols[v], np.int64) for v in vs], 1)
    return np.unique(rows, axis=0)


def served_queries(graph) -> list:
    """WatDiv template queries with one term bound to a data constant
    (the servable templates), then the star, chain and cycle shapes."""
    from repro_torch.core import generate_workload, make_shape_queries
    from repro_torch.core.workload import PROP
    pool = generate_workload(graph, 2 * SERVED, seed=3,
                             constant_fraction=1.0, cold_fraction=0.0)
    queries = [q for q, t in zip(pool.queries, pool.template_ids)
               if t not in UNSERVED_TEMPLATES][:SERVED]
    if len(queries) < SERVED:
        fail(f"only {len(queries)} servable template queries")
    props = iter(PROP[n] for n in SHAPE_PROPS)
    shapes = make_shape_queries(lambda: next(props), k=3)
    return queries + [shapes["star"], shapes["chain"], shapes["cycle"]]


def serve_phase(session, plain, graph, queries, card: str) -> Dict[str, int]:
    """Serve ``queries`` through ``session`` between a reset and a read
    of the launch counters; then hold every answer set against
    ``plain`` (the same engine on the plain versions) and a subset
    against the host ``match_pattern``.  Returns the launch counts."""
    from unittest import mock

    from repro_torch.core import match_pattern
    from repro_torch.core import spmd as spmd_module
    from repro_torch.kernels import ops, ref

    ops.reset_launches()
    lat: List[float] = []
    results = []
    t_serve = time.perf_counter()
    for q in queries:
        t0 = time.perf_counter()
        results.append(session.execute(q))
        lat.append(time.perf_counter() - t0)
    t_serve = time.perf_counter() - t_serve
    launches = dict(ops.LAUNCHES)
    st = session.stats()
    print(f"launches on the serve path: {launches}", flush=True)
    lat_ms = np.asarray(lat) * 1e3
    print(f"serve ({card}): {len(queries)} queries in {t_serve:.2f} s, "
          f"qps={len(queries) / t_serve:.3f}, "
          f"p50_ms={np.percentile(lat_ms, 50):.2f}, "
          f"p99_ms={np.percentile(lat_ms, 99):.2f}, "
          f"comm_bytes={st.comm_bytes}, capacity_tiers_tried="
          f"{len(queries) + int(st.extra['capacity_retries'])}, "
          + ", ".join(f"{k}={int(st.extra[k])}" for k in (
              "capacity_retries", "gather_steps", "edge_shipped_steps",
              "edge_cache_hits", "skipped_gathers", "routed_queries",
              "compiled_shapes"))
          + f", result_rows={st.result_rows}", flush=True)

    # the same engine on the plain versions: the kernel wrappers the
    # match loop calls are replaced by their plain versions for this
    # phase only, and no kernel may launch in it
    ops.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.multiple(spmd_module, join_count=ref.join_count_ref,
                             pair_semijoin=ref.pair_semijoin_ref,
                             dedup_rows=ref.dedup_rows_ref,
                             fused_join=ref.fused_join_ref):
        plain_results = [plain.execute(q) for q in queries]
    t_plain = time.perf_counter() - t0
    if any(ops.LAUNCHES.values()):
        fail(f"kernels launched in the plain run: {ops.LAUNCHES}")
    for i, (a, b) in enumerate(zip(results, plain_results)):
        ra, rb = answer_rows(a.bindings), answer_rows(b.bindings)
        if ra.shape != rb.shape or not np.array_equal(ra, rb):
            fail(f"query {i} {queries[i].edges}: {ra.shape[0]} rows on "
                 f"the kernels, {rb.shape[0]} on the plain versions")
    print(f"plain versions: {len(queries)} answer sets equal "
          f"({t_plain:.2f} s on the plain versions)", flush=True)
    t0 = time.perf_counter()
    checked = list(range(HOST_CHECKED)) + list(range(SERVED, len(queries)))
    for i in checked:
        want = match_pattern(graph, queries[i], max_rows=1 << 40)
        if not np.array_equal(answer_rows(want.columns),
                              answer_rows(results[i].bindings)):
            fail(f"query {i} {queries[i].edges}: answer set differs from "
                 f"match_pattern")
    print(f"host match_pattern: {len(checked)} answer sets equal "
          f"({time.perf_counter() - t0:.1f} s); rows of the shape queries "
          f"{[r.num_rows for r in results[SERVED:]]}", flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the "
              "card only", file=sys.stderr)
        sys.exit(1)
    from repro_torch.core import (PartitionConfig, Session, build_plan,
                                  generate_watdiv, generate_workload)
    from repro_torch.kernels import build

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(secs)} "
          f"kernels (per kernel: "
          f"{ {k: round(v, 1) for k, v in secs.items()} })", flush=True)
    for name in build.SOURCES:
        log = build._library_path(name).with_suffix(".log")
        info = [ln for ln in log.read_text().splitlines() if "registers" in ln]
        print(f"ptxas {name}: " + " | ".join(ln.strip() for ln in info),
              flush=True)

    t0 = time.perf_counter()
    graph = generate_watdiv(TRIPLES, seed=1)
    t_graph = time.perf_counter() - t0
    design = generate_workload(graph, DESIGN_QUERIES, seed=2)
    t0 = time.perf_counter()
    plan = build_plan(graph, design,
                      PartitionConfig(kind="vertical", num_sites=SITES))
    t_plan = time.perf_counter() - t0
    print(f"graph: {graph.num_edges} triples, {graph.num_vertices} "
          f"vertices in {t_graph:.1f} s; plan: {t_plan:.1f} s "
          f"({plan.stats.num_fragments} fragments, redundancy "
          f"{plan.stats.redundancy_ratio:.3f})", flush=True)
    t0 = time.perf_counter()
    session = Session(plan, backend="spmd", spmd_max_capacity=MAX_CAPACITY)
    store = session.engine.store
    print(f"store: {time.perf_counter() - t0:.1f} s, rows per site "
          f"{store.prop_dev_rows.sum(1).tolist()}, width "
          f"{store.csr_sub_s.shape[1]}", flush=True)

    kernels = kernel_phase(store)
    queries = served_queries(graph)
    plain = Session(plan, backend="spmd", spmd_max_capacity=MAX_CAPACITY)
    torch.cuda.reset_peak_memory_stats()
    launches = serve_phase(session, plain, graph, queries, card)
    print(f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"bytes ({card})", flush=True)
    missing = [k for k in KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the serve path: {missing}")
    for k in KERNELS:
        kernels[k]["launches"] = launches[k]

    rows = []
    for name, (source, replaces) in KERNELS.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": k["launches"],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
