#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on any error or mismatch:

1. the card's name and power limit; build the six CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, started
   together); ``ptxas``' registers, spills and shared memory of every
   kernel function (the warp-specialised flash kernel must not spill).
2. offline phase at full width: ``generate_watdiv(9_000_000, seed=1)``
   (about 7.6M distinct triples, 1.98M vertices: the most the 21-bit id
   bound admits), ``generate_workload(graph, 400, seed=2)`` and a
   4-site vertical plan, served by ``Session(plan, backend="spmd")`` on
   the card.
3. join kernels: each against its plain PyTorch version on the card,
   at the main path's shapes (binding tables of 4 x 4096 up to 4 x 2^18
   rows, 2 to 6 columns, the store's largest property window) and on
   the edge cases of the reference's kernel tests; all comparisons are
   exact (int32 / bool), ``join_range``'s ``lo`` included.  ``semijoin``,
   on no path, is checked at the same shapes.  ``join_count``'s and
   ``semijoin``'s two search modes are held exactly and timed at the
   serve's four probe-table sizes (and on a seeded column of Zipf-length
   runs; ``semijoin`` also against ``torch.isin``).  ``dedup_rows`` and
   its path form ``dedup_rows_masked`` are held exactly (mask and table)
   in six table styles, two of them all-gathers of replicated fragments
   (shuffled; compacted, as the match loop holds them), beside the count
   of distinct-row pairs with equal 32-bit row hashes (the full-row
   compare's cases), and timed at every tier.
   Times: the wrapper, its plain version and, where one PyTorch call
   computes the same function, that call.  The match loop's sites
   entry points (``fused_join_sites``, ``pair_semijoin_runs``) are held
   at every tier against their plain versions on a window of each of
   the 4 sites (one made empty, one all-sentinel), with per-site
   overflow and the wrap guard on one site; the fused join's rows also
   in the earlier kernel's order, rebuilt from plain versions.  Both
   are timed at the serve's tiers (CUDA events, device time and device
   operations per call), with the site windows read in place and
   copied first, beside the same work as one call per site.  The dedup
   as the match loop applies it (and as earlier trees did: the mask,
   then a ``torch.where``) and ``semijoin`` are timed on fixed seeded
   inputs that ``chip_baseline.py`` repeats in an earlier checkout.
4. serve: launch counters reset, WatDiv template queries with one term
   bound to a data constant plus a star, a chain and a cycle, counters
   read; every answer set equals the same engine run on the plain
   versions, a subset equals the host ``match_pattern``, and every
   kernel of the path launched; one warm pass under the profiler
   (device busy share, the port's kernels by name); then the same
   queries through ``execute_many`` in batches of 64 on a fresh engine
   (answers equal to ``execute``'s, counters and launches read).
5. front door, on the same plan: a traced ``Session`` answers the
   served queries directly (warming it on this thread; per query, the
   ``comm_step`` records' bytes and decision counts equal its ledger and
   counter deltas); warm passes untraced and traced (the tracing cost);
   the list twice through ``Session.serve()`` (launch counters reset
   before and read after ``close``; every outcome completed, no failure,
   no batch fallback, no breaker open; answers equal the direct and
   plain ones; serve and query latency p50/p99 from the registry, batch
   sizes, ``batch_shape_hits``); the span chain and the snapshot
   against ``REQUIRED_METRICS + REQUIRED_SERVE_METRICS``; an open-loop
   sweep at 1x / 4x / 16x of the sequential rate (3 s a tier, no
   failure allowed, sheds printed); a hot ``swap_store`` through the
   door between two halves of the list (answers unchanged, the swap's
   seconds and peak device memory); ``python -m repro_torch.serve
   --smoke``'s ``main`` in-process on the card.
6. LM: ``flash_attention`` against its plain version (qwen3-1.7b's
   prefill shape, the JAX package's attention sweep in float32 and
   bf16, rows with no visible key, one layer at 1 x 32768), each held to
   the JAX package's elementwise tolerance and to a row-relative bound,
   which controls (an all-zero output, one KV tile dropped) must fail;
   qwen3-1.7b built at its published width and depth with seeded random
   weights; the prefill forward at 2 x 4096 through the kernel (28
   launches; the last layer's output checked on the strided q, k, v the
   model passes, and shown to reach the model's head merge as a view)
   against the same forward on plain attention; ``serve()`` for 4
   requests (prompt 128, gen 32); the kernel-backed forward over the
   served prompts against the serve step's logits at the last prompt
   token; a profile of the forward and of 8 decode steps.
7. the kernels as one JSON line (each with the path it launched on and
   its launches there, and ``paths``: launches per path, the join
   kernels on ``spmd`` and ``serve``), the card line, and last the
   result.

``chip_baseline.py`` reuses phases of this script to measure an earlier
commit's checkout in the same chip call as a change.
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
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate

KERNELS = {   # name -> (source, TPU kernel it replaces, path it serves)
    "join_count": ("src/repro_torch/kernels/csrc/join_count.cu",
                   "src/repro/kernels/semijoin.py:63", "spmd"),
    "pair_semijoin": ("src/repro_torch/kernels/csrc/pair_semijoin.cu",
                      "src/repro/kernels/semijoin.py:80", "spmd"),
    "dedup_rows": ("src/repro_torch/kernels/csrc/dedup_rows.cu",
                   "src/repro/kernels/semijoin.py:239", "spmd"),
    "fused_join": ("src/repro_torch/kernels/csrc/fused_join.cu",
                   "src/repro/kernels/semijoin.py:270", "spmd"),
    # on no path: only the JAX package's kernel tests and exports use it
    "semijoin": ("src/repro_torch/kernels/csrc/semijoin.cu",
                 "src/repro/kernels/semijoin.py:39", None),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:36", "lm"),
}

# LM phase: qwen3-1.7b at its published width and depth, random weights
LM_ARCH = "qwen3-1.7b"
LM_BATCH, LM_SEQ = 2, 4096       # prefill forward (cut from 32 x 32768)
LM_LONG, LM_LONG_CHECKED = 32768, 512   # one layer's attention, timed
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 128, 32
LOGIT_TOL = 0.25                 # the JAX package's bf16 model tolerance
# the JAX package's attention sweep (tests/test_kernels.py ATTN_CASES):
# B, Hq, Hkv, Sq, Skv, D, causal, window
ATTN_CASES = [(1, 4, 2, 256, 256, 64, True, None),
              (2, 8, 8, 128, 128, 32, True, None),
              (1, 4, 1, 256, 256, 64, True, 128),
              (1, 2, 2, 200, 200, 64, True, None),
              (1, 4, 4, 128, 384, 64, True, None),
              (1, 8, 2, 512, 512, 128, True, None),
              (1, 4, 4, 256, 256, 64, True, 64)]
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-2}   # atol = rtol
# The JAX tolerance was set for its sweep (S <= 512), where outputs are
# about 10x larger than at the model's lengths: at S = 32768 a row reads
# about 0.009, under 4e-2.  So every comparison is also held to a bound
# scaled to what is compared: per query row, ||got - want|| / ||want||
# (rows with no visible key must be 0 exactly).  For bf16 that is four
# units in the last place of the row's size (2^-6 against bf16's 2^-8);
# controls that zero the output or drop one KV tile must fail it.  On an
# H100 the kernel's row errors reach 4.8e-3 (bf16) and 8.2e-7 (float32),
# the controls' 0.20 and more (PERF.md).
ATTN_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
# shapes the sweep leaves out: no causal mask (with and without a
# window, Sq < Skv and Sq > Skv) and an empty key sequence
ATTN_EXTRA = [(1, 4, 2, 100, 300, 64, False, None),
              (1, 4, 2, 300, 100, 32, False, 40),
              (1, 2, 1, 16, 0, 16, True, None)]


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


def host_s(fn: Callable[[], object]) -> float:
    """Seconds of one call of ``fn`` on the host clock, the card
    synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def bound(nbytes: float, ops: float, ops_per_s: float = SCALAR_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def device_stats(fn: Callable[[], object], reps: int = 50):
    """(mean device ms, device operations) per call of ``fn`` over
    ``reps`` calls: the summed durations and the count of the device
    events ``torch.profiler`` records (kernels, memsets, copies; the
    host's launch overhead left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3,
            len(evs) / reps)


def device_ms(fn: Callable[[], object], reps: int = 50) -> float:
    """Mean device time of ``fn``'s kernels per call (``device_stats``)."""
    return device_stats(fn, reps)[0]


def semijoin_modes(what: str, col: torch.Tensor, probe: torch.Tensor,
                   rec) -> None:
    """semijoin's two search modes (direct; staged, the table's samples
    in shared memory) and ``torch.isin`` on one column: each mode held
    exactly against the plain version and equal to ``torch.isin``.  The
    wrapper's threshold between the modes (``ops.SEMI_STAGE_MIN_PROBES``)
    is read from the device times; ``*_ms`` are CUDA events over
    back-to-back calls (the host's launch cost included)."""
    from repro_torch.kernels import ops, ref
    C = probe.numel()
    want = ref.semijoin_mask_ref(probe, col)
    isin = torch.isin(probe, col)
    if bool((isin != want).any()):
        fail(f"semijoin C={C} {what}: torch.isin differs from the plain "
             f"version")
    times = {}
    for mode, stage_min in (("direct", C + 1), ("staged", 0)):
        got = ops._semijoin_launch(probe, col, stage_min)
        rec("semijoin", _max_err(got, want, f"semijoin {mode} C={C} {what}"))
        if bool((got != isin).any()):
            fail(f"semijoin {mode} C={C} {what}: differs from torch.isin")
        fn = (lambda sm: lambda: ops._semijoin_launch(probe, col, sm)
              )(stage_min)
        times[f"{mode}_ms"] = cuda_ms(fn, reps=50)
        times[f"{mode}_device_ms"] = device_ms(fn)
    times["semijoin_ms"] = cuda_ms(lambda: ops.semijoin(probe, col), reps=50)
    times["isin_ms"] = cuda_ms(lambda: torch.isin(probe, col), reps=50)
    times["isin_device_ms"] = device_ms(lambda: torch.isin(probe, col))
    print(f"semijoin modes, {what}, C={C} T={col.numel()} (threshold "
          f"{ops.SEMI_STAGE_MIN_PROBES} queries): "
          + ", ".join(f"{k}={v:.4f}" for k, v in times.items()), flush=True)


def join_modes(keys: torch.Tensor, live: int, ints, rec) -> None:
    """join_count's two search modes (direct; staged, the column's top
    levels in shared memory), join_range and the library's searchsorted
    pair at the serve's four probe-table sizes on the store's largest
    window, and at the largest on a seeded column of Zipf-length runs;
    each mode held exactly against the plain version, lo included.  The
    wrapper's threshold between the modes (``ops.JOIN_STAGE_MIN_PROBES``)
    is read from the device times (the host's launch cost is the same
    for both); ``*_ms`` include it (CUDA events over back-to-back
    calls).  ``semijoin_modes`` follows on each column and its probes."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(4)
    runs = np.minimum(rng.zipf(1.6, size=keys.numel()), 50000)
    zipf = np.repeat(np.arange(runs.size, dtype=np.int64) * 3,
                     runs)[:keys.numel()].astype(np.int32)
    columns = [("store window", keys, live, c) for c in
               (4096, 1 << 14, 1 << 16, 1 << 18)]
    columns.append(("Zipf runs", torch.from_numpy(zipf).to(keys.device),
                    keys.numel(), 1 << 18))
    for what, col, n_live, cap in columns:
        C = SITES * cap
        probe = torch.where(ints(0, 2, C) == 0, col[ints(0, n_live, C).long()],
                            ints(int(col[0]), int(col[n_live - 1]) + 1, C))
        want = ref.join_range_ref(probe, col)
        times = {}
        for mode, stage_min in (("direct", C + 1), ("staged", 0)):
            for got, w, part in zip(ops._join_search(probe, col, True,
                                                     stage_min), want,
                                    ("lo", "cnt")):
                _max_err(got, w, f"join_range {mode} {part} C={C} {what}")
            fn = (lambda sm: lambda: ops._join_search(probe, col, False, sm)
                  )(stage_min)
            times[f"{mode}_ms"] = cuda_ms(fn, reps=50)
            times[f"{mode}_device_ms"] = device_ms(fn)
        times["join_count_ms"] = cuda_ms(lambda: ops.join_count(probe, col),
                                         reps=50)
        times["join_range_ms"] = cuda_ms(lambda: ops.join_range(probe, col),
                                         reps=50)

        def pair():
            return torch.searchsorted(col, probe, right=True) \
                - torch.searchsorted(col, probe)
        times["searchsorted_pair_ms"] = cuda_ms(pair, reps=50)
        times["searchsorted_pair_device_ms"] = device_ms(pair)
        print(f"join_count modes, {what}, C={C} T={col.numel()} (threshold "
              f"{ops.JOIN_STAGE_MIN_PROBES} probes): "
              + ", ".join(f"{k}={v:.4f}" for k, v in times.items()),
              flush=True)
        semijoin_modes(what, col, probe, rec)


#: binding-table styles of the dedup and fused-join checks
#: (``binding_table``)
TABLE_STYLES = ("dup_heavy", "random", "all_sentinel", "distinct",
                "gathered", "packed")


def binding_table(style, cap, V, ints, gen, dev, lo, hi):
    """A (SITES x cap, V) int32 binding table and its valid mask, values
    in [lo, hi).  "gathered" is an all-gather of replicated fragments:
    one site table of cap rows in each of the SITES blocks, each block
    shuffled, about 30% of rows invalid; "packed" the same of compacted
    site tables, as the match loop holds them: cap / 4 rows in another
    order at the front of each block, then padding.  Invalid rows are
    -1 except in "distinct"."""
    C = SITES * cap
    n = cap if style == "gathered" else cap // 4
    if style == "dup_heavy":
        bind = ints(0, 3, C, V)
    elif style == "distinct":
        bind = torch.arange(C * V, dtype=torch.int32, device=dev).reshape(C, V)
    elif style in ("gathered", "packed"):
        site = ints(lo, hi, n, V)
        bind = torch.cat([torch.cat([site[torch.randperm(
            n, generator=gen).to(dev)], site.new_full((cap - n, V), -1)])
            for _ in range(SITES)])
    else:
        bind = ints(lo, hi, C, V)
    if style == "all_sentinel":
        valid = torch.zeros(C, dtype=torch.bool, device=dev)
    elif style == "packed":
        valid = torch.arange(C, device=dev) % cap < n
    else:
        valid = ints(0, 10, C) < 7
    if style != "distinct":
        bind = torch.where(valid[:, None], bind, -1)
    return bind, valid


def check_dedup(bind, valid, what) -> int:
    """``dedup_rows`` and ``dedup_rows_masked`` on the card against their
    plain versions: the keep mask and the masked table, exact.  Returns
    the largest error (0; any difference fails)."""
    from repro_torch.kernels import ops, ref
    want = ref.dedup_rows_ref(bind, valid)
    _max_err(ops.dedup_rows(bind, valid), want, f"dedup_rows {what}")
    got_b, got_k = ops.dedup_rows_masked(bind, valid)
    _max_err(got_k, want, f"dedup_rows_masked {what} keep")
    _max_err(got_b, torch.where(want[:, None], bind, -1),
             f"dedup_rows_masked {what} table")
    return 0


def hash_collisions(bind, valid) -> int:
    """Pairs of distinct valid rows with equal 32-bit row hashes (the
    kernel's hash, through its plain version ``ref.row_hash_ref``): the
    rows on which the dedup's full-row compare meets a different row."""
    from repro_torch.kernels import ref
    rows = torch.unique(bind[valid], dim=0)
    if rows.shape[0] < 2:
        return 0
    counts = torch.unique(ref.row_hash_ref(rows), return_counts=True)[1]
    return int((counts * (counts - 1) // 2).sum())


def dedup_modes(bind, valid, what) -> None:
    """CUDA-event ms (back to back, the host's cost included), device ms
    and device operations a call of ``dedup_rows`` and of
    ``dedup_rows_masked``, and of the mask then a ``torch.where`` (the
    match loop's form before the masked entry)."""
    from repro_torch.kernels import ops
    calls = {"dedup_rows": lambda: ops.dedup_rows(bind, valid),
             "dedup_rows_masked": lambda: ops.dedup_rows_masked(bind, valid),
             "dedup_rows + where": lambda: torch.where(
                 ops.dedup_rows(bind, valid)[:, None], bind, -1)}
    parts = []
    for name, fn in calls.items():
        dms, dops = device_stats(fn)
        parts.append(f"{name} ms={cuda_ms(fn, reps=50):.4f} device_ms="
                     f"{dms:.4f} device_ops={dops:.1f}")
    print(f"dedup modes {what}: " + "; ".join(parts), flush=True)


def largest_window(store):
    """The store's largest property window as the kernel checks read it:
    (keys, payload, object-sorted objects, live rows, property, site,
    first row); each column has T rows, pads past the live ones."""
    from repro_torch.constants import INT32_SENTINEL
    windows = [store.prop_window(p)
               for p in range(store.csr_offs.shape[1] - 1)]
    prop = int(np.argmax(windows))
    T = windows[prop]
    j = int(np.argmax(store.prop_dev_rows[:, prop]))
    start, stop = int(store.csr_offs[j, prop]), int(store.csr_offs[j, prop + 1])
    live = torch.arange(T, device=store.device) < stop - start
    keys = torch.where(live, store.csr_sub_s[j, start:start + T],
                       INT32_SENTINEL).contiguous()
    payload = torch.where(live, store.csr_sub_o[j, start:start + T],
                          -1).contiguous()
    objs = torch.where(live, store.csr_obj_o[j, start:start + T],
                       INT32_SENTINEL).contiguous()
    return keys, payload, objs, stop - start, prop, j, start


def path_form_times(store, masked: bool) -> None:
    """At the main path's top shape (C = SITES x 2^18 rows, V = 4) on the
    store's largest window: CUDA-event ms (back to back), device ms and
    device operations a call of the dedup as the match loop applies it,
    on a gathered, a packed and a random table (``binding_table``), and
    of ``semijoin`` with every query a key of the window.  The dedup
    forms: the mask then a ``torch.where`` (the earlier trees' path)
    and, with ``masked``, the one-call ``dedup_rows_masked``.  The
    inputs come from a seed of their own, so ``chip_baseline.py`` times
    the same ones in a checkout of an earlier commit."""
    from repro_torch.kernels import ops
    dev = store.device
    gen = torch.Generator(device="cpu").manual_seed(5)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)
    keys, _p, _o, live, _prop, _j, _s = largest_window(store)
    kmin, kmax = int(keys[0]), int(keys[live - 1])
    cap = 1 << 18
    C, V = SITES * cap, 4
    probe = keys[ints(0, live, C).long()]
    calls = {}
    for style in ("gathered", "packed", "random"):
        bind, valid = binding_table(style, cap, V, ints, gen, dev, kmin,
                                    kmax + 1)
        calls[f"dedup_rows + where, {style}"] = (
            lambda b, v: lambda: torch.where(ops.dedup_rows(b, v)[:, None],
                                             b, -1))(bind, valid)
        if masked:
            calls[f"dedup_rows_masked, {style}"] = (
                lambda b, v: lambda: ops.dedup_rows_masked(b, v))(bind, valid)
    calls["semijoin"] = lambda: ops.semijoin(probe, keys)
    parts = []
    for name, fn in calls.items():
        dms, dops = device_stats(fn)
        parts.append(f"{name} ms={cuda_ms(fn, reps=50):.4f} device_ms="
                     f"{dms:.4f} device_ops={dops:.1f}")
    print(f"path forms C={C} V={V} T={keys.numel()}: " + "; ".join(parts),
          flush=True)
    for name, fn in calls.items():
        kernel_times(fn, f"{name} at C={C}")


def join_in_input_order(bind, valid, probe, keys, payload, capacity):
    """One site's output of the fused join in the order of the earlier
    CUDA kernel, rebuilt from plain versions: the in-place keep mask of
    ``dedup_rows_ref``, ``join_range_ref`` of the probes, then
    ``expand_from_counts`` over the rows in input order."""
    from repro_torch.kernels import ref
    keep = ref.dedup_rows_ref(bind, valid)
    lo, cnt = ref.join_range_ref(probe.contiguous(), keys)
    cnt = torch.where(keep, cnt, 0).to(torch.int32)
    return ref.expand_from_counts(bind, lo, cnt, payload, capacity)


def largest_windows(store):
    """m distinct windows of the store's CSR arrays, in the form the
    match loop passes them to the kernels: on each site, the run of the
    property it holds most rows of, all read at the largest of their
    window sizes (the vertical plan keeps the largest property on one
    site, so one property's windows would be empty elsewhere)."""
    from repro_torch.kernels import ref
    offs = store.csr_offs
    props = [int(np.argmax(store.prop_dev_rows[j]))
             for j in range(store.num_sites)]
    starts = tuple(int(offs[j, p]) for j, p in enumerate(props))
    return ref.SiteWindows(starts, tuple(
        int(offs[j, p + 1]) - starts[j] for j, p in enumerate(props)),
        max(store.prop_window(p) for p in props))


def check_join_sites(bind, valid, probe, keys, payload, cap, windows,
                     what) -> int:
    """``fused_join_sites`` on the card against its plain version (per
    site: the overflow count, and the row multiset where nothing
    overflowed) and against ``join_in_input_order`` (every output, row
    order included, except under the wrap guard).  Returns the largest
    error (0; any difference fails)."""
    from repro_torch.kernels import ops, ref
    got = ops.fused_join_sites(bind, valid, probe, keys, payload, cap,
                               windows)
    want = ref.fused_join_sites_ref(bind, valid, probe, keys, payload, cap,
                                    windows)
    tk, tp = ref.site_tables(keys, payload, windows, -1)
    for j in range(keys.shape[0]):
        w = f"{what} site {j}"
        _max_err(got[3][j], want[3][j], w + " overflow")
        if int(want[3][j]) == 0:
            _max_err(_sorted_rows(got[0][j], got[1][j], got[2][j]),
                     _sorted_rows(want[0][j], want[1][j], want[2][j]), w)
        if int(want[3][j]) != cap + 1:
            order = join_in_input_order(bind, valid, probe, tk[j], tp[j],
                                        cap)
            for g, o, part in zip(got, order, ("bind", "col", "valid")):
                _max_err(g[j], o, f"{w} {part} in input order")
    return 0


def check_pair_runs(q_s, q_o, t_s, t_o, runs, windows, what) -> int:
    """``pair_semijoin_runs`` on the card, both search modes, against
    its plain version (exact).  Returns the largest error (0)."""
    from repro_torch.kernels import ops, ref
    want = ref.pair_semijoin_runs_ref(q_s, q_o, t_s, t_o, runs, windows)
    _max_err(ops.pair_semijoin_runs(q_s, q_o, t_s, t_o, runs, windows),
             want, what)
    m = t_s.shape[0] if t_s.dim() == 2 else (
        q_s.shape[0] if q_s.dim() == 2 else 1)
    for mode, stage_min in (("direct", q_s.shape[-1] + 1), ("staged", 0)):
        got = ops._pair_launch(q_s, q_o, t_s, t_o, runs, windows, m,
                               stage_min)
        _max_err(got.reshape(want.shape), want, f"{what} {mode}")
    return 0


def sites_phase(arrk, arrp, windows, widths, ints, rec) -> None:
    """``fused_join_sites`` and ``pair_semijoin_runs`` against their
    plain versions at every tier width of ``widths`` (cap -> V), with m
    distinct site windows of the (m, W) CSR arrays ``arrk`` / ``arrp``
    (keys sorted by (key, payload) in each window): the windows as the
    match loop passes them with one site's made empty, and (m, T)
    tables holding an all-sentinel one; the four binding styles; per
    site overflow at capacity 1, 4 and 16; the wrap guard on one site;
    the pairs as shared and per-site queries, with the edge-shipped
    table of m sorted runs."""
    from repro_torch.constants import INT32_SENTINEL
    from repro_torch.kernels import ops, ref
    dev = arrk.device
    m, T = arrk.shape[0], windows.size
    empty = ref.SiteWindows(windows.starts, tuple(
        0 if j == 2 else n for j, n in enumerate(windows.lives)), T)
    tk, tp = ref.site_tables(arrk, arrp, windows, -1)
    sent_k, sent_p = tk.clone(), tp.clone()
    sent_k[1], sent_p[1] = INT32_SENTINEL, -1
    # the pair tables' form: pads (INT32_SENTINEL, INT32_SENTINEL)
    pk, po = ref.site_tables(arrk, arrp, windows, INT32_SENTINEL)
    pk[1], po[1] = INT32_SENTINEL, INT32_SENTINEL
    live0 = windows.lives[0]
    kmin, kmax = int(tk[0, 0]), int(tk[0, live0 - 1])
    # the edge-shipped table: each site's first L window rows, (s, o)
    # sorted, the rest of its run sentinel-filled
    L = 1 << 14
    g_s = torch.full((m, L), INT32_SENTINEL, dtype=torch.int32, device=dev)
    g_o = g_s.clone()
    for j in range(m):
        n = min(windows.lives[j], L // 2 + 97 * j)
        g_s[j, :n], g_o[j, :n] = tk[j, :n], tp[j, :n]
    g_s, g_o = g_s.reshape(-1), g_o.reshape(-1)
    for cap, V in widths.items():
        C = m * cap
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
            if style == "random":   # half the probes from the windows
                pick = ints(0, live0, C).long()
                bind[:, 0] = torch.where(valid & (ints(0, 2, C) == 0),
                                         tk[0][pick], bind[:, 0])
            probe = bind[:, 0]      # a column view, as the path passes
            what = f"fused_join_sites C={C} V={V} cap={cap} {style}"
            rec("fused_join", check_join_sites(
                bind, valid, probe, arrk, arrp, cap, empty, what))
            rec("fused_join", check_join_sites(
                bind, valid, probe, sent_k, sent_p, cap, None,
                what + " all-sentinel site"))
        # pairs: half of them rows of a window, some the pad pair
        pick = ints(0, live0, C).long()
        real = ints(0, 2, C) == 0
        q_s = torch.where(real, tk[0][pick], ints(kmin, kmax + 1, C))
        q_o = torch.where(real, tp[0][pick], ints(0, 1 << 21, C))
        q_s[:7], q_o[:7] = INT32_SENTINEL, INT32_SENTINEL
        per_site = torch.stack([q_s.roll(97 * j) for j in range(m)])
        per_site_o = torch.stack([q_o.roll(97 * j) for j in range(m)])
        what = f"pair_semijoin_runs C={C}"
        for args, form in (
                ((q_s, q_o, arrk, arrp, 1, empty), "windows, shared"),
                ((per_site, per_site_o, arrk, arrp, 1, empty),
                 "windows, per site"),
                ((q_s, q_o, pk, po, 1, None), "all-sentinel site"),
                ((per_site, per_site_o, g_s, g_o, m, None),
                 f"edge-shipped table of {m} runs"),
                ((q_s, q_o, g_s[:0], g_o[:0], 1, None), "empty table"),
                ((q_s[:0], q_o[:0], arrk, arrp, 1, windows),
                 "no queries")):
            rec("pair_semijoin", check_pair_runs(*args, f"{what} {form}"))
    # per-site overflow at capacity 1 / 4 / 16: a duplicate-heavy table
    # against dense key collisions, different on each site
    bind = ints(0, 3, 512, 2)
    valid = ints(0, 10, 512) < 9
    dense = torch.sort(ints(0, 3, m, 64), dim=1).values
    pay = ints(0, 99, m, 64)
    for cap in (1, 4, 16):
        want = ops.fused_join_sites(bind.cpu(), valid.cpu(),
                                    bind[:, 0].cpu(), dense.cpu(),
                                    pay.cpu(), cap)[3]
        if bool((want <= 0).any()):
            fail("sites overflow case did not overflow on every site")
        rec("fused_join", check_join_sites(
            bind, valid, bind[:, 0], dense, pay, cap, None,
            f"fused_join_sites overflow cap={cap}"))
    # wrap guard on site 0 only: a count above (2^31-1)/C there
    C = 1 << 16
    bind = torch.zeros((C, 1), dtype=torch.int32, device=dev)
    valid = torch.zeros(C, dtype=torch.bool, device=dev)
    valid[:3] = True
    bind[:3, 0] = torch.tensor([5, 6, 7], dtype=torch.int32, device=dev)
    wkeys = torch.sort(ints(0, 12, m, 40000), dim=1).values
    wkeys[0] = 5
    wpay = torch.arange(m * 40000, dtype=torch.int32,
                        device=dev).reshape(m, 40000)
    got = ops.fused_join_sites(bind, valid, bind[:, 0], wkeys, wpay, 16)[3]
    if int(got[0]) != 17 or bool((got[1:] == 17).any()):
        fail(f"sites wrap guard: overflow {got.tolist()}, expected 17 on "
             f"site 0 only")
    rec("fused_join", check_join_sites(bind, valid, bind[:, 0], wkeys, wpay,
                                       16, None, "fused_join_sites wrap"))
    torch.cuda.synchronize()
    print(f"sites checks: fused_join_sites and pair_semijoin_runs exact at "
          f"{m} sites, tiers {list(widths)}", flush=True)


def copied_tables(arrk, arrp, windows, pay_fill):
    """The (m, size) tables ``windows`` names, copied as the match
    loop's ``csr_window`` copies them (per site: one compare of an
    arange with the live rows, two ``torch.where``), then stacked: the
    copy form the in-place windows replace."""
    from repro_torch.constants import INT32_SENTINEL
    ks, ps = [], []
    for j, (a, n) in enumerate(zip(windows.starts, windows.lives)):
        live = torch.arange(windows.size, device=arrk.device) < n
        ks.append(torch.where(live, arrk[j, a:a + windows.size],
                              INT32_SENTINEL))
        ps.append(torch.where(live, arrp[j, a:a + windows.size], pay_fill))
    return torch.stack(ks), torch.stack(ps)


def sites_times(arrk, arrp, windows, ints) -> None:
    """The two sites entry points at the serve's tiers, 4 x 4096 to
    4 x 2^18, on the windows the match loop passes: CUDA-event ms per
    call (back to back, the host's cost included), device ms and device
    operations per call (the profiler), each with the windows read in
    place and with them first copied (``copied_tables``); and the pair
    kernel's two modes' device times (which set
    ``ops.PAIR_STAGE_MIN_PROBES``)."""
    from repro_torch.constants import INT32_SENTINEL
    from repro_torch.kernels import ops
    m = arrk.shape[0]
    tk = arrk[0, windows.starts[0]:windows.starts[0] + windows.lives[0]]
    tp = arrp[0, windows.starts[0]:windows.starts[0] + windows.lives[0]]
    n0 = windows.lives[0]
    for cap in (4096, 1 << 14, 1 << 16, 1 << 18):
        C, V = m * cap, 4
        bind = ints(int(tk[0]), int(tk[-1]) + 1, C, V)
        valid = ints(0, 10, C) < 7
        bind[:, 0] = tk[ints(0, n0, C).long()]
        pick = ints(0, n0, C).long()
        q_s, q_o = tk[pick], torch.where(ints(0, 2, C) == 0, tp[pick],
                                         ints(0, 1 << 21, C))
        calls = {
            "fused_join_sites": lambda: ops.fused_join_sites(
                bind, valid, bind[:, 0], arrk, arrp, cap, windows),
            "fused_join_sites copied": lambda: ops.fused_join_sites(
                bind, valid, bind[:, 0],
                *copied_tables(arrk, arrp, windows, -1), cap),
            "pair_semijoin_runs": lambda: ops.pair_semijoin_runs(
                q_s, q_o, arrk, arrp, 1, windows),
            "pair_semijoin_runs copied": lambda: ops.pair_semijoin_runs(
                q_s, q_o, *copied_tables(arrk, arrp, windows,
                                         INT32_SENTINEL), 1)}
        parts = []
        for name, fn in calls.items():
            ms = cuda_ms(fn, reps=50)
            dms, dops = device_stats(fn)
            parts.append(f"{name} ms={ms:.4f} device_ms={dms:.4f} "
                         f"device_ops={dops:.1f}")
        for mode, sm in (("direct", C + 1), ("staged", 0)):
            dms = device_ms(lambda: ops._pair_launch(
                q_s, q_o, arrk, arrp, 1, windows, m, sm))
            parts.append(f"pair {mode} device_ms={dms:.4f}")
        print(f"sites times C={C} ({m} x {cap}) T={windows.size}: "
              + "; ".join(parts), flush=True)
        if cap == 1 << 18:
            kernel_times(calls["fused_join_sites"],
                         f"fused_join_sites at C={C}")


def port_kernel_names() -> set:
    """The ``__global__`` function names in the port's ``csrc/``."""
    import re
    from repro_torch.kernels import build
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)")
    return {m.group(1) for f in build.CSRC.glob("*.cu*")
            for m in pat.finditer(f.read_text())}


def one_site_times(store, ints) -> None:
    """A gather step's joins as one call per site, through the one-site
    entry points both this tree and the one before the sites kernels
    have (``ops.fused_join``, ``ops.pair_semijoin``), at the serve's
    smallest and largest tiers on each site's window of its largest
    property: CUDA-event ms, device ms and device operations for the m
    calls."""
    from repro_torch.constants import INT32_SENTINEL
    from repro_torch.kernels import ops
    m, offs = store.num_sites, store.csr_offs
    props = [int(np.argmax(store.prop_dev_rows[j])) for j in range(m)]
    T = max(store.prop_window(p) for p in props)
    idx = torch.arange(T, device=store.device)
    wins = []
    for j, p in enumerate(props):
        a, n = int(offs[j, p]), int(offs[j, p + 1] - offs[j, p])
        wins.append((torch.where(idx < n, store.csr_sub_s[j, a:a + T],
                                 INT32_SENTINEL),
                     torch.where(idx < n, store.csr_sub_o[j, a:a + T], -1),
                     torch.where(idx < n, store.csr_sub_o[j, a:a + T],
                                 INT32_SENTINEL), n))
    k0, p0, _po, n0 = wins[0]
    for cap in (4096, 1 << 18):
        C, V = m * cap, 4
        bind = ints(int(k0[0]), int(k0[n0 - 1]) + 1, C, V)
        valid = ints(0, 10, C) < 7
        bind[:, 0] = k0[ints(0, n0, C).long()]
        probe = bind[:, 0].contiguous()
        pick = ints(0, n0, C).long()
        q_s, q_o = k0[pick], torch.where(ints(0, 2, C) == 0, p0[pick],
                                         ints(0, 1 << 21, C))

        def joins():
            for k, pay, _po, _n in wins:
                ops.fused_join(bind, valid, probe, k, pay, cap)

        def pairs():
            for k, _p, po, _n in wins:
                ops.pair_semijoin(q_s, q_o, k, po)
        parts = []
        for name, fn in (("fused_join", joins), ("pair_semijoin", pairs)):
            dms, dops = device_stats(fn, reps=20)
            parts.append(f"{m} x {name} ms={cuda_ms(fn):.4f} device_ms="
                         f"{dms:.4f} device_ops={dops:.1f}")
        print(f"one-site calls C={C} ({m} x {cap}) T={T}: "
              + "; ".join(parts), flush=True)


def kernel_label(name: str) -> str:
    """A profiler kernel name without its return type, namespace and
    arguments: "void (anonymous namespace)::k<true>(int*)" -> "k<true>"."""
    return name.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("(")[0] or name


def kernel_times(fn: Callable[[], object], what: str, reps: int = 20):
    """Device time per call of each device operation ``fn`` issues,
    by name (the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = kernel_label(e.name)
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    print(f"device time per call of {what}: " + "; ".join(
        f"{k} {v / reps / 1e3:.4f} ms" for k, v in by_name.items()),
        flush=True)


def kernel_phase(store) -> Dict[str, dict]:
    """Every kernel against its plain version; returns per-kernel
    numbers for the JSON line."""
    from repro_torch.constants import INT32_SENTINEL
    from repro_torch.kernels import ops, ref
    INT32_MIN = int(np.iinfo(np.int32).min)
    dev = store.device
    gen = torch.Generator(device="cpu").manual_seed(0)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    # the store's largest property window: real sorted keys + payload
    keys, payload, objs, n_live, prop, j, start = largest_window(store)
    T, stop = keys.numel(), start + n_live
    kmin, kmax = int(keys[0]), int(keys[stop - start - 1])
    print(f"kernel shapes: largest window T={T} (property {prop}, "
          f"site {j}, {stop - start} live rows)", flush=True)
    out = {name: {"max_abs_err": 0}
           for name, (_src, _tpu, path) in KERNELS.items() if path != "lm"}

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
            for got, want, what in zip(ops.join_range(probe, k),
                                       ref.join_range_ref(probe, k),
                                       ("lo", "cnt")):
                rec("join_count", _max_err(
                    got, want, f"join_range {what} C={C} T={k.numel()}"))
        # semijoin: the same probes against the window (duplicate keys,
        # INT32_MAX pads), an INT32_MIN-padded and an all-pad table, and
        # empty sides
        min_padded = torch.cat([torch.full((T // 4,), INT32_MIN,
                                           dtype=torch.int32, device=dev),
                                keys[:stop - start]])
        for q_, k in ((probe, keys), (probe, min_padded),
                      (probe, sentinel_keys), (probe, keys[:0]),
                      (probe[:0], keys)):
            got = ops.semijoin(q_, k)
            rec("semijoin", _max_err(got, ref.semijoin_mask_ref(q_, k),
                                     f"semijoin C={q_.numel()} "
                                     f"T={k.numel()}"))
            if bool((got != torch.isin(q_, k)).any()):
                fail(f"semijoin C={q_.numel()} T={k.numel()}: differs "
                     f"from torch.isin")
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
        collisions = {}
        for style in TABLE_STYLES:
            bind, valid = binding_table(style, cap, V, ints, gen, dev, kmin,
                                        kmax + 1)
            rec("dedup_rows", check_dedup(bind, valid,
                                          f"C={C} V={V} {style}"))
            collisions[style] = hash_collisions(bind, valid)
            pb = bind[:, 0].contiguous()
            for k, p_ in ((keys, payload), (sentinel_keys, payload)):
                got = ops.fused_join(bind, valid, pb, k, p_, cap)
                want = ref.fused_join_ref(bind, valid, pb, k, p_, cap)
                what = f"fused_join C={C} V={V} cap={cap} {style}"
                rec("fused_join", _max_err(got[3], want[3], what + " overflow"))
                if int(got[3]) == 0:
                    rec("fused_join", _max_err(_sorted_rows(*got[:3]),
                                               _sorted_rows(*want[:3]), what))
        print(f"dedup checks C={C} V={V}: dedup_rows and dedup_rows_masked "
              f"(mask and table) exact in {len(collisions)} styles; pairs "
              f"of distinct valid rows with equal 32-bit row hashes: "
              + ", ".join(f"{k} {v}" for k, v in collisions.items()),
              flush=True)
        for style in ("gathered", "packed"):
            dedup_modes(*binding_table(style, cap, V, ints, gen, dev, kmin,
                                       kmax + 1), f"C={C} V={V} {style}")
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
    join_modes(keys, stop - start, ints, rec)
    # the sites entry points on the path's own tables: a window on each
    # site in the subject-sorted CSR arrays
    win = largest_windows(store)
    print(f"sites windows: starts {win.starts}, live rows {win.lives}, "
          f"size {win.size}", flush=True)
    sites_phase(store.csr_sub_s, store.csr_sub_o, win, widths, ints, rec)
    sites_times(store.csr_sub_s, store.csr_sub_o, win, ints)
    one_site_times(store, ints)
    path_form_times(store, masked=True)

    # times at the main path's top tested shape: 4 sites x 2^18 rows
    cap = 1 << 18
    C, V = SITES * cap, 4
    lg = float(np.log2(max(T, 2)))
    probe = keys[ints(0, stop - start, C).long()]
    # pairs against site j's subject-sorted window, as the path passes
    # it: half of them rows of the window
    pick = ints(0, stop - start, C).long()
    q_s = keys[pick]
    q_o = torch.where(ints(0, 2, C) == 0, payload[pick],
                      ints(0, 1 << 21, C))
    one = ref.SiteWindows((start,), (stop - start,), T)
    sub_s, sub_o = store.csr_sub_s[j:j + 1], store.csr_sub_o[j:j + 1]
    pair_s, pair_o = ref.site_tables(sub_s, sub_o, one, INT32_SENTINEL)
    bind = ints(kmin, kmax + 1, C, V)
    valid = ints(0, 10, C) < 7
    pb = keys[ints(0, stop - start, C).long()]
    bind[:, 0] = pb
    # survivors and their expansion, for the fused join's data-dependent
    # bytes: capacity rows written
    n_keep = int(ref.dedup_rows_ref(bind, valid).sum())

    def pair_key(s_, o_):   # the composed s * 2^21 + o int64 key
        return s_.to(torch.int64) * (1 << 21) + o_.to(torch.int64)

    cases = {
        "join_count": (lambda: ops.join_count(probe, keys),
                       lambda: ref.join_count_ref(probe, keys),
                       lambda: torch.searchsorted(keys, probe, right=True)
                       - torch.searchsorted(keys, probe),
                       (2 * C + T) * 4, C * 2 * lg),
        "pair_semijoin": (lambda: ops.pair_semijoin_runs(
                              q_s, q_o, sub_s, sub_o, 1, one),
                          lambda: ref.pair_semijoin_runs_ref(
                              q_s, q_o, sub_s, sub_o, 1, one),
                          lambda: torch.isin(pair_key(q_s, q_o),
                                             pair_key(pair_s[0], pair_o[0])),
                          (C + T) * 8 + C, C * 2 * lg),
        "semijoin": (lambda: ops.semijoin(probe, keys),
                     lambda: ref.semijoin_mask_ref(probe, keys),
                     lambda: torch.isin(probe, keys),
                     (C + T) * 4 + C, C * lg),
        # the path's form: the mask and the masked table
        "dedup_rows": (lambda: ops.dedup_rows_masked(bind, valid),
                       lambda: ref.dedup_rows_masked_ref(bind, valid), None,
                       C * V * 4 * 2 + 2 * C, C * 6 * V),
        # one call for the SITES windows; bytes: the table and its
        # flags and probes, each window's stored keys (its pads are
        # virtual), the payload of at most capacity rows a site, and
        # the outputs
        "fused_join": (lambda: ops.fused_join_sites(
                           bind, valid, bind[:, 0], store.csr_sub_s,
                           store.csr_sub_o, cap, win),
                       lambda: ref.fused_join_sites_ref(
                           bind, valid, bind[:, 0], store.csr_sub_s,
                           store.csr_sub_o, cap, win), None,
                       C * V * 4 + C * 5 + 4 * sum(win.lives)
                       + 4 * sum(min(n, cap) for n in win.lives)
                       + SITES * cap * (4 * V + 5) + 4 * SITES,
                       C * 6 * V + SITES * (n_keep * 2 * lg + cap * 10)),
    }
    for name, (kern, plain, lib, nbytes, nops) in cases.items():
        bms, by = bound(nbytes, nops)
        out[name].update(
            ms=cuda_ms(kern), plain_ms=cuda_ms(plain, reps=5),
            library_ms=cuda_ms(lib) if lib is not None else None,
            bound_ms=bms, bound_by=by)
        dms, dops = device_stats(kern)
        print(f"kernel {name}: kernel_ms={out[name]['ms']:.4f} "
              f"(device {dms:.4f} ms, {dops:.1f} device operations) "
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
    with mock.patch.multiple(spmd_module, join_range=ref.join_range_ref,
                             pair_semijoin_runs=ref.pair_semijoin_runs_ref,
                             dedup_rows_masked=ref.dedup_rows_masked_ref,
                             fused_join_sites=ref.fused_join_sites_ref):
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
    serve_profile(session, queries)
    return launches, results


def serve_profile(session, queries) -> None:
    """One warm pass of the serve (capacity hints in place) under the
    profiler: the device busy share, the share of wall time outside any
    device work, the port's kernels summed by name, the five largest
    kernels."""
    device_profile(lambda: [session.execute(q) for q in queries],
                   f"RDF serve, one warm pass of {len(queries)} queries",
                   own_kernels=True)


def serve_many_phase(plan, queries, results, card: str) -> Dict[str, int]:
    """The same queries through ``Session.execute_many`` in batches of
    64 on a fresh engine: queries of one shape inside a batch share one
    run of the match loop.  Every answer set must equal the ``execute``
    serve's.  Returns the launch counts of the batched serve."""
    from repro_torch.core import Session
    from repro_torch.kernels import ops
    session = Session(plan, backend="spmd", spmd_max_capacity=MAX_CAPACITY)
    ops.reset_launches()
    t0 = time.perf_counter()
    many = session.execute_many(queries, batch_size=64)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = session.stats()
    hits = int(st.extra["batch_shape_hits"])
    print(f"serve execute_many batch_size=64 ({card}): {len(queries)} "
          f"queries in {secs:.2f} s, qps={len(queries) / secs:.3f}, "
          f"comm_bytes={st.comm_bytes}, capacity_tiers_tried="
          f"{len(queries) - hits + int(st.extra['capacity_retries'])}, "
          + ", ".join(f"{k}={int(st.extra[k])}" for k in (
              "batch_shape_hits", "capacity_retries", "gather_steps",
              "edge_shipped_steps", "edge_cache_hits", "skipped_gathers",
              "routed_queries", "compiled_shapes"))
          + f", result_rows={st.result_rows}", flush=True)
    print(f"launches on the execute_many serve: {launches}", flush=True)
    for i, (a, b) in enumerate(zip(many, results)):
        ra, rb = answer_rows(a.bindings), answer_rows(b.bindings)
        if ra.shape != rb.shape or not np.array_equal(ra, rb):
            fail(f"query {i} {queries[i].edges}: execute_many gives "
                 f"{ra.shape[0]} rows, execute {rb.shape[0]}")
    print(f"execute_many: {len(queries)} answer sets equal the execute "
          f"serve's", flush=True)
    return launches


# ----------------------------------------------------------------------
# Front-door phase
# ----------------------------------------------------------------------

DOOR_BATCH, DOOR_DELAY_MS = 16, 2.0
SWEEP = (1.0, 4.0, 16.0)          # multiples of the sequential base rate
SWEEP_S, SWEEP_QUEUE, SWEEP_DEADLINE_S = 3.0, 128, 5.0
DECISION_COUNTERS = {"gather": "gather_steps",
                     "edge_ship": "edge_shipped_steps",
                     "skip": "skipped_gathers",
                     "edge_cached": "edge_cache_hits"}


def _same_answers(got, want, what: str) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        ra, rb = answer_rows(a.bindings), answer_rows(b.bindings)
        if ra.shape != rb.shape or not np.array_equal(ra, rb):
            fail(f"{what}: query {i}: {ra.shape[0]} rows, expected "
                 f"{rb.shape[0]}")
    if len(got) != len(want):
        fail(f"{what}: {len(got)} answers for {len(want)} queries")


def _hist_delta(h, counts_before):
    """A histogram of the observations ``h`` took since its bucket
    counts were ``counts_before`` (its p50/p99 then describe that run
    alone)."""
    from repro_torch.obs.metrics import Histogram
    d = Histogram(h.buckets)
    d.counts = [a - b for a, b in zip(h.counts, counts_before)]
    d.count = sum(d.counts)
    return d


def _pcts_ms(h) -> str:
    return (f"p50={h.percentile(0.5) * 1e3:.2f} ms "
            f"p99={h.percentile(0.99) * 1e3:.2f} ms (n={h.count})")


def _reconcile(roots, sess, before_comm, before_counts, what) -> int:
    """Trace<->ledger over the ``query`` spans in ``roots`` (root spans
    or their children): the summed ``comm_step`` bytes and the
    per-decision record counts against the engine's counter deltas since
    ``before_*``.  Returns the byte delta, which must be 0."""
    recs = [r for root in roots for s in root.find("query")
            for r in s.records if r.get("kind") == "comm_step"]
    st = sess.stats()
    delta = sum(r["bytes"] for r in recs) - (st.comm_bytes - before_comm)
    if delta:
        fail(f"{what}: trace and ledger differ by {delta} bytes")
    for dec, counter in DECISION_COUNTERS.items():
        n = sum(1 for r in recs if r["decision"] == dec)
        if n != st.extra[counter] - before_counts[counter]:
            fail(f"{what}: {n} {dec} records, {counter} moved by "
                 f"{st.extra[counter] - before_counts[counter]}")
    return delta


def _settle(futs, timeout: float = 600.0) -> None:
    """Wait for every future; its outcome is read afterwards."""
    for f in futs:
        try:
            f.result(timeout=timeout)
        except Exception:       # judged by _door_failures
            pass


def _door_failures(door, futs, what: str) -> None:
    """Fail unless every future completed, nothing failed, no batch fell
    back and the breaker never opened: a front door turns errors into
    quiet outcomes."""
    bad = [f.outcome for f in futs if f.outcome != "completed"]
    st = door.stats()
    if bad or st["failed"] or st["batch_fallbacks"] or st["breaker_opens"]:
        errors = []
        for f in futs:
            if f.outcome == "failed":
                try:
                    f.result(0)
                except Exception as exc:          # the engine's error
                    errors.append(repr(exc))
        fail(f"{what}: outcomes {sorted(set(bad))}, failed={st['failed']}, "
             f"batch_fallbacks={st['batch_fallbacks']}, breaker_opens="
             f"{st['breaker_opens']}; first errors {errors[:3]}")


def door_phase(plan, queries, results, session, card: str,
               dev: str = "cuda") -> Dict[str, int]:
    """The serving front door on the plan of ``spmd_phase``: direct
    warm-up with tracing on, the served queries (twice) through
    ``Session.serve()``, trace<->ledger, the span chain and the metrics
    snapshot, the tracing cost against ``session`` (untraced, warm), a
    capacity sweep, a hot swap through the door, and the serve CLI.
    Returns the launches of the served pass."""
    from repro_torch.core import Session
    from repro_torch.kernels import ops
    from repro_torch.obs.export import (REQUIRED_METRICS,
                                        REQUIRED_SERVE_METRICS, snapshot,
                                        validate_snapshot)
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve import FrontDoor, FrontDoorConfig, measure_capacity
    from repro_torch.serve.__main__ import main as serve_main

    registry = MetricsRegistry()
    tracer = Tracer(enabled=True, capacity=4096)
    sess = Session(plan, backend="spmd", device=dev,
                   spmd_max_capacity=MAX_CAPACITY, tracer=tracer,
                   metrics_registry=registry)
    eng = sess.engine

    # 1. direct warm-up, traced: each query's records against its ledger
    t0 = time.perf_counter()
    direct, worst = [], 0
    for q in queries:
        before = sess.stats()
        direct.append(sess.execute(q))
        worst = max(worst, abs(_reconcile(
            tracer.store.spans()[-1:], sess, before.comm_bytes,
            before.extra, "traced direct pass")))
    t_cold = time.perf_counter() - t0
    _same_answers(direct, results, "traced direct pass")
    st = sess.stats()
    traced = sum(r["bytes"] for root in tracer.store.spans()
                 for r in root.records if r.get("kind") == "comm_step")
    if traced != st.comm_bytes:
        fail(f"trace: {traced} bytes traced, {st.comm_bytes} ledgered")
    print(f"trace<->ledger on the card: {len(queries)} queries, delta 0 "
          f"per query (largest {worst}) and in all ({traced} traced = "
          f"{st.comm_bytes} ledgered bytes), decision records equal the "
          f"counter deltas; cold traced pass {t_cold:.2f} s", flush=True)

    # tracing cost: warm passes, untraced (the serve's session) and
    # traced, alternated
    secs = {"untraced": [], "traced": []}
    for _ in range(3):
        for name, s in (("untraced", session), ("traced", sess)):
            secs[name].append(host_s(lambda: [s.execute(q)
                                              for q in queries]))
    print(f"tracing cost ({card}): warm pass of {len(queries)} queries "
          f"untraced {secs['untraced']} s, traced {secs['traced']} s",
          flush=True)
    base_qps = len(queries) / min(secs["traced"])

    # 2. served parity: the list twice, so that shapes coalesce
    served_list = list(queries) * 2
    lat_q = registry.histogram("repro_query_latency_seconds",
                               backend="spmd")
    q_before = list(lat_q.counts)
    before = sess.stats()
    n_roots = tracer.store.finished_total
    ops.reset_launches()
    t0 = time.perf_counter()
    with sess.serve(max_batch=DOOR_BATCH, max_delay_ms=DOOR_DELAY_MS) as door:
        futs = [door.submit(q, deadline_s=600.0) for q in served_list]
        _settle(futs)
    wall = time.perf_counter() - t0
    if dev == "cuda":
        torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)           # read after close(drain=True)
    _door_failures(door, futs, "served pass")
    served = [f.result(0) for f in futs]
    _same_answers(served, results * 2, "served pass")
    roots = tracer.store.spans()[-(tracer.store.finished_total - n_roots):]
    batch_roots = [s for s in roots if s.name == "serve_batch"]
    sizes: Dict[int, int] = {}
    for s in batch_roots:
        sizes[s.attrs["batch"]] = sizes.get(s.attrs["batch"], 0) + 1
    hits = sess.stats().extra["batch_shape_hits"] \
        - before.extra["batch_shape_hits"]
    lat_s = registry.histogram("repro_serve_latency_seconds",
                               backend="serve")
    print(f"front door ({card}): {len(served_list)} requests in "
          f"{wall:.2f} s, served qps={len(served_list) / wall:.3f}; "
          f"serve latency {_pcts_ms(lat_s)}; query latency "
          f"{_pcts_ms(_hist_delta(lat_q, q_before))}; batches="
          f"{int(door.stats()['batches'])}, batch sizes "
          f"{dict(sorted(sizes.items()))}, batch_shape_hits={int(hits)}, "
          f"failed={int(door.stats()['failed'])}, batch_fallbacks="
          f"{int(door.stats()['batch_fallbacks'])}", flush=True)
    print(f"launches on the front-door serve: {launches}", flush=True)
    print(f"front door: {len(served_list)} answer sets equal the direct "
          f"and the plain versions'", flush=True)

    # 3./4. the served pass reconciles too; span chain and snapshot
    _reconcile(batch_roots, sess, before.comm_bytes, before.extra,
               "served pass")
    if not batch_roots or not all(
            s.find("query") and any(r.get("kind") == "admission"
                                    for r in s.records)
            for s in batch_roots):
        fail("span chain: a serve_batch root lacks its query span or its "
             "admission records")
    required = tuple(REQUIRED_METRICS) + tuple(REQUIRED_SERVE_METRICS)
    doc = snapshot(registry, tracer=tracer)
    validate_snapshot(doc, required)
    names = {e["name"] for sec in ("counters", "gauges", "histograms")
             for e in doc[sec]}
    print(f"span chain: {len(batch_roots)} serve_batch roots, each with a "
          f"query span and admission records; snapshot validated "
          f"({len(required)} required names, {len(names)} names)",
          flush=True)

    # 5. capacity sweep at multiples of the sequential base rate
    reports = measure_capacity(
        lambda: FrontDoor(sess, FrontDoorConfig(
            max_queue=SWEEP_QUEUE, max_batch=DOOR_BATCH,
            max_delay_ms=DOOR_DELAY_MS)),
        queries, base_qps, multipliers=SWEEP, duration_s=SWEEP_S, seed=7,
        deadline_s=SWEEP_DEADLINE_S)
    for rep in reports:
        print(f"load {rep.offered_multiplier:g}x ({card}): offered "
              f"{rep.offered_qps:.3f} qps, achieved {rep.achieved_qps:.3f} "
              f"qps, p50={rep.p50_latency_s * 1e3:.2f} ms "
              f"p99={rep.p99_latency_s * 1e3:.2f} ms, submitted "
              f"{rep.submitted}, shed_rate={rep.shed_rate:.4f} "
              f"(queue_full={rep.shed_queue_full}, breaker="
              f"{rep.shed_breaker}, deadline={rep.deadline_expired}), "
              f"failed={rep.failed}", flush=True)
        if rep.failed:
            fail(f"load {rep.offered_multiplier:g}x: {rep.failed} failed "
                 f"requests")

    # 6. hot swap through the door, between two halves of the list
    sids = plan.site_edge_ids()
    half = len(queries) // 2
    swap = {}

    def do_swap():
        if dev == "cuda":
            torch.cuda.synchronize()
            swap["before"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        eng.swap_store(sids[1:] + sids[:1],
                       replicated_props=set(plan.replicated_props))
        if dev == "cuda":
            torch.cuda.synchronize()
            swap["peak"] = torch.cuda.max_memory_allocated()
            swap["after"] = torch.cuda.memory_allocated()
        swap["s"] = time.perf_counter() - t

    with sess.serve(max_batch=DOOR_BATCH, max_delay_ms=DOOR_DELAY_MS) as door:
        futs = [door.submit(q, deadline_s=600.0) for q in queries[:half]]
        _settle(futs)
        door.request_swap(do_swap)
        futs += [door.submit(q, deadline_s=600.0) for q in queries[half:]]
        _settle(futs)
    _door_failures(door, futs, "swap pass")
    _same_answers([f.result(0) for f in futs], results, "swap pass")
    gen, swaps = eng.store_generation, int(sess.stats().extra["store_swaps"])
    if (gen, door.swaps_applied, swaps) != (1, 1, 1):
        fail(f"swap: store_generation={gen}, swaps_applied="
             f"{door.swaps_applied}, store_swaps={swaps}")
    print(f"hot swap ({card}): {swap['s']:.2f} s, store_generation={gen}, "
          f"swaps_applied={door.swaps_applied}, store_swaps={swaps}; device "
          f"memory before {swap.get('before')} bytes, peak across the swap "
          f"{swap.get('peak')}, after {swap.get('after')}; "
          f"{len(queries)} answer sets equal before and after", flush=True)

    # 7. the serve CLI in-process, at its default size
    t0 = time.perf_counter()
    rc = serve_main(["--smoke", "--device", dev, "--out",
                     str(ROOT / "build" / "serve_smoke.json")])
    if rc != 0:
        fail(f"python -m repro_torch.serve --smoke returned {rc}")
    print(f"python -m repro_torch.serve --smoke: 0 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ----------------------------------------------------------------------
# LM phase
# ----------------------------------------------------------------------

def _attn_gaps(got: torch.Tensor, want: torch.Tensor):
    """(largest absolute error, largest row-relative error): the second
    is ||got - want|| / ||want|| over the last dimension, the largest of
    all query rows; a row whose ``want`` is 0 (no visible key) counts 0
    where ``got`` is 0 there too, else infinity."""
    if got.shape != want.shape:
        fail(f"flash_attention: shape {tuple(got.shape)} != "
             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0, 0.0
    diff = got.float() - want.float()
    dn, wn = diff.norm(dim=-1), want.float().norm(dim=-1)
    rel = torch.where(wn > 0, dn / wn.clamp_min(1e-30),
                      torch.where(dn > 0, float("inf"), 0.0))
    return float(diff.abs().max()), float(rel.max())


def _attn_passes(got: torch.Tensor, want: torch.Tensor,
                 dtype: torch.dtype) -> bool:
    """Both gates: the JAX package's elementwise tolerance for the type
    (atol = rtol) and the row-relative bound ``ATTN_ROW_TOL``."""
    if not bool(torch.isfinite(got).all()):
        return False
    tol = ATTN_TOL[dtype]
    g, w = got.float(), want.float()
    if bool(((g - w).abs() > tol + tol * w.abs()).any()):
        return False
    return _attn_gaps(got, want)[1] <= ATTN_ROW_TOL[dtype]


def _attn_close(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
                what: str):
    """Hold the flash kernel's output against its plain version's
    (``_attn_passes``); returns (largest absolute error, largest
    row-relative error)."""
    gaps = _attn_gaps(got, want)
    if not _attn_passes(got, want, dtype):
        fail(f"flash_attention {what}: max abs error {gaps[0]}, max "
             f"row-relative error {gaps[1]} (limits: atol = rtol = "
             f"{ATTN_TOL[dtype]}, row {ATTN_ROW_TOL[dtype]}), or non-finite")
    return gaps


def _attn_controls(want: torch.Tensor, dropped: torch.Tensor,
                   dtype: torch.dtype, what: str) -> None:
    """The gate must reject a wrong kernel: an all-zero output, and
    ``dropped``, the plain version with one KV tile left out.  Prints
    whether the elementwise tolerance alone would have accepted each."""
    from unittest import mock
    alone = []
    for name, bad in (("zeros", torch.zeros_like(want)),
                      ("one KV tile dropped", dropped)):
        if _attn_passes(bad, want, dtype):
            fail(f"flash_attention {what}: the gate accepts the control "
                 f"'{name}'")
        with mock.patch.dict(ATTN_ROW_TOL, {dtype: float("inf")}):
            if _attn_passes(bad, want, dtype):
                alone.append(name)
    print(f"flash_attention {what}: controls rejected (zeros: row error "
          f"{_attn_gaps(torch.zeros_like(want), want)[1]:.3e}; one KV tile "
          f"dropped: {_attn_gaps(dropped, want)[1]:.3e}); the elementwise "
          f"tolerance alone accepts {alone or 'none'}", flush=True)


def _attn_err(q, k, v, window, what, causal=True):
    from repro_torch.kernels import ops, ref
    return _attn_close(ops.attention(q, k, v, causal=causal, window=window),
                       ref.attention_ref(q, k, v, causal, window), q.dtype,
                       what)


def _drop_kv_tile(k: torch.Tensor, start: int, tile: int = 64):
    """k (or v) without keys [start, start + tile): through the plain
    version's end-of-timeline alignment, the attention of every query
    that saw those keys, without them (a kernel that skipped the
    tile)."""
    return torch.cat([k[:, :, :start], k[:, :, start + tile:]], dim=2)


def _attn_flop(B, Hq, Hkv, Sq, Skv, D):
    """FLOP of the two products over the visible (query, key) pairs of a
    causal run."""
    off = Skv - Sq
    pairs = sum(max(0, min(Skv, i + off + 1)) for i in range(Sq))
    return 4.0 * B * Hq * D * pairs


def _attn_bound(B, Hq, Hkv, Sq, Skv, D, elem):
    """Bytes (q, k, v read once, o written once) and ``_attn_flop``."""
    nbytes = (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D) * elem
    return bound(nbytes, _attn_flop(B, Hq, Hkv, Sq, Skv, D), BF16_OPS_PER_S)


def attention_phase(dev: str = "cuda") -> dict:
    """flash_attention against its plain version on the card: the
    model's prefill shape, the JAX package's sweep in float32 and bf16,
    rows with no visible key, and one layer at 1 x 32768 (its last 512
    query rows compared).  Returns the kernel's record."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.configs import get_arch
    cfg = get_arch(LM_ARCH).config
    gen = torch.Generator(device=dev).manual_seed(1)

    def qkv(B, Hq, Hkv, Sq, Skv, D, dtype):
        return [torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
                for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                              (B, Hkv, Skv, D))]

    gaps: Dict[torch.dtype, List[tuple]] = {torch.float32: [],
                                            torch.bfloat16: []}

    def check(a, window, what, causal=True):
        gaps[a[0].dtype].append(_attn_err(*a, window, what, causal))

    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shape = (LM_BATCH, H, Hkv, LM_SEQ, LM_SEQ, D)
    q, k, v = qkv(*shape, torch.bfloat16)
    check((q, k, v), None, f"model shape {shape} bf16")
    _attn_controls(ref.attention_ref(q, k, v),
                   ref.attention_ref(q, _drop_kv_tile(k, 0),
                                     _drop_kv_tile(v, 0)),
                   torch.bfloat16, f"model shape {shape}")
    for case in ATTN_CASES + ATTN_EXTRA:
        for dtype in (torch.float32, torch.bfloat16):
            check(qkv(*case[:6], dtype), case[7], f"{case} {dtype}",
                  causal=case[6])
    for window in (None, 16):       # Sq > Skv: 128 rows see no key
        for dtype in (torch.float32, torch.bfloat16):
            a = qkv(1, 4, 2, 256, 128, 32, dtype)
            check(a, window, f"no visible key, window {window} {dtype}")
            if bool(ops.attention(*a, window=window)[:, :, :128].any()):
                fail("flash_attention: a row with no visible key is not 0")
    print(f"flash_attention checks: {sum(map(len, gaps.values()))} cases; "
          + "; ".join(f"{dt}: max abs error {max(g[0] for g in gl):.3e}, "
                      f"max row-relative error {max(g[1] for g in gl):.3e}"
                      for dt, gl in gaps.items()), flush=True)

    rec = {"max_abs_err": max(g[0] for gl in gaps.values() for g in gl)}
    bms, by = _attn_bound(*shape, 2)
    rec.update(
        ms=cuda_ms(lambda: ops.attention(q, k, v)),
        plain_ms=cuda_ms(lambda: ref.attention_ref(q, k, v), reps=3),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        bound_ms=bms, bound_by=by)
    flop = _attn_flop(*shape)
    print(f"kernel flash_attention: kernel_ms={rec['ms']:.4f} "
          f"({flop / rec['ms'] / 1e9:.1f} TFLOP/s, {rec['ms'] / bms:.2f}x "
          f"the bound, {rec['ms'] / rec['library_ms']:.2f}x the library) "
          f"plain_ms={rec['plain_ms']:.4f} library_ms="
          f"{rec['library_ms']:.4f} bound_ms={bms:.5f} ({by}) at "
          f"B={LM_BATCH} Hq={H} Hkv={Hkv} S={LM_SEQ} D={D} bf16 causal",
          flush=True)
    del q, k, v

    # one layer at the prefill_32k length; the plain version's fp32
    # scores at full length would not fit, so only the last rows are
    # compared, through its Sq = 512, Skv = 32768 form
    q, k, v = qkv(1, H, Hkv, LM_LONG, LM_LONG, D, torch.bfloat16)
    q_last = q[:, :, -LM_LONG_CHECKED:]
    want = ref.attention_ref(q_last, k, v)
    err, rel = _attn_close(ops.attention(q, k, v)[:, :, -LM_LONG_CHECKED:],
                           want, torch.bfloat16, f"S={LM_LONG}, last rows")
    mid = LM_LONG // 2
    _attn_controls(want, ref.attention_ref(q_last, _drop_kv_tile(k, mid),
                                           _drop_kv_tile(v, mid)),
                   torch.bfloat16, f"S={LM_LONG}, last rows")
    del want
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    bms, by = _attn_bound(1, H, Hkv, LM_LONG, LM_LONG, D, 2)
    long_ms = cuda_ms(lambda: ops.attention(q, k, v), reps=3)
    long_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=3)
    flop = _attn_flop(1, H, Hkv, LM_LONG, LM_LONG, D)
    print(f"kernel flash_attention at B=1 S={LM_LONG}: kernel_ms="
          f"{long_ms:.4f} ({flop / long_ms / 1e9:.1f} TFLOP/s, "
          f"{long_ms / bms:.2f}x the bound, {long_ms / long_lib:.2f}x the "
          f"library) library_ms={long_lib:.4f} bound_ms={bms:.5f} "
          f"({by}); last {LM_LONG_CHECKED} rows max abs error {err:.3e}, "
          f"max row-relative error {rel:.3e}", flush=True)
    return rec


def device_profile(fn: Callable[[], object], what: str,
                   own_kernels: bool = False) -> None:
    """Device busy share of one call of ``fn``: the summed durations of
    the device-side events ``torch.profiler`` records (kernels, copies,
    fills; one stream, so they do not overlap) over the host-clock wall
    time of the call, and the rest of the wall time, outside any device
    work; the five largest kernels by device time; with
    ``own_kernels``, every kernel of the port's ``csrc/`` and the
    memsets, summed by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = host_s(fn)
    by_name: Dict[str, List[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy_us = sum(sum(v) for v in by_name.values())
    if busy_us <= 0:
        print(f"profile {what}: device busy share not measured (the "
              f"profiler recorded no device time)", flush=True)
        return
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    print(f"profile {what}: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / 1e4 / wall:.1f}%), outside "
          f"any device work {100 - busy_us / 1e4 / wall:.1f}% of the wall "
          f"time; {sum(map(len, by_name.values()))} device operations; top "
          "kernels: " + "; ".join(
              f"{name[:60]} {sum(v) / 1e3:.2f} ms x{len(v)}"
              for name, v in top[:5]), flush=True)
    if own_kernels:
        mine = port_kernel_names()
        own = [(kernel_label(name), v) for name, v in top
               if kernel_label(name).split("<")[0].split("::")[-1] in mine
               or name.startswith("Memset")]
        print(f"profile {what}, the port's kernels and memsets: " + "; ".join(
            f"{name} {sum(v) / 1e3:.3f} ms x{len(v)}" for name, v in own),
            flush=True)


def lm_phase(card: str, dev: str = "cuda") -> dict:
    """qwen3-1.7b at full width and depth on the card: the flash
    kernel's checks, the prefill forward through the kernel against the
    same forward on plain attention, then ``serve()`` and the forward
    against the serve step's logits.  Returns the flash record with its
    launches on the forward."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.launch.steps import make_forward_step
    from repro_torch.models import build_lm, get_api, param_count
    from repro_torch.models.lm import lm_defs

    # float32 products in full float32 for the float32 checks (the
    # default, stated): TF32 would round beyond their 2e-5 tolerance
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    rec = attention_phase(dev)

    cfg = dataclasses.replace(get_arch(LM_ARCH).config, use_flash_kernel=True)
    t0 = time.perf_counter()
    model = build_lm(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"lm: {cfg.name}, param_count={param_count(lm_defs(cfg))}, "
          f"{nbytes} bytes of weights, built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def max_diff(a, b):
        return max(float((a[i].float() - b[i].float()).abs().max())
                   for i in range(a.shape[0]))

    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                         generator=gen, device=dev, dtype=torch.int32)
    forward = make_forward_step(cfg)
    # the kernel's inputs and output in the last layer of the counted
    # forward: the strided head-transposed views the model passes
    seen = []
    real_attention = ops.attention

    def keep_last(q, k, v, **kw):
        out = real_attention(q, k, v, **kw)
        seen[:] = [(q, k, v, out, kw)]
        return out

    ops.reset_launches()
    with mock.patch.object(ops, "attention", keep_last):
        logits = forward(model, toks)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    q, k, v, out, kw = seen[0]
    if q.is_contiguous() or k.is_contiguous() or v.is_contiguous():
        fail("flash_attention: the forward passed contiguous q, k, v")
    # the kernel writes [B, Sq, Hq, D] rows: _sdpa's merge of the heads,
    # out.transpose(1, 2).reshape(B, Sq, Hq * D), is a view, not a copy
    merged = out.transpose(1, 2).reshape(out.shape[0], out.shape[2], -1)
    if merged.data_ptr() != out.data_ptr() \
            or merged.untyped_storage().data_ptr() \
            != out.untyped_storage().data_ptr():
        fail(f"flash_attention: the forward's output (strides "
             f"{out.stride()}) reaches _sdpa's head merge as a copy")
    print(f"flash_attention output strides {out.stride()}: _sdpa's head "
          f"merge is a view", flush=True)
    del merged
    err, rel = _attn_close(out, ref.attention_ref(q, k, v, **kw),
                           torch.bfloat16, "last layer of the forward")
    print(f"flash_attention on the last layer's q, k, v of the forward "
          f"(strides {q.stride()}, {k.stride()}): max abs error {err:.3e}, "
          f"max row-relative error {rel:.3e}", flush=True)
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    del q, k, v, out, seen
    print(f"launches on the LM forward: {launches}", flush=True)
    if launches["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention launched {launches['flash_attention']} "
             f"times in a {cfg.num_layers}-layer forward")
    if logits.shape != (LM_BATCH, LM_SEQ, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"forward logits: shape {tuple(logits.shape)} or non-finite")
    plain_forward = make_forward_step(
        dataclasses.replace(cfg, use_flash_kernel=False))
    ops.reset_launches()
    plain_logits = plain_forward(model, toks)
    if any(ops.LAUNCHES.values()):
        fail(f"kernels launched in the plain forward: {ops.LAUNCHES}")
    diff = max_diff(logits, plain_logits)
    del logits, plain_logits
    # warm timings (the first calls above also paid for cuBLAS set-up)
    t_fwd = host_s(lambda: forward(model, toks))
    t_plain = host_s(lambda: plain_forward(model, toks))
    print(f"forward ({card}): {LM_BATCH}x{LM_SEQ} tokens in {t_fwd:.3f} s "
          f"({LM_BATCH * LM_SEQ / t_fwd:.1f} tok/s) through the kernel, "
          f"{t_plain:.3f} s on plain attention (warm, host clock); logits "
          f"max abs difference {diff:.4f}", flush=True)
    if diff > LOGIT_TOL:
        fail(f"forward logits differ from plain attention by {diff}")
    device_profile(lambda: forward(model, toks), f"forward {LM_BATCH}x{LM_SEQ}")

    r = serve(LM_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
              gen_len=SERVE_GEN, smoke=False, seed=0, device=dev,
              model=model)
    if r.tokens.shape != (SERVE_BATCH, SERVE_GEN) or r.tokens.min() < 0 \
            or r.tokens.max() >= cfg.vocab_size:
        fail(f"serve tokens: shape {r.tokens.shape}, range "
             f"[{r.tokens.min()}, {r.tokens.max()}]")
    print(f"serve ({card}): {SERVE_BATCH} requests, prompt {SERVE_PROMPT}, "
          f"gen {SERVE_GEN}: prefill {r.prefill_sec:.3f} s "
          f"({SERVE_BATCH * SERVE_PROMPT / r.prefill_sec:.1f} tok/s), "
          f"decode {r.decode_sec:.3f} s ({r.tokens_per_sec:.1f} tok/s)",
          flush=True)
    # the kernel-backed forward over the served prompts against the
    # serve step's logits at the last prompt token
    prompts = torch.from_numpy(make_prompts(
        cfg.vocab_size, SERVE_BATCH, SERVE_PROMPT, 0)).to(dev)
    last = forward(model, prompts)[:, -1]
    api = get_api(cfg)
    cache = api.init_cache(cfg, SERVE_BATCH, SERVE_PROMPT, dev)
    for t in range(SERVE_PROMPT):
        step_logits, cache = api.decode(cfg, model, prompts[:, t], cache, t)
    diff = max_diff(last, step_logits)

    def decode_steps():
        for t in range(SERVE_PROMPT - 8, SERVE_PROMPT):
            api.decode(cfg, model, prompts[:, t], cache, t)
    device_profile(decode_steps, f"8 decode steps at batch {SERVE_BATCH}")
    print(f"serve step vs forward at the last prompt token: logits max abs "
          f"difference {diff:.4f}", flush=True)
    if diff > LOGIT_TOL:
        fail(f"forward and serve step logits differ by {diff}")
    print(f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes "
          f"in the LM phase ({card})", flush=True)
    rec["launches"] = launches["flash_attention"]
    return rec


def rdf_setup():
    """Phase 2: the WatDiv graph, its design workload, the 4-site plan
    and a session serving it on the card."""
    from repro_torch.core import (PartitionConfig, Session, build_plan,
                                  generate_watdiv, generate_workload)
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
    return graph, plan, session


def spmd_phase(card: str) -> Dict[str, dict]:
    """Phases 2 to 5: the WatDiv plan, the join kernels, the served
    queries (``execute``, its profile, then ``execute_many``), then the
    front door.  Returns the records of the kernels checked against the
    store, with their launches on the ``execute`` serve (``spmd``) and
    on the front door's served pass (``serve``)."""
    from repro_torch.core import Session
    graph, plan, session = rdf_setup()
    kernels = kernel_phase(session.engine.store)
    queries = served_queries(graph)
    plain = Session(plan, backend="spmd", spmd_max_capacity=MAX_CAPACITY)
    torch.cuda.reset_peak_memory_stats()
    launches, results = serve_phase(session, plain, graph, queries, card)
    print(f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"bytes ({card})", flush=True)
    missing = [k for k, (_s, _t, path) in KERNELS.items()
               if path == "spmd" and launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the serve path: {missing}")
    del plain
    many = serve_many_phase(plan, queries, results, card)
    missing = [k for k, (_s, _t, path) in KERNELS.items()
               if path == "spmd" and many[k] <= 0]
    if missing:
        fail(f"kernels never launched on the execute_many serve: {missing}")
    served = door_phase(plan, queries, results, session, card)
    missing = [k for k, (_s, _t, path) in KERNELS.items()
               if path == "spmd" and served[k] <= 0]
    if missing:
        fail(f"kernels never launched on the front-door serve: {missing}")
    for k in kernels:
        kernels[k]["launches"] = launches[k]
        if KERNELS[k][2] == "spmd":
            kernels[k]["paths"] = {"spmd": launches[k], "serve": served[k]}
    return kernels


def ptxas_lines(name: str) -> List[str]:
    """One line per kernel function of library ``name`` from its
    ``ptxas -v`` report: registers, spills, shared memory, and any
    warning ptxas gave (such as serialised wgmma).  Fails if the
    warp-specialised flash kernel spills."""
    import re
    from repro_torch.kernels import build

    def kernel_name(mangled: str) -> str:
        # Itanium mangling: each name is its length, then its characters
        # (the length may follow other digits); template arguments of
        # int and bool as ILi128ELb1EE
        for m in re.finditer(r"\d+", mangled):
            for start in range(m.start(), m.end()):
                size = int(mangled[start:m.end()])
                name = mangled[m.end():m.end() + size]
                if name.endswith("_kernel"):
                    t = re.match(r"I((?:L[ib]\d+E)+)E",
                                 mangled[m.end() + size:])
                    args = re.findall(r"L([ib])(\d+)E", t.group(1)) \
                        if t else []
                    return name + ("<" + ", ".join(
                        v if k == "i" else ("true" if v == "1" else "false")
                        for k, v in args) + ">" if args else "")
        return mangled

    log = build._library_path(name).with_suffix(".log").read_text()
    lines, fn = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = kernel_name(ln.split("for", 1)[1].strip())
            lines.append(fn + ":")
        elif fn and ("spill" in ln or "registers" in ln):
            lines[-1] += " " + ln.split(":", 1)[-1].strip()
            if "spill stores" in ln and "wgmma" in fn \
                    and not re.search(r"\b0 bytes spill stores", ln):
                fail(f"ptxas: {fn} spills registers: {ln.strip()}")
        elif "(C75" in ln:
            lines.append("warning: " + ln.split("info    :", 1)[-1].strip())
    return lines


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the "
              "card only", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import build

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(secs)} "
          f"kernels (per kernel: "
          f"{ {k: round(v, 1) for k, v in secs.items()} })", flush=True)
    for name in build.SOURCES:
        for line in ptxas_lines(name):
            print(f"ptxas {name}: {line}", flush=True)

    kernels = spmd_phase(card)
    torch.cuda.empty_cache()
    kernels["flash_attention"] = lm_phase(card)
    kernels["flash_attention"]["paths"] = {
        "lm": kernels["flash_attention"]["launches"]}

    rows = []
    for name, (source, replaces, path) in KERNELS.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "path": path or "none",
                     "paths": k.get("paths", {}),
                     "launches": k["launches"],
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
