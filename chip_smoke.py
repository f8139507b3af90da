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
   kernel of the path launched; the two runs' per-query ledgers
   (``comm_bytes`` and capacity retries) must be equal on every query
   that retried on neither side, and the retried queries that differ
   are printed (on an overflowing tier row order decides which rows
   survive); one warm pass under the profiler (device busy share, the
   port's kernels by name); then the same queries through
   ``execute_many`` in batches of 64 on a fresh engine (answers equal
   to ``execute``'s, counters and launches read).  Then the functional
   matcher API: ``spmd_match`` over the plan's 4-site store and
   ``local_match`` over the whole graph as one site for the star, chain
   and cycle, rows equal to the session's, and for a closed triangle
   (the cycle with its last edge turned around; 66,176 rows on this
   graph), rows equal to the host ``match_pattern``'s and not empty
   (the cycle and the triangle through ``pair_semijoin`` and
   ``dedup_rows``, every join kernel launched);
   and a site lost: ``replan_allocation`` of the plan's fragment
   affinity to 3 sites, the queries served on an SPMD engine over that
   allocation's store (the one ``SiteStore.from_fragmentation``
   builds) with answers equal to the 4-site
   serve's and every join kernel launched (store seconds, qps, p50/p99,
   the ledger against the 4-site one, resident rows per site).
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
6. the online adaptive loop on the same plan: a drifting stream
   (``generate_drifting_workload``, 200 uniform then 400 linear-heavy
   queries, every template query bound to a constant) through
   ``Session(plan, backend="adaptive")`` with the SPMD data plane
   (epochs of 100 queries, a 48,000,000-byte migration budget, room
   for the re-partition's optional moves): a line per epoch (drift,
   migration bytes and makespan, the deferred moves' affinity gains,
   re-fragmentation seconds by step, ``swap_store`` seconds, store
   generation, resident rows per site), resident rows per site before
   the stream and after every swap (a swap must change them), the
   serve before and after the first hot swap, the
   launches on both sides of it (every join kernel must launch on
   both), trace<->ledger on every tenth query, every answer against a
   static session of the original plan on the plain versions, the
   budget, the realized allocation and coverage after every
   re-partition, the same engine object throughout; the JAX package's
   ``bench_adaptive`` and ``bench_lifecycle`` at their own size, held
   to its values (``ONLINE_REFERENCE``); the original and the adapted
   plan through a ``PlanRepository`` (save / load seconds, bytes on
   disk, the latest equal to the adapted plan, provenance, monitor
   state); a seeded delta of 20,000 added and 10,000 removed triples
   through ``ingest_delta`` and a hot swap with the new graph, the
   served queries on it against the plain versions and
   ``match_pattern`` on the new graph.
7. strategies, on a ``STRATEGY_TRIPLES`` WatDiv graph (cut from the
   main graph for the time limit) with its own design workload and
   served queries: the vertical plan's serve of it, then the horizontal
   (minterm predicates), SHAPE and WARP plans (seconds split by offline
   step, WARP's label propagation on its own, fragments, minterm
   fragments, redundancy, resident rows per site), each served on the
   card (ledger line, launches; every join kernel must launch) with
   every answer set equal to the vertical plan's serve and to the same
   session on the plain versions; on the horizontal plan
   the host backends ``local`` and ``baseline`` (numpy on the host, as
   in the reference) answer the first template queries and the shapes
   with the spmd serve's answers.  Then the JAX package's seeded ledger
   benches (``spmd_comm``, ``spmd_replication``, ``spmd_routing``) on
   the card, held to their properties and to the JAX package's totals.
8. distributed, once the sessions above are freed: the graph's columns
   and the vertical plan written under the checkout's ``build/``
   (``np.save``, ``PartitionPlan.save``); ``torch.cuda.device_count()``
   ranks spawned (``repro_torch.launch.mesh.launch``, an NCCL group
   from a file store, rank r on ``cuda:r``, a timeout on the group and
   a deadline on the phase), each loading them, running ``spmd_match``
   on the three shapes untimed, and serving the phase 4 queries
   through ``Session(plan, backend="spmd", mesh=...)`` on its
   block of the 4 slots, with ``execute`` and then with
   ``execute_many`` on a fresh session: every rank's answers,
   per-query ledger (bytes and the deltas of ``LEDGER_COUNTERS``) and
   counters equal the one-process sessions' of phase 4, and every join
   kernel launches on every rank.  A line with the world size, the
   backend, the slots, qps, the collective calls and the join kernels'
   launches per rank.  Then, on the same group, rank 0 leads
   (``Session.lead``) and the other ranks follow (``Session.follow``):
   the front door -- the phase 4 queries twice through
   ``Session.serve()`` (every answer equal to phase 4's, every outcome
   completed), a sequential pass, a capacity sweep at 1x (4x and 16x
   are left to phase 5, for the time limit) and a hot swap to the same
   placement through the door (the store
   generation raised on every rank); every rank's per-query bytes and
   counters equal rank 0's -- and phase 6's adaptive stream through
   ``Session(plan, backend="adaptive", mesh=...)``, submitted once by
   rank 0, which runs the control plane (the shapes on the data plane
   before and after it on every rank): every rank's answers, bytes,
   epoch reports, realized placement and counters equal phase 6's.
   Lines with served qps, latency, the sweep, swap and
   re-fragmentation seconds, qps before and after the swap beside
   phase 6's, collective calls (broadcasts apart) and the join
   kernels' launches per rank on each path.
9. LM: ``flash_attention`` against its plain version (qwen3-1.7b's
   prefill shape, the JAX package's attention sweep in float32 and
   bf16, the model paths' head layouts (g = 8, g = 16, MHA at D 64, a
   window inside S), rows with no visible key, one layer at 1 x 32768),
   each held to
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
   Then MoE: qwen2-moe-a2.7b at its published width and depth (24
   layers, 14,315,735,040 parameters, bf16, seeded weights); the
   forward at 2 x 4096 on the plain config (flat dispatch, C = 688)
   with 24 flash launches, every layer's kernel output held against the
   plain version on its q, k, v and every layer's largest expert load
   and dropped assignments printed; against the same forward on plain
   attention replaying the kernel forward's expert choices (logits
   within 0.25; a token-layer whose own choice differs must be a
   near-tie); the production profile (batched dispatch, C = 344 per
   sequence); batched against flat at a capacity no expert can fill
   (factor num_experts / top_k: the same experts in every layer, logits
   within 0.25); ``serve()`` of 4 x (128 + 32); the forward against the
   decode steps at every prompt position at that capacity, decode
   replaying the forward's routing.  Then the arch sweep:
   mixtral-8x7b (1 x 8192, its 4096 window masking), qwen2.5-3b,
   nemotron-4-15b, musicgen-medium, pixtral-12b and llama3-405b (1 x
   4096) at full width with 2 layers: the same forward checks with 2
   launches each, a short ``serve()``, forward against decode steps;
   mixtral's rolling cache through 4096 + 64 decode steps, each step
   past the wrap against the windowed forward.  Then the other two
   families: rwkv6-1.6b at its published width and depth (24 layers,
   1,583,941,632 parameters, bf16): the forward at 2 x 4096, ``serve()``
   of 4 x (128 + 32), the decode state's bytes at ``max_len`` 160 and
   524,288 (equal), every layer's time mix chunked against token by
   token over a 1 x 300 prompt (two 256-token chunks, the last
   padded: the WKV state and the outputs held; the end-to-end forward
   against the decode steps, which this random-weight model parts in
   the reference too, printed), float32 at 2 layers on the card against
   the CPU (1 x 300, the forward and the decode steps); no kernel may
   launch.  jamba-1.5-large-398b at published width cut to
   one 8-layer super-block with an MoE FFN every 4th layer (2 MoE + 5
   dense mamba sublayers, 27,118,690,304 parameters): the forward at 1 x
   4096 with exactly one flash launch, held against the plain version on
   its q, k, v, with every MoE sublayer's largest expert load and dropped
   assignments; against plain attention with the routing replayed;
   ``serve()`` of 4 x (16 + 8); the forward against the decode steps at
   every prompt position at factor E / K with the routing replayed; one
   mamba layer at full width in float32 on the card against the CPU (1 x
   256: the output and the final scan and conv states).
10. train: ``ops.attention`` refuses a q that requires grad (no launch);
   one float32 train step at qwen3-1.7b's width with 2 layers on the
   card and on the CPU from the same weights and batches (loss and
   grad norm within the stated tolerances, and the loss of a second
   step; TF32 off); ``train()`` at full width with 2 layers in bf16,
   checkpointed after step 3 and resumed from it (the resumed losses
   equal the uninterrupted run's); then qwen3-1.7b at full width and
   depth, bf16 weights, float32 AdamW moments, remat "full", 8 steps of
   4 x 1024 tokens (tok/s over steps 2-8, step seconds, peak device
   memory, losses and grad norms; finite, the last loss below the
   first; no kernel launched: training takes plain attention), and a
   ninth step under the profiler (device busy share, largest kernels).
   The launch counts are set to 0 before the refusal and read after
   the ninth step: ``flash_attention``'s ``paths.train`` is that count.
11. sharded: the LM substrate on a (1, 1) ("data", "model")
   ``DeviceMesh`` over a one-rank NCCL group: qwen3-1.7b's forward
   through ``make_forward_step(mesh=)`` (28 flash launches through
   ``local_map``, logits held to the forward without a mesh), 3 train
   steps and 16 decode steps against the same steps without a mesh,
   qwen2-moe's forward with ``moe_shard_map`` (routing replayed), and
   the dry run's llama3-405b ``train_4k`` cell on 16x16 on the host
   (``sharded_phase``).
12. the kernels as one JSON line (each with the path it launched on and
   its launches there, and ``paths``: launches per path (flash on
   ``lm``, ``moe``, ``archs``, ``jamba``, ``train``, ``sharded`` and
   ``sharded_moe``), the join
   kernels on ``spmd``, ``serve``, ``matcher``, ``site_loss``,
   ``adaptive``, ``horizontal``, ``shape``, ``warp``, ``distributed``,
   ``distributed_door`` and ``distributed_adaptive``), the card line,
   and last the result.

``chip_baseline.py`` reuses phases of this script to measure an earlier
commit's checkout in the same chip call as a change.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import logging
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
# the model paths' head layouts at a small S: g = 8 (qwen2.5-3b, 16
# query heads over 2), g = 16 (llama3-405b, 128 over 8), MHA at D 64
# (musicgen-medium, 24 of 24) and a 512-key window inside S = 1024
# (mixtral's 32 over 8)
ATTN_MODEL_CASES = [(1, 16, 2, 512, 512, 128, True, None),
                    (1, 128, 8, 256, 256, 128, True, None),
                    (1, 24, 24, 512, 512, 64, True, None),
                    (1, 32, 8, 1024, 1024, 128, True, 512)]
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


#: the engine counters a query's ledger line holds beside its bytes
LEDGER_COUNTERS = ("capacity_retries", "gather_steps", "edge_shipped_steps",
                   "edge_cache_hits", "skipped_gathers")


def _counters(session) -> tuple:
    extra = session.stats().extra
    return tuple(int(extra[k]) for k in LEDGER_COUNTERS)


def serve_phase(session, plain, graph, queries, card: str):
    """Serve ``queries`` through ``session`` between a reset and a read
    of the launch counters; then hold every answer set against
    ``plain`` (the same engine on the plain versions) and a subset
    against the host ``match_pattern``.  Returns the launch counts, the
    results and the serve's ledger: per query its bytes and the deltas
    of ``LEDGER_COUNTERS``, and the engine's counters after the
    serve."""
    from unittest import mock

    from repro_torch.core import match_pattern
    from repro_torch.core import spmd as spmd_module
    from repro_torch.kernels import ops, ref

    ops.reset_launches()
    lat: List[float] = []
    results = []
    deltas: List[tuple] = []
    t_serve = time.perf_counter()
    for q in queries:
        before = _counters(session)
        t0 = time.perf_counter()
        results.append(session.execute(q))
        lat.append(time.perf_counter() - t0)
        deltas.append(tuple(a - b for a, b in zip(_counters(session),
                                                  before)))
    t_serve = time.perf_counter() - t_serve
    retries = [d[0] for d in deltas]
    launches = dict(ops.LAUNCHES)
    st = session.stats()
    ledger = {"per_query": [(r.stats.comm_bytes,) + d
                            for r, d in zip(results, deltas)],
              "extra": dict(st.extra), "qps": len(queries) / t_serve}
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
    plain_results = []
    plain_retries: List[int] = []
    with mock.patch.multiple(spmd_module, join_range=ref.join_range_ref,
                             pair_semijoin_runs=ref.pair_semijoin_runs_ref,
                             dedup_rows_masked=ref.dedup_rows_masked_ref,
                             fused_join_sites=ref.fused_join_sites_ref):
        for q in queries:
            before = _retries(plain)
            plain_results.append(plain.execute(q))
            plain_retries.append(_retries(plain) - before)
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
    compare_ledgers(queries, [r.stats.comm_bytes for r in results], retries,
                    [r.stats.comm_bytes for r in plain_results],
                    plain_retries)
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
    return launches, results, ledger


def _retries(session) -> int:
    return int(session.stats().extra["capacity_retries"])


def compare_ledgers(queries, card_bytes: List[int], card_retries: List[int],
                    plain_bytes: List[int], plain_retries: List[int]) -> None:
    """Hold the card's per-query ledger to the plain versions'.  A query
    that made no capacity retry on either side must ship the same bytes
    with the same retries.  On an overflowing tier the rows that
    survive depend on row order (the plain versions sort the deduped
    rows, the kernels keep them in place, as the reference's CPU path
    and its TPU kernels do), so that tier's bytes may differ: retried
    queries are printed, the ones that differ named, not failed."""
    same_free, retried, differ = 0, [], []
    for i in range(len(queries)):
        equal = (card_bytes[i] == plain_bytes[i]
                 and card_retries[i] == plain_retries[i])
        if card_retries[i] == 0 and plain_retries[i] == 0:
            if not equal:
                fail(f"ledger: query {i} {queries[i].edges} made no retry "
                     f"but ships {card_bytes[i]} bytes on the kernels, "
                     f"{plain_bytes[i]} on the plain versions")
            same_free += 1
            continue
        retried.append(i)
        if not equal:
            differ.append(i)
    diff = sum(card_bytes[i] - plain_bytes[i] for i in differ)
    print(f"ledger, kernels vs plain versions: {same_free} queries without "
          f"a retry equal; {len(retried)} retried ({sum(card_retries)} "
          f"retries on the kernels, {sum(plain_retries)} on the plain "
          f"versions), {len(differ)} of them differ, by {diff} bytes in "
          f"all (kernels {sum(card_bytes)}, plain {sum(plain_bytes)} "
          f"bytes)", flush=True)
    for i in differ:
        print(f"ledger differs: query {i} {queries[i].edges}: kernels "
              f"{card_bytes[i]} bytes / {card_retries[i]} retries, plain "
              f"{plain_bytes[i]} / {plain_retries[i]}", flush=True)


def serve_profile(session, queries) -> None:
    """One warm pass of the serve (capacity hints in place) under the
    profiler: the device busy share, the share of wall time outside any
    device work, the port's kernels summed by name, the five largest
    kernels."""
    device_profile(lambda: [session.execute(q) for q in queries],
                   f"RDF serve, one warm pass of {len(queries)} queries",
                   own_kernels=True)


def serve_many_phase(plan, queries, results, card: str):
    """The same queries through ``Session.execute_many`` in batches of
    64 on a fresh engine: queries of one shape inside a batch share one
    run of the match loop.  Every answer set must equal the ``execute``
    serve's.  Returns the launch counts of the batched serve and its
    ledger: bytes per query and the engine's counters."""
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
    return launches, {"per_query": [r.stats.comm_bytes for r in many],
                      "extra": dict(st.extra),
                      "qps": len(queries) / secs}


# ----------------------------------------------------------------------
# Matcher and site-loss phases
# ----------------------------------------------------------------------

MATCH_CAPACITY = 4096            # the first tier of the matcher's ladder


def _var_rows(rows: np.ndarray, cols: List[int]) -> np.ndarray:
    """Matcher rows in ``cols`` order as ``answer_rows`` lays an answer
    out: columns by sorted variable, distinct rows lexsorted."""
    out = rows[:, np.argsort(cols)].astype(np.int64)
    return np.unique(out, axis=0) if out.size else out.reshape(0, len(cols))


def _launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    from repro_torch.kernels import ops
    return {k: ops.LAUNCHES[k] - before.get(k, 0) for k in JOIN_KERNELS}


def closed_triangle(cycle):
    """The served cycle with its closing edge turned around: ``?a p1 ?b
    . ?b p2 ?c . ?a p3 ?c``.  On the smoke's graph the directed cycle
    has no match, while this triangle is closed by many (its answer is
    held non-empty), and its last edge still joins two bound variables,
    so it too goes through the pair semijoin and the cycle-close
    dedup."""
    from repro_torch.core.query import QueryGraph
    *path, last = cycle.edges
    return QueryGraph.make([(e.src, e.dst, e.prop) for e in path]
                           + [(last.dst, last.src, last.prop)])


def matcher_phase(graph, store, shapes, want, card: str,
                  dev: str = "cuda") -> Dict[str, int]:
    """The functional matcher API on the smoke's graph: ``spmd_match``
    over the plan's 4-site store and ``local_match`` over the whole
    graph as one site, for the star, chain and cycle, each answer equal
    to the session's (``want``, ``answer_rows``), and for the closed
    triangle (``closed_triangle``), whose answer ``match_pattern`` gives
    on the host and must not be empty.  ``spmd_match`` climbs from
    ``MATCH_CAPACITY`` until the matcher it builds reports no overflow
    (it returns what fitted, as the reference's does; the overflow is
    read through a recording ``make_spmd_matcher``); ``local_match``
    runs at four times the tier it settles on.  The cycle and the
    triangle must reach ``pair_semijoin_runs`` and ``dedup_rows_masked``
    and the phase every join kernel.  Returns its launches."""
    from unittest import mock

    from repro_torch.core import match_pattern
    from repro_torch.core import spmd as spmd_module
    from repro_torch.core.spmd import local_match, spmd_match
    from repro_torch.kernels import ops
    triangle = closed_triangle(shapes[2])
    t0 = time.perf_counter()
    tri_want = answer_rows(match_pattern(graph, triangle,
                                         max_rows=1 << 40).columns)
    t_host = time.perf_counter() - t0
    if tri_want.shape[0] == 0:
        fail(f"matcher: the closed triangle {triangle.edges} has no match "
             f"on the host")
    cols_t = [torch.from_numpy(np.asarray(c, np.int32)).to(dev)
              for c in (graph.s, graph.p, graph.o)]
    overflow: List[int] = []
    build = spmd_module.make_spmd_matcher

    def recording(pattern, capacity, mesh=None):
        fn = build(pattern, capacity, mesh)

        def run(st):
            out = fn(st)
            overflow.append(int(out[2].max()))
            return out
        return run

    start = dict(ops.LAUNCHES)
    for name, q, rows_want in zip(("star", "chain", "cycle", "triangle"),
                                  list(shapes) + [triangle],
                                  list(want) + [tri_want]):
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        cap = MATCH_CAPACITY
        with mock.patch.object(spmd_module, "make_spmd_matcher", recording):
            while True:
                rows, cols = spmd_match(store, q, capacity=cap)
                if overflow[-1] == 0:
                    break
                cap *= 2
                if cap > MAX_CAPACITY:
                    fail(f"matcher: the {name} overflows {MAX_CAPACITY} "
                         f"rows a site")
        torch.cuda.synchronize()
        t_spmd = time.perf_counter() - t0
        spmd_launches = _launch_delta(before)
        t0 = time.perf_counter()
        bind, valid, lcols = local_match(*cols_t, q, 4 * cap)
        local = bind[valid].cpu().numpy()
        t_local = time.perf_counter() - t0
        for what, got, c in (("spmd_match", rows, cols),
                             ("local_match", local, lcols)):
            got = _var_rows(got, c)
            if got.shape != rows_want.shape \
                    or not np.array_equal(got, rows_want):
                fail(f"matcher: {what} of the {name} gives {got.shape[0]} "
                     f"rows, the reference {rows_want.shape[0]}")
        print(f"matcher {name} ({card}): {rows_want.shape[0]} rows equal "
              f"the {'host match_pattern' if name == 'triangle' else 'session'}"
              f"'s from spmd_match at capacity {cap} over "
              f"{store.num_sites} sites ({t_spmd:.2f} s, launches "
              f"{spmd_launches}) and from local_match at {4 * cap} over one "
              f"site ({t_local:.2f} s)", flush=True)
        if name in ("cycle", "triangle"):
            missing = [k for k in ("pair_semijoin", "dedup_rows")
                       if k in JOIN_KERNELS and spmd_launches[k] <= 0]
            if missing:
                fail(f"matcher: the {name} never launched {missing}")
    launches = _launch_delta(start)
    print(f"launches on the matcher phase: {launches} (the triangle's "
          f"{triangle.edges}: host match_pattern {t_host:.1f} s)", flush=True)
    missing = [k for k in JOIN_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"matcher: kernels never launched: {missing}")
    return launches


LOST_SITE_COUNT = SITES - 1      # one site of the plan lost


def site_loss_phase(graph, plan, queries, results, session, card: str,
                    dev: str = "cuda") -> Dict[str, int]:
    """A site lost: ``replan_allocation`` re-clusters the vertical plan's
    fragment affinity onto ``LOST_SITE_COUNT`` sites (Algorithm 2,
    balanced), and an SPMD engine over the per-site edges of that
    allocation (``fragment_site_edge_ids``: its store is the one
    ``SiteStore.from_fragmentation`` builds, built once) serves the
    queries, every answer equal to the 4-site serve's (``results``) and
    every join kernel launched.  Prints the store seconds, qps,
    p50/p99, the ledger against the 4-site serve's and the resident
    rows per site.  Returns the serve's launches."""
    from repro_torch.core.allocation import fragment_affinity
    from repro_torch.core.spmd import SpmdEngine, fragment_site_edge_ids
    from repro_torch.distributed import replan_allocation
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    aff = fragment_affinity(plan.frag, plan.sel_usage, plan.weights)
    sizes = np.array([f.size for f in plan.frag.fragments], np.float64)
    site_of = replan_allocation(aff, LOST_SITE_COUNT, sizes)
    t_replan = time.perf_counter() - t0
    if sorted(set(site_of.tolist())) != list(range(LOST_SITE_COUNT)):
        fail(f"site loss: the re-allocation uses sites "
             f"{sorted(set(site_of.tolist()))}")
    t0 = time.perf_counter()
    eng = SpmdEngine(graph, fragment_site_edge_ids(
        plan.frag, site_of, LOST_SITE_COUNT), device=dev,
        max_capacity=MAX_CAPACITY)
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    ops.reset_launches()
    lat = []
    got = []
    t_serve = time.perf_counter()
    for q in queries:
        t = time.perf_counter()
        got.append(eng.execute(q))
        lat.append(time.perf_counter() - t)
    t_serve = time.perf_counter() - t_serve
    launches = {k: ops.LAUNCHES[k] for k in JOIN_KERNELS}
    for i, (a, b) in enumerate(zip(got, results)):
        ra, rb = answer_rows(a.bindings), answer_rows(b.bindings)
        if ra.shape != rb.shape or not np.array_equal(ra, rb):
            fail(f"site loss, query {i} {queries[i].edges}: {ra.shape[0]} "
                 f"rows on {LOST_SITE_COUNT} sites, {rb.shape[0]} on "
                 f"{SITES}")
    st, st4 = eng.stats(), session.stats()
    print(f"site loss ({card}): {SITES} -> {LOST_SITE_COUNT} sites, "
          f"replan_allocation {t_replan:.2f} s, store {t_store:.1f} s, "
          f"resident rows per site "
          f"{eng.store.prop_dev_rows.sum(1).tolist()} (on {SITES} sites "
          f"{session.engine.store.prop_dev_rows.sum(1).tolist()}); "
          f"{_pcts(lat)}; comm_bytes={st.comm_bytes} against "
          f"{sum(r.stats.comm_bytes for r in results)} on {SITES} sites; "
          f"capacity_retries={int(st.extra['capacity_retries'])} "
          f"({int(st4.extra['capacity_retries'])} on {SITES}); "
          f"{len(queries)} answer sets equal the {SITES}-site serve's; "
          f"launches {launches}", flush=True)
    missing = [k for k in JOIN_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"site loss: kernels never launched: {missing}")
    del eng
    torch.cuda.empty_cache()
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
# Strategies phase
# ----------------------------------------------------------------------

STRATEGY_KINDS = ("horizontal", "shape", "warp")
JOIN_KERNELS = ("join_count", "pair_semijoin", "dedup_rows", "fused_join")
HOST_TEMPLATES = 8       # template queries the host backends answer
# The baseline engine (as the reference's) answers a plan's
# fragmentation one edge at a time and joins the units in order of
# size: on the chain, hasGenre and makesReview, which share no
# variable, come first, a cross product of about 1.6e11 rows at this
# size.  It answers the other queries.
BASELINE_SKIPPED = ("chain",)


def strategy_plan(graph, design, kind: str, card: str):
    """``build_plan`` of ``kind`` at the smoke's size, with its seconds
    (split by offline step where the strategy records them; WARP's label
    propagation timed on its own), fragments, minterm fragments,
    redundancy ratio and resident rows per site."""
    from unittest import mock

    from repro_torch.core import PartitionConfig, baselines, build_plan
    lp = []
    propagate = baselines.label_propagation_partition

    def timed_propagation(*a, **kw):
        t0 = time.perf_counter()
        out = propagate(*a, **kw)
        lp.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    with mock.patch.object(baselines, "label_propagation_partition",
                           timed_propagation):
        plan = build_plan(graph, design,
                          PartitionConfig(kind=kind, num_sites=SITES))
    secs = time.perf_counter() - t0
    st = plan.stats
    split = (f" (mine {st.mine_sec:.1f} s, select {st.select_sec:.1f} s, "
             f"fragment {st.fragment_sec:.1f} s, allocate "
             f"{st.allocate_sec:.1f} s)" if st is not None else "")
    if lp:
        split += f" (label propagation {sum(lp):.1f} s)"
    frags = plan.frag.fragments if plan.frag is not None else []
    minterms = sum(1 for f in frags if f.minterm is not None
                   and f.minterm.terms)
    rows = [len(e) for e in plan.site_edge_ids()]
    print(f"plan {kind} ({card}): {secs:.1f} s{split}; {len(frags)} "
          f"fragments, {minterms} minterm fragments, redundancy "
          f"{plan.redundancy_ratio():.4f}, resident rows per site {rows}",
          flush=True)
    return plan


def strategy_serve(kind: str, plan, queries, want, card: str,
                   dev: str = "cuda"):
    """Serve ``queries`` on ``plan`` through ``Session(backend="spmd")``
    on the card between a reset and a read of the launch counters, print
    the ledger, hold every answer set against ``want`` (the vertical
    serve's) and against the same session on the plain versions, in
    which no kernel may launch.  Returns the launches of the serve and
    the session."""
    from unittest import mock

    from repro_torch.core import Session
    from repro_torch.core import spmd as spmd_module
    from repro_torch.kernels import ops, ref

    t0 = time.perf_counter()
    session = Session(plan, backend="spmd", device=dev,
                      spmd_max_capacity=MAX_CAPACITY)
    print(f"store {kind} ({card}): {time.perf_counter() - t0:.1f} s, rows "
          f"per site {session.engine.store.prop_dev_rows.sum(1).tolist()}",
          flush=True)
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
    lat_ms = np.asarray(lat) * 1e3
    print(f"serve {kind} ({card}): {len(queries)} queries in {t_serve:.2f} "
          f"s, qps={len(queries) / t_serve:.3f}, "
          f"p50_ms={np.percentile(lat_ms, 50):.2f}, "
          f"p99_ms={np.percentile(lat_ms, 99):.2f}, "
          f"comm_bytes={st.comm_bytes}, capacity_tiers_tried="
          f"{len(queries) + int(st.extra['capacity_retries'])}, "
          + ", ".join(f"{k}={int(st.extra[k])}" for k in (
              "capacity_retries", "gather_steps", "edge_shipped_steps",
              "edge_cache_hits", "skipped_gathers", "routed_queries",
              "compiled_shapes"))
          + f", result_rows={st.result_rows}", flush=True)
    print(f"launches on the {kind} serve: {launches}", flush=True)
    for i, (r, w) in enumerate(zip(results, want)):
        if not np.array_equal(answer_rows(r.bindings), w):
            fail(f"{kind} plan, query {i} {queries[i].edges}: "
                 f"{r.num_rows} rows, the vertical serve {w.shape[0]}")
    ops.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.multiple(spmd_module, join_range=ref.join_range_ref,
                             pair_semijoin_runs=ref.pair_semijoin_runs_ref,
                             dedup_rows_masked=ref.dedup_rows_masked_ref,
                             fused_join_sites=ref.fused_join_sites_ref):
        plain = [session.execute(q) for q in queries]
    t_plain = time.perf_counter() - t0
    if any(ops.LAUNCHES.values()):
        fail(f"kernels launched in the plain {kind} run: {ops.LAUNCHES}")
    for i, (r, w) in enumerate(zip(plain, want)):
        if not np.array_equal(answer_rows(r.bindings), w):
            fail(f"{kind} plan, query {i} {queries[i].edges}: {r.num_rows} "
                 f"rows on the plain versions, the vertical serve "
                 f"{w.shape[0]}")
    print(f"{kind}: {len(queries)} answer sets equal the vertical serve's "
          f"and the plain versions' ({t_plain:.2f} s on the plain "
          f"versions, {card})", flush=True)
    missing = [k for k in JOIN_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the {kind} serve: {missing}")
    return launches, results


def host_backends(plan, queries, results, card: str,
                  dev: str = "cuda") -> None:
    """The host engines on ``plan`` (``Session(backend="local")`` and
    ``"baseline"``, which compute in numpy on the host, as the
    reference's do): the first ``HOST_TEMPLATES`` template queries and
    the three shape queries (the baseline without
    ``BASELINE_SKIPPED``), answers equal to the spmd serve's."""
    from repro_torch.core import Session
    shapes = ("star", "chain", "cycle")
    for backend in ("local", "baseline"):
        idx = list(range(HOST_TEMPLATES)) + [
            SERVED + k for k, name in enumerate(shapes)
            if backend == "local" or name not in BASELINE_SKIPPED]
        t0 = time.perf_counter()
        session = Session(plan, backend=backend, device=dev)
        got = [session.execute(queries[i]) for i in idx]
        secs = time.perf_counter() - t0
        for i, r in zip(idx, got):
            if not np.array_equal(answer_rows(r.bindings),
                                  answer_rows(results[i].bindings)):
                fail(f"backend {backend}, query {i} {queries[i].edges}: "
                     f"{r.num_rows} rows, the spmd serve "
                     f"{results[i].num_rows}")
        st = session.stats()
        print(f"host backend {backend} on the {plan.strategy} plan "
              f"({card}; computes on the host in numpy): {len(idx)} "
              f"queries in "
              f"{secs:.2f} s, comm_bytes={st.comm_bytes}, simulated "
              f"response time {st.response_time:.6f} s, answers equal the "
              f"spmd serve's", flush=True)


# the strategies' WatDiv graph, cut from TRIPLES to keep the smoke
# inside its time limit (the horizontal, SHAPE and WARP plans took
# 31 / 3 / 48 s to build at TRIPLES, PERF.md)
STRATEGY_TRIPLES = 1_000_000


def strategies_phase(card: str, dev: str = "cuda"
                     ) -> Dict[str, Dict[str, int]]:
    """The horizontal, SHAPE and WARP plans of a STRATEGY_TRIPLES WatDiv
    graph (its design workload and served queries made as the main
    graph's), each served on the card with answers equal to the vertical
    plan's serve of the same graph and to the plain versions; the host
    backends on the horizontal plan.  Returns the launches of each serve
    by kind."""
    from repro_torch.core import (PartitionConfig, Session, build_plan,
                                  generate_watdiv, generate_workload)
    t0 = time.perf_counter()
    graph = generate_watdiv(STRATEGY_TRIPLES, seed=1)
    design = generate_workload(graph, DESIGN_QUERIES, seed=2)
    queries = served_queries(graph)
    vertical = build_plan(graph, design,
                          PartitionConfig(kind="vertical", num_sites=SITES))
    session = Session(vertical, backend="spmd", device=dev,
                      spmd_max_capacity=MAX_CAPACITY)
    want = [answer_rows(session.execute(q).bindings) for q in queries]
    print(f"strategies graph ({card}): {graph.num_edges} triples (cut from "
          f"{TRIPLES}), the vertical plan and its serve of "
          f"{len(queries)} queries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del session, vertical
    out = {}
    for kind in STRATEGY_KINDS:
        plan = strategy_plan(graph, design, kind, card)
        out[kind], served = strategy_serve(kind, plan, queries, want, card,
                                           dev)
        if kind == "horizontal":
            host_backends(plan, queries, served, card, dev)
        del plan, served
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# Ledger comparisons: the seeded SPMD benches of the JAX package
# ----------------------------------------------------------------------

LEDGER_TRIPLES, LEDGER_QUERIES, LEDGER_SEED = 8_000, 500, 5
LEDGER_SHAPE_SEED, LEDGER_PER_SHAPE = 9, 4
LEDGER_BUDGET, LEDGER_CAPACITY = 500_000, 16384
# the JAX package's totals (bytes) of its spmd_comm, spmd_replication and
# spmd_routing benches, on the CPU with 4 host devices
LEDGER_REFERENCE = {
    "spmd_comm": {"local": 19_352, "spmd_naive": 277_452,
                  "spmd_planned": 55_190},
    "spmd_replication": {"spmd_planned": 55_190, "spmd_replicated": 13_454},
    "spmd_routing": {"spmd_unrouted": 40_362, "spmd_routed": 13_454}}


def ledger_runs(core, benches=tuple(LEDGER_REFERENCE), **session_kw
                ) -> Dict[str, dict]:
    """The three ledger comparisons through ``core``'s ``Session`` (this
    port's ``repro_torch.core``, or any package with the same API):
    ``generate_watdiv(8_000, seed=5)``, 500 design queries (seed 6), 4
    sites, star/chain/cycle queries (seed 9, 4 of each), for each bench
    named in ``benches``.  Each bench's sessions answer shape by shape,
    in order.  Returns per bench the
    bytes each session shipped per shape, the answers that differ from
    ``match_pattern``, and each session's ``stats().extra``."""
    graph = core.generate_watdiv(LEDGER_TRIPLES, seed=LEDGER_SEED)
    design = core.generate_workload(graph, LEDGER_QUERIES,
                                    seed=LEDGER_SEED + 1)
    plan = core.build_plan(graph, design, core.PartitionConfig(
        kind="vertical", num_sites=SITES))
    replicated = core.build_plan(graph, design, core.PartitionConfig(
        kind="vertical", num_sites=SITES,
        replication_budget_bytes=LEDGER_BUDGET))

    def session(p, **kw):
        return core.Session(p, **kw, **session_kw)

    make = {
        "spmd_comm": lambda: {
            "local": session(plan, backend="local"),
            "spmd_naive": session(plan, backend="spmd",
                                  spmd_comm_plan=False),
            "spmd_planned": session(plan, backend="spmd")},
        "spmd_replication": lambda: {
            "spmd_planned": session(plan, backend="spmd",
                                    spmd_capacity=LEDGER_CAPACITY),
            "spmd_replicated": session(replicated, backend="spmd",
                                       spmd_capacity=LEDGER_CAPACITY)},
        "spmd_routing": lambda: {
            "spmd_unrouted": session(replicated, backend="spmd",
                                     spmd_capacity=LEDGER_CAPACITY,
                                     spmd_routing=False),
            "spmd_routed": session(replicated, backend="spmd",
                                   spmd_capacity=LEDGER_CAPACITY)}}
    rng = np.random.default_rng(LEDGER_SHAPE_SEED)
    props = np.asarray(graph.p)
    shapes: Dict[str, list] = {"star": [], "chain": [], "cycle": []}
    for _ in range(LEDGER_PER_SHAPE):
        for name, q in core.make_shape_queries(
                lambda: int(props[rng.integers(0, len(props))])).items():
            shapes[name].append(q)
    matching = importlib.import_module(core.__name__ + ".matching")
    want = {name: [matching.match_pattern(graph, q).num_rows for q in qs]
            for name, qs in shapes.items()}
    out = {}
    for bench in benches:
        sessions = make[bench]()
        per_shape: Dict[str, Dict[str, int]] = {}
        mismatches = 0
        for shape, qs in shapes.items():
            per_shape[shape] = {}
            for name, sess in sessions.items():
                before = sess.stats().comm_bytes
                rows = [sess.execute(q).num_rows for q in qs]
                per_shape[shape][name] = sess.stats().comm_bytes - before
                mismatches += sum(a != b for a, b in zip(rows, want[shape]))
        out[bench] = {"per_shape": per_shape, "mismatches": mismatches,
                      "extra": {n: dict(s.stats().extra)
                                for n, s in sessions.items()}}
    return out


def ledger_failures(runs: Dict[str, dict]) -> List[str]:
    """What ``ledger_runs`` output breaks: a mismatch, planned above
    naive, replicated above planned on a shape or below it on none,
    routed above unrouted on a shape or below it on none, a total unlike
    the JAX package's (printed per shape), or a capacity retry in
    ``spmd_comm`` (the JAX run has none)."""
    bad = []
    for bench, r in runs.items():
        if r["mismatches"]:
            bad.append(f"{bench}: {r['mismatches']} answers differ from "
                       f"match_pattern")
        totals = {n: sum(v[n] for v in r["per_shape"].values())
                  for n in LEDGER_REFERENCE[bench]}
        if totals != LEDGER_REFERENCE[bench]:
            bad.append(f"{bench}: totals {totals}, the JAX package's "
                       f"{LEDGER_REFERENCE[bench]}; per shape "
                       f"{r['per_shape']}")
    if "spmd_comm" in runs:
        comm = runs["spmd_comm"]["per_shape"].values()
        if sum(v["spmd_planned"] for v in comm) > sum(v["spmd_naive"]
                                                      for v in comm):
            bad.append("spmd_comm: planned above naive")
        if runs["spmd_comm"]["extra"]["spmd_planned"]["capacity_retries"]:
            bad.append("spmd_comm: capacity retries on the planned session")
    for bench, low, high in (("spmd_replication", "spmd_replicated",
                              "spmd_planned"),
                             ("spmd_routing", "spmd_routed",
                              "spmd_unrouted")):
        if bench not in runs:
            continue
        per = runs[bench]["per_shape"].values()
        if not all(v[low] <= v[high] for v in per):
            bad.append(f"{bench}: {low} above {high} on a shape")
        if not any(v[low] < v[high] for v in per):
            bad.append(f"{bench}: {low} below {high} on no shape")
    return bad


def ledger_phase(card: str) -> None:
    """The seeded ledger comparisons on the card, held to their
    properties and to the JAX package's totals."""
    import repro_torch.core as core
    t0 = time.perf_counter()
    runs = ledger_runs(core, device="cuda")
    secs = time.perf_counter() - t0
    for bench, r in runs.items():
        totals = {n: sum(v[n] for v in r["per_shape"].values())
                  for n in LEDGER_REFERENCE[bench]}
        print(f"ledger {bench} ({card}): "
              + ", ".join(f"{n} {totals[n]} (JAX CPU {want})"
                          for n, want in LEDGER_REFERENCE[bench].items())
              + f", mismatches {r['mismatches']}", flush=True)
    st = runs["spmd_comm"]["extra"]["spmd_planned"]
    print("ledger spmd_comm planned: " + ", ".join(
        f"{k}={int(st[k])}" for k in ("gather_steps", "edge_shipped_steps",
                                      "skipped_gathers", "capacity_retries",
                                      "devices"))
          + f"; the three benches in {secs:.1f} s ({card})", flush=True)
    bad = ledger_failures(runs)
    if bad:
        fail("ledger: " + "; ".join(bad))


# ----------------------------------------------------------------------
# The JAX package's seeded online benches (benchmarks/adaptive.py,
# benchmarks/lifecycle.py) at their own size
# ----------------------------------------------------------------------

ONLINE_BUDGET = 4_000_000           # bench_adaptive's migration budget
# the JAX package's values of both benches, on the CPU with 4 host
# devices (bench_lifecycle's comm_bytes: the SPMD ledger of its stream)
ONLINE_REFERENCE = {
    "adaptive": {"static_comm_bytes": 1_810_048,
                 "static_after_drift": 1_502_860,
                 "adaptive_comm_bytes": 946_336,
                 "adaptive_after_drift": 639_148,
                 "repartitions": 3, "moved_bytes": 289_872,
                 "wins_after_drift": 1, "stationary_repartitions": 0},
    "lifecycle": {"queries": 400, "errors": 0, "repartitions": 1,
                  "store_swaps": 1, "comm_bytes": 5_249_355,
                  "shipped_bytes": 4_344, "whole_fragment_bytes": 74_712,
                  "unassigned": 0}}


def online_bench_runs(core, online, **device_kw) -> Dict[str, dict]:
    """``bench_adaptive`` and ``bench_lifecycle`` through ``core``'s
    ``Session`` and ``online``'s ``AdaptiveEngine`` / ``ingest_delta``
    (this port's packages, or any with the same API; ``device_kw`` goes
    to every engine).  ``bench_adaptive``: ``generate_watdiv(20_000,
    seed=5)``, 8 sites, a 1,000-query uniform design workload, a
    uniform -> star-heavy -> chain-heavy stream of 1,700 queries through
    a static and an adaptive session (local data plane, epochs of 150,
    a 4,000,000-byte budget), then a stationary stream of 900.
    ``bench_lifecycle``: ``generate_watdiv(5_000, seed=3)``, 4 sites,
    400 queries through an ``AdaptiveEngine`` on the SPMD data plane
    (epochs of 100, a 2,000,000-byte budget), then a seeded delta of
    200 added and 100 removed triples through ``ingest_delta``.
    Returns both benches' numbers under ``ONLINE_REFERENCE``'s keys."""
    g = core.generate_watdiv(20_000, seed=5)
    cfg = core.PartitionConfig(kind="vertical", num_sites=8)
    drift_point = 300
    plan = core.build_plan(
        g, core.generate_drifting_workload(g, [(1_000, {})], seed=11), cfg)
    stream = core.generate_drifting_workload(
        g, [(drift_point, {}), (700, {"S": 12.0}), (700, {"L": 12.0})],
        seed=23).queries

    def adaptive_engine(p):
        return core.Session(p, backend="adaptive", **device_kw,
                            adaptive_config=online.AdaptiveConfig(
                                epoch_len=150,
                                migration_budget_bytes=ONLINE_BUDGET)
                            ).engine

    def replay(engine, queries):
        return [r.stats.comm_bytes for r in engine.execute_many(queries)]

    static = replay(core.Session(plan, backend="local", **device_kw),
                    stream)
    eng = adaptive_engine(plan)
    adaptive = replay(eng, stream)
    control = adaptive_engine(plan)
    replay(control, core.generate_drifting_workload(
        g, [(900, {})], seed=31).queries)
    out = {"adaptive": {
        "static_comm_bytes": int(np.sum(static)),
        "static_after_drift": int(np.sum(static[drift_point:])),
        "adaptive_comm_bytes": int(np.sum(adaptive)),
        "adaptive_after_drift": int(np.sum(adaptive[drift_point:])),
        "repartitions": eng.num_repartitions,
        "moved_bytes": int(eng.total_moved_bytes),
        "wins_after_drift": int(np.sum(adaptive[drift_point:])
                                < np.sum(static[drift_point:])),
        "stationary_repartitions": control.num_repartitions}}

    g = core.generate_watdiv(5_000, seed=3)
    plan = core.build_plan(
        g, core.generate_drifting_workload(g, [(400, {})], seed=11),
        core.PartitionConfig(kind="vertical", num_sites=4))
    eng = online.AdaptiveEngine(plan, online.AdaptiveConfig(
        epoch_len=100, serve_backend="spmd",
        migration_budget_bytes=2_000_000), **device_kw)
    stream = core.generate_drifting_workload(
        g, [(100, {}), (300, {"S": 12.0})], seed=23).queries
    errors = 0
    for q in stream:
        try:
            eng.execute(q)
        except Exception:  # noqa: BLE001 -- the bench counts failures
            errors += 1
    rng = np.random.default_rng(7)
    n_add, n_rem = 200, 100
    add = np.stack([rng.integers(0, g.num_vertices, n_add),
                    rng.integers(0, g.num_properties, n_add),
                    rng.integers(0, g.num_vertices, n_add)], axis=1)
    rem_idx = rng.choice(g.num_edges, n_rem, replace=False)
    rem = np.stack([g.s[rem_idx], g.p[rem_idx], g.o[rem_idx]], axis=1)
    dp = online.ingest_delta(
        plan, g.apply_delta(added_edges=add, removed_edges=rem),
        budget_bytes=10**7)
    out["lifecycle"] = {
        "queries": len(stream), "errors": errors,
        "repartitions": eng.num_repartitions,
        "store_swaps": eng.engine.store_generation,
        "comm_bytes": int(eng.engine.stats().comm_bytes),
        "shipped_bytes": int(dp.shipped_bytes),
        "whole_fragment_bytes": int(dp.whole_bytes),
        "unassigned": int(dp.unassigned)}
    return out


# ----------------------------------------------------------------------
# Adaptive phase: the online loop on the smoke's plan
# ----------------------------------------------------------------------

ADAPTIVE_EPOCH = 100
# The stream drifts to linear (chain) templates: its re-partition moves
# fragments between sites (14,950,092 bytes, 5,217,252 of them
# mandatory, on this graph), so the swap changes what the sites hold.
# A star-heavy drift's optional moves have affinity gains of 0 or less,
# which the planner never moves at any budget.  The budget leaves room
# for the optional moves after the mandatory materialization.
ADAPTIVE_BUDGET = 48_000_000
ADAPTIVE_PHASES = [(200, {}), (400, {"L": 12.0})]   # uniform, linear-heavy
ADAPTIVE_SEED = 23
TRACE_EVERY = 10                 # every 10th query of the stream traced
DELTA_ADD, DELTA_REMOVE, DELTA_SEED = 20_000, 10_000, 7


def adaptive_stream(graph) -> list:
    """``generate_drifting_workload`` of ``ADAPTIVE_PHASES``, every
    template query bound to a data constant, without the templates
    ``served_queries`` leaves out."""
    from repro_torch.core import generate_drifting_workload
    wl = generate_drifting_workload(graph, ADAPTIVE_PHASES,
                                    seed=ADAPTIVE_SEED, constant_fraction=1.0)
    return [q for q, t in zip(wl.queries, wl.template_ids)
            if t not in UNSERVED_TEMPLATES]


class StepTimer:
    """Seconds per named step, summed over calls of wrapped functions."""

    def __init__(self):
        self.secs: Dict[str, float] = {}

    def wrap(self, step: str, fn: Callable) -> Callable:
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.secs[step] = (self.secs.get(step, 0.0)
                                   + time.perf_counter() - t0)
        return timed

    def take(self) -> Dict[str, float]:
        out, self.secs = self.secs, {}
        return out


def _pcts(lat: List[float]) -> str:
    if not lat:
        return "no queries"
    ms = np.asarray(lat) * 1e3
    return (f"{len(lat)} queries in {sum(lat):.2f} s, qps="
            f"{len(lat) / sum(lat):.3f}, p50_ms={np.percentile(ms, 50):.2f}, "
            f"p99_ms={np.percentile(ms, 99):.2f}")


def _plain_answers(engine, queries) -> list:
    """Answer rows of ``queries`` on ``engine`` with the match loop's
    kernel wrappers replaced by their plain versions; no kernel may
    launch meanwhile."""
    from unittest import mock

    from repro_torch.core import spmd as spmd_module
    from repro_torch.kernels import ops, ref
    before = dict(ops.LAUNCHES)
    with mock.patch.multiple(spmd_module, join_range=ref.join_range_ref,
                             pair_semijoin_runs=ref.pair_semijoin_runs_ref,
                             dedup_rows_masked=ref.dedup_rows_masked_ref,
                             fused_join_sites=ref.fused_join_sites_ref):
        out = [answer_rows(engine.execute(q).bindings) for q in queries]
    if dict(ops.LAUNCHES) != before:
        fail(f"kernels launched in a plain run: {before} -> {ops.LAUNCHES}")
    return out


def adaptive_serve(graph, plan, card: str, dev: str = "cuda"):
    """Part 1: the drifting stream through ``Session(plan,
    backend="adaptive")`` on the SPMD data plane.  Prints a line per
    epoch and the serve before and after the first swap; holds every
    answer to a static session of ``plan`` on the plain versions, the
    budget, the realized plans, the engine's identity across swaps, the
    kernels' launches on both store generations and the trace<->ledger
    delta of every ``TRACE_EVERY``-th query.  Returns the adaptive
    engine and the stream's launches."""
    from repro_torch.core import Session
    from repro_torch.core import plan as plan_module
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import Tracer
    from repro_torch.online import AdaptiveConfig
    from repro_torch.online import loop as loop_module
    # the package exports the function ``refragment`` under the
    # module's name
    refrag_module = importlib.import_module("repro_torch.online.refragment")

    queries = adaptive_stream(graph)
    # WatDiv's templates close no cycle, so the stream alone never runs
    # the cycle-close kernels (pair_semijoin, dedup_rows): the star,
    # chain and cycle of served_queries run on the data plane itself
    # (outside the monitored stream) before it and after it
    shapes = served_queries(graph)[SERVED:]
    t0 = time.perf_counter()
    session = Session(plan, backend="adaptive", device=dev,
                      adaptive_config=AdaptiveConfig(
                          epoch_len=ADAPTIVE_EPOCH, serve_backend="spmd",
                          migration_budget_bytes=ADAPTIVE_BUDGET))
    eng = session.engine
    spmd = eng.engine
    spmd.max_capacity = MAX_CAPACITY
    print(f"adaptive ({card}): engine in {time.perf_counter() - t0:.1f} s; "
          f"stream of {len(queries)} queries (phases {ADAPTIVE_PHASES}, "
          f"seed {ADAPTIVE_SEED}, epochs of {ADAPTIVE_EPOCH}, budget "
          f"{ADAPTIVE_BUDGET} bytes)", flush=True)

    timer = StepTimer()
    reparts: Dict[int, dict] = {}
    swaps: List[dict] = []
    results: Dict[str, object] = {}
    refragment = loop_module.refragment
    repartition = eng._repartition
    swap_store = spmd.swap_store
    dictionary = loop_module.DataDictionary

    def timed_refragment(*a, **kw):
        results["res"] = refragment(*a, **kw)
        return results["res"]

    def checked_repartition():
        timer.take()
        mig = repartition()
        res = results.pop("res")
        split = timer.take()
        split["fragment"] = split.get("fragment", 0.0)
        split["other"] = res.elapsed_sec - sum(
            v for k, v in split.items() if k != "dictionary")
        if not eng.alloc.is_partition(len(eng.frag.fragments)):
            fail(f"epoch {eng.epoch}: the realized allocation is not a "
                 f"partition")
        if not eng.frag.coverage_ok(graph):
            fail(f"epoch {eng.epoch}: the new fragmentation does not "
                 f"cover the graph")
        reparts[eng.epoch] = {
            "secs": res.elapsed_sec, "split": split, "mig": mig,
            "fragments": len(res.frag.fragments),
            "kept": res.num_incumbents_kept,
            "deferred_bytes": sum(m.nbytes for m in mig.deferred),
            "mandatory_bytes": sum(m.nbytes for m in mig.applied
                                   if m.mandatory)}
        return mig

    def timed_swap(*a, **kw):
        before = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated()
        t = time.perf_counter()
        gen = swap_store(*a, **kw)
        torch.cuda.synchronize()
        swaps.append({"s": time.perf_counter() - t, "launches": before,
                      "gen": gen, "mem": mem,
                      "rows": spmd.store.prop_dev_rows.sum(1).tolist()})
        return gen

    tracer = Tracer(enabled=False, capacity=64)
    eng.set_tracer(tracer)
    eng._repartition = checked_repartition
    spmd.swap_store = timed_swap
    hooks = {"vertical": timer.wrap(
        "fragment", plan_module.STRATEGIES.get_refragment("vertical"))}
    patches = [(loop_module, "refragment", timed_refragment),
               (loop_module, "DataDictionary", type(
                   "TimedDictionary", (), {"build": staticmethod(
                       timer.wrap("dictionary", dictionary.build))})),
               (refrag_module, "warm_mine",
                timer.wrap("mine", refrag_module.warm_mine))]
    patches += [(refrag_module, name,
                 timer.wrap("select", getattr(refrag_module, name)))
                for name in ("usage_matrix", "match_edge_ids",
                             "select_patterns")]
    patches += [(refrag_module, name,
                 timer.wrap("allocate", getattr(refrag_module, name)))
                for name in ("allocate_fragments", "plan_replication")]
    from unittest import mock
    lat = {"before": [], "after": [], "swapping": []}
    answers = []
    traced = {0: 0, 1: 0}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()

    def run_shapes() -> list:
        res = data_plane_shapes(spmd, shapes)
        shape_digests.extend(answer_digest(r) for r in res)
        return [answer_rows(r.bindings) for r in res]

    shape_digests: List[str] = []
    digests, comm = [], []
    shape_answers = run_shapes()
    rows_before = spmd.store.prop_dev_rows.sum(1).tolist()
    t_stream = time.perf_counter()
    with mock.patch.dict(plan_module.STRATEGIES._refragmenters, hooks):
        with contextlib.ExitStack() as stack:
            for mod, name, fn in patches:
                stack.enter_context(mock.patch.object(mod, name, fn))
            for i, q in enumerate(queries):
                gen = spmd.store_generation
                trace = i % TRACE_EVERY == 0
                if trace:
                    before = spmd.stats()
                    tracer.enabled = True
                t = time.perf_counter()
                r = eng.execute(q)
                secs = time.perf_counter() - t
                tracer.enabled = False
                answers.append(answer_rows(r.bindings))
                digests.append(answer_digest(r))
                comm.append(int(r.stats.comm_bytes))
                if trace:
                    _reconcile(tracer.store.spans()[-1:], spmd,
                               before.comm_bytes, before.extra,
                               f"adaptive stream, query {i}")
                    traced[min(gen, 1)] += 1
                lat["swapping" if spmd.store_generation != gen
                    else "after" if gen else "before"].append(secs)
    t_stream = time.perf_counter() - t_stream
    shape_answers += run_shapes()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    eng._repartition = repartition
    spmd.swap_store = swap_store
    # what the distributed phase's adaptive stream is held to
    record = {"stream": [[(e.src, e.dst, e.prop) for e in q.edges]
                         for q in queries],
              "digests": digests, "per_query": comm,
              "shape_digests": shape_digests,
              "epochs": epoch_dicts(eng), "placement":
                  placement_digest(eng.plan),
              "extra": dict(eng.stats().extra),
              "inner_extra": dict(spmd.stats().extra),
              "qps": {k: len(v) / sum(v) if v else 0.0
                      for k, v in lat.items()},
              "refragment_s": [rp["secs"] for rp in reparts.values()],
              "swap_s": [sw["s"] for sw in swaps]}

    for ep in eng.epochs:
        d = ep.drift
        line = (f"epoch {ep.epoch} ({card}): {ep.queries} queries, "
                f"comm_bytes={ep.comm_bytes}, ")
        line += ("drift not checked (cooldown)" if d is None else
                 f"drift tv={d.tv_distance:.4f} coverage_loss="
                 f"{d.ref_coverage - d.coverage:.4f} fired={d.fired}"
                 + (f" ({d.reason})" if d.reason else ""))
        rp = reparts.get(ep.epoch)
        if rp is not None:
            sw = swaps[len([e for e in reparts if e <= ep.epoch]) - 1]
            line += (f"; moved_bytes={ep.moved_bytes} (mandatory "
                     f"{rp['mandatory_bytes']}) deferred_bytes="
                     f"{rp['deferred_bytes']} ({ep.deferred_moves} moves, "
                     f"affinity gains "
                     f"{[round(m.gain, 3) for m in rp['mig'].deferred]}) "
                     f"makespan={ep.migration_makespan_sec:.6f} s; "
                     f"refragment {rp['secs']:.1f} s ("
                     + ", ".join(f"{k} {v:.1f} s" for k, v in
                                 sorted(rp["split"].items()))
                     + f"), {rp['fragments']} fragments, {rp['kept']} "
                     f"incumbents kept; swap_store {sw['s']:.1f} s, store "
                     f"generation {sw['gen']}, resident rows per site "
                     f"{sw['rows']}")
        print(line, flush=True)
    print(f"adaptive serve ({card}): {len(queries)} queries in "
          f"{t_stream:.1f} s; before the swap {_pcts(lat['before'])}; "
          f"after {_pcts(lat['after'])}; {len(lat['swapping'])} queries "
          f"closed an epoch with a re-partition "
          f"({sum(lat['swapping']):.1f} s)", flush=True)
    if not swaps:
        fail("adaptive: drift never fired a re-partition")
    print(f"adaptive residency ({card}): resident rows per site before "
          f"the stream {rows_before}, after each swap "
          f"{[sw['rows'] for sw in swaps]}", flush=True)
    if all(sw["rows"] == rows_before for sw in swaps):
        fail(f"adaptive: no swap changed the resident rows per site "
             f"({rows_before})")
    first = swaps[0]["launches"]
    after = {k: launches[k] - first[k] for k in launches}
    print(f"launches on the adaptive stream and the shape queries before "
          f"and after it: before the first swap "
          f"{first}, after it {after}; max_memory_allocated={peak} bytes "
          f"({card})", flush=True)

    # the checks
    fired = sum(1 for ep in eng.epochs if ep.drift and ep.drift.fired)
    if fired < 1 or eng.num_repartitions < 1:
        fail(f"adaptive: drift fired {fired} times, "
             f"{eng.num_repartitions} re-partitions")
    # the budget bounds what an epoch ships beyond its mandatory
    # materializations (fragments of newly selected patterns, which the
    # planner ships whatever the budget: deferring them would strand
    # them, online/migration.py); an epoch over the budget is printed
    over = [ep.epoch for ep in eng.epochs if ep.moved_bytes
            - reparts.get(ep.epoch, {}).get("mandatory_bytes", 0)
            > max(ADAPTIVE_BUDGET
                  - reparts.get(ep.epoch, {}).get("mandatory_bytes", 0), 0)]
    if over:
        fail(f"adaptive: epochs {over} moved optional bytes past the "
             f"{ADAPTIVE_BUDGET}-byte budget")
    print("adaptive budget: " + "; ".join(
        f"epoch {e}: moved {eng.epochs[e].moved_bytes} bytes, mandatory "
        f"{rp['mandatory_bytes']}, "
        + ("within" if eng.epochs[e].moved_bytes <= ADAPTIVE_BUDGET
           else "over") + f" the {ADAPTIVE_BUDGET}-byte budget"
        for e, rp in sorted(reparts.items())), flush=True)
    st = spmd.stats()
    if eng.engine is not spmd or int(st.extra["store_swaps"]) != \
            spmd.store_generation or spmd.store_generation != \
            eng.num_repartitions:
        fail(f"adaptive: engine swapped or counts differ (store_swaps "
             f"{st.extra['store_swaps']}, generation "
             f"{spmd.store_generation}, re-partitions "
             f"{eng.num_repartitions})")
    for name, counts in (("before", first), ("after", after)):
        missing = [k for k in JOIN_KERNELS if counts[k] <= 0]
        if missing:
            fail(f"adaptive: kernels never launched {name} the swap: "
                 f"{missing}")
    if min(traced.values()) < 1:
        fail(f"adaptive: traced queries per store generation {traced}")
    print(f"trace<->ledger on the adaptive stream ({card}): delta 0 on "
          f"{traced[0]} traced queries of generation 0 and {traced[1]} of "
          f"later generations", flush=True)

    static = Session(plan, backend="spmd", device=dev,
                     spmd_max_capacity=MAX_CAPACITY)
    t0 = time.perf_counter()
    checked = queries + shapes + shapes
    want = _plain_answers(static.engine, queries + shapes)
    for i, (a, b) in enumerate(zip(answers + shape_answers,
                                   want + want[len(queries):])):
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"adaptive stream, query {i} {checked[i].edges}: "
                 f"{a.shape[0]} rows, {b.shape[0]} on a static session "
                 f"on the plain versions")
    print(f"adaptive: {len(checked)} answer sets (the stream, the shape "
          f"queries before and after it) equal a static session "
          f"of the original plan on the plain versions "
          f"({time.perf_counter() - t0:.1f} s, {card})", flush=True)
    del static
    torch.cuda.empty_cache()
    return eng, launches, record


def data_plane_shapes(spmd, shapes) -> list:
    """``shapes`` answered on an adaptive engine's SPMD data plane, with
    the monitor's hook off meanwhile: the stream it sees is the drifting
    workload alone."""
    hooks = list(spmd.post_execute_hooks)
    spmd.post_execute_hooks.clear()
    try:
        return [spmd.execute(q) for q in shapes]
    finally:
        spmd.post_execute_hooks.extend(hooks)


def epoch_dicts(eng) -> List[dict]:
    """An adaptive engine's epoch reports without the response time,
    which the SPMD data plane measures."""
    return [{k: v for k, v in dataclasses.asdict(ep).items()
             if k != "response_time"} for ep in eng.epochs]


def placement_digest(plan) -> str:
    """SHA-256 of a plan's ``site_edge_ids``."""
    import hashlib
    h = hashlib.sha256()
    for ids in plan.site_edge_ids():
        h.update(np.int64(len(ids)).tobytes())
        h.update(np.ascontiguousarray(ids, np.int64).tobytes())
    return h.hexdigest()


def repository_phase(plan, eng, card: str) -> None:
    """Part 3: the original and the adapted plan (with the monitor's
    state) through a ``PlanRepository`` at full size, under the
    checkout's ``build/``."""
    import shutil

    from repro_torch.online import PlanRepository
    root = ROOT / "build" / "plan_repository"
    shutil.rmtree(root, ignore_errors=True)
    repo = PlanRepository(root)
    t0 = time.perf_counter()
    v0 = repo.publish(plan, reason="vertical build")
    v1 = repo.publish(eng.plan, monitor=eng.monitor,
                      reason=f"{eng.num_repartitions} re-partitions")
    t_save = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())
    t0 = time.perf_counter()
    latest = repo.load_latest(eng.graph)
    t_load = time.perf_counter() - t0
    mon = repo.load_monitor(v1)
    prov = repo.provenance(v1)
    if latest != eng.plan or prov["parent"] != v0 or repo.versions() != \
            [v0, v1]:
        fail(f"plan repository: the latest version differs from the "
             f"adapted plan or provenance does not chain ({prov})")
    if not np.array_equal(mon.snapshot()[1], eng.monitor.snapshot()[1]):
        fail("plan repository: the monitor did not resume")
    print(f"plan repository ({card}): versions {repo.versions()} saved in "
          f"{t_save:.1f} s, {nbytes} bytes on disk; the latest loaded in "
          f"{t_load:.1f} s, equal to the adapted plan; provenance "
          f"{v1} <- {prov['parent']}; monitor resumed", flush=True)
    shutil.rmtree(root, ignore_errors=True)


def delta_phase(graph, eng, card: str, dev: str = "cuda") -> Dict[str, int]:
    """Part 4: a seeded delta of ``DELTA_ADD`` added and
    ``DELTA_REMOVE`` removed triples through ``ingest_delta`` on the
    adapted plan, hot-swapped into the same SPMD engine with the new
    graph; the served queries on it against the plain versions on the
    same engine and, for some, ``match_pattern`` on the new graph.
    Returns the launches of the serve."""
    from repro_torch.core import match_pattern
    from repro_torch.kernels import ops
    from repro_torch.online import ingest_delta
    rng = np.random.default_rng(DELTA_SEED)
    add = np.stack([rng.integers(0, graph.num_vertices, DELTA_ADD),
                    rng.integers(0, graph.num_properties, DELTA_ADD),
                    rng.integers(0, graph.num_vertices, DELTA_ADD)], 1)
    rem_idx = rng.choice(graph.num_edges, DELTA_REMOVE, replace=False)
    rem = np.stack([graph.s[rem_idx], graph.p[rem_idx], graph.o[rem_idx]], 1)
    t0 = time.perf_counter()
    g2 = graph.apply_delta(added_edges=add, removed_edges=rem)
    t_apply = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = ingest_delta(eng.plan, g2, budget_bytes=ADAPTIVE_BUDGET)
    t_ingest = time.perf_counter() - t0
    spmd = eng.engine
    t_swap = host_s(lambda: spmd.swap_store(
        dp.plan.site_edge_ids(), replicated_props=set(
            dp.plan.replicated_props), graph=g2))
    print(f"graph delta ({card}): {g2.num_edges} triples after "
          f"+{dp.added_edges} / -{dp.removed_edges} ({t_apply:.1f} s); "
          f"ingest_delta {t_ingest:.1f} s, {len(dp.deltas)} fragments "
          f"touched, shipped {dp.shipped_bytes} bytes against "
          f"{dp.whole_bytes} whole-fragment bytes (ratio "
          f"{dp.shipped_bytes / max(dp.whole_bytes, 1):.4f}), unassigned "
          f"{dp.unassigned}, within budget {dp.within_budget()}; swap_store "
          f"{t_swap:.1f} s, store generation {spmd.store_generation}",
          flush=True)
    if dp.unassigned or dp.shipped_bytes >= dp.whole_bytes \
            or not dp.plan.frag.coverage_ok(g2):
        fail("graph delta: unassigned edges, no saving over whole "
             "fragments, or the new graph not covered")
    queries = served_queries(graph)
    ops.reset_launches()
    got = [answer_rows(spmd.execute(q).bindings) for q in queries]
    launches = dict(ops.LAUNCHES)
    want = _plain_answers(spmd, queries)
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"graph delta, query {i}: {a.shape[0]} rows on the "
                 f"kernels, {b.shape[0]} on the plain versions")
    checked = list(range(HOST_CHECKED)) + list(range(SERVED, len(queries)))
    for i in checked:
        m = match_pattern(g2, queries[i], max_rows=1 << 40)
        if not np.array_equal(answer_rows(m.columns), got[i]):
            fail(f"graph delta, query {i}: answer set differs from "
                 f"match_pattern on the new graph")
    print(f"graph delta: {len(queries)} served queries equal the plain "
          f"versions, {len(checked)} equal match_pattern on the new graph; "
          f"launches {launches} ({card})", flush=True)
    missing = [k for k in JOIN_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"graph delta: kernels never launched: {missing}")
    return launches


def online_phase(card: str, dev: str = "cuda") -> None:
    """Part 2: the JAX package's online benches at their own size, held
    to its values."""
    import repro_torch.core as core
    import repro_torch.online as online
    t0 = time.perf_counter()
    runs = online_bench_runs(core, online, device=dev)
    secs = time.perf_counter() - t0
    for bench, got in runs.items():
        print(f"online bench {bench} ({card}): "
              + ", ".join(f"{k} {v} (JAX CPU {ONLINE_REFERENCE[bench][k]})"
                          for k, v in got.items()), flush=True)
    print(f"online benches in {secs:.1f} s ({card})", flush=True)
    if runs != ONLINE_REFERENCE:
        fail(f"online benches differ from the JAX package's: {runs}")


def adaptive_phase(graph, plan, card: str, dev: str = "cuda"):
    """The online adaptive loop on the smoke's vertical plan (parts 1,
    3 and 4) and the JAX package's online benches (part 2).  Returns
    the launches of the adaptive stream and the stream's record for the
    distributed phase."""
    t0 = time.perf_counter()
    eng, launches, record = adaptive_serve(graph, plan, card, dev)
    online_phase(card, dev)
    repository_phase(plan, eng, card)
    delta_phase(graph, eng, card, dev)
    print(f"adaptive phase: {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return launches, record


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
    for case in ATTN_CASES + ATTN_MODEL_CASES + ATTN_EXTRA:
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
    # the raw kineto events: parsing them into ``prof.events()`` takes
    # about 20 s for the 280,000 events of a forward of small operations
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name.setdefault(e.name(), []).append(e.duration_ns() / 1e3)
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
        cfg, SERVE_BATCH, SERVE_PROMPT, 0)).to(dev)
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


# ----------------------------------------------------------------------
# MoE phase and the arch sweep
# ----------------------------------------------------------------------

# qwen2-moe-a2.7b at its published width and depth (24 layers, 60 routed
# experts top-4 and 4 shared, bf16, seeded weights): the forward at 2 x
# 4096 (cut from prefill_32k's 32 x 32768), serve() of 4 x (128 + 32)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_BATCH, MOE_SEQ = 2, 4096


def ample(cfg):
    """``cfg`` at a capacity no expert can fill: factor num_experts /
    top_k makes C at least the group's token count, so the dispatches
    must agree and a forward drops what decode keeps: nothing.  (The
    reference's MoE tests use 8.0, which is ample at their sizes; with
    random weights one of qwen2-moe's 60 experts took 5,437 of 8,192
    tokens, past 8.0's C = 4,376.)"""
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.num_experts / cfg.top_k)


# Routing replay.  Two runs that compute a router's input in another
# order (flash against plain attention, a forward against decode steps)
# can send a token whose K-th and (K+1)-th router probabilities nearly
# tie to other experts.  With random weights the router ties often, and
# a capacity cut hands one token's change on to every later token of
# its experts, so past the first layers the two runs would compare two
# routings (PERF.md, PR 22).  The second run therefore replays the
# first's expert choices, weighted by its own router probabilities;
# every position's logits are held to LOGIT_TOL, and every token-layer
# whose own choice would have differed must be a near-tie there: a
# margin p_K - p_K+1 under ROUTING_TIE.
ROUTING_TIE = 2.0 ** -10
# the other published archs at full width with 2 layers: sequence of
# the flash forward (mixtral's 4096-key window masks at 8192)
SWEEP_ARCHS = {"mixtral-8x7b": 8192, "qwen2.5-3b": 4096,
               "nemotron-4-15b": 4096, "musicgen-medium": 4096,
               "pixtral-12b": 4096, "llama3-405b": 4096}
SWEEP_LAYERS = 2
SWEEP_BATCH, SWEEP_PROMPT, SWEEP_GEN = 4, 16, 8
# mixtral's rolling cache: decode steps past its window, every step
# after the wrap held to the windowed forward
ROLL_EXTRA = 64


@contextlib.contextmanager
def routing_log():
    """Wrap the LM's and jamba's ``moe_apply``: each call (one MoE layer)
    appends its expert ids ``idx`` [R, T, K], its largest expert load,
    capacity and dropped assignments, from ``moe_routing`` (what
    ``moe_apply`` routes with); the output is not touched."""
    from repro_torch.models import jamba, lm
    from repro_torch.models.layers import moe_apply, moe_routing
    records: List[dict] = []

    def logged(cfg, p, h, *args, **kw):
        r = moe_routing(cfg, p, h, *args, **kw)
        records.append({"idx": r["idx"], "max_load": int(r["loads"].max()),
                        "capacity": r["capacity"],
                        "dropped": int((~r["keep"]).sum())})
        return moe_apply(cfg, p, h, *args, **kw)

    lm.moe_apply = jamba.moe_apply = logged
    try:
        yield records
    finally:
        lm.moe_apply = jamba.moe_apply = moe_apply


@contextlib.contextmanager
def replayed_routing(choices: List[torch.Tensor]):
    """Each routing (one MoE layer's ``layers._route``) takes the next
    [R, T, K] expert ids of ``choices`` in place of its own top-k, each
    weighted by its own router probability, renormalised as ``_route``
    does.  Yields the token-layers routed, those whose own choice (as a
    set) differed and the largest router margin p_K - p_K+1 among them
    (device tensors until the block ends)."""
    from repro_torch.models import layers
    inner = layers._route
    it = iter(choices)
    stats = {"routed": 0, "differ": 0, "max_margin": 0.0}

    def replay(cfg, p, x, expert_perm):
        probs, own, _w = inner(cfg, p, x, expert_perm)
        idx = next(it)
        if idx.shape != own.shape:
            fail(f"routing replay: ids {tuple(idx.shape)} for a routing of "
                 f"{tuple(own.shape)}")
        K = cfg.top_k
        top = probs.topk(K + 1, dim=-1).values
        differ = (own.sort(-1).values != idx.sort(-1).values).any(-1)
        stats["routed"] += differ.numel()
        stats["differ"] = stats["differ"] + differ.sum()
        stats["max_margin"] = torch.maximum(
            torch.as_tensor(stats["max_margin"], device=probs.device),
            torch.where(differ, top[..., K - 1] - top[..., K], 0.0).max())
        vals = probs.gather(-1, idx)
        return probs, idx, vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)

    layers._route = replay
    try:
        yield stats
    finally:
        layers._route = inner
    if next(it, None) is not None:
        fail("routing replay: choices left over")
    stats["differ"] = int(stats["differ"])
    stats["max_margin"] = float(stats["max_margin"])


def replay_line(stats: dict, what: str) -> str:
    """Fail unless every token-layer whose own choice differed was a
    near-tie; the summary for the log."""
    if not stats["routed"]:
        return "no MoE layer"
    if stats["max_margin"] >= ROUTING_TIE:
        fail(f"{what}: a token's own expert choice differs from the "
             f"replayed one at a router margin of {stats['max_margin']} "
             f"(not a near-tie under {ROUTING_TIE})")
    return (f"routing replayed, {stats['differ']} of {stats['routed']} "
            f"token-layers would have chosen otherwise, at margins up to "
            f"{stats['max_margin']:.2e}")


@contextlib.contextmanager
def checked_attention(what: str):
    """Hold every ``ops.attention`` call (each layer of a forward) against
    the plain version on the same q, k, v (``_attn_close``); yields the
    list of (largest absolute, largest row-relative) errors."""
    from unittest import mock

    from repro_torch.kernels import ops, ref
    real = ops.attention
    gaps: List[tuple] = []

    def checked(q, k, v, **kw):
        out = real(q, k, v, **kw)
        gaps.append(_attn_close(out, ref.attention_ref(q, k, v, **kw),
                                q.dtype, f"{what}, layer {len(gaps)}"))
        return out

    with mock.patch.object(ops, "attention", checked):
        yield gaps


def _gaps_line(gaps: List[tuple]) -> str:
    return (f"every layer's kernel output against the plain version on its "
            f"q, k, v: max abs error {max(g[0] for g in gaps):.3e}, max "
            f"row-relative error {max(g[1] for g in gaps):.3e}")


def hold_logits(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """The largest absolute difference of two runs' logits [N, V]; fails
    past LOGIT_TOL."""
    diff = max(float((a[i:i + 256].float() - b[i:i + 256].float()).abs()
                     .max()) for i in range(0, a.shape[0], 256))
    if not diff <= LOGIT_TOL:
        fail(f"{what}: logits max abs difference {diff} (limit "
             f"{LOGIT_TOL})")
    return diff


def _layer_loads(records: List[dict]) -> str:
    return " ".join(f"{r['max_load']}/{r['capacity']}:{r['dropped']}"
                    for r in records)


def _step_choices(records: List[dict], B: int, S: int) -> List[torch.Tensor]:
    """A forward's routing over B x S tokens (one record per layer) as the
    choices of decode steps 0 to S - 1, layer by layer: [1, B, K] ids."""
    per_layer = [r["idx"].reshape(B, S, -1) for r in records]
    return [idx[:, t][None] for t in range(S) for idx in per_layer]


def _decode_all(cfg, model, prompts, dev, start: int = 0) -> torch.Tensor:
    """Decode steps over every position of ``prompts`` ([B, S] or [B, S,
    D]) from an empty cache: the logits [S - start, B, V] of the steps
    from ``start``."""
    from repro_torch.models import get_api
    api = get_api(cfg)
    B, S = prompts.shape[:2]
    cache = api.init_cache(cfg, B, S, dev)
    out = []
    for t in range(S):
        logits, cache = api.decode(cfg, model, prompts[:, t], cache, t)
        if t >= start:
            out.append(logits)
    return torch.stack(out)


def moe_phase(card: str, dev: str = "cuda") -> int:
    """qwen2-moe-a2.7b at published width and depth on the card: the
    flash forward on the plain config (flat dispatch) with 24 kernel
    launches, every layer's attention held against the plain version and
    every layer's expert loads; against plain attention; the production
    profile (batched dispatch); batched against flat at ample capacity;
    ``serve()``; the forward against the decode steps' logits at every
    prompt position.  Returns the forward's flash launches."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.launch.steps import make_forward_step
    from repro_torch.models import build_lm, param_count
    from repro_torch.models.layers import moe_capacity
    from repro_torch.models.lm import lm_defs

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    spec = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(spec.config, use_flash_kernel=True)
    t0 = time.perf_counter()
    model = build_lm(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"moe: {cfg.name}, param_count={param_count(lm_defs(cfg))}, "
          f"{nbytes} bytes of weights, built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ),
                         generator=gen, device=dev, dtype=torch.int32)
    N = MOE_BATCH * MOE_SEQ

    def flat(logits):
        return logits.reshape(-1, logits.shape[-1])

    forward = make_forward_step(cfg)
    ops.reset_launches()
    with checked_attention("MoE forward") as gaps, \
            routing_log() as flash_r:
        logits = forward(model, toks)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    print(f"launches on the MoE forward: {launches}; {_gaps_line(gaps)}",
          flush=True)
    if launches["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention launched {launches['flash_attention']} times "
             f"in a {cfg.num_layers}-layer MoE forward")
    if logits.shape != (MOE_BATCH, MOE_SEQ, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"MoE forward logits: shape {tuple(logits.shape)} or "
             f"non-finite")
    print(f"moe forward, flat dispatch (C = {moe_capacity(cfg, N)}, mean "
          f"load {N * cfg.top_k / cfg.num_experts:.1f}), largest expert "
          f"load / C : dropped assignments (of {N * cfg.top_k}) per layer: "
          f"{_layer_loads(flash_r)}", flush=True)
    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    ops.reset_launches()
    with replayed_routing([r["idx"] for r in flash_r]) as st:
        plain_logits = make_forward_step(plain_cfg)(model, toks)
    if any(ops.LAUNCHES.values()):
        fail(f"kernels launched in the plain MoE forward: {ops.LAUNCHES}")
    what = "moe forward, kernel vs plain attention"
    diff = hold_logits(flat(logits), flat(plain_logits), what)
    print(f"{what} ({replay_line(st, what)}): logits max abs difference "
          f"{diff:.4f}", flush=True)
    del plain_logits
    t_fwd = host_s(lambda: forward(model, toks))
    print(f"moe forward ({card}): {MOE_BATCH}x{MOE_SEQ} tokens in "
          f"{t_fwd:.3f} s ({N / t_fwd:.1f} tok/s, warm, host clock)",
          flush=True)
    device_profile(lambda: forward(model, toks),
                   f"moe forward {MOE_BATCH}x{MOE_SEQ}")

    # the production profile: batched dispatch, a capacity per sequence
    prod = dataclasses.replace(spec.optimized_config(), use_flash_kernel=True)
    with routing_log() as prod_r:
        prod_logits = make_forward_step(prod)(model, toks)
    diff = float(max((prod_logits[i].float() - logits[i].float()).abs().max()
                     for i in range(MOE_BATCH)))
    print(f"moe forward, production profile (batched, C = "
          f"{moe_capacity(prod, MOE_SEQ)} per sequence), loads per layer "
          f"{_layer_loads(prod_r)}; logits max abs difference from the flat "
          f"dispatch at the published capacity factor {cfg.capacity_factor}"
          f": {diff:.4f} (not held: other tokens are dropped)", flush=True)
    del prod_logits, logits, prod_r, flash_r
    wide, wide_prod = ample(cfg), ample(prod)
    with routing_log() as flat_r:
        flat_logits = make_forward_step(wide)(model, toks)
    with routing_log() as prod_r:
        prod_logits = make_forward_step(wide_prod)(model, toks)
    if any(r["dropped"] for r in flat_r + prod_r):
        fail("moe: an assignment dropped at the ample capacity")
    K = cfg.top_k
    same = [bool(torch.equal(a["idx"].reshape(-1, K), b["idx"].reshape(-1, K)))
            for a, b in zip(flat_r, prod_r)]
    what = (f"moe forward at capacity factor {wide.capacity_factor} (C = "
            f"{moe_capacity(wide, N)} flat, {moe_capacity(wide, MOE_SEQ)} "
            f"batched), batched vs flat dispatch")
    if not all(same):
        fail(f"{what}: the routing differs in layers "
             f"{[i for i, s in enumerate(same) if not s]}")
    diff = hold_logits(flat(prod_logits), flat(flat_logits), what)
    print(f"{what}: the same experts in every layer, logits max abs "
          f"difference {diff:.4f}", flush=True)
    del flat_logits, prod_logits, flat_r, prod_r

    r = serve(MOE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
              gen_len=SERVE_GEN, smoke=False, seed=0, device=dev,
              model=model)
    if r.tokens.shape != (SERVE_BATCH, SERVE_GEN) or r.tokens.min() < 0 \
            or r.tokens.max() >= cfg.vocab_size:
        fail(f"moe serve tokens: shape {r.tokens.shape}, range "
             f"[{r.tokens.min()}, {r.tokens.max()}]")
    print(f"moe serve ({card}): {SERVE_BATCH} requests, prompt "
          f"{SERVE_PROMPT}, gen {SERVE_GEN}: prefill {r.prefill_sec:.3f} s "
          f"({SERVE_BATCH * SERVE_PROMPT / r.prefill_sec:.1f} tok/s), decode "
          f"{r.decode_sec:.3f} s ({r.tokens_per_sec:.1f} tok/s)", flush=True)

    # the forward over the served prompts against the serve step's logits
    # at every prompt position, at the ample capacity (decode at B = 4
    # never drops); at the published one the forward drops, so it is
    # printed beside its drops
    prompts = torch.from_numpy(make_prompts(
        cfg, SERVE_BATCH, SERVE_PROMPT, 0)).to(dev)
    n = SERVE_BATCH * SERVE_PROMPT
    with routing_log() as fr:
        full = make_forward_step(wide)(model, prompts).transpose(0, 1)
    with replayed_routing(_step_choices(fr, SERVE_BATCH, SERVE_PROMPT)) as st:
        steps = _decode_all(wide, model, prompts, dev)
    what = f"moe forward vs serve step at capacity factor {wide.capacity_factor}"
    diff = hold_logits(full.reshape(n, -1), steps.reshape(n, -1), what)
    print(f"{what}, all {n} prompt positions ({replay_line(st, what)}): "
          f"logits max abs difference {diff:.4f}", flush=True)
    with routing_log() as fr:
        last = make_forward_step(cfg)(model, prompts)[:, -1]
    print(f"moe forward at the published capacity factor "
          f"{cfg.capacity_factor} (C = {moe_capacity(cfg, n)}, mean load "
          f"{n * cfg.top_k / cfg.num_experts:.1f}; dropped per layer "
          f"{[x['dropped'] for x in fr]}) vs the serve step at the last "
          f"prompt token: logits max abs difference "
          f"{float((last.float() - steps[-1].float()).abs().max()):.4f} "
          f"(not held)", flush=True)
    del steps, full, last, model
    torch.cuda.synchronize()
    print(f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes "
          f"in the MoE phase ({card}); {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    return launches["flash_attention"]


def _sweep_inputs(cfg, B: int, S: int, gen: torch.Generator, dev: str):
    if cfg.embed_inputs:
        return torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev, dtype=torch.int32)


def rolling_cache_check(cfg, model, dev: str) -> str:
    """mixtral's rolling cache at full width: one prompt of window +
    ``ROLL_EXTRA`` tokens through decode steps at the ample capacity
    (the cache holds the window, so it wraps; the steps replay the
    forward's routing), every step past the wrap against the windowed
    flash forward of the same tokens."""
    from repro_torch.launch.steps import make_forward_step
    wide = ample(cfg)
    S = cfg.window + ROLL_EXTRA
    gen = torch.Generator(device=dev).manual_seed(7)
    toks = _sweep_inputs(cfg, 1, S, gen, dev)
    with routing_log() as fr:
        full = make_forward_step(wide)(model, toks)[0, cfg.window:]
    t0 = time.perf_counter()
    with replayed_routing(_step_choices(fr, 1, S)) as st:
        steps = _decode_all(wide, model, toks, dev, start=cfg.window)
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    what = "rolling cache vs the windowed forward"
    diff = hold_logits(full, steps[:, 0], what)
    return (f"{what}: {S} decode steps in {t_steps:.1f} s, the last "
            f"{ROLL_EXTRA} past the {cfg.window}-slot wrap, "
            f"{replay_line(st, what)}, logits max abs difference "
            f"{diff:.4f}")


def arch_sweep_phase(card: str, dev: str = "cuda") -> int:
    """The other six published archs at full width, ``SWEEP_LAYERS``
    layers: a flash forward (2 launches, each layer held against the
    plain version on its q, k, v) against plain attention, ``serve()``,
    the forward against the decode steps' logits at every prompt
    position, and mixtral's rolling cache.  Returns the flash launches of
    the counted forwards."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.launch.steps import make_forward_step
    from repro_torch.models import build_lm, param_count
    from repro_torch.models.lm import lm_defs

    total = 0
    for arch, seq in SWEEP_ARCHS.items():
        t_arch = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(get_arch(arch).config,
                                  num_layers=SWEEP_LAYERS,
                                  use_flash_kernel=True)
        model = build_lm(cfg, device=dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(5)
        x = _sweep_inputs(cfg, 1, seq, gen, dev)
        forward = make_forward_step(cfg)
        ops.reset_launches()
        with checked_attention(arch) as gaps, routing_log() as fr:
            logits = forward(model, x)
        torch.cuda.synchronize()
        n = ops.LAUNCHES["flash_attention"]
        if n != SWEEP_LAYERS:
            fail(f"{arch}: flash_attention launched {n} times in a "
                 f"{SWEEP_LAYERS}-layer forward")
        total += n
        if not bool(torch.isfinite(logits).all()):
            fail(f"{arch}: non-finite forward logits")
        t_fwd = host_s(lambda: forward(model, x))
        with replayed_routing([r["idx"] for r in fr]) as st:
            plain = make_forward_step(dataclasses.replace(
                cfg, use_flash_kernel=False))(model, x)
        what = f"{arch} kernel vs plain attention"
        lines = [f"{_gaps_line(gaps)}; kernel vs plain attention "
                 f"({replay_line(st, what)}): logits max abs difference "
                 f"{hold_logits(logits[0], plain[0], what):.4f}"]
        del logits, plain
        r = serve(arch, batch=SWEEP_BATCH, prompt_len=SWEEP_PROMPT,
                  gen_len=SWEEP_GEN, smoke=False, seed=0, device=dev,
                  model=model)
        if r.tokens.shape != (SWEEP_BATCH, SWEEP_GEN) \
                or r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            fail(f"{arch} serve tokens: shape {r.tokens.shape}")
        wide = ample(cfg)
        prompts = torch.from_numpy(make_prompts(
            cfg, SWEEP_BATCH, SWEEP_PROMPT, 0)).to(dev)
        with routing_log() as fr:
            full = make_forward_step(wide)(model, prompts).transpose(0, 1)
        with replayed_routing(_step_choices(fr, SWEEP_BATCH,
                                            SWEEP_PROMPT)) as st:
            steps = _decode_all(wide, model, prompts, dev)
        k = SWEEP_BATCH * SWEEP_PROMPT
        what = f"{arch} forward vs decode steps"
        lines.append(f"forward vs decode steps at all {k} prompt positions "
                     f"({replay_line(st, what)}): logits max abs difference "
                     f"{hold_logits(full.reshape(k, -1), steps.reshape(k, -1), what):.4f}")
        del steps, full
        if cfg.window is not None:
            lines.append(rolling_cache_check(cfg, model, dev))
        torch.cuda.synchronize()
        print(f"arch {arch} ({card}): {SWEEP_LAYERS} of "
              f"{get_arch(arch).config.num_layers} layers, "
              f"{param_count(lm_defs(cfg))} parameters; forward 1x{seq} "
              f"{t_fwd:.3f} s ({seq / t_fwd:.1f} tok/s), {n} flash launches; "
              f"serve {SWEEP_BATCH}x({SWEEP_PROMPT}+{SWEEP_GEN}) decode "
              f"{r.tokens_per_sec:.1f} tok/s; " + "; ".join(lines)
              + f"; max_memory_allocated={torch.cuda.max_memory_allocated()}"
              f" bytes; {time.perf_counter() - t_arch:.1f} s", flush=True)
        del model
        torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------------
# The rwkv and hybrid families
# ----------------------------------------------------------------------

# rwkv6-1.6b at its published width and depth (24 layers, bf16, seeded
# weights): the forward at LM_BATCH x LM_SEQ, serve() of SERVE_BATCH x
# (SERVE_PROMPT + SERVE_GEN), and over a prompt of three 256-token
# chunks, the last padded, the chunked recurrence against the decode
# step layer by layer.  End to end, the forward and the decode steps of
# this random-weight model part far past LOGIT_TOL, in the reference
# too: the per-head group norm (eps 64e-5) multiplies the rounding of a
# head whose wkv nearly vanishes by up to 40, and 24 layers compound it
# (float32 0.31 over 600 positions on an H100; the reference's own bf16
# forward and decode 0.96 apart at the second token; PERF.md).
# So every layer's time mix runs chunked and token by token on the
# forward's own input: the WKV state after the prompt is held to
# float32's rounding and the outputs to four bf16 units in the last
# place of the largest (the normed wkv is rounded to bf16); the end-to-
# end gap over the first RWKV_SHOWN positions is printed
RWKV_ARCH = "rwkv6-1.6b"
# the check's prompt: two 256-chunks, the second padded (cut from 600,
# three chunks, for the smoke's time: one chunk boundary is crossed)
RWKV_PROMPT, RWKV_SHOWN = 300, 64
RWKV_STATE_RTOL, RWKV_MIX_RTOL = 1e-5, 2.0 ** -6
RWKV_LONG = 524_288              # long_500k's context
# card against CPU: float32 at full width with 2 layers, 1 x 300 tokens
# (two chunks, the second padded), the forward and the decode steps
# within 1e-4 of the largest logit
FAMILY_CHECK_LAYERS, RWKV_CHECK_SEQ, FAMILY_CHECK_RTOL = 2, 300, 1e-4
# jamba-1.5-large-398b at published width, one super-block of 8 layers
# with an MoE FFN every 4th layer (2 MoE + 5 dense mamba sublayers,
# 27,118,690,304 parameters, 54.2 GB of bf16; moe_every 2 would be 90.5
# GB): the forward at 1 x 4096 with its one attention layer through the
# kernel, serve() of 4 x (16 + 8), one mamba layer at full width in
# float32 on the card and the CPU over 1 x 256 tokens
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_LAYERS, JAMBA_MOE_EVERY = 8, 4
JAMBA_SEQ, JAMBA_PROFILE_SEQ = 4096, 1024
JAMBA_PROMPT, JAMBA_GEN = 16, 8
JAMBA_CHECK_SEQ = 256


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|: the card against the CPU."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _cache_bytes(cache) -> int:
    if isinstance(cache, dict):
        return sum(_cache_bytes(v) for v in cache.values())
    return cache.numel() * cache.element_size()


def rwkv_stepwise_check(cfg, model, prompt: torch.Tensor) -> str:
    """Every layer of the forward over ``prompt`` [1, T]: its time mix
    chunked (``wkv_chunked``) and token by token from the carried decode
    state (``wkv_step``) on the same input; the WKV state after the
    prompt within ``RWKV_STATE_RTOL`` of its largest entry and the
    outputs within ``RWKV_MIX_RTOL`` of the largest.  The forward goes on
    from the chunked outputs."""
    import torch.nn.functional as F

    from repro_torch.models.common import rms_norm
    from repro_torch.models.rwkv import channel_mix, time_mix
    eps = cfg.norm_eps
    N = cfg.rwkv_head_dim
    state_gap = mix_gap = 0.0
    with torch.no_grad():
        x = F.embedding(prompt.long(), model.embed)
        for blk in model.blocks:
            xn = rms_norm(x, blk.ln1, eps)
            h, (S_end, _last) = time_mix(cfg, blk.tm, xn)
            state = (x.new_zeros((1, cfg.d_model // N, N, N),
                                 dtype=torch.float32),
                     xn.new_zeros(xn[:, 0].shape))
            outs = []
            for t in range(prompt.shape[1]):
                o, state = time_mix(cfg, blk.tm, xn[:, t:t + 1], state=state)
                outs.append(o)
            state_gap = max(state_gap, _rel_gap(state[0], S_end))
            mix_gap = max(mix_gap, _rel_gap(torch.cat(outs, 1), h))
            x = x + h.to(x.dtype)
            x = x + channel_mix(cfg, blk.cm, rms_norm(x, blk.ln2, eps)
                                )[0].to(x.dtype)
    what = (f"chunked vs stepped time mix, every layer, 1 x "
            f"{prompt.shape[1]} (chunk {cfg.chunk_size}, the last padded)")
    if not (state_gap <= RWKV_STATE_RTOL and mix_gap <= RWKV_MIX_RTOL):
        fail(f"rwkv {what}: WKV state {state_gap}, outputs {mix_gap} "
             f"(limits {RWKV_STATE_RTOL}, {RWKV_MIX_RTOL})")
    return (f"{what}: WKV state max abs difference / max abs entry "
            f"{state_gap:.3e} (limit {RWKV_STATE_RTOL}), outputs "
            f"{mix_gap:.3e} (limit {RWKV_MIX_RTOL:.3e})")


def rwkv_phase(card: str, dev: str = "cuda") -> None:
    """rwkv6-1.6b at published width and depth: the forward, serve(),
    the decode state's bytes at two context lengths, the chunked
    recurrence against the decode step at every layer over a 600-token
    prompt (the end-to-end forward against the decode steps printed over
    its first 64 positions),
    and the card against the CPU at 2 layers in float32, forward and
    decode steps.  No kernel may launch: the reference runs WKV6 in plain
    jnp."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_forward_step
    from repro_torch.models import get_api, param_count

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(RWKV_ARCH).config
    api = get_api(cfg)
    t0 = time.perf_counter()
    model = api.build(cfg, dev, 0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ), generator=gen,
                         device=dev, dtype=torch.int32)
    forward = make_forward_step(cfg)
    ops.reset_launches()
    logits = forward(model, toks)
    torch.cuda.synchronize()
    if logits.shape != (LM_BATCH, LM_SEQ, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"rwkv forward logits: shape {tuple(logits.shape)} or "
             f"non-finite")
    del logits
    t_fwd = host_s(lambda: forward(model, toks))
    print(f"rwkv ({card}): {cfg.name}, {cfg.num_layers} layers, "
          f"param_count={param_count(api.defs(cfg))}, {nbytes} bytes of "
          f"weights, built on the card in {t_build:.1f} s; forward "
          f"{LM_BATCH}x{LM_SEQ} tokens in {t_fwd:.3f} s "
          f"({LM_BATCH * LM_SEQ / t_fwd:.1f} tok/s, warm, host clock)",
          flush=True)
    device_profile(lambda: forward(model, toks),
                   f"rwkv forward {LM_BATCH}x{LM_SEQ}")

    r = serve(RWKV_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
              gen_len=SERVE_GEN, smoke=False, seed=0, device=dev, model=model)
    if r.tokens.shape != (SERVE_BATCH, SERVE_GEN) or r.tokens.min() < 0 \
            or r.tokens.max() >= cfg.vocab_size:
        fail(f"rwkv serve tokens: shape {r.tokens.shape}")
    sizes = {n: _cache_bytes(api.init_cache(cfg, 1, n, dev))
             for n in (SERVE_PROMPT + SERVE_GEN, RWKV_LONG)}
    if len(set(sizes.values())) != 1:
        fail(f"rwkv decode state bytes differ by context: {sizes}")
    print(f"rwkv serve ({card}): {SERVE_BATCH} requests, prompt "
          f"{SERVE_PROMPT}, gen {SERVE_GEN}: prefill {r.prefill_sec:.3f} s "
          f"({SERVE_BATCH * SERVE_PROMPT / r.prefill_sec:.1f} tok/s), decode "
          f"{r.decode_sec:.3f} s ({r.tokens_per_sec:.1f} tok/s); decode "
          f"state bytes by max_len {sizes}", flush=True)
    prompt = torch.randint(0, cfg.vocab_size, (1, RWKV_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    line = rwkv_stepwise_check(cfg, model, prompt)
    t_check = time.perf_counter() - t0
    shown = prompt[:, :RWKV_SHOWN]
    gaps = (forward(model, shown)[0].float()
            - _decode_all(cfg, model, shown, dev)[:, 0].float()).abs().amax(-1)
    del model
    torch.cuda.empty_cache()
    launches = dict(ops.LAUNCHES)
    if any(launches.values()):
        fail(f"kernels launched on the rwkv path: {launches}")
    print(f"rwkv {line} ({t_check:.1f} s); end to end, forward vs decode "
          f"steps over the first {RWKV_SHOWN} positions, bf16: logits max "
          f"abs difference {float(gaps.max()):.4f}, median over positions "
          f"{float(gaps.median()):.4f}, {int((gaps > LOGIT_TOL).sum())} of "
          f"{RWKV_SHOWN} positions past {LOGIT_TOL} (not held); launches "
          f"{launches}; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes",
          flush=True)

    # the card against the CPU: float32, 2 layers, 1 x 300 tokens
    c32 = dataclasses.replace(cfg, num_layers=FAMILY_CHECK_LAYERS,
                              dtype=torch.float32)
    cpu_model = api.build(c32, "cpu", 1)
    card_model = copy.deepcopy(cpu_model).to(dev)
    x = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, RWKV_CHECK_SEQ)).astype(np.int32))
    t0 = time.perf_counter()
    want = api.apply(c32, cpu_model, x)[0]
    t_cpu = time.perf_counter() - t0
    rel = _rel_gap(api.apply(c32, card_model, x.to(dev))[0], want)
    rel_steps = _rel_gap(_decode_all(c32, card_model, x.to(dev), dev)[:, 0],
                         want[0])
    del cpu_model, card_model
    torch.cuda.empty_cache()
    print(f"rwkv card vs CPU ({card}): float32, {cfg.d_model} wide, "
          f"{FAMILY_CHECK_LAYERS} layers, 1 x {RWKV_CHECK_SEQ} tokens: max "
          f"abs difference / max abs logit, the card's forward {rel:.3e}, "
          f"its decode steps {rel_steps:.3e}, against the CPU's forward "
          f"(limit {FAMILY_CHECK_RTOL}; CPU {t_cpu:.1f} s); "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not max(rel, rel_steps) <= FAMILY_CHECK_RTOL:
        fail(f"rwkv card vs CPU: forward {rel}, decode steps {rel_steps}")


def mamba_check(cfg, card: str, dev: str = "cuda") -> str:
    """One mamba layer of ``cfg``'s width in float32 on the card and on
    the CPU, from the same seeded weights, over 1 x ``JAMBA_CHECK_SEQ``
    tokens: the output and the final (scan, conv) state within
    ``FAMILY_CHECK_RTOL`` of the largest entry."""
    import copy

    from repro_torch.models.common import init_params
    from repro_torch.models.ssm import Mamba, mamba_apply
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_mod = init_params(Mamba(c32, torch.device("cpu")),
                          torch.Generator().manual_seed(4))
    card_mod = copy.deepcopy(cpu_mod).to(dev)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (1, JAMBA_CHECK_SEQ, cfg.d_model)).astype(np.float32))
    t0 = time.perf_counter()
    with torch.no_grad():
        want = mamba_apply(c32, cpu_mod, x)
        t_cpu = time.perf_counter() - t0
        got = mamba_apply(c32, card_mod, x.to(dev))
    gaps = [_rel_gap(g, w) for g, w in ((got[0], want[0]),
                                        (got[1][0], want[1][0]),
                                        (got[1][1], want[1][1]))]
    what = (f"one mamba layer, float32, d_in {cfg.ssm_expand * cfg.d_model}, "
            f"1 x {JAMBA_CHECK_SEQ} tokens, card vs CPU")
    if not max(gaps) <= FAMILY_CHECK_RTOL:
        fail(f"{what}: relative gaps (y, h, conv) {gaps}")
    del cpu_mod, card_mod
    torch.cuda.empty_cache()
    return (f"{what}: max abs difference / max abs entry y {gaps[0]:.3e}, h "
            f"{gaps[1]:.3e}, conv {gaps[2]:.3e} (limit {FAMILY_CHECK_RTOL}; "
            f"CPU {t_cpu:.1f} s)")


def jamba_phase(card: str, dev: str = "cuda") -> int:
    """jamba-1.5-large-398b at published width, one super-block: the
    forward through the kernel (one launch, held against the plain
    version on its q, k, v), against plain attention with the routing
    replayed, ``serve()``, the forward against the decode steps at every
    prompt position at an ample capacity with the routing replayed, and
    one mamba layer card against CPU.  Returns the forward's flash
    launches."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.launch.steps import make_forward_step
    from repro_torch.models import get_api, param_count
    from repro_torch.models.layers import moe_capacity

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full_cfg = get_arch(JAMBA_ARCH).config
    cfg = dataclasses.replace(full_cfg, num_layers=JAMBA_LAYERS,
                              moe_every=JAMBA_MOE_EVERY, use_flash_kernel=True)
    cut = (f"{JAMBA_LAYERS} of {full_cfg.num_layers} layers (one "
           f"super-block), moe_every {JAMBA_MOE_EVERY} (not "
           f"{full_cfg.moe_every}): {cfg.attn_every // cfg.moe_every} MoE + "
           f"{cfg.attn_every - 1 - cfg.attn_every // cfg.moe_every} dense "
           f"mamba sublayers")
    api = get_api(cfg)
    t0 = time.perf_counter()
    model = api.build(cfg, dev, 0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"jamba ({card}): {cfg.name}, cut: {cut}; "
          f"param_count={param_count(api.defs(cfg))}, {nbytes} bytes of "
          f"weights, built on the card in {t_build:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (1, JAMBA_SEQ), generator=gen,
                         device=dev, dtype=torch.int32)
    forward = make_forward_step(cfg)
    ops.reset_launches()
    with checked_attention("jamba forward") as gaps, routing_log() as fr:
        logits = forward(model, toks)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches["flash_attention"] != 1:
        fail(f"flash_attention launched {launches['flash_attention']} times "
             f"in the jamba forward (one attention layer)")
    if not bool(torch.isfinite(logits).all()):
        fail("jamba forward: non-finite logits")
    print(f"launches on the jamba forward: {launches}; {_gaps_line(gaps)}; "
          f"C = {moe_capacity(cfg, JAMBA_SEQ)} (mean load "
          f"{JAMBA_SEQ * cfg.top_k / cfg.num_experts:.1f}), largest expert "
          f"load / C : dropped assignments (of {JAMBA_SEQ * cfg.top_k}) per "
          f"MoE sublayer: {_layer_loads(fr)}", flush=True)
    with replayed_routing([r["idx"] for r in fr]) as st:
        plain = make_forward_step(dataclasses.replace(
            cfg, use_flash_kernel=False))(model, toks)
    what = "jamba kernel vs plain attention"
    diff = hold_logits(logits[0], plain[0], what)
    print(f"{what} ({replay_line(st, what)}): logits max abs difference "
          f"{diff:.4f}", flush=True)
    del logits, plain, fr
    t_fwd = host_s(lambda: forward(model, toks))
    short = toks[:, :JAMBA_PROFILE_SEQ]
    print(f"jamba forward ({card}): 1x{JAMBA_SEQ} tokens in {t_fwd:.3f} s "
          f"({JAMBA_SEQ / t_fwd:.1f} tok/s, warm, host clock)", flush=True)
    device_profile(lambda: forward(model, short),
                   f"jamba forward 1x{JAMBA_PROFILE_SEQ}")

    r = serve(JAMBA_ARCH, batch=SERVE_BATCH, prompt_len=JAMBA_PROMPT,
              gen_len=JAMBA_GEN, smoke=False, seed=0, device=dev, model=model)
    if r.tokens.shape != (SERVE_BATCH, JAMBA_GEN) or r.tokens.min() < 0 \
            or r.tokens.max() >= cfg.vocab_size:
        fail(f"jamba serve tokens: shape {r.tokens.shape}")
    wide = ample(cfg)
    prompts = torch.from_numpy(make_prompts(
        cfg, SERVE_BATCH, JAMBA_PROMPT, 0)).to(dev)
    with routing_log() as fr:
        full = make_forward_step(wide)(model, prompts).transpose(0, 1)
    with replayed_routing(_step_choices(fr, SERVE_BATCH, JAMBA_PROMPT)) as st:
        steps = _decode_all(wide, model, prompts, dev)
    k = SERVE_BATCH * JAMBA_PROMPT
    what = (f"jamba forward vs decode steps at capacity factor "
            f"{wide.capacity_factor}")
    diff = hold_logits(full.reshape(k, -1), steps.reshape(k, -1), what)
    del full, steps, model
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    print(f"jamba serve ({card}): {SERVE_BATCH} requests, prompt "
          f"{JAMBA_PROMPT}, gen {JAMBA_GEN}: prefill {r.prefill_sec:.3f} s "
          f"({SERVE_BATCH * JAMBA_PROMPT / r.prefill_sec:.1f} tok/s), decode "
          f"{r.decode_sec:.3f} s ({r.tokens_per_sec:.1f} tok/s); {what}, all "
          f"{k} prompt positions ({replay_line(st, what)}): logits max abs "
          f"difference {diff:.4f}; max_memory_allocated={peak} bytes",
          flush=True)
    print(f"jamba mamba check ({card}): {mamba_check(cfg, card, dev)}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches["flash_attention"]


# ----------------------------------------------------------------------
# Train phase
# ----------------------------------------------------------------------

# qwen3-1.7b at its published width and depth with its production
# profile (remat "full"), bf16 weights and float32 AdamW moments; cut
# from the train_4k shape (256 x 4096) to 4 x 1024 tokens, 8 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
TRAIN_CUT = (f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ} (not 256 x 4096), "
             f"{TRAIN_STEPS} steps, synthetic TokenStream, no checkpoint")
# card against CPU: one float32 step at full width with 2 layers, then
# the loss of a second; float32 sums in another order (TF32 off)
CHECK_LAYERS, CHECK_BATCH, CHECK_SEQ = 2, 2, 64
CHECK_LOSS_ATOL, CHECK_GNORM_RTOL = 1e-4, 1e-4
# train() stopped and resumed at full width with 2 layers (bf16): five
# steps checkpointing after the third, then a run resumed from it
RESUME_BATCH, RESUME_SEQ, RESUME_STEPS, RESUME_AT = 2, 256, 5, 3


def _train_steps(cfg, model, n, batch, seq, seed=0, profile=None,
                 mesh=None):
    """``n`` steps of ``make_train_step`` (on ``mesh`` when given: the
    bundle's step, which shards the model) on ``TokenStream`` batches,
    and with ``profile`` (a label) one step more under the profiler.
    Returns (losses, grad norms, step seconds, model) of the ``n``, and
    with ``profile`` the card's peak memory over them."""
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import is_dtensor
    from repro_torch.optim import AdamWConfig, adamw_init
    dev = next(model.parameters()).device
    if mesh is None:
        step = make_train_step(cfg, batch=batch, seq=seq, total_steps=n)
    else:
        step = make_train_step(cfg, batch=batch, seq=seq, total_steps=n,
                               mesh=mesh).fn
    opt = adamw_init(dict(model.named_parameters()), AdamWConfig())
    stream = TokenStream(DataConfig(cfg.vocab_size, seq, batch, seed=seed))
    losses, norms, secs = [], [], []
    try:
        for i in range(n):
            x, y = stream.batch_at(i)
            x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, x, y)
            m = {k: v.full_tensor() if is_dtensor(v) else v
                 for k, v in m.items()}
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)
        if profile:
            peak = torch.cuda.max_memory_allocated()
            x, y = (torch.from_numpy(a).to(dev) for a in stream.batch_at(n))
            device_profile(lambda: step(model, opt, x, y), profile)
    finally:
        stream.close()
    return (losses, norms, secs, model) + ((peak,) if profile else ())


def train_check_phase(card: str, dev: str = "cuda") -> None:
    """One float32 train step of qwen3-1.7b's width with 2 layers on the
    card and on the CPU from the same weights and batches: loss and
    gradient norm within the stated tolerances, and the loss of a
    second step."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.models import build_lm
    cfg = dataclasses.replace(get_arch(LM_ARCH).optimized_config(),
                              num_layers=CHECK_LAYERS, dtype=torch.float32)
    cpu_model = build_lm(cfg, device="cpu", seed=1)
    card_model = copy.deepcopy(cpu_model).to(dev)
    t0 = time.perf_counter()
    cl, cn, _s, _m = _train_steps(cfg, cpu_model, 2, CHECK_BATCH, CHECK_SEQ)
    t_cpu = time.perf_counter() - t0
    del _m, cpu_model
    gl, gn, _s, _m = _train_steps(cfg, card_model, 2, CHECK_BATCH, CHECK_SEQ)
    del _m, card_model
    torch.cuda.empty_cache()
    print(f"train check ({card}): float32, {cfg.d_model} wide, "
          f"{CHECK_LAYERS} layers, {CHECK_BATCH}x{CHECK_SEQ} tokens: loss "
          f"{gl[0]!r} on the card, {cl[0]!r} on the CPU; grad norm "
          f"{gn[0]!r} / {cn[0]!r}; second step's loss {gl[1]!r} / "
          f"{cl[1]!r} (CPU {t_cpu:.1f} s; tolerances loss {CHECK_LOSS_ATOL}, "
          f"grad norm {CHECK_GNORM_RTOL} relative)", flush=True)
    for what, a, b in (("loss", gl[0], cl[0]), ("second loss", gl[1], cl[1])):
        if not abs(a - b) <= CHECK_LOSS_ATOL:
            fail(f"train check: {what} {a} on the card, {b} on the CPU")
    if not abs(gn[0] - cn[0]) <= CHECK_GNORM_RTOL * abs(cn[0]):
        fail(f"train check: grad norm {gn[0]} on the card, {cn[0]} on the "
             f"CPU")


def train_resume_phase(card: str, dev: str = "cuda") -> None:
    """``train()`` at full width with 2 layers, checkpointing after step
    ``RESUME_AT``, then a run resumed from that checkpoint: its losses
    equal the uninterrupted run's."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    cfg = dataclasses.replace(get_arch(LM_ARCH).optimized_config(),
                              num_layers=CHECK_LAYERS)
    d = ROOT / "build" / "train_checkpoints"
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(steps=RESUME_STEPS, batch=RESUME_BATCH, seq=RESUME_SEQ,
              config_override=cfg, ckpt_dir=str(d), log_every=100,
              device=dev)
    t0 = time.perf_counter()
    whole = train(LM_ARCH, ckpt_every=RESUME_AT, **kw)
    t_whole = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in d.rglob("*") if p.is_file())
    t0 = time.perf_counter()
    resumed = train(LM_ARCH, **kw)
    t_resumed = time.perf_counter() - t0
    shutil.rmtree(d, ignore_errors=True)
    print(f"train resume ({card}): {cfg.d_model} wide, {CHECK_LAYERS} "
          f"layers, bf16: {RESUME_STEPS} steps in {t_whole:.1f} s with a "
          f"checkpoint of {nbytes} bytes after step {RESUME_AT}; resumed "
          f"from step {resumed.resumed_from} in {t_resumed:.1f} s; losses "
          f"{whole.losses} / resumed {resumed.losses}", flush=True)
    if resumed.resumed_from != RESUME_AT \
            or resumed.losses != whole.losses[RESUME_AT:]:
        fail("train resume: the resumed losses differ from the "
             "uninterrupted run's")


def train_phase(card: str, dev: str = "cuda") -> int:
    """The LM training path on the card: attention refuses autograd;
    the card agrees with the CPU at 2 layers; ``train()`` resumes
    exactly; then qwen3-1.7b at full width and depth trains
    ``TRAIN_STEPS`` steps (finite, decreasing loss).  The launch counts
    are set to 0 once, before the refusal, and read after the whole
    phase: no kernel may launch on the training path.  Returns
    flash_attention's count (0)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_lm, param_count
    from repro_torch.models.lm import lm_defs
    # float32 products in full float32 for the card-against-CPU check
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launches()
    q = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    try:
        ops.attention(q, q.detach(), q.detach())
    except RuntimeError as e:
        print(f"attention under autograd ({card}): refused ({e})",
              flush=True)
    else:
        fail("attention: a q that requires grad was not refused on the card")
    if ops.LAUNCHES["flash_attention"]:
        fail("attention: the refused call launched the kernel")
    del q
    train_check_phase(card, dev)
    train_resume_phase(card, dev)

    cfg = get_arch(LM_ARCH).optimized_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_lm(cfg, device=dev, seed=0)
    losses, norms, secs, model, peak = _train_steps(
        cfg, model, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
        profile=f"train step {TRAIN_STEPS + 1} (qwen3-1.7b, "
                f"{TRAIN_BATCH}x{TRAIN_SEQ})")
    launches = dict(ops.LAUNCHES)
    print(f"launches on the training path (refusal, card-vs-CPU check, "
          f"resume, full-depth steps): {launches}", flush=True)
    if any(launches.values()):
        fail(f"kernels launched on the training path: {launches}")
    warm = secs[1:]
    print(f"train ({card}): {cfg.name}, {param_count(lm_defs(cfg))} "
          f"parameters, {cfg.num_layers} layers, {cfg.dtype} weights, "
          f"float32 AdamW moments, remat {cfg.remat!r}; cut: {TRAIN_CUT}; "
          f"tok/s over steps 2-{TRAIN_STEPS} "
          f"{TRAIN_BATCH * TRAIN_SEQ * len(warm) / sum(warm):.1f}; step s "
          f"{[round(t, 4) for t in secs]}; max_memory_allocated={peak} "
          f"bytes; loss {losses[0]!r} -> {losses[-1]!r} ({losses}); grad "
          f"norms {norms}", flush=True)
    if not all(np.isfinite(losses + norms)):
        fail(f"train: non-finite loss or grad norm ({losses}, {norms})")
    if not losses[-1] < losses[0]:
        fail(f"train: the last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    del model
    torch.cuda.empty_cache()
    return launches["flash_attention"]


# ----------------------------------------------------------------------
# Sharded phase: the LM substrate on a DeviceMesh
# ----------------------------------------------------------------------

# qwen3-1.7b at full width and depth through the mesh-aware steps
# (``launch.steps`` with ``mesh=``) on a (1, 1) ("data", "model")
# DeviceMesh over a one-rank NCCL group (NCCL refuses two ranks on one
# card), each held to the same step without a mesh: the flash forward
# at LM_BATCH x LM_SEQ, SHARD_TRAIN_STEPS train steps at TRAIN_BATCH x
# TRAIN_SEQ, SHARD_DECODE greedy decode steps at SERVE_BATCH; then
# qwen2-moe-a2.7b's forward with ``moe_shard_map`` (the routing of the
# run without a mesh replayed); then one dry-run cell on the host
SHARD_TRAIN_STEPS, SHARD_DECODE = 3, 16
# step 1 shares its weights and batch with the run without a mesh: its
# loss is held to 1e-6 and its grad norm to 1e-3 relative (read on an
# H100: 117.57716 against 117.58144, 3.6e-5 apart), which a gradient
# left out or counted twice would pass by far.  The later losses are a
# backstop at tests/test_torch_train.py's bf16 loss tolerance: the
# mesh's backward hands some gradients on in another memory layout
# (made contiguous past ``local_map``), so cuBLAS sums the bf16 weight
# gradients in another order (read on an H100: losses equal at step 1,
# 6.4e-4 and 7.0e-3 apart at steps 2 and 3 of 3)
SHARD_FIRST_LOSS_ATOL, SHARD_FIRST_NORM_RTOL = 1e-6, 1e-3
SHARD_LOSS_ATOL = 2e-2
SHARD_DRYRUN = ("llama3-405b", "train_4k")


def _local_full(t: torch.Tensor) -> torch.Tensor:
    from repro_torch.models.common import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _decode_tokens(step, model, first: torch.Tensor, cache, n: int):
    """``n`` greedy decode steps from the tokens ``first`` [B]: the
    tokens [n, B] (on the host) and the last cache."""
    tok, out = first, []
    for pos in range(n):
        tok, cache = step(model, tok, cache, pos)
        out.append(_local_full(tok).cpu())
    return torch.stack(out), cache


def sharded_phase(card: str, dev: str = "cuda") -> Dict[str, int]:
    """The LM substrate across a DeviceMesh on the card (see above):
    the sharded qwen3-1.7b logits, losses and tokens equal the unsharded
    ones (logits within LOGIT_TOL, the first loss within
    SHARD_FIRST_LOSS_ATOL, the first grad norm within
    SHARD_FIRST_NORM_RTOL and the other losses within SHARD_LOSS_ATOL,
    tokens exactly); flash_attention launches once per layer in the sharded
    forwards (through ``local_map`` on each rank's heads); the
    qwen2-moe forward with ``moe_shard_map`` equals its run without a
    mesh; the dry-run cell prints.  Returns flash_attention's launches
    on the sharded forwards (``sharded``: qwen3, ``sharded_moe``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_grid_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.steps import make_forward_step, make_serve_step
    from repro_torch.models import build_lm, get_api

    out: Dict[str, int] = {}
    # DTensor logs every two-step Partial reduction it schedules
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    if torch.device(dev).type == "cuda":
        # the group's card, current before the mesh is made on it
        torch.cuda.set_device(torch.device(dev).index or 0)
    dist.init_process_group(
        "nccl" if torch.device(dev).type == "cuda" else "gloo",
        store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_grid_mesh((1, 1), ("data", "model"), device=dev)
        print(f"sharded: {mesh} over a one-rank "
              f"{dist.get_backend().upper()} group ({card})", flush=True)
        cfg = dataclasses.replace(get_arch(LM_ARCH).config,
                                  use_flash_kernel=True)
        model = build_lm(cfg, device=dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                             generator=gen, device=dev, dtype=torch.int32)
        forward = make_forward_step(cfg)
        want = forward(model, toks)
        prompts = torch.from_numpy(make_prompts(
            cfg, SERVE_BATCH, SERVE_PROMPT, 0)).to(dev)
        api = get_api(cfg)
        plain_tokens, _c = _decode_tokens(
            make_serve_step(cfg), model, prompts[:, 0],
            api.init_cache(cfg, SERVE_BATCH, SHARD_DECODE, dev),
            SHARD_DECODE)
        t_plain = host_s(lambda: forward(model, toks))
        bundle = make_forward_step(cfg, mesh=mesh, batch=LM_BATCH,
                                   seq=LM_SEQ)
        ops.reset_launches()
        t0 = time.perf_counter()
        got = bundle.fn(model, toks)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        out["sharded"] = ops.LAUNCHES["flash_attention"]
        what = "sharded forward (1x1 mesh) vs the forward without a mesh"
        diff = hold_logits(_local_full(got).reshape(-1, cfg.vocab_size),
                           want.reshape(-1, cfg.vocab_size), what)
        print(f"{what}: logits max abs difference {diff!r}; placements "
              f"{tuple(got.placements)}; flash_attention launches "
              f"{out['sharded']}", flush=True)
        if out["sharded"] != cfg.num_layers:
            fail(f"flash_attention launched {out['sharded']} times in a "
                 f"{cfg.num_layers}-layer sharded forward")
        del got, want
        t_shard = host_s(lambda: bundle.fn(model, toks))
        print(f"sharded forward ({card}): {LM_BATCH}x{LM_SEQ} tokens in "
              f"{t_shard:.3f} s warm ({LM_BATCH * LM_SEQ / t_shard:.1f} "
              f"tok/s), {t_first:.3f} s for the first call (DTensor's "
              f"sharding propagation), {t_plain:.3f} s without a mesh "
              f"(host clock)", flush=True)
        sb = make_serve_step(cfg, mesh=mesh, batch=SERVE_BATCH,
                             max_len=SHARD_DECODE)
        t0 = time.perf_counter()
        tokens, _c = _decode_tokens(
            sb.fn, model, prompts[:, 0],
            api.init_cache(cfg, SERVE_BATCH, SHARD_DECODE, dev),
            SHARD_DECODE)
        t_dec = time.perf_counter() - t0
        if not torch.equal(tokens, plain_tokens):
            fail(f"sharded decode: tokens {tokens.tolist()} differ from the "
                 f"decode without a mesh {plain_tokens.tolist()}")
        print(f"sharded decode ({card}): {SHARD_DECODE} greedy steps at "
              f"batch {SERVE_BATCH} in {t_dec:.2f} s, tokens equal the "
              f"decode without a mesh", flush=True)
        del model, _c
        torch.cuda.empty_cache()

        tcfg = get_arch(LM_ARCH).optimized_config()
        runs = []
        for m in (None, mesh):
            model = build_lm(tcfg, device=dev, seed=0)
            losses, norms, secs, model = _train_steps(
                tcfg, model, SHARD_TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                mesh=m)
            runs.append((losses, norms, secs))
            del model
            torch.cuda.empty_cache()
        (lu, nu, su), (ls, ns, ss) = runs
        gap = max(abs(a - b) for a, b in zip(lu, ls))
        print(f"sharded train ({card}): {SHARD_TRAIN_STEPS} steps at "
              f"{TRAIN_BATCH}x{TRAIN_SEQ}, losses {ls} (without a mesh "
              f"{lu}, max abs difference {gap!r}), grad norms {ns} ({nu}), "
              f"step s {[round(t, 3) for t in ss]} "
              f"({[round(t, 3) for t in su]})", flush=True)
        norm_gap = abs(nu[0] - ns[0]) / abs(nu[0])
        print(f"sharded train: step-1 grad norm relative difference "
              f"{norm_gap!r}", flush=True)
        if not (abs(lu[0] - ls[0]) <= SHARD_FIRST_LOSS_ATOL
                and norm_gap <= SHARD_FIRST_NORM_RTOL
                and gap <= SHARD_LOSS_ATOL):
            fail(f"sharded train: first losses differ by "
                 f"{abs(lu[0] - ls[0])}, first grad norms by {norm_gap} "
                 f"relative, losses by up to {gap}")

        mcfg = dataclasses.replace(get_arch(MOE_ARCH).config,
                                   use_flash_kernel=True, moe_shard_map=True)
        model = build_lm(mcfg, device=dev, seed=0)
        mtoks = torch.randint(0, mcfg.vocab_size, (MOE_BATCH, MOE_SEQ),
                              generator=torch.Generator(device=dev)
                              .manual_seed(3), device=dev,
                              dtype=torch.int32)
        with routing_log() as r:
            mwant = make_forward_step(mcfg)(model, mtoks)
        mb = make_forward_step(mcfg, mesh=mesh, batch=MOE_BATCH,
                               seq=MOE_SEQ)
        ops.reset_launches()
        with replayed_routing([x["idx"] for x in r]) as st:
            mgot = mb.fn(model, mtoks)
        torch.cuda.synchronize()
        out["sharded_moe"] = ops.LAUNCHES["flash_attention"]
        what = "sharded qwen2-moe forward (moe_shard_map, 1x1 mesh)"
        diff = hold_logits(_local_full(mgot).reshape(-1, mcfg.vocab_size),
                           mwant.reshape(-1, mcfg.vocab_size), what)
        print(f"{what} vs without a mesh ({replay_line(st, what)}): logits "
              f"max abs difference {diff!r}; flash_attention launches "
              f"{out['sharded_moe']}", flush=True)
        if out["sharded_moe"] != mcfg.num_layers:
            fail(f"flash_attention launched {out['sharded_moe']} times in "
                 f"the {mcfg.num_layers}-layer sharded MoE forward")
        del model, mgot, mwant, r
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    arch, shape = SHARD_DRYRUN
    try:
        rep = dryrun.run_cell(arch, shape, False,
                              ROOT / "build" / "dryrun_torch")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    mem, hc = rep["memory"], rep["hlo_accounting"]
    print(f"dry run {arch} {shape} {rep['mesh']} (host, meta tensors over a "
          f"fake group of 256): argument {mem['argument_bytes_per_device']} "
          f"bytes, output {mem['output_bytes_per_device']} bytes, temp "
          f"{mem['temp_bytes_per_device']!r} bytes per device; "
          f"{hc['flops_per_device']!r} FLOPs, "
          f"{hc['hbm_traffic_bytes_per_device']!r} traffic bytes per "
          f"device; collective bytes {hc['collective_bytes']}, counts "
          f"{hc['collective_counts']}; {rep['trace_sec']} s", flush=True)
    if not hc["flops_per_device"] > 0:
        fail(f"dry run {arch} {shape}: no FLOPs counted")
    return out


# ----------------------------------------------------------------------
# Distributed phase: the engine across a process group
# ----------------------------------------------------------------------

DIST_TIMEOUT_S = 300.0     # a collective waiting longer fails its group
DIST_DEADLINE_S = 600.0    # every rank answers within this, or all end


def answer_digest(result) -> str:
    """SHA-256 of a result's variables and ``answer_rows``."""
    import hashlib
    h = hashlib.sha256(repr(sorted(result.bindings)).encode())
    if result.bindings:
        h.update(np.ascontiguousarray(answer_rows(result.bindings)).tobytes())
    return h.hexdigest()


def distributed_handoff(graph, plan, queries, results, ledger,
                        many_ledger) -> dict:
    """Write the graph's columns and the plan (``PartitionPlan.save``)
    to a fresh directory under the checkout's ``build/``, for the ranks
    to load, beside the one-process serve's answers and ledgers."""
    import tempfile
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="distributed-", dir=base))
    t0 = time.perf_counter()
    for c in ("s", "p", "o"):
        np.save(out / f"{c}.npy", getattr(graph, c))
    (out / "graph.json").write_text(json.dumps({
        "num_vertices": int(graph.num_vertices),
        "num_properties": int(graph.num_properties)}))
    plan.save(out / "plan")
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"distributed handoff: graph and plan written in "
          f"{time.perf_counter() - t0:.1f} s ({size} bytes)", flush=True)
    return {"dir": str(out),
            "edges": [[(e.src, e.dst, e.prop) for e in q.edges]
                      for q in queries],
            "digests": [answer_digest(r) for r in results],
            "ledger": ledger, "many": many_ledger}


def _sync(dev: str) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def distributed_rank(handoff_dir: str, query_edges, stream_edges,
                     dev: str) -> dict:
    """One rank of the distributed phase: the graph and the plan loaded
    from the handoff, a ``SITES``-slot mesh over the whole group (rank r
    on ``cuda:r``), the queries served with ``execute`` on one session
    and with ``execute_many`` (batches of 64) on a fresh one; then, on
    the same group, the front door (``distributed_door``) and the
    adaptive stream (``distributed_adaptive``), rank 0 leading.  Before
    the timed serve, ``spmd_match`` runs the three shape queries once
    at ``MATCH_CAPACITY`` on the session's shard (untimed and outside
    the session's counters), so that the group's communicator set-up
    and the rank's first kernel and collective calls fall outside the
    qps; the launch and collective counts are set to 0 after it, before
    the first query, and read after the last.  Returns what it served:
    answer digests, ledgers, counters, seconds."""
    import torch.distributed as dist

    from repro_torch.core import PartitionPlan, QueryGraph, RDFGraph, Session
    from repro_torch.core.spmd import (COLLECTIVES, reset_collectives,
                                       spmd_match)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    d = Path(handoff_dir)
    t0 = time.perf_counter()
    meta = json.loads((d / "graph.json").read_text())
    graph = RDFGraph(*(np.load(d / f"{c}.npy") for c in "spo"),
                     meta["num_vertices"], meta["num_properties"])
    plan = PartitionPlan.load(d / "plan", graph)
    mesh = make_host_mesh(SITES, group=dist.group.WORLD, device=dev)
    queries = [QueryGraph.make(e) for e in query_edges]
    out = {"backend": dist.get_backend(), "world": mesh.world,
           "device": str(mesh.device), "slots": list(mesh.local_slots),
           "load_s": time.perf_counter() - t0}

    def session():
        t = time.perf_counter()
        sess = Session(plan, backend="spmd", device=dev,
                       spmd_max_capacity=MAX_CAPACITY, mesh=mesh)
        _sync(dev)
        return sess, time.perf_counter() - t

    sess, out["store_s"] = session()
    t0 = time.perf_counter()
    for q in queries[SERVED:]:
        spmd_match(sess.engine.store, q, MATCH_CAPACITY, mesh=mesh)
    _sync(dev)
    out["warm_s"] = time.perf_counter() - t0
    ops.reset_launches()
    reset_collectives()
    results, per_query = [], []
    t0 = time.perf_counter()
    for q in queries:
        before = _counters(sess)
        results.append(sess.execute(q))
        per_query.append((results[-1].stats.comm_bytes,) + tuple(
            a - b for a, b in zip(_counters(sess), before)))
    _sync(dev)
    out["execute_s"] = time.perf_counter() - t0
    out["execute"] = {"per_query": per_query,
                      "extra": dict(sess.stats().extra),
                      "digests": [answer_digest(r) for r in results],
                      "launches": dict(ops.LAUNCHES),
                      "collectives": dict(COLLECTIVES)}
    del sess, results
    sess, _ = session()
    t0 = time.perf_counter()
    many = sess.execute_many(queries, batch_size=64)
    _sync(dev)
    out["many_s"] = time.perf_counter() - t0
    out["many"] = {"per_query": [r.stats.comm_bytes for r in many],
                   "extra": dict(sess.stats().extra),
                   "digests": [answer_digest(r) for r in many]}
    out["launches"] = dict(ops.LAUNCHES)
    out["collectives"] = dict(COLLECTIVES)
    del many
    # the door leads the execute_many session: its store is built and
    # its capacity hints are warm, as the one-process door's are
    t0 = time.perf_counter()
    out["door"] = distributed_door(sess, plan, mesh, queries, dev)
    del sess
    out["door_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the star, chain and cycle: ``served_queries`` puts them last
    out["adaptive"] = distributed_adaptive(
        plan, mesh, [QueryGraph.make(e) for e in stream_edges],
        queries[-3:], dev)
    out["adaptive_s"] = time.perf_counter() - t0
    return out


#: the load multiples of the distributed door's sweep: 1x alone, to
#: keep the smoke within its time limit (4x and 16x run on one process)
DIST_SWEEP = (1.0,)


def _led(sess, mesh, body) -> dict:
    """``body()`` inside ``sess.lead()`` on rank 0; the other ranks
    follow.  Returns what rank 0's body returned, or the followed
    calls."""
    if mesh.rank == 0:
        with sess.lead():
            return body()
    t0 = time.perf_counter()
    calls = sess.follow()
    return {"followed": len(calls),
            "errors": [c.error for c in calls if c.error],
            "follow_s": time.perf_counter() - t0}


def _timed_swaps(engine, secs: List[float]) -> None:
    """Time every ``swap_store`` of an SPMD engine into ``secs``."""
    swap = engine.swap_store

    def timed(*a, **kw):
        _sync(str(engine.device))
        t = time.perf_counter()
        gen = swap(*a, **kw)
        _sync(str(engine.device))
        secs.append(time.perf_counter() - t)
        return gen
    engine.swap_store = timed


def distributed_door(sess, plan, mesh, queries, dev: str) -> dict:
    """The front door over ``sess``, which rank 0 leads: the queries
    twice through ``Session.serve()``, a sequential pass (the base
    rate), the capacity sweep at ``DIST_SWEEP`` multiples of it, and a
    hot swap to the same placement through the door
    (``Session.swap_store``) between two halves of the list; the
    other ranks follow.  Every rank records each query its engine
    answers (bytes), its counters, its store generation, its swap
    seconds and its launches and collective calls over the part."""
    from repro_torch.core.spmd import COLLECTIVES, reset_collectives
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import FrontDoor, FrontDoorConfig, measure_capacity
    registry = MetricsRegistry()
    sess.engine.set_metrics_registry(registry)
    per_query: List[int] = []
    sess.post_execute_hooks.append(
        lambda q, r: per_query.append(int(r.stats.comm_bytes)))
    swap_s: List[float] = []
    _timed_swaps(sess.engine, swap_s)
    sids = plan.site_edge_ids()
    half = len(queries) // 2

    def lead() -> dict:
        out = {}
        served_list = list(queries) * 2
        t0 = time.perf_counter()
        with sess.serve(max_batch=DOOR_BATCH,
                        max_delay_ms=DOOR_DELAY_MS) as door:
            futs = [door.submit(q, deadline_s=600.0) for q in served_list]
            _settle(futs)
        out["served_s"] = time.perf_counter() - t0
        out["outcomes"] = [f.outcome for f in futs]
        out["digests"] = [answer_digest(f.result(0)) for f in futs
                          if f.outcome == "completed"]
        out["batches"] = int(door.stats()["batches"])
        out["latency"] = _pcts_ms(registry.histogram(
            "repro_serve_latency_seconds", backend="serve"))
        t0 = time.perf_counter()
        for q in queries:
            sess.execute(q)
        base_qps = len(queries) / (time.perf_counter() - t0)
        out["base_qps"] = base_qps
        reports = measure_capacity(
            lambda: FrontDoor(sess, FrontDoorConfig(
                max_queue=SWEEP_QUEUE, max_batch=DOOR_BATCH,
                max_delay_ms=DOOR_DELAY_MS)),
            queries, base_qps, multipliers=DIST_SWEEP, duration_s=SWEEP_S,
            seed=7, deadline_s=SWEEP_DEADLINE_S)
        out["sweep"] = [(r.offered_multiplier, r.offered_qps,
                         r.achieved_qps, r.p50_latency_s, r.p99_latency_s,
                         r.shed_rate, r.failed) for r in reports]
        with sess.serve(max_batch=DOOR_BATCH,
                        max_delay_ms=DOOR_DELAY_MS) as door:
            futs = [door.submit(q, deadline_s=600.0) for q in queries[:half]]
            _settle(futs)
            door.request_swap(lambda: sess.swap_store(
                sids, replicated_props=set(plan.replicated_props)))
            futs += [door.submit(q, deadline_s=600.0)
                     for q in queries[half:]]
            _settle(futs)
        out["swap_outcomes"] = [f.outcome for f in futs]
        out["swap_digests"] = [answer_digest(f.result(0)) for f in futs
                               if f.outcome == "completed"]
        out["swaps_applied"] = door.swaps_applied
        return out

    _sync(dev)
    ops.reset_launches()
    reset_collectives()
    out = _led(sess, mesh, lead)
    _sync(dev)
    out.update(launches=dict(ops.LAUNCHES), collectives=dict(COLLECTIVES),
               per_query=per_query, extra=dict(sess.stats().extra),
               generation=sess.engine.store_generation, swap_s=swap_s)
    return out


def distributed_adaptive(plan, mesh, stream, shapes, dev: str) -> dict:
    """The adaptive stream on the group: ``Session(plan,
    backend="adaptive", mesh=...)`` on the SPMD data plane with
    ``adaptive_serve``'s configuration; the shapes on the data plane
    before and after it, every rank making the same calls (outside the
    monitored stream, as ``adaptive_serve`` runs them); the stream
    itself submitted once, by rank 0, which leads and runs the control
    plane, while the other ranks follow.  Every rank records its
    answers' digests and bytes per stream query, the shapes' digests,
    its epoch reports, placement digest, counters, swap seconds,
    launches (also at its first swap) and collective calls; rank 0
    also the re-fragmentation seconds and its qps before and after the
    first swap."""
    from repro_torch.core import Session
    from repro_torch.core.spmd import COLLECTIVES, reset_collectives
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.online import AdaptiveConfig
    from repro_torch.online import loop as loop_module
    sess = Session(plan, backend="adaptive", device=dev, mesh=mesh,
                   adaptive_config=AdaptiveConfig(
                       epoch_len=ADAPTIVE_EPOCH, serve_backend="spmd",
                       migration_budget_bytes=ADAPTIVE_BUDGET),
                   metrics_registry=MetricsRegistry())
    eng = sess.engine
    spmd = eng.engine
    spmd.max_capacity = MAX_CAPACITY
    answered: list = []       # digested after the stream, untimed
    sess.post_execute_hooks.append(lambda q, r: answered.append(r))
    swap_s: List[float] = []
    _timed_swaps(spmd, swap_s)
    at_swap: List[dict] = []
    swap = spmd.swap_store

    def counted_swap(*a, **kw):
        at_swap.append(dict(ops.LAUNCHES))
        return swap(*a, **kw)
    spmd.swap_store = counted_swap
    refragment = loop_module.refragment
    refrag_s: List[float] = []

    def timed_refragment(*a, **kw):
        t = time.perf_counter()
        try:
            return refragment(*a, **kw)
        finally:
            refrag_s.append(time.perf_counter() - t)

    def lead() -> dict:
        lat = {"before": [], "after": []}
        for q in stream:
            gen = spmd.store_generation
            t = time.perf_counter()
            sess.execute(q)
            secs = time.perf_counter() - t
            if spmd.store_generation == gen:
                lat["after" if gen else "before"].append(secs)
        return {"qps": {k: len(v) / sum(v) if v else 0.0
                        for k, v in lat.items()}}

    _sync(dev)
    ops.reset_launches()
    reset_collectives()
    shape_digests = [answer_digest(r) for r in data_plane_shapes(spmd, shapes)]
    t0 = time.perf_counter()
    loop_module.refragment = timed_refragment
    try:
        out = _led(sess, mesh, lead)
    finally:
        loop_module.refragment = refragment
    _sync(dev)
    out["stream_s"] = time.perf_counter() - t0
    shape_digests += [answer_digest(r)
                      for r in data_plane_shapes(spmd, shapes)]
    _sync(dev)
    out.update(digests=[answer_digest(r) for r in answered],
               per_query=[int(r.stats.comm_bytes) for r in answered],
               shape_digests=shape_digests, epochs=epoch_dicts(eng),
               placement=placement_digest(eng.plan),
               extra=dict(sess.stats().extra),
               inner_extra=dict(spmd.stats().extra),
               generation=spmd.store_generation, swap_s=swap_s,
               refragment_s=refrag_s, launches=dict(ops.LAUNCHES),
               at_swap=at_swap[0] if at_swap else None,
               collectives=dict(COLLECTIVES))
    return out




def _differ(got, want) -> list:
    """Indices (lists) or keys (dicts) where ``got`` and ``want``
    differ."""
    if isinstance(got, dict):
        return sorted(k for k in set(got) | set(want)
                      if got.get(k) != want.get(k))
    return [i for i, (a, b) in enumerate(zip(got, want)) if a != b] or \
        [f"lengths {len(got)} and {len(want)}"]


def _hold(r: int, what: str, got, want) -> None:
    if got != want:
        fail(f"distributed: rank {r}'s {what} differ at "
             f"{_differ(got, want)[:10]}")


def distributed_phase(card: str, handoff: dict, dev: str = "cuda"
                      ) -> Dict[str, Dict[str, int]]:
    """The served queries on ``torch.cuda.device_count()`` ranks of an
    NCCL group (a gloo group of one rank when ``dev`` is the CPU), each
    rank on its own card with its block of the ``SITES`` slots, through
    ``Session(plan, backend="spmd", mesh=...)``: every rank's answers,
    per-query bytes and counter deltas (``execute``) and per-query
    bytes (``execute_many``), and its counters after each serve, equal
    the one-process session's.  Then, rank 0 leading: the front door
    (every answer equal to the one-process serve's, every outcome
    completed, every rank's per-query bytes and counters equal rank
    0's, a capacity sweep, a hot swap raising the store generation on
    every rank) and the adaptive stream (every rank's answers, bytes,
    shape answers, epoch reports, placement and counters equal
    ``adaptive_serve``'s).  Every join kernel launches on every rank on
    each path.  Returns rank 0's launches per path (``distributed``,
    ``distributed_door``, ``distributed_adaptive``)."""
    import shutil

    from repro_torch.launch.mesh import launch
    on_card = torch.device(dev).type == "cuda"
    world = torch.cuda.device_count() if on_card else 1
    backend = "nccl" if on_card else "gloo"
    ad = handoff["adaptive"]
    t0 = time.perf_counter()
    try:
        outs = launch(distributed_rank, world, handoff["dir"],
                      backend=backend,
                      args=(handoff["dir"], handoff["edges"], ad["stream"],
                            dev),
                      timeout_s=DIST_TIMEOUT_S, deadline_s=DIST_DEADLINE_S)
    finally:
        shutil.rmtree(handoff["dir"], ignore_errors=True)
    secs = time.perf_counter() - t0
    n = len(handoff["edges"])
    for r, o in enumerate(outs):
        if on_card and (o["backend"] != "nccl" or o["device"] != f"cuda:{r}"):
            fail(f"distributed: rank {r} ran {o['backend']} on "
                 f"{o['device']}")
        for what, got, want in (
                ("execute answers", o["execute"]["digests"],
                 handoff["digests"]),
                ("execute ledger", o["execute"]["per_query"],
                 handoff["ledger"]["per_query"]),
                ("execute counters", o["execute"]["extra"],
                 handoff["ledger"]["extra"]),
                ("execute_many answers", o["many"]["digests"],
                 handoff["digests"]),
                ("execute_many ledger", o["many"]["per_query"],
                 handoff["many"]["per_query"]),
                ("execute_many counters", o["many"]["extra"],
                 handoff["many"]["extra"]),
                ("door ledger", o["door"]["per_query"],
                 outs[0]["door"]["per_query"]),
                ("door counters", o["door"]["extra"],
                 outs[0]["door"]["extra"]),
                ("adaptive stream answers", o["adaptive"]["digests"],
                 ad["digests"]),
                ("adaptive stream ledger", o["adaptive"]["per_query"],
                 ad["per_query"]),
                ("adaptive shape answers", o["adaptive"]["shape_digests"],
                 ad["shape_digests"]),
                ("epoch reports", o["adaptive"]["epochs"], ad["epochs"]),
                ("adaptive counters", o["adaptive"]["extra"], ad["extra"]),
                ("adaptive data plane counters",
                 o["adaptive"]["inner_extra"], ad["inner_extra"])):
            _hold(r, what, got, want)
        if o["adaptive"]["placement"] != ad["placement"]:
            fail(f"distributed: rank {r}'s realized placement differs from "
                 f"the one-process adaptive stream's")
        if o["door"]["generation"] != 1 or o["adaptive"]["generation"] \
                != int(ad["inner_extra"]["store_generation"]):
            fail(f"distributed: rank {r}'s store generations "
                 f"{o['door']['generation']} (door) and "
                 f"{o['adaptive']['generation']} (adaptive)")
        if r and (o["door"]["errors"] or o["adaptive"]["errors"]):
            fail(f"distributed: rank {r} recorded errors "
                 f"{o['door']['errors'] + o['adaptive']['errors']}")
        for path, counts in (("execute", o["execute"]["launches"]),
                             ("both serves", o["launches"]),
                             ("door", o["door"]["launches"]),
                             ("adaptive", o["adaptive"]["launches"])):
            missing = [k for k in JOIN_KERNELS if on_card and counts[k] <= 0]
            if missing:
                fail(f"distributed: rank {r} never launched {missing} on "
                     f"the {path} path")
    lead = outs[0]["door"]
    if set(lead["outcomes"] + lead["swap_outcomes"]) != {"completed"}:
        fail(f"distributed door: outcomes "
             f"{sorted(set(lead['outcomes'] + lead['swap_outcomes']))}")
    _hold(0, "door answers", lead["digests"], handoff["digests"] * 2)
    _hold(0, "door answers across the swap", lead["swap_digests"],
          handoff["digests"])
    if lead["swaps_applied"] != 1:
        fail(f"distributed door: {lead['swaps_applied']} swaps applied")
    for mult, offered, achieved, p50, p99, shed, failed in lead["sweep"]:
        if failed:
            fail(f"distributed door: {failed} failed requests at {mult:g}x")
    print(f"distributed ({card}): world {world}, backend {backend}, "
          f"{SITES} slots ({[o['slots'] for o in outs]}), {n} queries; "
          f"execute qps="
          f"{[round(n / o['execute_s'], 3) for o in outs]} "
          f"(one process {handoff['ledger']['qps']:.3f}), execute_many "
          f"qps={[round(n / o['many_s'], 3) for o in outs]} (one process "
          f"{handoff['many']['qps']:.3f}); load {outs[0]['load_s']:.1f} s, "
          f"store {outs[0]['store_s']:.1f} s, untimed warm-up "
          f"{outs[0]['warm_s']:.2f} s, phase {secs:.1f} s; "
          f"collective calls per rank (execute, then both) "
          f"{[(o['execute']['collectives'], o['collectives']) for o in outs]}"
          f"; join kernel launches per rank "
          f"{[{k: o['launches'][k] for k in JOIN_KERNELS} for o in outs]}; "
          f"answers, per-query ledger and counters of every rank equal the "
          f"one-process session's", flush=True)
    def joins(counts) -> dict:
        return counts and {k: counts[k] for k in JOIN_KERNELS}
    print(f"distributed door ({card}): rank 0 leads, {world - 1} "
          f"following; {2 * n} requests in {lead['served_s']:.2f} s, served "
          f"qps={2 * n / lead['served_s']:.3f} in {lead['batches']} "
          f"batches, serve latency {lead['latency']}; answers equal the "
          f"one-process serve's, every outcome completed; base rate "
          f"{lead['base_qps']:.3f} qps; hot swap to the same placement "
          f"through the door: store generation "
          f"{[o['door']['generation'] for o in outs]}, swap s per rank "
          f"{[[round(x, 2) for x in o['door']['swap_s']] for o in outs]}; "
          f"part {outs[0]['door_s']:.1f} s; collective calls per rank "
          f"{[o['door']['collectives'] for o in outs]}; join kernel "
          f"launches per rank "
          f"{[joins(o['door']['launches']) for o in outs]}"
          f"; per-query bytes and counters of every rank equal rank 0's",
          flush=True)
    for mult, offered, achieved, p50, p99, shed, failed in lead["sweep"]:
        print(f"distributed load {mult:g}x ({card}): offered {offered:.3f} "
              f"qps, achieved {achieved:.3f} qps, p50={p50 * 1e3:.2f} ms "
              f"p99={p99 * 1e3:.2f} ms, shed_rate={shed:.4f}, "
              f"failed={failed}", flush=True)
    lad = outs[0]["adaptive"]
    print(f"distributed adaptive ({card}): rank 0 leads and runs the "
          f"control plane, {world - 1} following; {len(ad['stream'])} "
          f"queries in {lad['stream_s']:.1f} s; re-fragmentation on rank 0 "
          f"{[round(x, 1) for x in lad['refragment_s']]} s (one process "
          f"{[round(x, 1) for x in ad['refragment_s']]}); swap s per rank "
          f"{[[round(x, 2) for x in o['adaptive']['swap_s']] for o in outs]}"
          f" (one process {[round(x, 2) for x in ad['swap_s']]}); qps "
          f"before the swap {lad['qps']['before']:.3f} (one process "
          f"{ad['qps']['before']:.3f}), after {lad['qps']['after']:.3f} "
          f"(one process {ad['qps']['after']:.3f}); "
          f"{len(lad['epochs'])} epochs, "
          f"{int(lad['extra']['repartitions'])} re-partitions; part "
          f"{outs[0]['adaptive_s']:.1f} s; collective calls per rank "
          f"{[o['adaptive']['collectives'] for o in outs]}; join kernel "
          f"launches per rank "
          f"{[joins(o['adaptive']['launches']) for o in outs]} (at the "
          f"first swap {[joins(o['adaptive']['at_swap']) for o in outs]}"
          f"); answers, bytes, shape answers, epoch reports, placement and "
          f"counters of every rank equal the one-process stream's",
          flush=True)
    return {"distributed": {k: outs[0]["launches"][k] for k in JOIN_KERNELS},
            "distributed_door": {k: lead["launches"][k]
                                 for k in JOIN_KERNELS},
            "distributed_adaptive": {k: lad["launches"][k]
                                     for k in JOIN_KERNELS}}


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
    return graph, design, plan, session


def spmd_phase(card: str):
    """Phases 2 to 7: the WatDiv plan, the join kernels, the served
    queries (``execute``, its profile, then ``execute_many``), the
    front door, the online adaptive loop, the horizontal / SHAPE / WARP
    plans and the host backends, then the seeded ledger comparisons.
    Returns the records of the kernels checked against the store, with
    their launches on the ``execute`` serve (``spmd``), on the front
    door's served pass (``serve``), on the adaptive stream
    (``adaptive``) and on each strategy's serve; and the handoff of the
    distributed phase (``distributed_handoff``)."""
    from repro_torch.core import Session
    clock = [time.perf_counter()]

    def phase_seconds(name: str) -> None:
        now = time.perf_counter()
        print(f"phase seconds: {name} {now - clock[0]:.1f}", flush=True)
        clock[0] = now

    graph, design, plan, session = rdf_setup()
    phase_seconds("rdf setup")
    kernels = kernel_phase(session.engine.store)
    phase_seconds("kernels")
    queries = served_queries(graph)
    plain = Session(plan, backend="spmd", spmd_max_capacity=MAX_CAPACITY)
    torch.cuda.reset_peak_memory_stats()
    launches, results, ledger = serve_phase(session, plain, graph, queries,
                                            card)
    print(f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"bytes ({card})", flush=True)
    missing = [k for k, (_s, _t, path) in KERNELS.items()
               if path == "spmd" and launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the serve path: {missing}")
    del plain
    many, many_ledger = serve_many_phase(plan, queries, results, card)
    missing = [k for k, (_s, _t, path) in KERNELS.items()
               if path == "spmd" and many[k] <= 0]
    if missing:
        fail(f"kernels never launched on the execute_many serve: {missing}")
    handoff = distributed_handoff(graph, plan, queries, results, ledger,
                                  many_ledger)
    phase_seconds("serve")
    matcher = matcher_phase(graph, session.engine.store, queries[SERVED:],
                            [answer_rows(r.bindings)
                             for r in results[SERVED:]], card)
    lost = site_loss_phase(graph, plan, queries, results, session, card)
    phase_seconds("matcher and site loss")
    served = door_phase(plan, queries, results, session, card)
    missing = [k for k, (_s, _t, path) in KERNELS.items()
               if path == "spmd" and served[k] <= 0]
    if missing:
        fail(f"kernels never launched on the front-door serve: {missing}")
    phase_seconds("front door")
    del session
    torch.cuda.empty_cache()
    adaptive, handoff["adaptive"] = adaptive_phase(graph, plan, card)
    del plan
    torch.cuda.empty_cache()
    phase_seconds("adaptive")
    strategies = strategies_phase(card)
    ledger_phase(card)
    phase_seconds("strategies and ledger")
    for k in kernels:
        kernels[k]["launches"] = launches[k]
        if KERNELS[k][2] == "spmd":
            kernels[k]["paths"] = {"spmd": launches[k], "serve": served[k],
                                   "matcher": matcher[k],
                                   "site_loss": lost[k],
                                   "adaptive": adaptive[k],
                                   **{kind: strategies[kind][k]
                                      for kind in STRATEGY_KINDS}}
    return kernels, handoff


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

    kernels, handoff = spmd_phase(card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for path, counts in distributed_phase(card, handoff).items():
        for k, n in counts.items():
            kernels[k]["paths"][path] = n
    print(f"phase seconds: distributed {time.perf_counter() - t0:.1f}",
          flush=True)
    t0 = time.perf_counter()
    kernels["flash_attention"] = lm_phase(card)
    torch.cuda.empty_cache()
    print(f"phase seconds: lm {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    moe = moe_phase(card)
    print(f"phase seconds: moe {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    archs = arch_sweep_phase(card)
    print(f"phase seconds: archs {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    rwkv_phase(card)
    jamba = jamba_phase(card)
    print(f"phase seconds: families {time.perf_counter() - t0:.1f}",
          flush=True)
    t0 = time.perf_counter()
    kernels["flash_attention"]["paths"] = {
        "lm": kernels["flash_attention"]["launches"],
        "moe": moe, "archs": archs, "jamba": jamba,
        "train": train_phase(card)}
    print(f"phase seconds: train {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    kernels["flash_attention"]["paths"].update(sharded_phase(card))
    print(f"phase seconds: sharded {time.perf_counter() - t0:.1f}",
          flush=True)

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
