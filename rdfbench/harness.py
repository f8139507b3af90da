"""One run of one cell: set up the system under test, load it through
its front door for a window, judge the answers, print the result.

Everything that belongs to one configuration, mix or per-layer metric
is a file found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py`` (whose
``read(run)`` returns the metric's value or ``None``).  A cell and the
metrics it reports are entries of ``BENCHMARK.json``.

Set-up (``setup_s``, from the process's start to the first timed
request): the graph and the design workload from the seed, the plan
(``build_plan``), the ``Session`` with its site store, one request of
every shape the mix sends (which builds and loads the kernels), and the
door.  The window: the mix's clients load ``Session.serve()`` for
``--seconds``.  After it: the device's peak memory, the program's state
freed, then the reference judges a seeded sample of the requests.

The last line of standard output is the result; the numbers compared
are the last lines of standard error and the last key of the result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import devtrace, reference, roofline, traffic, watdiv

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: seconds past the window's close that an answer is waited for
GRACE_S = 60.0
#: the profiled part of a traced window: its last third or this many
#: seconds, whichever is shorter
PROFILE_MAX_S = 6.0
#: top-level modules the run may not hold: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: outcomes that count as failed; ``completed`` is the only other
FAILED = ("failed", "shed", "deadline", "unresolved")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json",
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``benchmark``, its configuration and mix
    read from their files, and the metrics it reports: each end-to-end
    metric that lists it (or lists no cells), each per-layer metric that
    lists it or, listing none, moves a metric the cell reports."""
    spec = json.loads(Path(benchmark).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {benchmark}; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json")
                        .read_text())
    mix = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    shown = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in shown)]
    return Cell(name, int(w["chips"]), config, mix, e2e, per)


def reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "rdfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_device(chips: int) -> str:
    """The device of the run: CUDA with at least ``chips`` cards, or
    ``SystemExit``."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("rdfbench: CUDA is not available; no result")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"rdfbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present; no result")
    return "cuda"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
# Set-up
# ----------------------------------------------------------------------

@dataclasses.dataclass
class System:
    graph_cols: Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]
    perm: np.ndarray
    session: object
    plan_s: float


def build_system(cfg: Dict, seed: int, device: str) -> System:
    """The configuration's graph and design workload, relabelled by the
    seed (``watdiv.relabel``), the plan and the session."""
    from repro_torch.core import (PartitionConfig, QueryGraph, RDFGraph,
                                  Session, Workload, build_plan)
    t0 = time.monotonic()
    s, p, o, nv, n_props = watdiv.generate_watdiv(int(cfg["triples_drawn"]),
                                                  int(cfg["graph_seed"]))
    design, tids = watdiv.generate_workload(
        nv, int(cfg["design_queries"]), int(cfg["design_seed"]),
        zipf_a=float(cfg["design_template_zipf"]),
        cold_fraction=float(cfg["design_cold_fraction"]),
        constant_fraction=float(cfg["design_constant_fraction"]))
    perm = traffic.rng(seed, traffic.GRAPH).permutation(nv).astype(np.int32)
    s, o, design = watdiv.relabel(perm, s, o, design)
    cols = (s, p, o, nv, n_props)
    graph = RDFGraph(s, p, o, nv, n_props,
                     property_names=list(watdiv.PROPERTIES))
    workload = Workload([QueryGraph.make(e) for e in design], tids)
    t1 = time.monotonic()
    plan = build_plan(graph, workload, PartitionConfig(
        kind=cfg["kind"], num_sites=int(cfg["num_sites"])))
    t2 = time.monotonic()
    session = Session(plan, backend="spmd", device=device,
                      spmd_capacity=int(cfg["spmd_capacity"]),
                      spmd_max_capacity=int(cfg["spmd_max_capacity"]))
    t3 = time.monotonic()
    st = plan.stats
    log(f"graph: {len(s)} triples, {nv} vertices, {t1 - t0:.3f} s; "
        f"plan ({cfg['kind']}, {cfg['num_sites']} sites): {t2 - t1:.3f} s, "
        f"mine {st.mine_sec:.3f} select {st.select_sec:.3f} fragment "
        f"{st.fragment_sec:.3f} allocate {st.allocate_sec:.3f}, "
        f"{st.num_fragments} fragments, redundancy "
        f"{st.redundancy_ratio:.4f}; store: {t3 - t2:.3f} s")
    return System(cols, perm, session, t2 - t1)


def warm_up(session, door, mix: Dict) -> None:
    """Run every shape the mix sends, directly and through the door."""
    from repro_torch.core import QueryGraph
    for edges, tid in traffic.warmup_queries(mix):
        q = QueryGraph.make(edges)
        t = time.monotonic()
        try:
            session.execute(q)
            what = "answered"
        except Exception as exc:  # noqa: BLE001 -- a shape may fail
            what = f"failed ({type(exc).__name__})"
        log(f"warm-up template {tid}: {what} in "
            f"{time.monotonic() - t:.3f} s")
    futs = [door.submit(QueryGraph.make(e))
            for e, _t in traffic.warmup_queries(mix)]
    for f in futs:
        try:
            f.result(timeout=600)
        except Exception:  # noqa: BLE001 -- its outcome was logged above
            pass


# ----------------------------------------------------------------------
# The window
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Req:
    index: int
    tid: int
    edges: watdiv.Query
    check: bool
    due: float = 0.0
    sent: float = 0.0
    done: Optional[float] = None
    outcome: str = "pending"
    comm: int = 0
    answer: Optional[Dict] = None
    error: str = ""


def settle(r: Req, fut, until: float, stamped: bool) -> None:
    """Wait for ``r``'s answer until ``until`` and record its outcome;
    ``stamped`` takes the completion time from the door's latency
    stamp, else from the clock when the wait returns."""
    from repro_torch.serve import DeadlineExceededError
    try:
        res = fut.result(timeout=max(0.0, until - time.monotonic()))
    except TimeoutError:
        r.outcome = "unresolved"
        return
    except DeadlineExceededError as exc:
        r.outcome, r.error = "deadline", str(exc)[:300]
        return
    except Exception as exc:  # noqa: BLE001 -- the engine's refusal
        r.outcome = "failed"
        r.error = f"{type(exc).__name__}: {exc}"[:300]
        return
    r.done = (r.sent + fut.latency_s) if stamped else time.monotonic()
    r.outcome = "completed"
    r.comm = int(res.stats.comm_bytes)
    if r.check:
        r.answer = res.bindings


class Profiled:
    """The profiled part of a traced window: its last third or last
    ``PROFILE_MAX_S``, marked by a ``MARK`` host span.  The profiler
    starts before the window (its warm-up takes a second or more), the
    thread that keeps the window's time starts and ends the mark, and
    ``finish`` stops the profiler once the door is closed, since reading
    its events holds the interpreter for seconds.  The join wrappers
    count only inside the mark."""

    MARK = "rdfbench.profiled"

    def __init__(self, on: bool, device: str, counting, seconds: float):
        self.device, self.counting = device, counting
        self.span = min(PROFILE_MAX_S, seconds / 3)
        self.start_at = math.inf
        self.prof = devtrace.profiler(device) if on else None
        self._mark = None
        self.state = "warm" if on else "off"

    def begin(self, t0: float, seconds: float) -> None:
        self.start_at = t0 + seconds - self.span

    def tick(self, now: float) -> None:
        """Start the mark once its time has come; at ``math.inf`` (the
        window's close) end it."""
        if self.state == "warm" and now >= self.start_at:
            import torch
            self.prof.step()
            self._mark = torch.profiler.record_function(self.MARK)
            self._mark.__enter__()
            self.counting.recording = True
            self.state = "marking"
        if self.state == "marking" and now == math.inf:
            self.counting.recording = False
            self._mark.__exit__(None, None, None)
            self.state = "marked"

    def finish(self) -> Optional[devtrace.TraceSummary]:
        """Stop the profiler and summarise the marked part."""
        if self.state != "marked":
            return None
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.prof.step()
        self.prof.stop()
        self.state = "done"
        return devtrace.summarize(devtrace.records(self.prof), self.MARK)


def closed_window(door, requests: traffic.Requests, mix: Dict,
                  seconds: float, prof: Profiled, t0: float) -> List[Req]:
    """``clients`` callers, each sending its next request when its last
    one is answered, until the window closes."""
    from repro_torch.core import QueryGraph
    from repro_torch.serve import ShedError
    t1 = t0 + seconds
    backoff = float(mix["shed_backoff_ms"]) / 1e3
    reqs: List[Req] = []

    def client() -> None:
        while time.monotonic() < t1:
            i, edges, tid, check = requests.next()
            r = Req(i, tid, edges, check)
            reqs.append(r)
            r.due = r.sent = time.monotonic()
            try:
                fut = door.submit(QueryGraph.make(edges))
            except ShedError as exc:
                r.outcome, r.error = "shed", str(exc)[:300]
                time.sleep(backoff)
                continue
            settle(r, fut, t1 + GRACE_S, stamped=False)

    threads = [threading.Thread(target=client, daemon=True,
                                name=f"rdfbench-client-{k}")
               for k in range(int(mix["clients"]))]
    for t in threads:
        t.start()
    while (now := time.monotonic()) < t1:
        prof.tick(now)
        time.sleep(min(0.02, max(t1 - now, 0.0)))
    prof.tick(math.inf)
    for t in threads:
        t.join(timeout=max(0.0, t1 + GRACE_S + 5.0 - time.monotonic()))
    return reqs


def open_window(door, requests: traffic.Requests, offsets: np.ndarray,
                seconds: float, prof: Profiled, t0: float
                ) -> Tuple[List[Req], np.ndarray]:
    """One request at each offset, sent whatever the door does; returns
    the requests and how late each was sent."""
    from repro_torch.core import QueryGraph
    from repro_torch.serve import ShedError
    t1 = t0 + seconds
    todo = []
    for off in offsets:
        i, edges, tid, check = requests.next()
        todo.append((Req(i, tid, edges, check, due=t0 + float(off)),
                     QueryGraph.make(edges)))
    pend = []
    late = np.zeros(len(todo))
    for k, (r, q) in enumerate(todo):
        prof.tick(time.monotonic())
        wait = r.due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        r.sent = time.monotonic()
        late[k] = r.sent - r.due
        try:
            pend.append((r, door.submit(q)))
        except ShedError as exc:
            r.outcome, r.error = "shed", str(exc)[:300]
    while (now := time.monotonic()) < t1:
        prof.tick(now)
        time.sleep(min(0.02, max(t1 - now, 0.0)))
    prof.tick(math.inf)
    for r, fut in pend:
        settle(r, fut, t1 + GRACE_S, stamped=True)
    return [r for r, _q in todo], late


# ----------------------------------------------------------------------
# Judging
# ----------------------------------------------------------------------

def judge(index: reference.GraphIndex, reqs: List[Req], max_capacity: int,
          answers: Optional[Callable] = None) -> Dict[str, int]:
    """Hold each checked request's outcome against the reference: an
    answer must equal the whole graph's, a refusal is sound only where
    a connected part of the query's constant-free pattern matches more
    than ``max_capacity`` rows, and every request must resolve.
    ``answers`` puts another answerer (the control) in the program's
    place for the requests the program answered."""
    peaks: Dict = {}
    wrong = compared = 0
    notes: List[str] = []
    sizes: Dict[int, List[int]] = {}
    for r in reqs:
        if not r.check or r.outcome in ("shed", "deadline") or (
                answers is not None and r.outcome != "completed"):
            continue
        compared += 1
        if r.outcome == "completed":
            got = (answers(r.edges) if answers is not None
                   else reference.rows_of(r.answer))
            want = reference.match(index, r.edges)
            sizes.setdefault(r.tid, []).append(len(want[1]))
            ok = reference.same_answer(got, want)
        elif r.outcome == "failed":
            key = reference.normalized(r.edges)
            if key not in peaks:
                peaks[key] = reference.pattern_peak(index, r.edges)
            ok = peaks[key] is not None and peaks[key] > max_capacity
        else:
            ok = False
        if not ok:
            wrong += 1
            if len(notes) < 5:
                notes.append(f"request {r.index} (template {r.tid}, "
                             f"{r.outcome}) {r.edges} {r.error}")
    for n in notes:
        log(f"wrong outcome: {n}")
    for key, peak in peaks.items():
        log(f"refused pattern {key}: largest connected part matches "
            f"{peak} rows, max_capacity {max_capacity}")
    log("checked answers by template (count, non-empty, median rows, "
        "most rows): " + "; ".join(
            f"t{tid} {len(v)} {sum(n > 0 for n in v)} "
            f"{int(np.median(v))} {max(v)}"
            for tid, v in sorted(sizes.items())))
    return {"wrong_outcomes": wrong, "compared": compared, "sizes": sizes}


# ----------------------------------------------------------------------
# Metrics and the result
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What a per-layer reader may read."""
    plan_s: float
    completed: int
    door: Dict[str, float]
    engine: Dict[str, float]
    trace: Optional[devtrace.TraceSummary]
    join_bytes: int
    device_kind: str


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def end_to_end(reqs: List[Req], loop: str, t1: float, seconds: float
               ) -> Tuple[Dict[str, float], List[Req]]:
    """The end-to-end metrics this loop defines, and the requests they
    count as completed in the window."""
    if loop == "closed":
        done = [r for r in reqs if r.outcome == "completed"
                and r.done <= t1]
        out = {"qps": len(done) / seconds}
    else:
        done = [r for r in reqs if r.outcome == "completed"]
        out = {}
        # a request with no answer waits at least until the waiting ends
        lat = [(r.done if r.outcome == "completed" else t1 + GRACE_S)
               - r.due for r in reqs]
        if lat:
            log("latency from the due time: " + ", ".join(
                f"p{q} {percentile(lat, q / 100) * 1e3:.3f} ms"
                for q in (50, 90, 95, 99)))
    if done:
        out["shipped_bytes_per_query"] = sum(r.comm for r in done) / len(done)
    return out, done


def delta(after: Dict, before: Dict) -> Dict[str, float]:
    return {k: float(after[k]) - float(before.get(k, 0.0))
            for k in after if isinstance(after[k], (int, float))}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Outcome:
    """A finished window, the program's state freed."""
    reqs: List[Req]
    e2e: Dict[str, float]
    run: Run
    peak: int
    graph_cols: Tuple


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str, t_start: float) -> Outcome:
    """Set up, warm up, run the window and free the program's state."""
    import torch
    from repro_torch.core import spmd
    cfg, mix = cell.config, cell.mix
    system = build_system(cfg, seed, device)
    session = system.session
    door = session.serve()
    door.start()
    t = time.monotonic()
    warm_up(session, door, mix)
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"warm-up: {time.monotonic() - t:.3f} s")
    t = time.monotonic()
    requests = traffic.Requests(mix, system.graph_cols, system.perm, seed)
    log(f"binding domains: {time.monotonic() - t:.3f} s; vertices per "
        "template variable: " + "; ".join(
            f"t{i} " + " ".join(str(len(d)) for d in doms.values())
            for i, doms in enumerate(requests.domains)))
    offsets = traffic.arrivals(mix, seconds, seed)
    counting = roofline.CountingJoins()
    door0, eng0 = door.stats(), session.stats().extra
    prof = Profiled(trace, device, counting, seconds)
    with counting.installed(spmd) if trace else contextlib.nullcontext():
        t0 = time.monotonic()
        setup_s = t0 - t_start
        prof.begin(t0, seconds)
        if mix["loop"] == "closed":
            reqs = closed_window(door, requests, mix, seconds, prof, t0)
        else:
            reqs, late = open_window(door, requests, offsets, seconds, prof,
                                     t0)
            log(f"generator lateness: p50 {np.percentile(late, 50) * 1e3:.3f}"
                f" ms, p99 {np.percentile(late, 99) * 1e3:.3f} ms, max "
                f"{late.max(initial=0.0) * 1e3:.3f} ms over {len(late)} "
                f"arrivals")
        door1, eng1 = door.stats(), session.stats().extra
        door.close()
        join_bytes = counting.bytes()
    if device == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, device
    summary = prof.finish()
    if summary is not None:
        log(f"trace: {summary.window_s:.3f} s profiled, device busy "
            f"{summary.busy_s:.6f} s, join kernels "
            f"{summary.join_device_s:.6f} s, {counting.calls} join calls, "
            f"{join_bytes} bytes")
    del door, session
    system.session = None
    if device == "cuda":
        torch.cuda.empty_cache()
    t1 = t0 + seconds
    e2e, done = end_to_end(reqs, mix["loop"], t1, seconds)
    e2e["setup_s"] = setup_s
    outcomes = {k: sum(r.outcome == k for r in reqs)
                for k in ("completed",) + FAILED}
    log(f"window: {len(reqs)} requests, outcomes {outcomes}, "
        f"{len(done)} completed in the window, " + ", ".join(
            f"{k}={v}" for k, v in sorted(e2e.items())))
    for e in sorted({r.error for r in reqs if r.error})[:3]:
        log(f"error: {e}")
    run = Run(system.plan_s, len(done), delta(door1, door0),
              delta(eng1, eng0), summary, join_bytes, kind)
    return Outcome(reqs, e2e, run, peak, system.graph_cols)


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None,
         benchmark: Path = ROOT / "BENCHMARK.json",
         bench_dir: Path = BENCH_DIR) -> int:
    t_start = time.monotonic() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="rdfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, benchmark, bench_dir)
    device = require_device(cell.chips)
    res = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                  t_start)
    t = time.monotonic()
    checks = judge(reference.GraphIndex(*res.graph_cols), res.reqs,
                   int(cell.config["spmd_max_capacity"]))
    log(f"judged in {time.monotonic() - t:.3f} s")
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"], bench_dir)(res.run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res.e2e[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in res.e2e}
    # a metric with no reading (no request answered) fails the run
    missing = [m["name"] for m in cell.end_to_end if m["name"] not in res.e2e]
    if missing:
        log(f"no reading of {missing}: no request was answered")
    found = forbidden_modules()
    if found:
        log(f"rdfbench: the run loaded {found}; no result")
        return 3
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": res.run.device_kind, "count": cell.chips,
                   "memory_peak_bytes": res.peak}
    out = {"correct": checks["compared"] >= 1 and not missing
           and checks["wrong_outcomes"] == 0,
           "attempted": len(res.reqs),
           "failed": sum(r.outcome in FAILED for r in res.reqs),
           "metrics": metrics, "device": device_info}
    if res.run.trace is not None:
        device_info["busy_s"] = res.run.trace.busy_s
        device_info["window_s"] = res.run.trace.window_s
        out["breakdown"] = {"device_ops": res.run.trace.device_ops,
                            "idle_gaps": res.run.trace.idle_gaps}
    out["checks"] = {
        "wrong_outcomes": {"value": checks["wrong_outcomes"], "limit": 0},
        "compared": {"value": checks["compared"], "at_least": 1}}
    log(f"check wrong_outcomes {checks['wrong_outcomes']} limit 0")
    log(f"check compared {checks['compared']} at least 1")
    print(json.dumps(out), flush=True)
    return 0
