"""Distributed query processing (§7.3): execute a decomposed query over
the fragment allocation.

Two engines share one planner (Algorithms 3+4):

* ``DistributedEngine`` -- the paper's exact host engine over the
  allocation, in numpy on the host as in the reference (it runs on no
  accelerator there either).  Each site runs its subqueries on its
  local fragments (the paper's per-site gStore call), intermediate
  binding tables are joined along the optimized left-deep plan, and
  every cross-site shipment is accounted in bytes.  A calibrated cost
  model turns (scanned edges, produced rows, shipped bytes) into
  simulated wall-clock, giving the response-time/throughput benchmarks
  their numbers (§8.3-8.5).

* ``SpmdEngine`` (``core/spmd.py``) -- the sites in lock step on the
  GPU, fragments resident per site, fixed-capacity binding tables with
  overflow auto-retry and the CUDA join kernels in the match loop --
  exact on any number of sites.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .allocation import Allocation
from .decomposition import Decomposition, decompose
from .dictionary import DataDictionary
from .engine import EngineBase, EngineStats
from .fragmentation import Fragment, Fragmentation
from .graph import RDFGraph
from .matching import MatchResult, _PropIndex, match_pattern
from .optimizer import JoinPlan, optimize
from .query import QueryGraph


# ----------------------------------------------------------------------
# Cost model constants (calibrated on this host; relative numbers --
# orderings, not absolute cluster wall-clock -- are what we validate
# against the paper).
# ----------------------------------------------------------------------
@dataclasses.dataclass
class CostModel:
    sec_per_edge_scan: float = 2.0e-8      # per fragment edge visited
    sec_per_result_row: float = 5.0e-8     # per binding row produced
    bytes_per_row_col: float = 4.0         # int32 columns
    network_bytes_per_sec: float = 1.0e9   # 1 GB/s cluster links
    network_latency_sec: float = 2.0e-4    # per message
    join_sec_per_row: float = 3.0e-8


@dataclasses.dataclass
class ExecStats:
    response_time: float
    comm_bytes: int
    sites_touched: Set[int]
    per_site_busy: Dict[int, float]
    result_rows: int
    decomposition_size: int


@dataclasses.dataclass
class QueryResult:
    bindings: Dict[int, np.ndarray]
    num_rows: int
    stats: ExecStats


# ----------------------------------------------------------------------
# Binding-table join (hash join on shared variables)
# ----------------------------------------------------------------------

def join_bindings(left: Dict[int, np.ndarray], right: Dict[int, np.ndarray]
                  ) -> Dict[int, np.ndarray]:
    lvars = set(left)
    rvars = set(right)
    shared = sorted(lvars & rvars)
    ln = len(next(iter(left.values()))) if left else 0
    rn = len(next(iter(right.values()))) if right else 0
    if not shared:
        # cartesian product
        li = np.repeat(np.arange(ln), rn)
        ri = np.tile(np.arange(rn), ln)
    else:
        def keys(cols: Dict[int, np.ndarray], n: int) -> np.ndarray:
            k = np.zeros(n, dtype=np.int64)
            for v in shared:
                k = k * 2_000_003 + cols[v].astype(np.int64)
            return k
        lk, rk = keys(left, ln), keys(right, rn)
        order = np.argsort(rk, kind="stable")
        rks = rk[order]
        lo = np.searchsorted(rks, lk, side="left")
        hi = np.searchsorted(rks, lk, side="right")
        counts = hi - lo
        li = np.repeat(np.arange(ln), counts)
        if len(li):
            starts = np.repeat(lo, counts)
            offs = np.arange(len(starts)) - np.repeat(
                np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
            ri = order[starts + offs]
        else:
            ri = np.zeros(0, np.int64)
        # hash keys can collide; verify equality on actual columns
        ok = np.ones(len(li), dtype=bool)
        for v in shared:
            ok &= left[v][li] == right[v][ri]
        li, ri = li[ok], ri[ok]
    out: Dict[int, np.ndarray] = {v: c[li] for v, c in left.items()}
    for v, c in right.items():
        if v not in out:
            out[v] = c[ri]
    return out


def _nrows(cols: Dict[int, np.ndarray]) -> int:
    return len(next(iter(cols.values()))) if cols else 0


# ----------------------------------------------------------------------
# Host execution engine
# ----------------------------------------------------------------------

class DistributedEngine(EngineBase):
    """Fragment-resident distributed SPARQL engine (host-exact).  It
    computes in numpy on the host, as the reference's does: it is the
    paper's host engine, and the SPMD backend never gives way to it."""

    trace_name = "local"

    def __init__(self, graph: RDFGraph, frag: Fragmentation,
                 alloc: Allocation, dictionary: DataDictionary,
                 cold_props: Set[int], cost: Optional[CostModel] = None):
        # EngineBase provides post_execute_hooks: called as
        # hook(query, result) after every execute()
        self._init_engine_base()
        self.graph = graph
        self.frag = frag
        self.alloc = alloc
        self.dict = dictionary
        self.cold_props = cold_props
        self.cost = cost or CostModel()
        # materialize per-fragment subgraphs + their match indexes lazily
        self._frag_graphs: Dict[Tuple[str, int], RDFGraph] = {}
        self._frag_index: Dict[Tuple[str, int], _PropIndex] = {}

    @property
    def num_sites(self) -> int:
        return self.dict.num_sites

    # -- fragment access ------------------------------------------------
    def _fragment(self, kind: str, fi: int) -> Tuple[RDFGraph, _PropIndex]:
        key = (kind, fi)
        if key not in self._frag_graphs:
            f = (self.frag.fragments[fi] if kind == "hot"
                 else self.frag.cold_fragments[fi])
            sub = self.graph.subgraph(f.edge_ids)
            self._frag_graphs[key] = sub
            self._frag_index[key] = _PropIndex(sub)
        return self._frag_graphs[key], self._frag_index[key]

    def _relevant_fragments(self, sq: QueryGraph, pattern_id: Optional[int]
                            ) -> List[Tuple[str, int, int]]:
        """(kind, frag idx, site) of fragments that may hold matches.

        Horizontal pruning (§5.2/§8.4): a constant in the subquery rules
        out fragments whose minterm predicate contradicts it -- this is
        the paper's 'filter out irrelevant fragments' win.
        """
        out: List[Tuple[str, int, int]] = []
        if pattern_id is None:
            for ci in range(len(self.frag.cold_fragments)):
                site = self.dict.cold_sites[ci] if ci < len(self.dict.cold_sites) else 0
                out.append(("cold", ci, site))
            return out
        consts = sq.constant_bindings()  # normalized var -> constant
        from .query import find_embedding
        for fi in self.dict.frags_of_pattern.get(pattern_id, []):
            f = self.frag.fragments[fi]
            if f.minterm is not None and consts:
                emb = find_embedding(self.frag.patterns[pattern_id],
                                     sq.normalize())
                contradicted = False
                if emb is not None:
                    for t in f.minterm.terms:
                        qv = emb.get(t.var)
                        if qv is not None and qv in consts:
                            if t.equal and consts[qv] != t.value:
                                contradicted = True
                            if not t.equal and consts[qv] == t.value:
                                contradicted = True
                if contradicted:
                    continue
            out.append(("hot", fi, int(self.alloc.site_of[fi])))
        return out

    # -- query execution -------------------------------------------------
    def _execute(self, query: QueryGraph) -> QueryResult:
        cm = self.cost
        tr = self.tracer
        decomp = decompose(query, self.dict, self.cold_props)
        plan = optimize(decomp, self.dict)

        busy: Dict[int, float] = {}
        comm_bytes = 0
        sites_touched: Set[int] = set()
        n_msgs = 0

        # 1) per-subquery local matching at each relevant site
        sub_results: List[Dict[int, np.ndarray]] = []
        sub_home: List[int] = []
        for si, sq in enumerate(decomp.subqueries):
            pid = decomp.pattern_ids[si]
            rel = self._relevant_fragments(sq, pid)
            merged: Optional[Dict[int, np.ndarray]] = None
            best_site, best_rows = 0, -1
            with tr.span("site_match", subquery=si,
                         pattern_id=pid if pid is not None else -1,
                         fragments=len(rel)) as sp:
                for kind, fi, site in rel:
                    g, idx = self._fragment(
                        "hot" if kind == "hot" else "cold", fi)
                    res = match_pattern(g, sq, index=idx)
                    sites_touched.add(site)
                    busy[site] = busy.get(site, 0.0) + (
                        g.num_edges * cm.sec_per_edge_scan +
                        res.num_rows * cm.sec_per_result_row)
                    cols = {v: c for v, c in res.columns.items()}
                    if res.num_rows > best_rows:
                        best_rows, best_site = res.num_rows, site
                    if merged is None:
                        merged = cols
                    else:
                        merged = {v: np.concatenate([merged[v], cols[v]])
                                  for v in merged}
                if merged is None:
                    merged = {v: np.zeros(0, np.int32)
                              for v in sq.vertices() if v < 0}
                # overlap dedup: the same match may exist in several
                # fragments
                merged = _dedup_rows(merged)
                sp.set("rows", _nrows(merged))
                sp.set("sites", len({s for _, _, s in rel}))
            sub_results.append(merged)
            sub_home.append(best_site)

        # 2) join along the optimized plan; ship the smaller side
        order = plan.order
        acc = sub_results[order[0]]
        acc_site = sub_home[order[0]]
        join_time = 0.0
        for k in order[1:]:
            nxt = sub_results[k]
            nxt_site = sub_home[k]
            rows_acc, rows_nxt = _nrows(acc), _nrows(nxt)
            with tr.span("join", subquery=k, site=nxt_site) as sp:
                shipped = 0
                if nxt_site != acc_site:
                    ship_cols = (len(nxt), rows_nxt) if rows_nxt <= rows_acc \
                        else (len(acc), rows_acc)
                    if rows_nxt > rows_acc:
                        acc_site = nxt_site
                    shipped = int(ship_cols[0] * ship_cols[1]
                                  * cm.bytes_per_row_col)
                    comm_bytes += shipped
                    n_msgs += 1
                acc = join_bindings(acc, nxt)
                join_time += (_nrows(acc) + rows_acc + rows_nxt) \
                    * cm.join_sec_per_row
                busy[acc_site] = busy.get(acc_site, 0.0) + (
                    (_nrows(acc) + rows_acc + rows_nxt) * cm.join_sec_per_row)
                sp.set("shipped_bytes", shipped)
                sp.set("rows", _nrows(acc))

        # response time: parallel local phase (max over sites) + comm + joins
        local = max(busy.values()) if busy else 0.0
        comm = comm_bytes / cm.network_bytes_per_sec + n_msgs * cm.network_latency_sec
        rt = local + comm + join_time

        stats = ExecStats(rt, comm_bytes, sites_touched, busy,
                          _nrows(acc), len(decomp.subqueries))
        return self._finish(query, QueryResult(acc, _nrows(acc), stats))

    def _stats_extra(self) -> Dict[str, float]:
        return {"num_fragments": float(len(self.frag.fragments))}


def _dedup_rows(cols: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    if not cols:
        return cols
    n = _nrows(cols)
    if n == 0:
        return cols
    keys = np.zeros(n, dtype=np.int64)
    for v in sorted(cols):
        keys = keys * 2_000_003 + cols[v].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    first = np.ones(n, dtype=bool)
    first[1:] = ks[1:] != ks[:-1]
    keep = np.sort(order[first])
    return {v: c[keep] for v, c in cols.items()}


# ----------------------------------------------------------------------
# Throughput simulation (§8.3): list-scheduling of a query stream.
# Queries occupy only the sites their fragments live on, so queries with
# disjoint footprints run concurrently (the VF win); strategies touching
# all sites serialize.
# ----------------------------------------------------------------------

def simulate_throughput(engine, queries: Sequence[QueryGraph],
                        horizon_sec: float = 60.0) -> Tuple[float, List[ExecStats]]:
    """List-schedule the query stream; queries occupy only the sites they
    touch, so disjoint-footprint queries overlap (the VF win).  Accepts
    anything implementing the ``Engine`` protocol (``engine.num_sites``
    + ``execute``), including a ``Session``."""
    n_sites = engine.num_sites
    site_free = np.zeros(n_sites)
    stats: List[ExecStats] = []
    for q in queries:
        r = engine.execute(q)
        stats.append(r.stats)
        sites = sorted(r.stats.sites_touched) or [0]
        start = max(site_free[list(sites)]) if sites else 0.0
        finish = start + r.stats.response_time
        for s in sites:
            site_free[s] = finish
    makespan = float(site_free.max()) if len(queries) else 0.0
    qpm = len(queries) / max(makespan, 1e-9) * 60.0
    return qpm, stats
