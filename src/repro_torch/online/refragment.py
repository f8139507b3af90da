"""Incremental re-mining + re-selection, warm-started from the current
FAP set.

The heavy lifting of §4-§6 is reused verbatim (``core.mining``,
``core.selection``, ``core.fragmentation``, ``core.allocation``); what
makes this *incremental* rather than from-scratch is the input and the
seeds:

* mining runs over the monitor's bounded deduped shape table (a few
  hundred shapes with decayed multiplicities), never over the raw query
  log -- the monitor already did the workload compression that makes the
  offline pipeline tractable, continuously;
* the incumbent selected patterns are injected as candidates with their
  support recomputed on the live distribution, so Algorithm 1 can retain
  them without pattern growth having to rediscover them, and an
  incumbent's fragment that survives selection is a zero-byte migration
  (it is already materialized on some site);
* hot/cold property classification (Def. 5) comes from the monitor's
  decayed incidence masses, and minterm predicate mining (§5.2) from its
  raw-query reservoir.

The returned allocation is the *desired* placement; the migration
planner (``online.migration``) decides how much of it to realize within
the byte budget.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Set

import numpy as np

from ..core.allocation import (Allocation, ReplicationPlan,
                               allocate_fragments, plan_replication,
                               workload_property_heat)
from ..core.fragmentation import Fragmentation
from ..core.graph import RDFGraph
from ..core.matching import _PropIndex, match_edge_ids
from ..core.mining import (FrequentPattern, mine_frequent_patterns_deduped,
                           usage_matrix)
from ..core.plan import STRATEGIES, PartitionConfig
from ..core.query import QueryGraph, is_subgraph_of
from ..core.selection import select_patterns
from .monitor import WorkloadMonitor


@dataclasses.dataclass
class RefragmentResult:
    frag: Fragmentation
    desired_alloc: Allocation        # pre-migration-budget placement
    selected_patterns: List[QueryGraph]
    cold_props: Set[int]
    sel_usage: np.ndarray            # usage matrix over selected patterns
    weights: np.ndarray              # snapshot multiplicities
    num_mined: int
    num_incumbents_kept: int
    elapsed_sec: float
    # desired replication set re-ranked on the live heat (None when the
    # config's replication budget is 0); the migration planner decides
    # how much of the diff to ship this epoch
    desired_replication: Optional[ReplicationPlan] = None
    # sites whose decayed load share exceeds the monitor's hot-site
    # factor (AdPart-style): routed execution concentrates load on the
    # fragment holders, so a persistently hot site means its shards
    # should be split/replicated -- the migration planner gets them
    # flagged here and can prioritize moves off them within budget
    hot_sites: tuple = ()


def warm_mine(uniq: Sequence[QueryGraph], weights: np.ndarray, min_sup: int,
              max_edges: int, incumbents: Sequence[QueryGraph]
              ) -> List[FrequentPattern]:
    """Mine the live snapshot, then merge incumbent patterns (support
    recomputed live) so selection sees them even when decayed support
    dips below minSup -- incumbents are already materialized, so keeping
    a borderline one is free while dropping it costs a migration."""
    fps = mine_frequent_patterns_deduped(uniq, weights, min_sup, max_edges)
    have = {fp.pattern.canonical_code() for fp in fps}
    for pat in incumbents:
        code = pat.canonical_code()
        if code in have:
            continue
        sup_set = {qi for qi, q in enumerate(uniq) if is_subgraph_of(pat, q)}
        sup = int(weights[sorted(sup_set)].sum()) if sup_set else 0
        fps.append(FrequentPattern(pat, sup, sup_set))
        have.add(code)
    return fps


def refragment(graph: RDFGraph, monitor: WorkloadMonitor,
               config: PartitionConfig,
               incumbent_patterns: Sequence[QueryGraph],
               replica_bytes_per_edge: Optional[float] = None
               ) -> RefragmentResult:
    """One re-partitioning pass over the monitor's live distribution.
    ``replica_bytes_per_edge`` prices the desired replication set in the
    caller's shipping unit (``AdaptiveConfig.bytes_per_edge``), so
    replica diffs and fragment moves compete in the same currency
    inside the migration budget; default: the offline pass's unit."""
    t0 = time.perf_counter()
    cfg = config
    uniq, weights = monitor.snapshot()
    if not uniq:
        raise ValueError("monitor has no observed queries to refragment on")
    total = int(weights.sum())
    min_sup = max(int(total * cfg.min_sup_fraction), 1)

    # --- mine (§4), warm-started ---
    fps = warm_mine(uniq, weights, min_sup, cfg.max_pattern_edges,
                    incumbent_patterns)

    # --- live hot/cold split (Def. 5 on decayed incidence) ---
    fprops = monitor.hot_properties(cfg.theta_fraction)
    have = {fp.pattern.canonical_code() for fp in fps if fp.num_edges == 1}
    for prop in fprops:
        pat = QueryGraph.make([(-1, -2, prop)])
        if pat.canonical_code() not in have:
            sup = sum(int(w) for q, w in zip(uniq, weights)
                      if prop in q.properties())
            fps.append(FrequentPattern(pat, sup, set()))
    cold_props = set(range(graph.num_properties)) - set(fprops)

    # --- select (§4.1) ---
    patterns = [fp.pattern for fp in fps]
    U = usage_matrix(patterns, uniq)
    idx = _PropIndex(graph)
    frag_sizes = np.array(
        [len(match_edge_ids(graph, p, index=idx, max_rows=cfg.max_rows))
         for p in patterns], dtype=np.int64)
    hot_ids, cold_ids = graph.hot_cold_split(fprops)
    sc = max(int(len(hot_ids) * cfg.storage_factor),
             int(frag_sizes[[i for i, fp in enumerate(fps)
                             if fp.num_edges == 1]].sum()) + 1)
    sel = select_patterns(fps, U, weights, frag_sizes, sc, fprops)
    selected = [patterns[i] for i in sel.selected]
    sel_U = U[:, sel.selected]
    kept = sum(1 for p in selected
               if p.canonical_code() in {q.canonical_code()
                                         for q in incumbent_patterns})

    # --- fragment (§5) on the live hot/cold split, dispatched through
    # the strategy registry's refragment hooks so registered strategies
    # join the adaptive loop without this module hardcoding kinds ---
    frag = STRATEGIES.get_refragment(cfg.kind)(
        graph, selected, monitor.raw_sample(), cfg, cold_ids, idx)

    # --- allocate (§6): desired placement, pre-budget; the data
    # dictionary is built by the caller against the *realized*
    # (post-migration-budget) placement ---
    alloc = allocate_fragments(frag, sel_U, weights, cfg.num_sites,
                               cfg.balance_factor)

    # --- replication (beyond-paper): re-rank the replicated property
    # set on the *live* heat, same budget knob as the offline pass; the
    # migration planner ships the diff within its own byte budget ---
    repl = None
    if cfg.replication_budget_bytes > 0:
        heat = workload_property_heat(uniq, weights, graph.num_properties)
        kw = ({"bytes_per_edge": float(replica_bytes_per_edge)}
              if replica_bytes_per_edge is not None else {})
        repl = plan_replication(graph, cfg.num_sites,
                                cfg.replication_budget_bytes, heat, **kw)

    # --- hot-shard flagging (AdPart-style): surface the sites whose
    # decayed load share runs hot so the migration planner can
    # prioritize splitting/rebalancing their fragments ---
    hot = tuple(monitor.hot_sites())
    return RefragmentResult(frag, alloc, selected, cold_props,
                            sel_U, weights, len(fps), kept,
                            time.perf_counter() - t0, repl, hot)
