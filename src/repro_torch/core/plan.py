"""``PartitionPlan``: the product of the offline phase (mine -> select ->
fragment -> allocate, plus the budgeted replication pass), detached
from any engine, and ``build_plan`` that produces one.

Only the vertical strategy (§5.1) is ported so far; the horizontal
strategy, the SHAPE/WARP baselines, the data dictionary and plan
save/load come in later slices.  Host-side planning is numpy, exactly
as in the reference, so the same seeds give the same plan.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Set, Union

import numpy as np
import torch

from .allocation import (Allocation, ReplicationPlan, allocate_fragments,
                         fap_property_heat, plan_replication,
                         replicated_edge_ids, workload_property_heat)
from .executor import CostModel
from .fragmentation import Fragmentation, build_fragmentation
from .graph import RDFGraph
from .matching import _PropIndex, match_edge_ids
from .mining import (FrequentPattern, frequent_properties,
                     mine_frequent_patterns_deduped, usage_matrix)
from .query import QueryGraph
from .selection import SelectionResult, select_patterns
from .workload import Workload

#: fragmentation strategies this package can build
STRATEGIES = ("vertical",)


@dataclasses.dataclass
class PartitionConfig:
    """Offline-phase knobs: strategy (``kind``), cluster width
    (``num_sites``), and the paper's mining/selection thresholds (the
    inline comments cite the sections)."""
    min_sup_fraction: float = 0.001   # minSup as a fraction of |Q| (§8.2)
    theta_fraction: float = 0.001     # hot-property threshold (Def. 5)
    storage_factor: float = 1.6       # SC = factor * |E(hot)| (§4.1.2)
    kind: str = "vertical"
    num_sites: int = 10               # paper's cluster size
    max_pattern_edges: int = 6
    per_pattern_predicates: int = 2   # simple predicates per FAP (§5.2)
    num_cold_parts: int = 2
    balance_factor: float = 0.0       # 0 = faithful Algorithm 2
    max_rows: int = 5_000_000
    replication_budget_bytes: int = 0  # 0 = no replication (paper-faithful)

    def __post_init__(self) -> None:
        if self.kind not in STRATEGIES:
            raise ValueError(
                f"unknown or not yet ported fragmentation strategy "
                f"kind={self.kind!r}; available: {list(STRATEGIES)}")
        if self.num_sites < 1:
            raise ValueError(f"num_sites must be >= 1, got {self.num_sites}")
        if self.replication_budget_bytes < 0:
            raise ValueError(f"replication_budget_bytes must be >= 0, got "
                             f"{self.replication_budget_bytes}")


@dataclasses.dataclass
class OfflineStats:
    """Timing + quality provenance of one offline run."""
    mine_sec: float
    select_sec: float
    fragment_sec: float
    allocate_sec: float
    num_patterns_mined: int
    num_patterns_selected: int
    num_fragments: int
    redundancy_ratio: float
    hit_rate: float                    # fraction of workload hit by FAPs
    benefit: float


@dataclasses.dataclass(eq=False)
class PartitionPlan:
    """Fragmentation + allocation + selected FAPs + config provenance.
    ``graph`` is attached: fragments store edge ids into it."""

    strategy: str
    config: PartitionConfig
    graph: RDFGraph
    selected_patterns: List[QueryGraph]
    frag: Fragmentation
    alloc: Allocation
    cold_props: Set[int]
    design_workload: Workload
    sel_usage: np.ndarray              # deduped usage over selected
    weights: np.ndarray                # deduped query multiplicities
    stats: OfflineStats
    selection: SelectionResult
    # properties replicated to every site by the budgeted replication
    # pass (their join steps are shard-complete under SPMD serving)
    replicated_props: Set[int] = dataclasses.field(default_factory=set)
    replication: Optional[ReplicationPlan] = None

    @property
    def num_sites(self) -> int:
        """Logical cluster width the plan allocates over."""
        return self.config.num_sites

    def site_edge_ids(self) -> List[np.ndarray]:
        """Edge ids resident per site: hot fragments follow the
        allocation, cold fragments ride round-robin, and edges of
        ``replicated_props`` land on every site."""
        per_site: List[List[np.ndarray]] = [[] for _ in range(self.num_sites)]
        for fi, f in enumerate(self.frag.fragments):
            per_site[int(self.alloc.site_of[fi])].append(f.edge_ids)
        for k, f in enumerate(self.frag.cold_fragments):
            per_site[k % self.num_sites].append(f.edge_ids)
        if self.replicated_props:
            rep = replicated_edge_ids(self.graph, self.replicated_props)
            for g in per_site:
                g.append(rep)
        return [np.unique(np.concatenate(g)) if g
                else np.zeros(0, np.int64) for g in per_site]

    def build_spmd_engine(self, device: Union[str, torch.device] = "cuda",
                          num_devices: Optional[int] = None,
                          capacity: int = 4096,
                          cost: Optional[CostModel] = None,
                          max_capacity: Optional[int] = None,
                          comm_plan: bool = True,
                          routing: bool = True):
        """Build the ``SpmdEngine`` over this plan's per-site storage.

        Args:
            device: where the store lives and the joins run ("cuda" by
                default; "cpu" runs the kernels' plain versions).
            num_devices: width of the site axis the logical sites fold
                onto (default: one slot per logical site).
            capacity: starting per-site binding-table rows (doubled
                transparently on overflow).
            cost: optional ``CostModel``.
            max_capacity: retry-ladder ceiling; overflow past it raises.
            comm_plan: size-aware per-join-step communication planning.
            routing: per-query site routing (requires ``comm_plan``).
        """
        from .spmd import SpmdEngine
        return SpmdEngine(self.graph, self.site_edge_ids(), device=device,
                          num_devices=num_devices, capacity=capacity,
                          cost=cost, max_capacity=max_capacity,
                          comm_plan=comm_plan,
                          replicated_props=set(self.replicated_props),
                          routing=routing)


def _replication_pass(graph: RDFGraph, cfg: PartitionConfig,
                      workload: Workload, patterns: List[QueryGraph],
                      usage: np.ndarray, weights: np.ndarray
                      ) -> Optional[ReplicationPlan]:
    """The budgeted replication pass: heat from the selected FAPs'
    workload-weighted usage, else from the raw design workload.
    ``None`` when the budget is 0 (paper-faithful)."""
    if cfg.replication_budget_bytes <= 0:
        return None
    heat = None
    if len(patterns):
        heat = fap_property_heat(patterns, usage, weights,
                                 graph.num_properties)
    if heat is None or not heat.any():
        uniq, w = workload.dedup_normalized()
        heat = workload_property_heat(uniq, w, graph.num_properties)
    return plan_replication(graph, cfg.num_sites,
                            cfg.replication_budget_bytes, heat)


def build_plan(graph: RDFGraph, workload: Workload,
               config: Optional[PartitionConfig] = None) -> PartitionPlan:
    """Run the offline phase: mine (§4) -> select (§4.1, Algorithm 1) ->
    vertical fragmentation (§5.1) -> allocation (§6, Algorithm 2), plus
    the replication pass when the config budgets one.

    Args:
        graph: the RDF graph to fragment.
        workload: the design query workload.
        config: ``PartitionConfig`` (vertical over 10 sites by default).

    Returns:
        A ``PartitionPlan`` with the graph attached, ready for
        ``Session``.
    """
    cfg = config or PartitionConfig()
    min_sup = max(int(len(workload) * cfg.min_sup_fraction), 1)
    theta = max(int(len(workload) * cfg.theta_fraction), 1)

    t0 = time.perf_counter()
    uniq, weights = workload.dedup_normalized()
    fps = mine_frequent_patterns_deduped(uniq, weights, min_sup,
                                         cfg.max_pattern_edges)
    t_mine = time.perf_counter() - t0

    # integrity: add 1-edge patterns for every frequent property
    fprops = frequent_properties(workload, theta)
    have = {fp.pattern.canonical_code() for fp in fps if fp.num_edges == 1}
    for prop in fprops:
        pat = QueryGraph.make([(-1, -2, prop)])
        if pat.canonical_code() not in have:
            sup = sum(int(w) for q, w in zip(uniq, weights)
                      if prop in q.properties())
            fps.append(FrequentPattern(pat, sup, set()))
    cold_props = set(range(graph.num_properties)) - set(fprops)

    t0 = time.perf_counter()
    patterns = [fp.pattern for fp in fps]
    U = usage_matrix(patterns, uniq)
    idx = _PropIndex(graph)
    frag_sizes = np.array(
        [len(match_edge_ids(graph, p, index=idx, max_rows=cfg.max_rows))
         for p in patterns], dtype=np.int64)
    hot_ids, _ = graph.hot_cold_split(fprops)
    sc = max(int(len(hot_ids) * cfg.storage_factor),
             int(frag_sizes[[i for i, fp in enumerate(fps)
                             if fp.num_edges == 1]].sum()) + 1)
    sel = select_patterns(fps, U, weights, frag_sizes, sc, fprops)
    selected = [patterns[i] for i in sel.selected]
    sel_U = U[:, sel.selected]
    t_sel = time.perf_counter() - t0
    hit = float((sel_U.max(axis=1) > 0) @ weights) / max(weights.sum(), 1)

    t0 = time.perf_counter()
    frag = build_fragmentation(graph, workload, selected, theta,
                               cfg.num_cold_parts, cfg.max_rows)
    t_frag = time.perf_counter() - t0

    t0 = time.perf_counter()
    alloc = allocate_fragments(frag, sel_U, weights, cfg.num_sites,
                               cfg.balance_factor)
    t_alloc = time.perf_counter() - t0

    stats = OfflineStats(t_mine, t_sel, t_frag, t_alloc, len(fps),
                         len(sel.selected), len(frag.fragments),
                         frag.redundancy_ratio(graph), hit, sel.benefit)
    repl = _replication_pass(graph, cfg, workload, selected, sel_U, weights)
    return PartitionPlan(
        strategy=cfg.kind, config=cfg, graph=graph,
        selected_patterns=selected, frag=frag, alloc=alloc,
        cold_props=cold_props, design_workload=workload,
        sel_usage=sel_U, weights=weights, stats=stats, selection=sel,
        replicated_props=(repl.prop_set if repl is not None else set()),
        replication=repl)
