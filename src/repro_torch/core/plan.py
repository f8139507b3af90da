"""``PartitionPlan``: the product of the offline phase, and the
``StrategyRegistry`` that produces one from any registered fragmentation
strategy.

* ``build_plan(graph, workload, config)`` dispatches on ``config.kind``
  through the strategy registry -- ``"vertical"`` / ``"horizontal"``
  (the paper's §5), ``"shape"`` / ``"warp"`` (the §8 baselines) -- and
  returns a ``PartitionPlan`` bundling fragmentation, allocation, data
  dictionary, selected FAPs, the design workload and the config.
* New strategies are one ``@register_strategy("name")`` away; config
  validation lists whatever is registered.

Engines are *built from* plans (``build_local_engine`` etc. -- the
``Session`` facade picks per backend); a plan itself holds no device
state.  Host-side planning is numpy, exactly as in the reference, so
the same seeds give the same plan.  Plan save/load and the warm start
from an incumbent plan are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from .allocation import (Allocation, ReplicationPlan, allocate_fragments,
                         fap_property_heat, plan_replication,
                         property_site_map, replicated_edge_ids,
                         workload_property_heat)
from .baselines import (BaselineEngine, BaselineFragmentation,
                        shape_fragmentation, warp_fragmentation)
from .dictionary import DataDictionary
from .executor import CostModel, DistributedEngine
from .fragmentation import (Fragmentation, build_fragmentation,
                            horizontal_fragmentation,
                            vertical_fragmentation)
from .graph import RDFGraph
from .matching import _PropIndex, match_edge_ids
from .mining import (FrequentPattern, frequent_properties,
                     mine_frequent_patterns_deduped, usage_matrix)
from .query import QueryGraph
from .selection import SelectionResult, select_patterns
from .workload import Workload


# ----------------------------------------------------------------------
# Strategy registry
# ----------------------------------------------------------------------

class StrategyRegistry:
    """Name -> plan function(graph, workload, config) -> PartitionPlan.

    A strategy may additionally register a *re-fragmentation hook*
    (``register_refragment``): how an adaptive loop rebuilds this
    strategy's fragment set from a live snapshot --
    ``hook(graph, selected, sample, config, cold_ids, index)`` ->
    ``Fragmentation``, where ``sample`` is a raw-query reservoir
    (minterm predicate mining, §5.2) and ``index`` a shared
    ``_PropIndex``.  The online loop that calls the hooks is not ported
    yet; the hooks are.
    """

    def __init__(self) -> None:
        self._plan_fns: Dict[str, Callable[..., "PartitionPlan"]] = {}
        self._refragmenters: Dict[str, Callable[..., Fragmentation]] = {}

    def register(self, name: str) -> Callable:
        """Decorator registering a plan function under ``name`` (making
        it a valid ``PartitionConfig.kind``)."""
        def deco(fn: Callable[..., "PartitionPlan"]) -> Callable:
            self._plan_fns[name] = fn
            return fn
        return deco

    def register_refragment(self, name: str) -> Callable:
        """Decorator registering a re-fragmentation hook for strategy
        ``name`` (see class docstring for the hook signature)."""
        def deco(fn: Callable[..., Fragmentation]) -> Callable:
            self._refragmenters[name] = fn
            return fn
        return deco

    def unregister(self, name: str) -> None:
        """Remove ``name`` (plan function and any refragment hook) from the
        registry (no-op if absent)."""
        self._plan_fns.pop(name, None)
        self._refragmenters.pop(name, None)

    def get(self, name: str) -> Callable[..., "PartitionPlan"]:
        """The plan function registered under ``name``; raises ``ValueError``
        listing the registered strategies otherwise."""
        if name not in self._plan_fns:
            raise ValueError(
                f"unknown fragmentation strategy {name!r}; registered "
                f"strategies: {self.names()}")
        return self._plan_fns[name]

    def get_refragment(self, name: str) -> Callable[..., Fragmentation]:
        """The re-fragmentation hook registered for strategy ``name``;
        raises ``ValueError`` listing the strategies that *do* carry a
        hook otherwise (a strategy without one cannot ride the
        adaptive loop)."""
        if name not in self._refragmenters:
            raise ValueError(
                f"strategy {name!r} has no re-fragmentation hook; "
                f"strategies with refragment hooks: "
                f"{self.refragment_names()} (register one with "
                f"@STRATEGIES.register_refragment({name!r}))")
        return self._refragmenters[name]

    def names(self) -> List[str]:
        """Registered strategy names, sorted."""
        return sorted(self._plan_fns)

    def refragment_names(self) -> List[str]:
        """Strategy names carrying a re-fragmentation hook, sorted."""
        return sorted(self._refragmenters)

    def __contains__(self, name: str) -> bool:
        return name in self._plan_fns


STRATEGIES = StrategyRegistry()
register_strategy = STRATEGIES.register
register_refragment = STRATEGIES.register_refragment


# ----------------------------------------------------------------------
# Config + offline stats
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PartitionConfig:
    """Offline-phase knobs: strategy choice (``kind`` must name a
    registered strategy -- validated at construction), cluster width
    (``num_sites``), and the paper's mining/selection thresholds (the
    inline comments cite the sections)."""
    min_sup_fraction: float = 0.001   # minSup as a fraction of |Q| (§8.2)
    theta_fraction: float = 0.001     # hot-property threshold (Def. 5)
    storage_factor: float = 1.6       # SC = factor * |E(hot)| (§4.1.2)
    kind: str = "vertical"            # any registered strategy name
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
                f"unknown fragmentation strategy kind={self.kind!r}; "
                f"registered strategies: {STRATEGIES.names()}")
        if self.num_sites < 1:
            raise ValueError(f"num_sites must be >= 1, got {self.num_sites}")
        if self.replication_budget_bytes < 0:
            raise ValueError(f"replication_budget_bytes must be >= 0, got "
                             f"{self.replication_budget_bytes}")


@dataclasses.dataclass
class OfflineStats:
    """Timing + quality provenance of one offline run (mine/select/
    fragment/allocate seconds, pattern and fragment counts, redundancy
    ratio, workload hit rate, selection Benefit)."""
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


# ----------------------------------------------------------------------
# The plan artifact
# ----------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class PartitionPlan:
    """Fragmentation + allocation + dictionary + selected FAPs + config
    provenance, detached from any engine.  ``graph`` is a runtime
    attachment: fragments store edge ids *into* it.  SHAPE and WARP
    plans hold ``baseline_frag`` (edge ids per site) instead of
    ``frag`` / ``alloc`` / ``dictionary``."""

    strategy: str
    config: PartitionConfig
    graph: Optional[RDFGraph] = None
    selected_patterns: List[QueryGraph] = dataclasses.field(
        default_factory=list)
    frag: Optional[Fragmentation] = None
    alloc: Optional[Allocation] = None
    dictionary: Optional[DataDictionary] = None
    cold_props: Set[int] = dataclasses.field(default_factory=set)
    baseline_frag: Optional[BaselineFragmentation] = None
    design_workload: Optional[Workload] = None
    sel_usage: Optional[np.ndarray] = None   # deduped usage over selected
    weights: Optional[np.ndarray] = None     # deduped query multiplicities
    stats: Optional[OfflineStats] = None
    selection: Optional[SelectionResult] = None  # runtime-only provenance
    # properties replicated to every site by the budgeted replication
    # pass (their join steps are shard-complete under SPMD serving);
    # ``replication`` is the pass's full provenance (ranking, costs,
    # spend)
    replicated_props: Set[int] = dataclasses.field(default_factory=set)
    replication: Optional[ReplicationPlan] = None

    # -- basic facts ----------------------------------------------------
    @property
    def num_sites(self) -> int:
        """Logical cluster width the plan allocates over."""
        return self.config.num_sites

    def redundancy_ratio(self) -> float:
        """Stored triples / graph triples (>= 1; overlap between
        fragments is the paper's storage-for-communication trade)."""
        if self.graph is None:
            raise RuntimeError("plan has no attached graph")
        if self.frag is not None:
            return self.frag.redundancy_ratio(self.graph)
        if self.baseline_frag is not None:
            return self.baseline_frag.redundancy_ratio(self.graph)
        raise RuntimeError("plan holds no fragmentation")

    def site_edge_ids(self) -> List[np.ndarray]:
        """Edge ids resident per site -- the uniform storage view every
        backend can consume (SPMD SiteStore, baseline engine).  Hot
        fragments follow the allocation; cold fragments ride round-robin
        exactly as in ``DataDictionary.build``; edges of
        ``replicated_props`` land on *every* site (that is what makes
        those properties shard-complete under SPMD serving)."""
        if self.baseline_frag is not None:
            per_site = [[np.asarray(e, np.int64)]
                        for e in self.baseline_frag.site_edges]
        else:
            if self.frag is None or self.alloc is None:
                raise RuntimeError("plan holds no fragmentation/allocation")
            per_site = [[] for _ in range(self.num_sites)]
            for fi, f in enumerate(self.frag.fragments):
                per_site[int(self.alloc.site_of[fi])].append(f.edge_ids)
            for k, f in enumerate(self.frag.cold_fragments):
                per_site[k % self.num_sites].append(f.edge_ids)
        if self.replicated_props:
            if self.graph is None:
                raise RuntimeError("plan has no attached graph to "
                                   "materialize replicated properties from")
            rep = replicated_edge_ids(self.graph, self.replicated_props)
            for g in per_site:
                g.append(rep)
        return [np.unique(np.concatenate(g)) if g
                else np.zeros(0, np.int64) for g in per_site]

    def property_sites(self) -> Dict[int, Tuple[int, ...]]:
        """The plan's fragment->site map at property granularity: for
        each property with resident edges, the sorted sites holding at
        least one of them (``core.allocation.property_site_map`` over
        ``site_edge_ids``).  This is the placement view the routing
        layer consumes at serving time -- the SPMD engine recomputes it
        device-side from ``SiteStore`` residency metadata, so the two
        always agree on the realized placement."""
        if self.graph is None:
            raise RuntimeError("plan has no attached graph")
        return property_site_map(self.graph, self.site_edge_ids())

    # -- engine construction (the Session facade picks per backend) -----
    def build_local_engine(self, cost: Optional[CostModel] = None
                           ) -> DistributedEngine:
        """Build the exact host ``DistributedEngine`` (decompose ->
        match per site -> ship-smaller-side joins, Algorithms 3+4).  It
        computes in numpy on the host, as the reference's does.

        Args:
            cost: optional ``CostModel`` for the timing/byte ledger.

        Returns:
            A ready ``DistributedEngine``.

        Raises:
            RuntimeError: no graph attached.
            ValueError: the strategy produced site-partitioned storage
                only (no fragment dictionary) -- use ``"baseline"`` or
                ``"spmd"``.
        """
        if self.graph is None:
            raise RuntimeError("plan has no attached graph")
        if self.frag is None or self.alloc is None or self.dictionary is None:
            raise ValueError(
                f"strategy {self.strategy!r} produces site-partitioned "
                f"storage only (no fragment dictionary); use "
                f"backend='baseline' or backend='spmd'")
        return DistributedEngine(self.graph, self.frag, self.alloc,
                                 self.dictionary, set(self.cold_props), cost)

    def build_baseline_engine(self, cost: Optional[CostModel] = None
                              ) -> BaselineEngine:
        """Build the gather-all ``BaselineEngine`` over the plan's
        per-site storage (the SHAPE/WARP execution model; WARP plans
        keep their local patterns).  It computes in numpy on the host,
        as the reference's does.

        Args:
            cost: optional ``CostModel`` for the timing/byte ledger.

        Returns:
            A ready ``BaselineEngine``.

        Raises:
            RuntimeError: no graph attached.
        """
        if self.graph is None:
            raise RuntimeError("plan has no attached graph")
        if self.baseline_frag is not None:
            bf = self.baseline_frag
            if self.replicated_props:
                # replicated edges are part of the uniform storage view
                # (site_edge_ids); rebuild so every backend serves the
                # same per-site storage
                bf = BaselineFragmentation(self.site_edge_ids(), bf.name)
        else:
            bf = BaselineFragmentation(self.site_edge_ids(),
                                       f"PLAN:{self.strategy}")
        local = self.selected_patterns if bf.name == "WARP" else None
        return BaselineEngine(self.graph, bf, local_patterns=local, cost=cost)

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
        if self.graph is None:
            raise RuntimeError("plan has no attached graph")
        from .spmd import SpmdEngine
        return SpmdEngine(self.graph, self.site_edge_ids(), device=device,
                          num_devices=num_devices, capacity=capacity,
                          cost=cost, max_capacity=max_capacity,
                          comm_plan=comm_plan,
                          replicated_props=set(self.replicated_props),
                          routing=routing)


# ----------------------------------------------------------------------
# Shared offline front: mine (§4) + select (§4.1)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _MinedSelection:
    selected_patterns: List[QueryGraph]
    sel_usage: np.ndarray
    weights: np.ndarray
    cold_props: Set[int]
    fprops: List[int]
    selection: SelectionResult
    num_mined: int
    hit_rate: float
    mine_sec: float
    select_sec: float


def _mine_and_select(graph: RDFGraph, workload: Workload,
                     cfg: PartitionConfig) -> _MinedSelection:
    min_sup = max(int(len(workload) * cfg.min_sup_fraction), 1)
    theta = max(int(len(workload) * cfg.theta_fraction), 1)

    t0 = time.perf_counter()
    uniq, weights = workload.dedup_normalized()
    fps = mine_frequent_patterns_deduped(uniq, weights, min_sup,
                                         cfg.max_pattern_edges)
    t_mine = time.perf_counter() - t0

    # integrity: add 1-edge patterns for every frequent property
    fprops = frequent_properties(workload, theta)
    have = {fp.pattern.canonical_code(): True for fp in fps
            if fp.num_edges == 1}
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
    return _MinedSelection(selected, sel_U, weights, cold_props, fprops,
                           sel, len(fps), float(hit), t_mine, t_sel)


# ----------------------------------------------------------------------
# Registered strategies
# ----------------------------------------------------------------------

def _replication_pass(graph: RDFGraph, cfg: PartitionConfig,
                      workload: Optional[Workload] = None,
                      patterns: Optional[Sequence[QueryGraph]] = None,
                      usage: Optional[np.ndarray] = None,
                      weights: Optional[np.ndarray] = None
                      ) -> Optional[ReplicationPlan]:
    """The budgeted replication pass shared by every strategy: heat from
    the selected FAPs' workload-weighted usage when the strategy mined
    any, else from the raw design workload's per-property selection
    frequencies.  ``None`` when the budget knob is 0 (paper-faithful)."""
    if cfg.replication_budget_bytes <= 0:
        return None
    heat = None
    if patterns is not None and usage is not None and weights is not None \
            and len(patterns):
        heat = fap_property_heat(patterns, usage, weights,
                                 graph.num_properties)
    if (heat is None or not heat.any()) and workload is not None:
        uniq, w = workload.dedup_normalized()
        heat = workload_property_heat(uniq, w, graph.num_properties)
    if heat is None:
        return None
    return plan_replication(graph, cfg.num_sites,
                            cfg.replication_budget_bytes, heat)


def _workload_driven_plan(graph: RDFGraph, workload: Workload,
                          cfg: PartitionConfig) -> PartitionPlan:
    """The paper's pipeline: mine -> select -> fragment -> allocate ->
    dictionary (vertical §5.1 or horizontal §5.2 per ``cfg.kind``),
    plus the budgeted replication pass when the config asks for one."""
    ms = _mine_and_select(graph, workload, cfg)
    theta = max(int(len(workload) * cfg.theta_fraction), 1)

    t0 = time.perf_counter()
    frag = build_fragmentation(
        graph, workload, ms.selected_patterns, theta, cfg.kind,
        cfg.num_cold_parts, cfg.per_pattern_predicates, cfg.max_rows)
    t_frag = time.perf_counter() - t0

    t0 = time.perf_counter()
    alloc = allocate_fragments(frag, ms.sel_usage, ms.weights,
                               cfg.num_sites, cfg.balance_factor)
    dictionary = DataDictionary.build(graph, frag, alloc, cfg.num_sites)
    t_alloc = time.perf_counter() - t0

    stats = OfflineStats(
        ms.mine_sec, ms.select_sec, t_frag, t_alloc, ms.num_mined,
        len(ms.selection.selected), len(frag.fragments),
        frag.redundancy_ratio(graph), ms.hit_rate, ms.selection.benefit)
    repl = _replication_pass(graph, cfg, workload, ms.selected_patterns,
                             ms.sel_usage, ms.weights)
    return PartitionPlan(
        strategy=cfg.kind, config=cfg, graph=graph,
        selected_patterns=ms.selected_patterns, frag=frag, alloc=alloc,
        dictionary=dictionary, cold_props=ms.cold_props,
        design_workload=workload, sel_usage=ms.sel_usage,
        weights=ms.weights, stats=stats, selection=ms.selection,
        replicated_props=(repl.prop_set if repl is not None else set()),
        replication=repl)


@register_strategy("vertical")
def _vertical(graph: RDFGraph, workload: Workload,
              cfg: PartitionConfig) -> PartitionPlan:
    return _workload_driven_plan(graph, workload, cfg)


@register_strategy("horizontal")
def _horizontal(graph: RDFGraph, workload: Workload,
                cfg: PartitionConfig) -> PartitionPlan:
    return _workload_driven_plan(graph, workload, cfg)


@register_refragment("vertical")
def _vertical_refragment(graph: RDFGraph, selected: List[QueryGraph],
                         sample: Workload, cfg: PartitionConfig,
                         cold_ids: np.ndarray, index) -> Fragmentation:
    return vertical_fragmentation(graph, selected, cold_ids,
                                  cfg.num_cold_parts, index=index,
                                  max_rows=cfg.max_rows)


@register_refragment("horizontal")
def _horizontal_refragment(graph: RDFGraph, selected: List[QueryGraph],
                           sample: Workload, cfg: PartitionConfig,
                           cold_ids: np.ndarray, index) -> Fragmentation:
    return horizontal_fragmentation(graph, selected, sample, cold_ids,
                                    cfg.num_cold_parts,
                                    cfg.per_pattern_predicates,
                                    index=index, max_rows=cfg.max_rows)


@register_strategy("shape")
def _shape(graph: RDFGraph, workload: Workload,
           cfg: PartitionConfig) -> PartitionPlan:
    """SHAPE baseline (§8.1): workload-oblivious subject-object hashing.
    The replication pass (workload-heat ranked) still applies: hashing
    decides residency, replication tops up the hottest properties."""
    bf = shape_fragmentation(graph, cfg.num_sites)
    repl = _replication_pass(graph, cfg, workload)
    return PartitionPlan(strategy="shape", config=cfg, graph=graph,
                         baseline_frag=bf, design_workload=workload,
                         replicated_props=(repl.prop_set if repl is not None
                                           else set()),
                         replication=repl)


@register_strategy("warp")
def _warp(graph: RDFGraph, workload: Workload,
          cfg: PartitionConfig) -> PartitionPlan:
    """WARP baseline (§8.1): min-cut parts + replication of the mined
    workload patterns that straddle parts."""
    ms = _mine_and_select(graph, workload, cfg)
    bf, _part = warp_fragmentation(graph, cfg.num_sites,
                                   ms.selected_patterns)
    repl = _replication_pass(graph, cfg, workload, ms.selected_patterns,
                             ms.sel_usage, ms.weights)
    return PartitionPlan(strategy="warp", config=cfg, graph=graph,
                         selected_patterns=ms.selected_patterns,
                         baseline_frag=bf, design_workload=workload,
                         sel_usage=ms.sel_usage, weights=ms.weights,
                         cold_props=ms.cold_props,
                         selection=ms.selection,
                         replicated_props=(repl.prop_set if repl is not None
                                           else set()),
                         replication=repl)


# ----------------------------------------------------------------------

def build_plan(graph: RDFGraph, workload: Workload,
               config: Optional[PartitionConfig] = None,
               incumbent: Optional[PartitionPlan] = None) -> PartitionPlan:
    """Run the offline phase with the strategy named by ``config.kind``.

    Args:
        graph: the RDF graph to fragment (triples as int32 columns).
        workload: the design query workload the fragmentation is mined
            from.
        config: ``PartitionConfig`` (strategy kind, number of sites,
            mining/selection thresholds); defaults to vertical
            fragmentation over 10 sites.
        incumbent: an existing plan to warm-start from; the warm start
            rides on the online loop, which is not ported yet.

    Returns:
        A ``PartitionPlan`` with the graph attached, ready to serve
        through ``Session``.

    Raises:
        ValueError: ``config.kind`` names no registered strategy.
        NotImplementedError: ``incumbent`` is given.
    """
    if incumbent is not None:
        raise NotImplementedError(
            "build_plan(incumbent=...) warm-starts through the online "
            "loop, which is not ported yet")
    cfg = config or PartitionConfig()
    return STRATEGIES.get(cfg.kind)(graph, workload, cfg)
