"""``PartitionPlan``: the product of the offline phase, and the
``StrategyRegistry`` that produces one from any registered fragmentation
strategy.

* ``build_plan(graph, workload, config)`` dispatches on ``config.kind``
  through the strategy registry -- ``"vertical"`` / ``"horizontal"``
  (the paper's §5), ``"shape"`` / ``"warp"`` (the §8 baselines) -- and
  returns a ``PartitionPlan`` bundling fragmentation, allocation, data
  dictionary, selected FAPs, the design workload and the config.
* ``PartitionPlan.save()`` / ``PartitionPlan.load()`` round-trip the
  plan through ``repro_torch.checkpoint`` (npy-per-leaf + a
  ``plan.json`` manifest) in the JAX package's format, so a plan saved
  by either package loads in the other and compares equal.
* ``build_plan(..., incumbent=plan)`` warm-starts from an incumbent's
  FAP set through ``repro_torch.online.refragment``.
* New strategies are one ``@register_strategy("name")`` away; config
  validation lists whatever is registered.

Engines are *built from* plans (``build_local_engine`` etc. -- the
``Session`` facade picks per backend); a plan itself holds no device
state.  Host-side planning is numpy, exactly as in the reference, so
the same seeds give the same plan.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
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
from .fragmentation import (Fragment, Fragmentation, MintermPredicate,
                            SimplePredicate, build_fragmentation,
                            horizontal_fragmentation,
                            vertical_fragmentation)
from .graph import RDFGraph
from .matching import _PropIndex, match_edge_ids
from .mining import (FrequentPattern, frequent_properties,
                     mine_frequent_patterns_deduped, usage_matrix)
from .query import QueryGraph
from .selection import SelectionResult, select_patterns
from .workload import Workload

PLAN_FORMAT_VERSION = 1


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
    ``_PropIndex``.  ``online.refragment`` dispatches through the hook
    table instead of hardcoding kinds, so a newly registered
    frag-bearing strategy joins the adaptive loop by registering both.
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
# Query (de)serialization helpers: flat int64 stream
# [n_edges, s,d,p, s,d,p, ...] per query -- tiny, checkpoint-friendly.
# ----------------------------------------------------------------------

def encode_queries(queries: Sequence[QueryGraph]) -> np.ndarray:
    """Flatten query graphs into the int64 stream format above."""
    out: List[int] = []
    for q in queries:
        out.append(q.num_edges)
        for e in q.edges:
            out.extend((e.src, e.dst, e.prop))
    return np.asarray(out, dtype=np.int64) if out else np.zeros(0, np.int64)


def decode_queries(flat: np.ndarray) -> List[QueryGraph]:
    """Inverse of ``encode_queries``."""
    flat = np.asarray(flat, dtype=np.int64)
    qs: List[QueryGraph] = []
    i = 0
    while i < len(flat):
        n = int(flat[i])
        i += 1
        qs.append(QueryGraph.make(
            [(int(flat[i + 3 * k]), int(flat[i + 3 * k + 1]),
              int(flat[i + 3 * k + 2])) for k in range(n)]))
        i += 3 * n
    return qs


def _minterm_to_json(mt: Optional[MintermPredicate]) -> Optional[dict]:
    if mt is None:
        return None
    return {"pattern_idx": mt.pattern_idx,
            "terms": [[t.var, t.value, bool(t.equal)] for t in mt.terms]}


def _minterm_from_json(d: Optional[dict]) -> Optional[MintermPredicate]:
    if d is None:
        return None
    return MintermPredicate(int(d["pattern_idx"]), tuple(
        SimplePredicate(int(v), int(val), bool(eq))
        for v, val, eq in d["terms"]))


def _graph_signature(graph: RDFGraph) -> Dict[str, int]:
    """Size counts + a content checksum of the triple arrays: fragment
    edge ids index into the graph, so size-equal but different graphs
    must be rejected at load time."""
    import zlib
    crc = 0
    for a in (graph.s, graph.p, graph.o):
        crc = zlib.crc32(np.ascontiguousarray(a, np.int32).tobytes(), crc)
    return {"num_edges": graph.num_edges,
            "num_vertices": graph.num_vertices,
            "num_properties": graph.num_properties,
            "triples_crc32": int(crc)}


# ----------------------------------------------------------------------
# The plan artifact
# ----------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class PartitionPlan:
    """Fragmentation + allocation + dictionary + selected FAPs + config
    provenance, detached from any engine.  ``graph`` is a runtime
    attachment: fragments store edge ids *into* it; ``save()`` records
    only its signature and ``load()`` re-attaches and validates.  SHAPE
    and WARP plans hold ``baseline_frag`` (edge ids per site) instead
    of ``frag`` / ``alloc`` / ``dictionary``."""

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
    # spend) and round-trips through save()/load()
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
                          routing: bool = True,
                          mesh=None):
        """Build the ``SpmdEngine`` over this plan's per-site storage.

        Args:
            device: where the store lives and the joins run ("cuda" by
                default; "cpu" runs the kernels' plain versions).
            num_devices: width of the one-process site axis the logical
                sites fold onto (default: one slot per logical site).
            mesh: a ``repro_torch.launch.mesh.SiteMesh`` to fold the
                sites onto instead; on a process group every rank builds
                its shard on its own device and must make the same
                calls.
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
                          routing=routing, mesh=mesh)

    # -- serialization (built on repro_torch.checkpoint) --------------
    def save(self, path) -> Path:
        """Write the plan under ``path/`` (``plan.json`` + an npy-per-leaf
        checkpoint).  The graph itself is NOT stored -- only its
        signature, validated on load."""
        if self.graph is None:
            raise RuntimeError("plan has no attached graph to sign")
        from ..checkpoint.ckpt import save_checkpoint
        path = Path(path)
        arrays: Dict[str, np.ndarray] = {}
        meta: Dict[str, object] = {
            "format": PLAN_FORMAT_VERSION,
            "strategy": self.strategy,
            "config": dataclasses.asdict(self.config),
            "graph_signature": _graph_signature(self.graph),
            "patterns": [encode_queries([p]).tolist()
                         for p in self.selected_patterns],
            "stats": (dataclasses.asdict(self.stats)
                      if self.stats is not None else None),
        }
        arrays["cold_props"] = np.asarray(sorted(self.cold_props), np.int64)
        arrays["replicated_props"] = np.asarray(
            sorted(self.replicated_props), np.int64)
        if self.replication is not None:
            meta["replication"] = {
                "props": [int(p) for p in self.replication.props],
                "budget_bytes": self.replication.budget_bytes,
                "spent_bytes": self.replication.spent_bytes,
                "heat": {str(p): h
                         for p, h in self.replication.heat.items()},
                "cost_bytes": {str(p): c
                               for p, c in self.replication.cost_bytes
                               .items()}}
        if self.design_workload is not None:
            arrays["design_workload"] = encode_queries(
                self.design_workload.queries)
        if self.frag is not None:
            meta["fragments"] = [
                {"pattern_idx": f.pattern_idx, "card": f.card,
                 "kind": f.kind, "minterm": _minterm_to_json(f.minterm)}
                for f in self.frag.fragments]
            meta["cold_fragments"] = [
                {"kind": f.kind} for f in self.frag.cold_fragments]
            for i, f in enumerate(self.frag.fragments):
                arrays[f"frag_{i}"] = np.asarray(f.edge_ids, np.int64)
            for i, f in enumerate(self.frag.cold_fragments):
                arrays[f"cold_{i}"] = np.asarray(f.edge_ids, np.int64)
        if self.alloc is not None:
            arrays["site_of"] = np.asarray(self.alloc.site_of, np.int64)
        if self.baseline_frag is not None:
            meta["baseline"] = {
                "name": self.baseline_frag.name,
                "num_sites": len(self.baseline_frag.site_edges)}
            for j, e in enumerate(self.baseline_frag.site_edges):
                arrays[f"site_{j}"] = np.asarray(e, np.int64)
        if self.sel_usage is not None:
            arrays["sel_usage"] = np.asarray(self.sel_usage, np.float64)
        if self.weights is not None:
            arrays["weights"] = np.asarray(self.weights, np.int64)
        meta["arrays"] = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                          for k, v in arrays.items()}
        save_checkpoint(path, 0, arrays)
        (path / "plan.json").write_text(json.dumps(meta, indent=1))
        return path

    @staticmethod
    def load(path, graph: RDFGraph) -> "PartitionPlan":
        """Rebuild a plan from ``save()`` output; ``graph`` must be the
        graph the plan was built on (signature-checked).  The data
        dictionary is rebuilt, so a loaded plan serves queries without
        re-running the offline phase."""
        from ..checkpoint.ckpt import load_checkpoint
        path = Path(path)
        meta = json.loads((path / "plan.json").read_text())
        if meta.get("format") != PLAN_FORMAT_VERSION:
            raise ValueError(f"unsupported plan format {meta.get('format')}")
        sig = meta["graph_signature"]
        got = _graph_signature(graph)
        if sig != got:
            raise ValueError(
                f"plan was built on a different graph: saved signature "
                f"{sig}, attached graph {got}")
        like = {k: np.zeros(tuple(spec["shape"]), dtype=spec["dtype"])
                for k, spec in meta["arrays"].items()}
        raw = load_checkpoint(path, 0, like)
        arrays = {k: np.asarray(raw[k]).astype(meta["arrays"][k]["dtype"])
                  for k in like}
        cfg = PartitionConfig(**meta["config"])
        patterns = [decode_queries(np.asarray(flat, np.int64))[0]
                    for flat in meta["patterns"]]
        frag = alloc = dictionary = None
        if "fragments" in meta:
            frags = [Fragment(arrays[f"frag_{i}"], int(fm["pattern_idx"]),
                              _minterm_from_json(fm["minterm"]),
                              int(fm["card"]), fm["kind"])
                     for i, fm in enumerate(meta["fragments"])]
            cold = [Fragment(arrays[f"cold_{i}"], -1, None, 0, cm["kind"])
                    for i, cm in enumerate(meta["cold_fragments"])]
            frag = Fragmentation(frags, list(patterns), cfg.kind, cold)
            alloc = Allocation(arrays["site_of"], cfg.num_sites)
            dictionary = DataDictionary.build(graph, frag, alloc,
                                              cfg.num_sites)
        baseline = None
        if "baseline" in meta:
            b = meta["baseline"]
            baseline = BaselineFragmentation(
                [arrays[f"site_{j}"] for j in range(int(b["num_sites"]))],
                b["name"])
        stats = (OfflineStats(**meta["stats"])
                 if meta.get("stats") is not None else None)
        replication = None
        if meta.get("replication") is not None:
            r = meta["replication"]
            replication = ReplicationPlan(
                [int(p) for p in r["props"]],
                {int(p): float(h) for p, h in r["heat"].items()},
                {int(p): int(c) for p, c in r["cost_bytes"].items()},
                int(r["budget_bytes"]), int(r["spent_bytes"]))
        wl = (Workload(decode_queries(arrays["design_workload"]))
              if "design_workload" in arrays else None)
        return PartitionPlan(
            strategy=meta["strategy"], config=cfg, graph=graph,
            selected_patterns=patterns, frag=frag, alloc=alloc,
            dictionary=dictionary,
            cold_props=set(int(p) for p in arrays["cold_props"]),
            baseline_frag=baseline, design_workload=wl,
            sel_usage=arrays.get("sel_usage"), weights=arrays.get("weights"),
            stats=stats,
            # PR-4-era plans predate replication: missing field -> empty
            replicated_props=set(
                int(p) for p in arrays.get("replicated_props", ())),
            replication=replication)

    # -- equality (dtype-insensitive on arrays) --------------------------
    def _state(self) -> Tuple:
        def ai(a) -> Tuple:
            a = np.asarray(a, np.int64)
            return (a.shape, a.tobytes())

        def af(a) -> Optional[Tuple]:
            if a is None:
                return None
            a = np.asarray(a, np.float64)
            return (a.shape, a.tobytes())

        frag_state = None
        if self.frag is not None:
            frag_state = (
                tuple((ai(f.edge_ids), f.pattern_idx, f.card, f.kind,
                       _minterm_to_json(f.minterm) and
                       json.dumps(_minterm_to_json(f.minterm)))
                      for f in self.frag.fragments),
                tuple((ai(f.edge_ids), f.kind)
                      for f in self.frag.cold_fragments))
        return (
            self.strategy,
            tuple(sorted(dataclasses.asdict(self.config).items())),
            tuple(p.canonical_code() for p in self.selected_patterns),
            frag_state,
            ai(self.alloc.site_of) if self.alloc is not None else None,
            tuple(sorted(self.cold_props)),
            (self.baseline_frag.name,
             tuple(ai(e) for e in self.baseline_frag.site_edges))
            if self.baseline_frag is not None else None,
            ai(encode_queries(self.design_workload.queries))
            if self.design_workload is not None else None,
            af(self.sel_usage),
            ai(self.weights) if self.weights is not None else None,
            tuple(sorted(self.replicated_props)),
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, PartitionPlan):
            return NotImplemented
        return self._state() == other._state()


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
            fragmentation over 10 sites, or to the incumbent's config
            when warm-starting.
        incumbent: an existing plan to warm-start from.  Its selected
            FAP set seeds mining/selection (``online.refragment``),
            so patterns the previous plan materialized are retained
            when they still pay for themselves on the new workload --
            the lifecycle layer's successive-version path.

    Returns:
        A ``PartitionPlan`` with the graph attached -- ready to serve
        through ``Session`` or to ``save()`` for later ``load()``.

    Raises:
        ValueError: ``config.kind`` names no registered strategy (or,
            when warm-starting, no refragment hook).
    """
    if incumbent is None:
        cfg = config or PartitionConfig()
        return STRATEGIES.get(cfg.kind)(graph, workload, cfg)

    cfg = config or incumbent.config
    # warm start: replay the design workload through a monitor and run
    # the incremental pipeline seeded with the incumbent's FAP set
    # (lazy import -- core must not depend on online at module scope)
    from ..online.monitor import WorkloadMonitor
    from ..online.refragment import refragment
    monitor = WorkloadMonitor(graph.num_properties)
    monitor.bulk_load(workload)
    res = refragment(graph, monitor, cfg, incumbent.selected_patterns)
    dictionary = DataDictionary.build(graph, res.frag, res.desired_alloc,
                                      cfg.num_sites)
    repl = res.desired_replication
    return PartitionPlan(
        strategy=cfg.kind, config=cfg, graph=graph,
        selected_patterns=res.selected_patterns, frag=res.frag,
        alloc=res.desired_alloc, dictionary=dictionary,
        cold_props=res.cold_props, design_workload=workload,
        sel_usage=res.sel_usage, weights=res.weights,
        replicated_props=(repl.prop_set if repl is not None else set()),
        replication=repl)
