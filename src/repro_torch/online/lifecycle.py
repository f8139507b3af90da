"""Living plan lifecycle: versioned plan publication and graph-delta
ingestion -- the layer that keeps a *served* fragmentation current as
both the workload (``online.loop``) and the data (``apply_delta``)
move under it.

Two pieces:

* ``PlanRepository`` -- a versioned store of ``PartitionPlan``
  artifacts over ``repro_torch.checkpoint``.  ``publish`` writes version
  ``n+1`` with provenance chaining (parent version, graph signature,
  reason), optionally alongside the workload monitor's serialized
  state so a restarted process resumes with the live decayed
  statistics instead of a cold monitor.  ``build_plan(graph, workload,
  cfg, incumbent=repo.load_latest(graph))`` closes the loop: the next
  version is warm-started from the incumbent FAP set.

* ``ingest_delta`` -- materializes a graph delta *as fragment diffs*:
  each fragment keeps its surviving edges (removals are dropped by
  triple-identity remapping), added edges are routed to the fragment
  whose pattern carries their property (cold properties round-robin
  over the cold parts), and only the per-fragment **diffs** ship
  through the migration cost model -- never the whole fragment.  The
  result is a rebuilt ``PartitionPlan`` over the new graph at the
  *same* placement, ready for ``SpmdEngine.swap_store`` (serving
  continues through the ingestion) plus the shipping ledger
  (``shipped_bytes`` vs. the whole-fragment ``whole_bytes`` baseline).

Additions are *mandatory* shipments -- the same doctrine as
``plan_migration``'s mandatory materializations: deferring an added
edge would break Def. 3 coverage of the new graph, so the budget is
reported against, not enforced on, the mandatory set.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..core.dictionary import DataDictionary
from ..core.fragmentation import Fragment, Fragmentation
from ..core.graph import RDFGraph
from ..core.plan import PartitionPlan, _graph_signature
from .migration import BYTES_PER_EDGE, MigrationPlan, Move, schedule_migration
from .monitor import WorkloadMonitor


class PlanRepository:
    """Versioned on-disk store of partition plans with provenance.

    Layout::

        <root>/v_<n>/plan.json + step_0/   -- PartitionPlan.save output
        <root>/v_<n>/provenance.json       -- version, parent, reason,
                                              graph signature
        <root>/v_<n>/monitor/step_0/       -- optional WorkloadMonitor
                                              state (checkpoint pytree)

    Versions are monotonically increasing ints starting at 1.  The
    graph itself is never stored (plans sign it; the caller re-attaches
    it at load), so a repository stays small even for large graphs.
    """

    def __init__(self, root) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------
    def versions(self) -> List[int]:
        """Published version numbers, ascending."""
        out = []
        for p in self.root.glob("v_*"):
            if (p / "provenance.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest(self) -> Optional[int]:
        """Highest published version, or ``None`` on an empty repo."""
        vs = self.versions()
        return vs[-1] if vs else None

    def _vdir(self, version: int) -> Path:
        return self.root / f"v_{version}"

    # ------------------------------------------------------------------
    def publish(self, plan: PartitionPlan, *,
                monitor: Optional[WorkloadMonitor] = None,
                parent: Optional[int] = None,
                reason: str = "") -> int:
        """Write ``plan`` as the next version and return its number.

        ``parent`` defaults to the current latest (provenance chain);
        ``monitor`` additionally checkpoints the live workload-monitor
        state next to the plan, so ``load_monitor`` can resume the
        decayed statistics in a fresh process.
        """
        if parent is None:
            parent = self.latest()
        version = (self.latest() or 0) + 1
        vdir = self._vdir(version)
        plan.save(vdir)
        if monitor is not None:
            from ..checkpoint.ckpt import save_checkpoint
            save_checkpoint(vdir / "monitor", 0, monitor.state())
        prov = {
            "version": version,
            "parent": parent,
            "reason": reason,
            "strategy": plan.strategy,
            "graph_signature": (_graph_signature(plan.graph)
                                if plan.graph is not None else None),
            "num_selected_patterns": len(plan.selected_patterns),
            "replicated_props": sorted(int(p)
                                       for p in plan.replicated_props),
        }
        (vdir / "provenance.json").write_text(json.dumps(prov, indent=2))
        return version

    def provenance(self, version: int) -> Dict:
        """The provenance record written at ``publish`` time."""
        return json.loads(
            (self._vdir(version) / "provenance.json").read_text())

    def load_version(self, version: int, graph: RDFGraph) -> PartitionPlan:
        """Load one version (graph signature-checked by the plan
        loader)."""
        return PartitionPlan.load(self._vdir(version), graph)

    def load_latest(self, graph: RDFGraph) -> PartitionPlan:
        """Load the highest version; raises on an empty repository."""
        latest = self.latest()
        if latest is None:
            raise FileNotFoundError(
                f"plan repository {self.root} has no published versions")
        return self.load_version(latest, graph)

    def load_monitor(self, version: int) -> WorkloadMonitor:
        """Rebuild the workload monitor published with ``version``
        (cross-process safe: the sketch is keyed by stable digests)."""
        from ..checkpoint.ckpt import load_checkpoint
        mdir = self._vdir(version) / "monitor"
        manifest_path = mdir / "step_0" / "manifest.json"
        if not manifest_path.exists():
            raise FileNotFoundError(
                f"version {version} was published without monitor state")
        manifest = json.loads(manifest_path.read_text())
        like = {e["name"]: np.zeros(tuple(e["shape"]), dtype=e["dtype"])
                for e in manifest["leaves"]}
        raw = load_checkpoint(mdir, 0, like)
        return WorkloadMonitor.from_state(
            {k: np.asarray(v) for k, v in raw.items()})


# ----------------------------------------------------------------------
# Graph-delta ingestion
# ----------------------------------------------------------------------

@dataclasses.dataclass
class FragmentDelta:
    """Edge-id diff of one fragment across a graph delta (ids into the
    NEW graph for additions, counts only for removals -- a removal
    ships a 12-byte tombstone key, not rows)."""
    frag_idx: int               # hot index, or -1 - k for cold part k
    site: int                   # owning site (receiver of the shipment)
    added: np.ndarray           # new-graph edge ids appended
    removed: int                # edges dropped by the delta
    nbytes: int                 # diff shipment cost


@dataclasses.dataclass
class DeltaPlan:
    """Result of ``ingest_delta``: the rebuilt plan over the new graph
    at the same placement, plus the diff-shipping ledger."""
    plan: PartitionPlan         # serves the new graph (same placement)
    deltas: List[FragmentDelta]  # only fragments the delta touched
    migration: MigrationPlan    # the diffs as a shippable plan
    shipped_bytes: int          # Σ diff bytes (adds + tombstones)
    whole_bytes: int            # re-shipping every touched fragment whole
    added_edges: int
    removed_edges: int
    unassigned: int             # added edges no fragment claimed (0 in a
    # healthy plan: integrity seeds guarantee a 1-edge fragment per hot
    # property and cold parts absorb the rest)
    makespan_sec: float = 0.0

    def within_budget(self) -> bool:
        return self.migration.within_budget()


def _remap_fragment(old_graph: RDFGraph, new_graph: RDFGraph,
                    edge_ids: np.ndarray) -> np.ndarray:
    """Old-graph edge ids -> surviving new-graph edge ids (removed
    triples drop out)."""
    eids = np.asarray(edge_ids, np.int64)
    if eids.size == 0:
        return eids
    new_ids = new_graph.edge_ids_for_triples(
        old_graph.s[eids], old_graph.p[eids], old_graph.o[eids])
    return new_ids[new_ids >= 0]


def ingest_delta(plan: PartitionPlan, new_graph: RDFGraph, *,
                 budget_bytes: int = 0,
                 bytes_per_edge: float = BYTES_PER_EDGE,
                 link_bytes_per_sec: float = 1.0e9) -> DeltaPlan:
    """Materialize a graph delta as per-fragment edge diffs.

    Args:
        plan: the serving plan (graph attached -- the *old* graph).
        new_graph: ``plan.graph.apply_delta(...)`` output (or any graph
            sharing the old one's property universe).
        budget_bytes: the epoch's migration byte budget.  Additions are
            mandatory (coverage), so like ``plan_migration`` the
            effective bound is ``max(budget, mandatory)``; the report's
            ``within_budget()`` says whether the diff fit.
        bytes_per_edge: shipping cost per added edge row / removal
            tombstone.
        link_bytes_per_sec: link speed for the makespan model.

    Returns:
        A ``DeltaPlan``: rebuilt plan over ``new_graph`` at the same
        placement (feed its ``site_edge_ids()`` to
        ``SpmdEngine.swap_store`` to serve through the ingestion), the
        per-fragment diffs, and the shipped-vs-whole byte ledger.
    """
    if plan.graph is None:
        raise RuntimeError("plan has no attached graph to diff against")
    if plan.frag is None or plan.alloc is None:
        raise ValueError(
            f"delta ingestion needs a workload-driven plan with a "
            f"fragment dictionary; strategy {plan.strategy!r} only "
            f"provides site-partitioned storage")
    if new_graph.num_properties != plan.graph.num_properties:
        raise ValueError("delta may not change the property universe")
    old_graph = plan.graph
    frag = plan.frag
    num_sites = plan.config.num_sites

    # --- which new edges are additions (no triple match in the old) ---
    old_ids = old_graph.edge_ids_for_triples(new_graph.s, new_graph.p,
                                             new_graph.o)
    added_ids = np.nonzero(old_ids < 0)[0].astype(np.int64)
    removed_total = int(old_graph.num_edges) - int((old_ids >= 0).sum())

    # --- route each added edge to a fragment by property: a hot
    # property goes to a fragment whose pattern carries it (preferring
    # the 1-edge integrity fragment -- residency metadata and local
    # decomposition both reason from pattern properties, so membership
    # must stay consistent with them); cold properties round-robin over
    # the cold parts exactly like the original cold split ---
    prop_frag: Dict[int, int] = {}
    single_edge: Dict[int, bool] = {}
    for fi, f in enumerate(frag.fragments):
        if not 0 <= f.pattern_idx < len(frag.patterns):
            continue
        pat = frag.patterns[f.pattern_idx]
        single = pat.num_edges == 1
        for p in set(pat.properties()):
            if p not in prop_frag or (single and not single_edge[p]):
                prop_frag[p] = fi
                single_edge[p] = single
    n_cold = len(frag.cold_fragments)
    hot_extra: Dict[int, List[int]] = {}
    cold_extra: Dict[int, List[int]] = {}
    unassigned = 0
    for eid in added_ids:
        p = int(new_graph.p[eid])
        fi = prop_frag.get(p)
        if fi is not None and p not in plan.cold_props:
            hot_extra.setdefault(fi, []).append(int(eid))
        elif n_cold:
            cold_extra.setdefault(int(eid) % n_cold, []).append(int(eid))
        elif fi is not None:
            hot_extra.setdefault(fi, []).append(int(eid))
        else:
            unassigned += 1

    # --- rebuild every fragment: surviving remapped ids + its share of
    # the additions; record diffs for the ones the delta touched ---
    deltas: List[FragmentDelta] = []
    moves: List[Move] = []
    shipped = 0
    whole = 0

    def _diff(idx: int, site: int, old_eids: np.ndarray,
              kept: np.ndarray, extra: List[int]) -> np.ndarray:
        nonlocal shipped, whole
        add = np.asarray(sorted(extra), np.int64)
        new_eids = (np.unique(np.concatenate([kept, add]))
                    if add.size else kept)
        n_removed = int(len(old_eids)) - int(len(kept))
        if add.size or n_removed:
            nbytes = int(round((add.size + n_removed) * bytes_per_edge))
            deltas.append(FragmentDelta(idx, site, add, n_removed, nbytes))
            moves.append(Move(idx, None, site, nbytes, 0.0,
                              mandatory=True))
            shipped += nbytes
            whole += int(round(len(new_eids) * bytes_per_edge))
        return new_eids

    new_frags: List[Fragment] = []
    for fi, f in enumerate(frag.fragments):
        kept = _remap_fragment(old_graph, new_graph, f.edge_ids)
        site = int(plan.alloc.site_of[fi])
        new_eids = _diff(fi, site, f.edge_ids, kept,
                         hot_extra.get(fi, []))
        new_frags.append(Fragment(new_eids, f.pattern_idx, f.minterm,
                                  f.card, f.kind))
    new_cold: List[Fragment] = []
    for k, f in enumerate(frag.cold_fragments):
        kept = _remap_fragment(old_graph, new_graph, f.edge_ids)
        new_eids = _diff(-1 - k, k % num_sites, f.edge_ids, kept,
                         cold_extra.get(k, []))
        new_cold.append(Fragment(new_eids, f.pattern_idx, f.minterm,
                                 f.card, f.kind))
    new_frag = Fragmentation(new_frags, list(frag.patterns), frag.kind,
                             new_cold)

    migration = MigrationPlan(
        final_site_of=np.asarray(plan.alloc.site_of, np.int64).copy(),
        applied=moves, deferred=[], moved_bytes=shipped,
        budget_bytes=int(budget_bytes),
        replicated_props=set(plan.replicated_props))
    makespan = 0.0
    if moves:
        makespan = schedule_migration(migration, num_sites,
                                      link_bytes_per_sec)

    dictionary = DataDictionary.build(new_graph, new_frag, plan.alloc,
                                      num_sites)
    new_plan = PartitionPlan(
        strategy=plan.strategy, config=plan.config, graph=new_graph,
        selected_patterns=list(plan.selected_patterns), frag=new_frag,
        alloc=plan.alloc, dictionary=dictionary,
        cold_props=set(plan.cold_props),
        design_workload=plan.design_workload,
        sel_usage=plan.sel_usage, weights=plan.weights,
        replicated_props=set(plan.replicated_props),
        replication=plan.replication)
    return DeltaPlan(new_plan, deltas, migration, shipped, whole,
                     int(added_ids.size), removed_total, unassigned,
                     makespan)
