"""SPMD distributed subgraph matching on one GPU: the plan's sites run in
lock step over a leading site axis.

The reference runs one program per mesh device under ``shard_map`` and
calls its collectives from inside that per-device code.  Here every
site's state is a list of per-site tensors, and the match loop walks
the join steps in order: all sites finish step k before step k's
collective runs.  The collectives (``SiteAxis``: ``all_gather``,
``psum``, ``axis_index``) are tensor ops along dimension 0 of the
per-site parts, behind a small interface that a ``torch.distributed``
backend can take over later.

Everything the reference decides per join step is kept:

* **skip** -- the step's property is shard-complete (or complete on
  every route member): each site extends its bindings against its own
  edge table, nothing is shipped;
* **ship bindings** vs. **ship edges** -- otherwise the global binding
  count is compared with the property's resident edge bytes (in
  float32, as the reference's in-trace predicate) and the smaller side
  is gathered.  The reference's ``lax.cond`` predicate is the same on
  every device; here it is one host read per dynamic step.  A gathered
  edge table is cached across the steps of one query that share a
  property (``COMM_EDGE_CACHED``, free);
* **seed decimation** and **routing** -- step 0 stripes the seeds of a
  shard-complete property across the sites (or the route members), and
  sites outside a query's route never seed.

The ledger counts logical data-plane bytes with the reference's
formulas (``bind_row_bytes``, ``EDGE_ROW_BYTES``, ``route_width - 1``
peers, every attempted capacity tier, the final gather), so its numbers
compare 1:1 with the JAX engine.

The join probes run through ``repro_torch.kernels.ops``: the CUDA
kernels for a store on the card, their plain versions for a store on
the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..constants import INT32_SENTINEL
from ..device import resolve_device
from ..kernels import ref as kref
from ..kernels.ops import (compact_rows, dedup_rows_masked,
                           fused_join_sites, join_range, pair_semijoin_runs)
from .engine import EngineBase
from .executor import CostModel, ExecStats, QueryResult
from .graph import RDFGraph
from .query import PROP_VAR, QueryGraph, _connected_edge_order
from .routing import RoutePlan, plan_route, route_prop_complete

_I32 = torch.int32


# ----------------------------------------------------------------------
# Collectives over the site axis
# ----------------------------------------------------------------------

class SiteAxis:
    """Collectives over the leading site axis, for sites that run in one
    process: each takes the per-site parts (one tensor per site, in site
    order) and returns what every site receives, which is the same for
    all of them."""

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Tiled all_gather: the parts concatenated along dimension 0."""
        return torch.cat(list(parts), 0)

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum of the per-site scalars."""
        return torch.stack(list(parts)).sum(0)

    def axis_index(self, site: int) -> int:
        """Position of ``site`` on the axis."""
        return site


# ----------------------------------------------------------------------
# Site-sharded storage
# ----------------------------------------------------------------------

@dataclasses.dataclass
class SiteStore:
    """Per-site edge storage, padded to a uniform width, on one device.

    ``build`` derives the static per-property residency metadata the
    communication planner and the router read (host-side numpy):

    * ``prop_dev_rows[j, p]``     -- edge rows of ``p`` stored on site j;
    * ``prop_dev_distinct[j, p]`` -- distinct edge ids behind those rows;
    * ``prop_union_rows[p]``      -- distinct edge ids of ``p`` resident
      anywhere;
    * ``prop_dev_owned[j, p]``    -- rows of ``p`` site j *owns* for edge
      shipping: each resident edge id is owned by its lowest-indexed
      holder, so the owned sets are each resident edge exactly once.

    and packs the **CSR per-property edge tables** on the device: rows
    sorted by (p, s, o) give each property one subject-sorted run
    (``csr_sub_s`` keys, ``csr_sub_o`` payload), a second (p, o, s) sort
    the object-sorted runs (``csr_obj_o`` / ``csr_obj_s``), ``owned``
    the per-row owner flags in the subject-sorted order, and
    ``csr_offs`` (m, P + 1) the run offsets, kept on the host since
    windows are sliced with static offsets.  Key columns pad with
    ``INT32_SENTINEL``, payloads with -1, and the arrays run ``csr_pad``
    rows past the last run so a window never leaves the array.
    """
    num_sites: int
    e_max: int
    prop_dev_rows: np.ndarray       # (m, P) int64
    prop_dev_distinct: np.ndarray   # (m, P) int64
    prop_union_rows: np.ndarray     # (P,) int64
    csr_sub_s: torch.Tensor         # (m, e_max + csr_pad) int32
    csr_sub_o: torch.Tensor
    csr_obj_o: torch.Tensor
    csr_obj_s: torch.Tensor
    csr_offs: np.ndarray            # (m, P + 1) int64
    csr_pad: int
    prop_dev_owned: np.ndarray      # (m, P) int64
    owned: torch.Tensor             # (m, e_max + csr_pad) bool

    @property
    def device(self) -> torch.device:
        return self.csr_sub_s.device

    @staticmethod
    def build(graph: RDFGraph, site_edge_ids: Sequence[np.ndarray],
              device: Union[str, torch.device] = "cuda",
              pad_multiple: int = 512) -> "SiteStore":
        dev = resolve_device(device)
        m = len(site_edge_ids)
        e_max = max((len(e) for e in site_edge_ids), default=1)
        e_max = int(np.ceil(max(e_max, 1) / pad_multiple) * pad_multiple)
        n_props = graph.num_properties
        dev_rows = np.zeros((m, n_props), np.int64)
        dev_distinct = np.zeros((m, n_props), np.int64)
        dev_owned = np.zeros((m, n_props), np.int64)
        # edge ownership for shipping: ascending site order, each
        # resident edge id claimed by its first holder (first row of the
        # id within that site)
        owner = np.full(graph.num_edges, -1, np.int64)
        per_site = []
        for j, eids in enumerate(site_edge_ids):
            eids = np.asarray(eids, np.int64)
            s, p, o = graph.s[eids], graph.p[eids], graph.o[eids]
            order = np.lexsort((o, s, p))
            n = len(eids)
            dev_rows[j] = np.bincount(p, minlength=n_props)[:n_props]
            dev_distinct[j] = np.bincount(
                graph.p[np.unique(eids)], minlength=n_props)[:n_props]
            first_here = np.zeros(n, bool)
            first_here[np.unique(eids, return_index=True)[1]] = True
            claim = first_here & (owner[eids] < 0)
            owner[eids[claim]] = j
            dev_owned[j] = np.bincount(
                p[claim], minlength=n_props)[:n_props]
            per_site.append((s, p, o, order, claim[order]))
        resident = np.unique(np.concatenate(
            [np.zeros(0, np.int64)]
            + [np.asarray(e, np.int64) for e in site_edge_ids]))
        union = np.bincount(graph.p[resident], minlength=n_props)[:n_props]
        # pad past the last run by the largest window any property can
        # ask for (max per-site run, rounded like prop_window)
        pad = int(np.ceil(max(int(dev_rows.max(initial=1)), 1) / 8) * 8)
        width = e_max + pad
        sub_s = np.full((m, width), INT32_SENTINEL, np.int32)
        sub_o = np.full((m, width), -1, np.int32)
        obj_o = np.full((m, width), INT32_SENTINEL, np.int32)
        obj_s = np.full((m, width), -1, np.int32)
        offs = np.zeros((m, n_props + 1), np.int64)
        owned = np.zeros((m, width), bool)
        for j, (s, p, o, order, claim_sorted) in enumerate(per_site):
            n = len(order)
            sub_s[j, :n], sub_o[j, :n] = s[order], o[order]
            owned[j, :n] = claim_sorted
            order_o = np.lexsort((s, o, p))
            obj_o[j, :n], obj_s[j, :n] = o[order_o], s[order_o]
            offs[j, 1:] = np.cumsum(
                np.bincount(p, minlength=n_props)[:n_props])

        def put(a):
            return torch.from_numpy(a).to(dev)

        return SiteStore(m, e_max, dev_rows, dev_distinct, union,
                         put(sub_s), put(sub_o), put(obj_o), put(obj_s),
                         offs, pad, dev_owned, put(owned))

    def prop_shard_complete(self, prop: int) -> bool:
        """Every site holds every resident edge of ``prop`` (a join step
        on it needs no shipping).  Properties outside the metadata range
        are trivially complete."""
        if not (0 <= prop < self.prop_union_rows.shape[0]):
            return True
        return bool(np.all(self.prop_dev_distinct[:, prop]
                           == self.prop_union_rows[prop]))

    def prop_rows(self, prop: int) -> Tuple[int, int]:
        """(total stored rows across sites, max rows on any site)."""
        if not 0 <= prop < self.prop_dev_rows.shape[1]:
            return 0, 0
        col = self.prop_dev_rows[:, prop]
        return int(col.sum()), int(col.max(initial=0))

    def prop_window(self, prop: int) -> int:
        """Static CSR window rows for ``prop``: the max per-site run,
        rounded up to 8 (min 8) -- the one sizing formula shared by the
        per-step table slices and the step-0 seed window."""
        _total, per_dev = self.prop_rows(prop)
        return int(np.ceil(max(per_dev, 1) / 8) * 8)

    def prop_resident_rows(self, prop: int) -> int:
        """Distinct edges of ``prop`` resident anywhere -- the rows an
        edge-shipping step puts on the wire."""
        if not 0 <= prop < self.prop_union_rows.shape[0]:
            return 0
        return int(self.prop_union_rows[prop])

    def prop_ship_window(self, prop: int) -> int:
        """Static per-site buffer rows for *shipping* ``prop``: the max
        owned rows on any site, rounded up to 8 (min 8)."""
        if not 0 <= prop < self.prop_dev_owned.shape[1]:
            return 8
        per_dev = int(self.prop_dev_owned[:, prop].max(initial=0))
        return int(np.ceil(max(per_dev, 1) / 8) * 8)


# ----------------------------------------------------------------------
# Per-join-step communication planning
# ----------------------------------------------------------------------

# decision codes, as reported in the matcher's per-step decision vector
COMM_GATHER = 0       # shipped the binding tables (all_gather + dedup)
COMM_EDGE = 1         # shipped the step property's edge rows instead
COMM_SKIP = 2         # shipped nothing (shard-complete property / 1 site)
COMM_EDGE_CACHED = 3  # reused an earlier step's gathered edge table

#: decision code -> the name used in trace records
COMM_DECISION_NAMES = {COMM_GATHER: "gather", COMM_EDGE: "edge_ship",
                       COMM_SKIP: "skip", COMM_EDGE_CACHED: "edge_cached"}


def bind_row_bytes(num_cols: int) -> int:
    """Wire bytes of one binding-table row: ``num_cols`` int32 columns
    plus the validity byte.  Shared by the ship-smaller-side predicate
    and the ``comm_bytes`` ledger."""
    return num_cols * 4 + 1


EDGE_ROW_BYTES = 8   # one shipped edge row: two int32 columns (key, pay)


@dataclasses.dataclass(frozen=True)
class StepComm:
    """Static communication spec for one join step.

    mode: ``"gather"`` (always ship bindings, planner off), ``"skip"``
    (the property is shard-complete, or complete on every route member:
    ``route_complete``), or ``"dynamic"`` (ship the smaller side).
    """
    mode: str
    prop: int
    gather_cap: int     # per-site edge-gather buffer rows ("dynamic")
    edge_rows: int      # distinct resident rows of ``prop`` (wire rows)
    route_complete: bool = False

    @property
    def edge_bytes(self) -> int:
        """Wire bytes of shipping this property's resident edge rows
        (per receiving peer)."""
        return self.edge_rows * EDGE_ROW_BYTES


def plan_step_comm(store: SiteStore, pattern: QueryGraph,
                   enabled: bool = True,
                   route: Optional[RoutePlan] = None
                   ) -> Tuple[StepComm, ...]:
    """One ``StepComm`` per join step (steps >= 1 of the connected edge
    order).  ``enabled=False`` ships bindings every step (the naive
    broadcast join); ``route`` additionally skips steps whose property
    is complete on every route member."""
    order = _connected_edge_order(pattern)
    specs: List[StepComm] = []
    for ei in order[1:]:
        prop = pattern.edges[ei].prop
        union = store.prop_resident_rows(prop)
        if not enabled:
            specs.append(StepComm("gather", prop, 0, union))
        elif store.prop_shard_complete(prop):
            specs.append(StepComm("skip", prop, 0, union))
        elif route is not None and route_prop_complete(
                store, prop, route.members):
            specs.append(StepComm("skip", prop, 0, union,
                                  route_complete=True))
        else:
            specs.append(StepComm("dynamic", prop,
                                  store.prop_ship_window(prop), union))
    return tuple(specs)


def plan_seed_decimation(store: SiteStore, pattern: QueryGraph) -> bool:
    """Stripe step 0's seed rows across the sites?  True when step 0's
    property is shard-complete and duplicate-free on every site: each
    site then holds the identical, identically sorted seed list, so
    keeping every ``m``-th row partitions the seeds exactly."""
    order = _connected_edge_order(pattern)
    if not order:
        return False
    prop = pattern.edges[order[0]].prop
    if not store.prop_shard_complete(prop):
        return False
    if 0 <= prop < store.prop_dev_rows.shape[1] \
            and not np.array_equal(store.prop_dev_rows[:, prop],
                                   store.prop_dev_distinct[:, prop]):
        return False
    return True


# ----------------------------------------------------------------------
# Fixed-capacity join primitives
# ----------------------------------------------------------------------

def _expand_fixed(bind: torch.Tensor, valid: torch.Tensor,
                  col_vals: torch.Tensor, keys_sorted: torch.Tensor,
                  payload: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Join-expand a binding table (C, V) against a sorted (keys ->
    payload) edge table into ``capacity`` rows.  Returns (new_bind,
    new_payload_col, new_valid, overflow) where overflow counts result
    rows that did NOT fit (0-d int32, 0 when exact); the int32 wrap
    guard is the reference's (``kernels.ref.expand_from_counts``)."""
    probe = torch.where(valid, col_vals, INT32_SENTINEL)
    lo, cnt = join_range(probe, keys_sorted)
    cnt = torch.where(valid, cnt, 0).to(_I32)
    return kref.expand_from_counts(bind, lo, cnt, payload, capacity)


def _dedup_padded(bind: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invalidate duplicate rows of a padded binding table (exact).
    After an all_gather the same partial match can arrive from several
    sites; deduping keeps capacity pressure at the distinct matches.

    On the card one ``dedup_rows_masked`` call keeps the rows in place
    and writes the masked table; on the CPU the lexsort of record
    returns the rows sorted, as the reference's CPU path does.  Row
    order is invisible in an exact answer, but it decides which rows
    survive a truncated (overflowing) capacity tier, and with them the
    ledger of that tier."""
    C, V = bind.shape
    if V == 0 or not bind.is_cuda:
        bs, keep, _order = kref.dedup_padded_ref(bind, valid)
        return bs, keep
    return dedup_rows_masked(bind, valid)


def _compress_rows(bind: torch.Tensor, keep: torch.Tensor, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the rows selected by ``keep`` into a fresh capacity-row
    table.  Returns (bind, valid, overflow-row-count)."""
    (out,), valid = compact_rows(keep, (bind,), capacity, fill=-1)
    over = (keep.sum() - capacity).clamp(min=0).to(_I32)
    return out, valid, over


def _var_col_trace(pattern: QueryGraph) -> Tuple[List[int], List[int]]:
    """Host-side replay of the match loop's column bookkeeping.  Returns
    (final binding-column order, #columns entering each join step >=
    1) -- the latter sizes the binding gathers for the comm ledger."""
    order = _connected_edge_order(pattern)
    edges = pattern.edges
    var_cols: List[int] = []
    step_in_cols: List[int] = []
    for step, ei in enumerate(order):
        e = edges[ei]
        if step == 0:
            if e.src < 0:
                var_cols.append(e.src)
            if e.dst < 0 and e.dst != e.src:
                var_cols.append(e.dst)
            continue
        step_in_cols.append(len(var_cols))
        s_known = e.src >= 0 or e.src in var_cols
        d_known = e.dst >= 0 or e.dst in var_cols
        if s_known and d_known:
            continue
        if s_known:
            if e.dst < 0:
                var_cols.append(e.dst)
        else:
            if e.src < 0:
                var_cols.append(e.src)
    return var_cols, step_in_cols


@dataclasses.dataclass
class MatchOutput:
    """What one run of the match loop returns: per-site binding tables
    and validity masks (the final gather concatenates them; columns in
    ``_var_col_trace`` order), per-site overflow row counts, the
    per-step decision codes (host ints) and shipped-row counts (device
    scalars)."""
    binds: List[torch.Tensor]
    valids: List[torch.Tensor]
    overflow: torch.Tensor          # (m,) int32
    decisions: List[int]
    shipped: List[torch.Tensor]


def _match_sites(store: SiteStore, pattern: QueryGraph, capacity: int,
                 comm: Optional[Sequence[StepComm]] = None,
                 seed_decimate: bool = False,
                 route_ranks: Optional[Sequence[int]] = None,
                 route_width: int = 0) -> MatchOutput:
    """Match ``pattern`` over every site's shard in lock step, each
    site's binding table padded to ``capacity`` rows.

    With more than one site every join step is a broadcast join whose
    shipping is chosen by ``comm`` (one ``StepComm`` per join step;
    ``None`` ships bindings every step):

    * ship **bindings**: all_gather + exact dedup of the binding tables,
      then every site expands them against its OWN edges;
    * ship **edges**: every site's owned rows of the step's property are
      compacted into a static buffer and all_gather-ed instead, and each
      site expands its local bindings against the global table (cached
      for later steps on the same property);
    * **skip**: the local edge table already is the global one.

    In every mode the union over sites of a step's outputs is exactly
    the set of partial matches of the covered pattern prefix against the
    whole graph.  With one site the loop is purely local (decisions all
    ``COMM_SKIP``).  ``seed_decimate`` stripes step 0's seeds across the
    sites (``plan_seed_decimation``) or, with ``route_ranks`` set
    (``RoutePlan.seed_ranks``: stripe rank per site, -1 outside the
    route), across the ``route_width`` route members; sites outside the
    route never seed.  Overflow (result rows beyond capacity at any
    step) is counted, never silently dropped.
    """
    m = store.num_sites
    axis = SiteAxis() if m > 1 else None
    dev = store.device
    order = _connected_edge_order(pattern)
    edges = pattern.edges
    var_cols: List[int] = []
    imax = INT32_SENTINEL
    offs = store.csr_offs
    n_props = offs.shape[1] - 1
    windows = {e.prop: store.prop_window(e.prop) for e in edges}

    def col_idx(v: int) -> int:
        return var_cols.index(v)

    def csr_window(j: int, prop: int, subject_side: bool,
                   size: Optional[int] = None, pay_fill: int = -1
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(keys, payload, live rows) of site j's packed run of
        ``prop``: a static-size window over the pre-sorted CSR arrays,
        tail masked to the sentinels (a window can spill into the next
        property's run)."""
        if size is None:
            size = windows.get(prop, 8)
        if not 0 <= prop < n_props:   # never stored: empty static table
            return (torch.full((size,), imax, dtype=_I32, device=dev),
                    torch.full((size,), pay_fill, dtype=_I32, device=dev), 0)
        arrk, arrp = ((store.csr_sub_s, store.csr_sub_o) if subject_side
                      else (store.csr_obj_o, store.csr_obj_s))
        start = int(offs[j, prop])
        n = int(offs[j, prop + 1]) - start
        live = torch.arange(size, device=dev) < n
        return (torch.where(live, arrk[j, start:start + size], imax),
                torch.where(live, arrp[j, start:start + size], pay_fill), n)

    def site_windows(prop: int) -> kref.SiteWindows:
        """Every site's ``csr_window`` of ``prop`` as the kernels read it
        in place: offsets into row j of the CSR arrays and live rows."""
        size = windows.get(prop, 8)
        if not 0 <= prop < n_props:
            return kref.SiteWindows((0,) * m, (0,) * m, size)
        starts = tuple(int(offs[j, prop]) for j in range(m))
        return kref.SiteWindows(
            starts, tuple(int(offs[j, prop + 1]) - starts[j]
                          for j in range(m)), size)

    def owned_run_window(j: int, prop: int, size: int,
                         n_live: int) -> torch.Tensor:
        """Owned-row flags aligned with ``csr_window(j, prop, True,
        size)``, tail masked."""
        if not 0 <= prop < n_props:
            return torch.zeros(size, dtype=torch.bool, device=dev)
        start = int(offs[j, prop])
        return store.owned[j, start:start + size] \
            & (torch.arange(size, device=dev) < n_live)

    binds = [torch.full((capacity, 0), -1, dtype=_I32, device=dev)] * m
    valids = [torch.zeros(capacity, dtype=torch.bool, device=dev)] * m
    ovf = [torch.zeros((), dtype=_I32, device=dev)] * m
    decs: List[int] = []
    shipped_rows: List[torch.Tensor] = []
    # cross-step edge-gather cache: prop -> gathered (keys(s), payload(o))
    edge_cache: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    for step, ei in enumerate(order):
        e = edges[ei]
        s_known = e.src >= 0 or e.src in var_cols
        d_known = e.dst >= 0 or e.dst in var_cols

        if step == 0:
            # seed from each site's packed run of the property
            cols_j: List[Tuple[torch.Tensor, torch.Tensor]] = []
            for j in range(m):
                seed_s, seed_o, n_live = csr_window(j, e.prop, True)
                sel = torch.arange(seed_s.shape[0], device=dev) < n_live
                if e.src >= 0:
                    sel &= seed_s == e.src
                if e.dst >= 0:
                    sel &= seed_o == e.dst
                if e.src < 0 and e.src == e.dst:
                    sel &= seed_s == seed_o
                if route_ranks is not None and axis is not None:
                    my_rank = route_ranks[axis.axis_index(j)]
                    if seed_decimate:
                        rank = torch.cumsum(sel, 0) - 1
                        sel &= (rank % max(route_width, 1)) == my_rank
                    elif my_rank < 0:
                        sel = torch.zeros_like(sel)
                elif seed_decimate and axis is not None:
                    rank = torch.cumsum(sel, 0) - 1
                    sel &= (rank % m) == axis.axis_index(j)
                (s_col, o_col), valids[j] = compact_rows(
                    sel, (seed_s, seed_o), capacity, fill=-1)
                ovf[j] = torch.maximum(
                    ovf[j], (sel.sum() - capacity).to(_I32))
                cols_j.append((s_col, o_col))
            seed_cols = []
            if e.src < 0:
                var_cols.append(e.src)
                seed_cols.append(0)
            if e.dst < 0 and e.dst != e.src:
                var_cols.append(e.dst)
                seed_cols.append(1)
            binds = [torch.stack([c[k] for k in seed_cols], 1) if seed_cols
                     else torch.zeros((capacity, 0), dtype=_I32, device=dev)
                     for c in cols_j]
            continue

        sc = comm[step - 1] if comm is not None else None
        mode = ("skip" if axis is None
                else sc.mode if sc is not None else "gather")
        n_in = len(var_cols)          # binding columns entering the step
        cached = edge_cache.get(e.prop) if mode == "dynamic" else None

        # -- shared builders for this step --------------------------------
        def gathered_prop_tables() -> Tuple[torch.Tensor, torch.Tensor]:
            # every site's OWNED rows of the property, compacted into the
            # static ship buffer and gathered: each resident edge exactly
            # once, still (s, o)-sorted per site, sentinel fill last.  An
            # earlier step's gather of the same property is reused.
            if cached is not None:
                return cached
            parts_s, parts_o = [], []
            for j in range(m):
                fk, fp, n_run = csr_window(j, e.prop, True, pay_fill=imax)
                ow = owned_run_window(j, e.prop, fk.shape[0], n_run)
                (ls, lo_), _ = compact_rows(ow, (fk, fp), sc.gather_cap)
                parts_s.append(ls)
                parts_o.append(lo_)
            return axis.all_gather(parts_s), axis.all_gather(parts_o)

        def gathered_bindings():
            # the rows on the wire: the psum'd count of a dynamic step
            gb = axis.all_gather(binds)
            gv = axis.all_gather(valids)
            return gb, gv, gv.sum()

        def ship_bindings() -> Tuple[bool, torch.Tensor]:
            """The dynamic decision: psum the live binding count and
            compare the two sides' wire bytes in float32 (the byte
            formulas are the ledger's).  A cached edge table makes the
            edge side free.  Returns (ship bindings?, global count)."""
            n_glob = axis.psum([v.sum() for v in valids])
            gather_cost = np.float32(int(n_glob)) \
                * np.float32(bind_row_bytes(n_in))
            edge_cost = (np.float32(0.0) if cached is not None
                         else np.float32(sc.edge_bytes))
            return bool(gather_cost <= edge_cost), n_glob

        if mode == "dynamic":
            via_gather, row_v = ship_bindings()
            if via_gather:
                dec_v = COMM_GATHER
            else:
                dec_v = (COMM_EDGE_CACHED if cached is not None
                         else COMM_EDGE)
        elif mode == "gather":
            via_gather, dec_v = True, COMM_GATHER
        else:
            via_gather, dec_v = False, COMM_SKIP
            row_v = torch.zeros((), dtype=torch.int64, device=dev)

        if s_known and d_known:
            # cycle close: membership of the bound (src, dst) pair among
            # the property's edges, whose tables are (s, o)-sorted runs:
            # each site's window of the subject-sorted CSR arrays, or the
            # m runs of the edge-shipped table
            def pair_col(bts, v):
                """Query column of endpoint ``v`` over the binding
                tables ``bts``: (C,) for one table, (m, C) for m."""
                nr = bts[0].shape[0]
                if v >= 0:
                    col = torch.full((nr,), v, dtype=_I32, device=dev)
                    return col if len(bts) == 1 else col.expand(len(bts), nr)
                c = col_idx(v)
                return bts[0][:, c] if len(bts) == 1 \
                    else torch.stack([b[:, c] for b in bts])

            if via_gather:
                gb, gv, shipped = gathered_bindings()
                gb, gv = _dedup_padded(gb, gv)
                keep = gv & pair_semijoin_runs(
                    pair_col([gb], e.src), pair_col([gb], e.dst),
                    store.csr_sub_s, store.csr_sub_o, 1,
                    site_windows(e.prop))
                for j in range(m):
                    binds[j], valids[j], over = _compress_rows(
                        gb, keep[j], capacity)
                    ovf[j] = torch.maximum(ovf[j], over)
                row_v = shipped
            else:
                sv, dv = pair_col(binds, e.src), pair_col(binds, e.dst)
                if mode == "skip":
                    keep = pair_semijoin_runs(
                        sv, dv, store.csr_sub_s, store.csr_sub_o, 1,
                        site_windows(e.prop))
                else:
                    g_s, g_o = gathered_prop_tables()
                    edge_cache[e.prop] = (g_s, g_o)
                    keep = pair_semijoin_runs(sv, dv, g_s, g_o, m)
                for j in range(m):
                    valids[j] = valids[j] & keep[j]
                    binds[j] = torch.where(valids[j][:, None], binds[j], -1)
        else:
            # expansion: probe the known endpoint against the property's
            # (key -> payload) table; keys are subjects when the source
            # is bound, objects when the destination is
            known = e.src if s_known else e.dst

            def probe_vals(bt):
                nr = bt.shape[0]
                return (torch.full((nr,), known, dtype=_I32, device=dev)
                        if known >= 0 else bt[:, col_idx(known)])

            new_cols: List[torch.Tensor] = [None] * m
            if via_gather:
                # one call joins the gathered table against every site's
                # window, read in place from the CSR arrays
                gb, gv, shipped = gathered_bindings()
                arrk, arrp = ((store.csr_sub_s, store.csr_sub_o) if s_known
                              else (store.csr_obj_o, store.csr_obj_s))
                nb, nc, nv, over = fused_join_sites(
                    gb, gv, probe_vals(gb), arrk, arrp, capacity,
                    site_windows(e.prop))
                for j in range(m):
                    binds[j], new_cols[j], valids[j] = nb[j], nc[j], nv[j]
                    ovf[j] = torch.maximum(ovf[j], over[j])
                row_v = shipped
            else:
                if mode == "skip":
                    tables = [csr_window(j, e.prop, s_known)[:2]
                              for j in range(m)]
                else:
                    g_s, g_o = gathered_prop_tables()
                    edge_cache[e.prop] = (g_s, g_o)
                    gk, gp = (g_s, g_o) if s_known else (g_o, g_s)
                    gorder = torch.argsort(gk, stable=True)
                    tables = [(gk[gorder], gp[gorder])] * m
                for j in range(m):
                    binds[j], new_cols[j], valids[j], over = _expand_fixed(
                        binds[j], valids[j], probe_vals(binds[j]),
                        *tables[j], capacity)
                    ovf[j] = torch.maximum(ovf[j], over)
            new_var = e.dst if s_known else e.src
            if new_var < 0:
                var_cols.append(new_var)
                binds = [torch.cat([b, c[:, None]], 1)
                         for b, c in zip(binds, new_cols)]
            else:
                for j in range(m):
                    valids[j] = valids[j] & (new_cols[j] == new_var)
                    binds[j] = torch.where(valids[j][:, None], binds[j], -1)

        decs.append(dec_v)
        shipped_rows.append(row_v.to(torch.int64))

    overflow = torch.stack(ovf).clamp(min=0)
    return MatchOutput(binds, valids, overflow, decs, shipped_rows)


# ----------------------------------------------------------------------
# SPMD execution engine
# ----------------------------------------------------------------------

class SpmdEngine(EngineBase):
    """``Engine`` front over the site-axis ``SiteStore`` path.

    Logical sites fold round-robin onto ``num_devices`` slots of the
    site axis (the reference's mesh devices; by default one slot per
    logical site), every join step broadcast-joins across them, and
    constants are normalized out of the matched pattern and re-applied
    as a filter -- so the static per-step plan is keyed by query
    **shape** x **capacity tier** x store generation.

    ``capacity`` bounds each site's binding table.  Overflow is counted;
    on overflow the query re-executes with doubled capacity until exact,
    and past ``max_capacity`` a ``RuntimeError`` is raised -- never a
    silently truncated answer.  ``comm_plan`` and ``routing`` select the
    reference's size-aware step planning and per-query routing (both on
    by default; ``False`` restores the naive gather-every-step join and
    whole-axis execution with identical answers).  ``stats().comm_bytes``
    ledgers the data-plane bytes with the reference's formulas; the
    counters keep the reference's names.  With tracing on, each query's
    root span carries one ``comm_step`` record per join step per
    attempted tier plus the final gather, built from the same vectors
    and byte formulas as the ledger.
    """

    trace_name = "spmd"

    def __init__(self, graph: RDFGraph, site_edge_ids: Sequence[np.ndarray],
                 device: Union[str, torch.device] = "cuda",
                 num_devices: Optional[int] = None,
                 capacity: int = 4096, cost: Optional[CostModel] = None,
                 max_capacity: Optional[int] = None,
                 comm_plan: bool = True,
                 replicated_props: Optional[set] = None,
                 routing: bool = True):
        self._init_engine_base()
        self.device = resolve_device(device)
        self.graph = graph
        # provenance from the replication pass: attributes skip
        # decisions to replication in the counters (residency metadata,
        # not this set, detects shard-completeness)
        self.replicated_props = set(replicated_props or ())
        self.logical_sites = len(site_edge_ids)
        m = int(num_devices) if num_devices is not None \
            else max(self.logical_sites, 1)
        if m < 1:
            raise ValueError(f"num_devices must be >= 1, got {m}")
        folded: List[List[np.ndarray]] = [[] for _ in range(m)]
        for j, eids in enumerate(site_edge_ids):
            folded[j % m].append(np.asarray(eids, np.int64))
        self.store = SiteStore.build(
            graph, [np.unique(np.concatenate(g)) if g
                    else np.zeros(0, np.int64) for g in folded],
            device=self.device)
        self.capacity = int(capacity)
        self.max_capacity = max(int(max_capacity) if max_capacity is not None
                                else max(self.capacity, 1 << 20),
                                self.capacity)
        self.cost = cost or CostModel()
        self.comm_plan = bool(comm_plan)
        self.routing = bool(routing)
        self._routes: Dict[Tuple, RoutePlan] = {}
        # keyed by exact edge structure (NOT QueryGraph, whose __eq__ is
        # canonical-isomorphism: isomorphic patterns with different edge
        # orders produce different binding-column orders) x capacity
        # tier x store generation
        self._matchers: Dict[Tuple[Tuple, int, int], object] = {}
        self._comm_specs: Dict[Tuple, Tuple[StepComm, ...]] = {}
        self._seed_decim: Dict[Tuple, bool] = {}
        # last capacity tier that answered this edge structure exactly
        self._cap_hints: Dict[Tuple, int] = {}
        self._compiles = 0
        self._store_gen = 0
        # shape sharing inside one _execute_batch group: the group's
        # edge key and, once its first member ran, (MatchOutput, caps,
        # attempts) on the device
        self._shared_run: Optional[Tuple[MatchOutput, List[int], List]] = None
        self._shared_run_key: Optional[Tuple] = None
        for name in ("batch_shape_hits", "capacity_retries",
                     "overflow_events", "gather_steps", "edge_shipped_steps",
                     "skipped_gathers", "comm_bytes_saved",
                     "replication_skipped_steps", "edge_cache_hits",
                     "decimated_seed_queries", "routed_queries",
                     "route_skipped_steps", "store_swaps"):
            self._bump(name, 0)

    @property
    def num_sites(self) -> int:
        return self.logical_sites

    # ------------------------------------------------------------------
    def _route(self, pattern: QueryGraph) -> Optional[RoutePlan]:
        """Cached ``plan_route`` for this pattern, or ``None`` when
        routing is inactive (disabled, planner off, or one site)."""
        if not (self.routing and self.comm_plan
                and self.store.num_sites > 1):
            return None
        rp = self._routes.get(pattern.edges)
        if rp is None:
            rp = plan_route(self.store, pattern)
            self._routes[pattern.edges] = rp
        return rp

    def _comm_spec(self, pattern: QueryGraph) -> Tuple[StepComm, ...]:
        spec = self._comm_specs.get(pattern.edges)
        if spec is None:
            spec = plan_step_comm(self.store, pattern,
                                  enabled=self.comm_plan,
                                  route=self._route(pattern))
            self._comm_specs[pattern.edges] = spec
        return spec

    def _seed_decimation(self, pattern: QueryGraph) -> bool:
        """Routed execution uses the route's decision; otherwise
        ``plan_seed_decimation``'s whole-axis rule, and only with the
        planner on (the naive arm reproduces the gather-every-step
        baseline exactly)."""
        dec = self._seed_decim.get(pattern.edges)
        if dec is None:
            route = self._route(pattern)
            if route is not None:
                dec = route.decimate
            else:
                dec = self.comm_plan and plan_seed_decimation(self.store,
                                                              pattern)
            self._seed_decim[pattern.edges] = dec
        return dec

    def _start_capacity(self, pattern: QueryGraph) -> int:
        """First capacity tier for a pattern with no retry-ladder hint:
        a decimated seed step over ``r`` route members (on a property
        not complete on the whole axis) starts ``ceil(log2(m / r))``
        tiers lower, floored so the striped seed rows fit."""
        route = self._route(pattern)
        m = self.store.num_sites
        if (route is None or not route.decimate or route.p0_mesh_complete
                or not 1 <= route.width < m):
            return self.capacity
        shift = int(np.ceil(np.log2(m / route.width)))
        cap = max(self.capacity >> shift, 8)
        while cap < self.capacity and cap < route.seed_rows:
            cap *= 2
        return cap

    def _matcher(self, pattern: QueryGraph, capacity: int):
        """The match loop bound to this pattern's static plan (comm
        specs, seed decimation, route) at one capacity tier."""
        key = (pattern.edges, capacity, self._store_gen)
        fn = self._matchers.get(key)
        if fn is None:
            route = self._route(pattern)
            comm = self._comm_spec(pattern)
            decimate = self._seed_decimation(pattern)
            store = self.store

            def fn():
                return _match_sites(
                    store, pattern, capacity, comm=comm,
                    seed_decimate=decimate,
                    route_ranks=(route.seed_ranks if route is not None
                                 else None),
                    route_width=route.width if route is not None else 0)

            self._matchers[key] = fn
            self._compiles += 1
        return fn

    def _run_exact(self, norm: QueryGraph
                   ) -> Tuple[MatchOutput, List[int],
                              List[Tuple[np.ndarray, np.ndarray, int]]]:
        """Run the match loop for a normalized pattern, doubling the
        capacity until no site overflows.  Returns (the exact run,
        capacities attempted -- the last one succeeded, per-attempt
        (step decisions, step shipped rows, final-gather valid rows)
        for the comm ledger).  Raises ``RuntimeError`` if
        ``max_capacity`` is still too small."""
        cap = self._cap_hints.get(norm.edges, self._start_capacity(norm))
        caps: List[int] = []
        attempts: List[Tuple[np.ndarray, np.ndarray, int]] = []
        while True:
            caps.append(cap)
            out = self._matcher(norm, cap)()
            # one host read per attempt: overflow, shipped rows, final rows
            n_steps = len(out.shipped)
            host = torch.cat([out.overflow.to(torch.int64),
                              torch.stack(out.shipped) if n_steps else
                              out.overflow.new_zeros(0, dtype=torch.int64),
                              torch.stack([v.sum() for v in out.valids]
                                          ).sum().reshape(1)]).cpu().numpy()
            m = self.store.num_sites
            attempts.append((np.asarray(out.decisions, np.int32),
                             host[m:m + n_steps].astype(np.int32),
                             int(host[-1])))
            if int(host[:m].max(initial=0)) <= 0:
                self._cap_hints[norm.edges] = cap
                return out, caps, attempts
            self._bump("overflow_events")
            if cap >= self.max_capacity:
                raise RuntimeError(
                    f"SPMD binding tables still overflow at max_capacity="
                    f"{cap} rows per site (started at {self.capacity}) "
                    f"for pattern {norm.edges}; refusing to return a "
                    f"truncated answer.  Raise Session(spmd_capacity=...)"
                    f"/spmd_max_capacity for this workload.")
            cap = min(cap * 2, self.max_capacity)
            self._bump("capacity_retries")

    def _execute(self, query: QueryGraph) -> QueryResult:
        """Match ``query`` whole and return the exact ``QueryResult``.
        Raises ``NotImplementedError`` for wildcard properties and
        ``RuntimeError`` when ``max_capacity`` cannot hold the
        answer."""
        if any(e.prop == PROP_VAR for e in query.edges):
            raise NotImplementedError(
                "SPMD matcher requires constant properties (wildcard "
                "property labels would match the -1 padding)")
        t0 = time.perf_counter()
        norm = query.normalize()
        # inside an _execute_batch group every member has the same
        # normalized pattern, so the match loop's output is the same:
        # the first member runs it, the others reuse it and apply only
        # their own constants below
        reused = (self._shared_run is not None
                  and self._shared_run_key == norm.edges)
        if reused:
            out, caps, attempts = self._shared_run
            self._bump("batch_shape_hits")
        else:
            out, caps, attempts = self._run_exact(norm)
            if self._shared_run_key == norm.edges:
                self._shared_run = (out, caps, attempts)
        # final gather; the constants the normalization stripped are
        # applied on the device before the distinct rows come back
        nmap = query.normalization_map()
        var_order, step_in_cols = _var_col_trace(norm)
        col_of = {nv: i for i, nv in enumerate(var_order)}
        bind = torch.cat(out.binds, 0)
        keep = torch.cat(out.valids, 0)
        for orig, nv in nmap.items():
            if orig >= 0:
                keep = keep & (bind[:, col_of[nv]] == orig)
        rows = bind[keep].cpu().numpy()
        if rows.size:
            rows = np.unique(rows, axis=0)
        bindings = {orig: rows[:, col_of[nv]].astype(np.int32)
                    for orig, nv in nmap.items() if orig < 0}
        n = int(rows.shape[0])
        # communication ledger from the per-step decisions: logical
        # data-plane bytes per step to each of the w-1 peers (valid
        # binding rows, or the property's resident edge rows, or nothing
        # when skipped), plus the final gather of every site's valid
        # rows; every attempted tier really ran, so every one counts
        m = self.store.num_sites
        V = len(col_of)
        spec = self._comm_spec(norm)
        route = self._route(norm)
        w = route.width if route is not None else m
        routed = route is not None and route.width < m
        tr = self.tracer
        trace_on = tr.enabled
        comm = 0
        if reused:
            # the run -- and every collective in it -- happened once, for
            # the group's first member: this member shipped nothing
            if trace_on:
                tr.annotate(devices=m, capacity_tiers=caps,
                            shape_reused=True, route_width=w,
                            routed=routed,
                            comm_planner=bool(self.comm_plan))
        elif m > 1:             # 1 site: no peers, nothing ever ships
            decimated = self._seed_decimation(norm)
            if decimated:
                self._bump("decimated_seed_queries")
            if routed:
                self._bump("routed_queries")
            for ai, (dec, srows, n_final) in enumerate(attempts):
                for ji, sc in enumerate(spec):
                    d, r = int(dec[ji]), int(srows[ji])
                    row_bytes = bind_row_bytes(step_in_cols[ji])
                    step_bytes = 0
                    if d == COMM_GATHER:
                        step_bytes = (w - 1) * r * row_bytes
                        self._bump("gather_steps")
                    elif d == COMM_EDGE:
                        step_bytes = (w - 1) * sc.edge_bytes
                        self._bump("edge_shipped_steps")
                        self._bump("comm_bytes_saved",
                                   (w - 1) * (r * row_bytes
                                              - sc.edge_bytes))
                    elif d == COMM_EDGE_CACHED:
                        self._bump("edge_cache_hits")
                        self._bump("comm_bytes_saved",
                                   (w - 1) * r * row_bytes)
                    else:
                        self._bump("skipped_gathers")
                        if sc.route_complete:
                            self._bump("route_skipped_steps")
                        if sc.prop in self.replicated_props:
                            self._bump("replication_skipped_steps")
                    comm += step_bytes
                    if trace_on:
                        # same vectors, same byte formulas as the ledger:
                        # trace and ledger cannot diverge
                        tr.add_record({
                            "kind": "comm_step", "attempt": ai,
                            "capacity": caps[ai], "step": ji + 1,
                            "prop": sc.prop,
                            "decision": COMM_DECISION_NAMES[d],
                            "rows": r, "bytes": step_bytes,
                            "route_width": w,
                            "occupancy": (r / (m * caps[ai])
                                          if d != COMM_SKIP else 0.0)})
                final_bytes = (w - 1) * n_final * bind_row_bytes(V)
                comm += final_bytes
                if trace_on:
                    tr.add_record({
                        "kind": "comm_step", "attempt": ai,
                        "capacity": caps[ai], "step": len(spec) + 1,
                        "prop": -1, "decision": "final_gather",
                        "rows": n_final, "bytes": final_bytes,
                        "route_width": w,
                        "occupancy": n_final / (m * caps[ai])})
            if trace_on:
                tr.annotate(devices=m, capacity_tiers=caps,
                            overflow_events=len(caps) - 1,
                            capacity_retries=len(caps) - 1,
                            seed_decimated=bool(decimated),
                            route_width=w, routed=routed,
                            comm_planner=bool(self.comm_plan))
        elif trace_on:
            # one site: no peers, no collectives -- the span says so
            # instead of carrying zero-filled step records
            tr.annotate(devices=m, capacity_tiers=caps,
                        overflow_events=len(caps) - 1,
                        capacity_retries=len(caps) - 1,
                        seed_decimated=False,
                        route_width=1, routed=False,
                        comm_planner=bool(self.comm_plan))
        elapsed = time.perf_counter() - t0
        if routed:
            touched = {j for j in range(self.logical_sites)
                       if (j % m) in route.member_set}
            busy = {j: elapsed / max(w, 1) for j in route.members}
        else:
            touched = set(range(self.logical_sites))
            busy = {j: elapsed / max(m, 1) for j in range(m)}
        stats = ExecStats(elapsed, int(comm), touched, busy, n, 1)
        return self._finish(query, QueryResult(bindings, n, stats))

    def _execute_batch(self, batch: List[QueryGraph]) -> List[QueryResult]:
        """Group the batch by normalized edge key; each group runs the
        match loop once and its later members reuse the output
        (``batch_shape_hits``, no comm bytes).  Results come back in
        input order, with answers identical to sequential execution."""
        groups: Dict[Tuple, List[int]] = {}
        for i, q in enumerate(batch):
            if any(e.prop == PROP_VAR for e in q.edges):
                # raises in _execute: alone in its group, so the error
                # surfaces for exactly this query
                groups.setdefault(("__prop_var__", i), []).append(i)
            else:
                groups.setdefault(q.normalize().edges, []).append(i)
        out: List[Optional[QueryResult]] = [None] * len(batch)
        for key, idxs in groups.items():
            # key[:1], not key[0]: a zero-edge query's key is ()
            share = len(idxs) > 1 and key[:1] != ("__prop_var__",)
            self._shared_run_key = key if share else None
            self._shared_run = None
            try:
                for i in idxs:
                    out[i] = self.execute(batch[i])
            finally:
                self._shared_run_key = None
                self._shared_run = None
        return out

    @property
    def store_generation(self) -> int:
        """Monotonic counter bumped by every ``swap_store`` -- the
        serving layer's witness that a hot swap happened."""
        return self._store_gen

    def swap_store(self, site_edge_ids: Sequence[np.ndarray],
                   replicated_props: Optional[set] = None,
                   graph: Optional[RDFGraph] = None) -> int:
        """Replace the folded ``SiteStore`` with one built for a new
        placement (and optionally a delta-updated graph): the engine
        object survives a re-partition, so a serving front door keeps
        the same engine handle across plan versions.

        The new store is built on ``self.device`` *before* any engine
        state changes, then installed together with the planner caches'
        invalidation in one host-side step -- the engine is
        single-threaded, so an execute runs entirely on the old store or
        entirely on the new one.  Matchers are keyed by store
        generation; the old generation's are dropped here, since they
        hold the retired store's tensors and never match again
        (``compiled_shapes`` keeps counting every one built).

        Returns the new store generation.
        """
        graph = graph if graph is not None else self.graph
        m = self.store.num_sites
        folded: List[List[np.ndarray]] = [[] for _ in range(m)]
        for j, eids in enumerate(site_edge_ids):
            folded[j % m].append(np.asarray(eids, np.int64))
        store = SiteStore.build(
            graph, [np.unique(np.concatenate(g)) if g
                    else np.zeros(0, np.int64) for g in folded],
            device=self.device)
        # install: everything planned against the old store's residency
        # (routes, comm specs, seed decimation, capacity hints) is
        # invalid for the new placement
        self.graph = graph
        self.store = store
        self.logical_sites = len(site_edge_ids)
        if replicated_props is not None:
            self.replicated_props = set(replicated_props)
        self._routes.clear()
        self._comm_specs.clear()
        self._seed_decim.clear()
        self._cap_hints.clear()
        self._matchers.clear()
        self._shared_run = None
        self._shared_run_key = None
        self._store_gen += 1
        self._bump("store_swaps")
        return self._store_gen

    def route_key(self, query: QueryGraph) -> Optional[Tuple[int, ...]]:
        """Stable routing token for ``query``: its route's member
        sites, or ``None`` when routing is inactive (or the query is
        unroutable).  A pure function of the *normalized* shape, so the
        serving layer can fold it into its shape-bucket keys without
        ever splitting a same-shape batch (``repro_torch.serve``)."""
        if any(e.prop == PROP_VAR for e in query.edges):
            return None
        route = self._route(query.normalize())
        return route.members if route is not None else None

    def _stats_extra(self) -> Dict[str, float]:
        # key names follow the reference's catalogue; the join-kernel
        # gauge is 1 when the store lives on the card (CUDA kernels)
        return {"compiled_shapes": float(self._compiles),
                "store_generation": float(self._store_gen),
                "devices": float(self.store.num_sites),
                "comm_planner": float(self.comm_plan),
                "routing": float(bool(self.routing and self.comm_plan
                                      and self.store.num_sites > 1)),
                "replicated_props": float(len(self.replicated_props)),
                "pallas_join_kernels": float(self.device.type == "cuda"),
                "csr_prop_tables": 1.0}
