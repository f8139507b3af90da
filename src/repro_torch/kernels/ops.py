"""Public wrappers around the CUDA kernels.

Each wrapper dispatches on the device of its tensors and on nothing
else: tensors on the CPU go to the plain version in ``ref.py``; tensors
on a CUDA device launch the hand-written kernel (``csrc/``, built at
first use by ``build.py``) on the current stream of that device, or the
wrapper raises.  ``LAUNCHES`` counts kernel launches per wrapper, one
per call that reached the card.

``compact_rows`` is plain tensor code on every device (a cumsum-scatter:
torch has no ``nonzero(size=, fill_value=)``), as it is plain jnp in
the reference.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import ref
from ..constants import INT32_SENTINEL

_I32 = torch.int32

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {"join_count": 0, "pair_semijoin": 0,
                            "dedup_rows": 0, "fused_join": 0, "semijoin": 0,
                            "flash_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors
    (kernel); raises on any other device or on mixed devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def _i32(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dtype != _I32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    return t.contiguous()


def _flags(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.bool:
        raise TypeError(f"{name}: expected a bool mask, got {t.dtype}")
    return t.contiguous()


def _vectors(name: str, *tensors: torch.Tensor) -> None:
    """1-D tensors of one length: the kernels index them in lock step,
    so a mismatch would read past the end of one of them."""
    first = tensors[0].shape
    if any(t.dim() != 1 or t.shape != first for t in tensors):
        raise ValueError(f"{name}: expected 1-D tensors of one length, "
                         f"got shapes {[tuple(t.shape) for t in tensors]}")


def _table(name: str, bind: torch.Tensor, *rows: torch.Tensor) -> None:
    """A (C, V) binding table and (C,) per-row vectors."""
    if bind.dim() != 2 or any(r.dim() != 1 or r.shape[0] != bind.shape[0]
                              for r in rows):
        raise ValueError(f"{name}: expected a (C, V) table and (C,) "
                         f"vectors, got shapes "
                         f"{[tuple(t.shape) for t in (bind,) + rows]}")


def _launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream of its tensors'
    device, with that device current (raising on tensors that span
    devices or lie off the card): tensors pass as their data pointers,
    ``None`` as a null pointer, anything else (ints, ctypes arrays of
    host values) as it is."""
    from .build import kernel
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: a launch takes tensors on one CUDA "
                         f"device, got {sorted(str(d) for d in devs)}")
    dev = devs.pop()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernel(name)(*(a.data_ptr() if isinstance(a, torch.Tensor)
                             else a for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def _hash_size(C: int) -> int:
    """Power-of-two open-addressing table size >= 2C (load factor <=
    1/2: probe chains stay short and an empty slot always exists)."""
    H = 8
    while H < 2 * C:
        H *= 2
    return H


def compact_rows(sel: torch.Tensor, cols: Tuple[torch.Tensor, ...],
                 size: int, fill: int = INT32_SENTINEL
                 ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Pack the rows where ``sel`` holds into fixed-``size`` int32
    buffers padded with ``fill``, in order; selected rows beyond
    ``size`` are dropped (callers size the buffer statically or count
    the surplus as overflow).  Each entry of ``cols`` is indexed on its
    leading axis.  Returns ``(packed columns, valid mask)`` with no host
    synchronisation: destinations come from a cumsum, surplus and
    unselected rows scatter to one discarded slot."""
    dev = sel.device
    pos = torch.cumsum(sel, 0) - 1
    dest = torch.where(sel & (pos < size), pos, size)
    out = []
    for c in cols:
        buf = torch.full((size + 1,) + tuple(c.shape[1:]), fill, dtype=_I32,
                         device=dev)
        buf.index_copy_(0, dest, c.to(_I32))
        out.append(buf[:size])
    ok = torch.arange(size, device=dev) < sel.sum()
    return tuple(out), ok


#: calls with fewer probes search the key column directly; larger ones
#: first stage every 2^k-th key in shared memory (``csrc/join_count.cu``).
#: Chosen from the card's device times of both modes at the serve's four
#: probe-table sizes (4 x 4096 .. 4 x 2^18), which ``chip_smoke.py``
#: prints (PERF.md).
JOIN_STAGE_MIN_PROBES = 1 << 17
#: keys a staged call samples into shared memory (``kMaxSamples``)
JOIN_SAMPLES = 8192


def _join_search(probe: torch.Tensor, keys_sorted: torch.Tensor,
                 want_lo: bool, stage_min: int = JOIN_STAGE_MIN_PROBES
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(lo or None, cnt) of each probe on the card: one ``join_count``
    call (``stage_min`` other than the threshold is for measuring the
    two modes, as ``chip_smoke.py`` does)."""
    probe = _i32("join_count", probe)
    keys = _i32("join_count", keys_sorted)
    n = probe.numel()
    cnt = torch.empty_like(probe)
    lo = torch.empty_like(probe) if want_lo else None
    samples = torch.empty(JOIN_SAMPLES, dtype=_I32, device=probe.device) \
        if n >= stage_min else None
    _launch("join_count", probe, n, keys, keys.numel(), lo, cnt, stage_min,
            samples)
    return lo, cnt


def join_range(probe: torch.Tensor, keys_sorted: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, cnt), both int32: ``probe[i]``'s run in the ascending int32
    key column ``keys_sorted`` is ``[lo[i], lo[i] + cnt[i])`` (lo is
    searchsorted side="left"; cnt the multiplicity).

    On the card it replaces the TPU's ``semijoin.py::_count_kernel``
    with ``csrc/join_count.cu``, bound by the L2 sectors its dependent
    loads touch: one search a probe, the run's end by a short gallop;
    calls of at least ``JOIN_STAGE_MIN_PROBES`` probes first stage
    ``JOIN_SAMPLES`` sampled keys in shared memory and interpolate
    within the window two samples bracket."""
    _vectors("join_range", probe)
    _vectors("join_range", keys_sorted)
    if not _on_card("join_range", probe, keys_sorted):
        return ref.join_range_ref(probe, keys_sorted)
    return _join_search(probe, keys_sorted, True)


def join_count(probe: torch.Tensor, keys_sorted: torch.Tensor
               ) -> torch.Tensor:
    """counts[i] = multiplicity of ``probe[i]`` in the ascending int32
    key column ``keys_sorted`` (the ``cnt`` of ``join_range``, from the
    same kernel with no ``lo`` written)."""
    _vectors("join_count", probe)
    _vectors("join_count", keys_sorted)
    if not _on_card("join_count", probe, keys_sorted):
        return ref.join_count_ref(probe, keys_sorted)
    return _join_search(probe, keys_sorted, False)[1]


#: semijoin calls with fewer queries search the table directly; larger
#: ones first stage every 2^k-th key in shared memory (``csrc/semijoin.cu``,
#: the staged search of ``join_count``).  Below it the sample gather's
#: launch and the persistent grid cost more than the L2 sectors the
#: staged search saves.  Chosen from the card's device times of both
#: modes on the store's largest window at 4 x 4096 to 4 x 2^18 queries,
#: which ``chip_smoke.py``'s ``semijoin modes`` lines print (PERF.md).
SEMI_STAGE_MIN_PROBES = 1 << 17


def _semijoin_launch(queries: torch.Tensor, table_sorted: torch.Tensor,
                     stage_min: int = SEMI_STAGE_MIN_PROBES) -> torch.Tensor:
    """The membership mask on the card: one ``semijoin`` call
    (``stage_min`` other than the threshold is for measuring the two
    modes, as ``chip_smoke.py`` does)."""
    queries = _i32("semijoin", queries)
    table = _i32("semijoin", table_sorted)
    n = queries.numel()
    out = torch.empty(queries.shape, dtype=torch.bool, device=queries.device)
    samples = torch.empty(JOIN_SAMPLES, dtype=_I32, device=queries.device) \
        if n >= stage_min else None
    _launch("semijoin", queries, n, table, table.numel(), out, stage_min,
            samples)
    return out


def semijoin(queries: torch.Tensor, table_sorted: torch.Tensor
             ) -> torch.Tensor:
    """mask[i] = ``queries[i]`` occurs in the ascending int32 column
    ``table_sorted``; empty sides give an all-False mask.

    On the card it replaces the TPU's ``semijoin.py::_semijoin_kernel``
    with ``csrc/semijoin.cu``, bound by the L2 sectors of its dependent
    loads: one search a query, staged as ``join_count``'s from
    ``SEMI_STAGE_MIN_PROBES`` queries."""
    _vectors("semijoin", queries)
    _vectors("semijoin", table_sorted)
    if not _on_card("semijoin", queries, table_sorted):
        return ref.semijoin_mask_ref(queries, table_sorted)
    return _semijoin_launch(queries, table_sorted)


#: most sites one launch of a match-loop join kernel serves
#: (``rt::kMaxSites``); the wrappers raise above it
MAX_SITES = 64
#: pair_semijoin calls with fewer queries (per site) search each table
#: directly; larger ones on one-run tables stage sampled subjects in
#: shared memory (``csrc/pair_semijoin.cu``).  Chosen from the card's
#: device times of both modes at the serve's tiers, which
#: ``chip_smoke.py`` prints (PERF.md): at 4 sites x 16,384 queries the
#: two are even, at 4 x 65,536 staging takes well under half the time.
PAIR_STAGE_MIN_PROBES = 1 << 15


def _site_spans(name: str, table: torch.Tensor, m: int,
                windows: Optional[ref.SiteWindows]
                ) -> Tuple[list, list, int]:
    """(offsets, live rows, size) of each site's table in ``table``'s
    storage: the whole 1-D table for every site, row j of an (m, W)
    table, or the ``windows`` over those rows (in elements)."""
    if not 1 <= m <= MAX_SITES:
        raise ValueError(f"{name}: the kernel serves 1 to {MAX_SITES} "
                         f"sites a call, got {m}")
    if table.dim() == 1:
        if windows is not None:
            raise ValueError(f"{name}: windows need (m, W) tables")
        return [0] * m, [table.shape[0]] * m, table.shape[0]
    W = table.shape[1]
    if windows is None:
        return [j * W for j in range(m)], [W] * m, W
    if len(windows.starts) != m or len(windows.lives) != m \
            or any(s < 0 or s + windows.size > W for s in windows.starts) \
            or any(not 0 <= n <= windows.size for n in windows.lives):
        raise ValueError(f"{name}: windows {windows} do not fit {m} sites "
                         f"of {W} rows")
    return ([j * W + s for j, s in enumerate(windows.starts)],
            list(windows.lives), windows.size)


def _host_array(ctype, values) -> ctypes.Array:
    return (ctype * len(values))(*values)


def _query_strides(name: str, q: torch.Tensor, m: int) -> Tuple[int, int]:
    """(site stride, element stride) of a (C,) or (m, C) int32 query
    column, read in place (a column of a binding table included)."""
    if q.dtype != _I32:
        raise TypeError(f"{name}: expected int32, got {q.dtype}")
    if q.dim() == 1:
        return 0, q.stride(0)
    return q.stride(0), q.stride(1)


def _pair_launch(q_s: torch.Tensor, q_o: torch.Tensor, t_s: torch.Tensor,
                 t_o: torch.Tensor, runs: int,
                 windows: Optional[ref.SiteWindows], m: int,
                 stage_min: int = PAIR_STAGE_MIN_PROBES) -> torch.Tensor:
    """(m, C) membership on the card: one launch, two when staged."""
    C = q_s.shape[-1]
    t_s, t_o = _i32("pair_semijoin", t_s), _i32("pair_semijoin", t_o)
    offs, lives, size = _site_spans("pair_semijoin", t_s, m, windows)
    if size % runs:
        raise ValueError(f"pair_semijoin: {size} table rows do not split "
                         f"into {runs} equal runs")
    (qs_site, qs_step), (qo_site, qo_step) = (
        _query_strides("pair_semijoin", q, m) for q in (q_s, q_o))
    dev = q_s.device
    out = torch.empty((m, C), dtype=torch.bool, device=dev)
    staged = runs == 1 and C >= stage_min
    scratch = torch.empty(m * JOIN_SAMPLES, dtype=_I32,
                          device=dev) if staged else None
    _launch("pair_semijoin", q_s, qs_site, qs_step, q_o, qo_site, qo_step,
            C, t_s, t_o, _host_array(ctypes.c_longlong, offs),
            _host_array(ctypes.c_int, lives), m, size, runs, stage_min,
            scratch, out)
    return out


def pair_semijoin(q_s: torch.Tensor, q_o: torch.Tensor,
                  t_s: torch.Tensor, t_o: torch.Tensor) -> torch.Tensor:
    """mask[i] = some table row r has (t_s[r], t_o[r]) == (q_s[i],
    q_o[i]); neither side needs to be sorted.  On the card the table is
    lexsorted first (two stable sorts, as the reference wrapper does
    outside its kernel), then searched as one run by the kernel of
    ``pair_semijoin_runs``; the match loop calls that entry instead,
    with tables that are sorted already."""
    _vectors("pair_semijoin", q_s, q_o)
    _vectors("pair_semijoin", t_s, t_o)
    if not _on_card("pair_semijoin", q_s, q_o, t_s, t_o):
        return ref.pair_semijoin_ref(q_s, q_o, t_s, t_o)
    q_s, q_o = _i32("pair_semijoin", q_s), _i32("pair_semijoin", q_o)
    order = ref.lexsort((t_o, t_s))
    return _pair_launch(q_s, q_o, t_s[order], t_o[order], 1, None, 1)[0]


def pair_semijoin_runs(q_s: torch.Tensor, q_o: torch.Tensor,
                       t_s: torch.Tensor, t_o: torch.Tensor, runs: int = 1,
                       windows: Optional[ref.SiteWindows] = None
                       ) -> torch.Tensor:
    """(s, o) membership against tables the caller keeps sorted: each
    table is ``runs`` equal runs, each lexsorted by (s, o), sentinel
    pads (INT32_SENTINEL, INT32_SENTINEL) included as rows.

    Queries are (C,), shared by every site, or (m, C), one row a site,
    any strides (a column of a binding table is read in place).  Tables
    are (T,), one table for every site, or (m, W), one row a site, of
    which ``windows`` may name a tail-masked window each (the match
    loop's CSR windows, pads past each site's live rows).  Returns (C,)
    when both sides are 1-D, else (m, C).

    On the card it replaces the TPU's ``semijoin.py::_pair_kernel``
    with ``csrc/pair_semijoin.cu``, bound by the L2 sectors of its
    dependent loads: one (s, o) lower-bound search per query and run,
    no sort; one-run calls of at least ``PAIR_STAGE_MIN_PROBES`` queries
    stage sampled subjects in shared memory.  On the CPU the plain
    version runs after a check that every run is sorted (a ValueError
    otherwise); on the card nothing is checked."""
    if q_s.shape != q_o.shape or t_s.shape != t_o.shape \
            or q_s.dim() not in (1, 2) or t_s.dim() not in (1, 2) \
            or runs < 1:
        raise ValueError(f"pair_semijoin: expected (C,) or (m, C) query "
                         f"pairs, (T,) or (m, W) table pairs and runs >= 1, "
                         f"got {tuple(q_s.shape)}, {tuple(q_o.shape)}, "
                         f"{tuple(t_s.shape)}, {tuple(t_o.shape)}, {runs}")
    if q_s.dim() == 2 and t_s.dim() == 2 and q_s.shape[0] != t_s.shape[0]:
        raise ValueError(f"pair_semijoin: {q_s.shape[0]} query rows for "
                         f"{t_s.shape[0]} sites")
    if not _on_card("pair_semijoin", q_s, q_o, t_s, t_o):
        tabs = ref.site_tables(t_s, t_o, windows, INT32_SENTINEL) \
            if t_s.dim() == 2 else (t_s, t_o)
        if tabs[0].shape[-1] % runs or not ref.runs_sorted(*tabs, runs):
            raise ValueError(f"pair_semijoin: the table is not {runs} "
                             f"equal runs lexsorted by (s, o)")
        return ref.pair_semijoin_runs_ref(q_s, q_o, t_s, t_o, runs, windows)
    m = t_s.shape[0] if t_s.dim() == 2 else (
        q_s.shape[0] if q_s.dim() == 2 else 1)
    out = _pair_launch(q_s, q_o, t_s, t_o, runs, windows, m)
    return out[0] if q_s.dim() == 1 and t_s.dim() == 1 else out


def _dedup_scratch_bytes(C: int) -> int:
    """Bytes of one ``rt_dedup_rows`` call's scratch: ``_hash_size(C)``
    64-bit slots, then C alive bytes."""
    return 8 * _hash_size(C) + C


def _dedup_launch(bind: torch.Tensor, valid: torch.Tensor, masked: bool
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(masked table or None, keep) on the card: one ``dedup_rows``
    call, three device operations (memset, insert, keep pass)."""
    C, V = bind.shape
    if V == 0:
        raise ValueError("dedup_rows: the kernel needs at least one column")
    bind, valid = _i32("dedup_rows", bind), _flags("dedup_rows", valid)
    dev = bind.device
    scratch = torch.empty(_dedup_scratch_bytes(C), dtype=torch.uint8,
                          device=dev)
    keep = torch.empty(C, dtype=torch.bool, device=dev)
    out = torch.empty_like(bind) if masked else None
    _launch("dedup_rows", bind, valid, C, V, scratch, _hash_size(C), keep,
            out)
    return out, keep


def dedup_rows(bind: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """First-occurrence keep mask over the valid rows of a padded (C, V)
    int32 binding table: ``keep[i]`` iff ``valid[i]`` and no earlier
    valid row equals row ``i``.  Rows stay in place.

    On the card it replaces the TPU's ``semijoin.py::_dedup_kernel``
    with ``csrc/dedup_rows.cu``, bound by memory: a parallel insert
    into 64-bit slots of (row hash, row index) that marks every
    duplicate as it goes, then one streaming pass."""
    _table("dedup_rows", bind, valid)
    if not _on_card("dedup_rows", bind, valid):
        return ref.dedup_rows_ref(bind, valid)
    return _dedup_launch(bind, valid, False)[1]


def dedup_rows_masked(bind: torch.Tensor, valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dedup_rows`` with its mask applied, as the match loop uses it:
    (the table with every row that is not kept set to -1, keep), rows
    in place.  On the card the kernel's keep pass writes the table too,
    in the same call."""
    _table("dedup_rows", bind, valid)
    if not _on_card("dedup_rows", bind, valid):
        return ref.dedup_rows_masked_ref(bind, valid)
    return _dedup_launch(bind, valid, True)


#: rows of one tile of the fused join's scan (``kScanTile``)
FUSED_SCAN_TILE = 1024


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _fused_join_scratch(C: int, m: int) -> int:
    """int32 scratch of one ``rt_fused_join`` launch for m sites (the
    layout in ``csrc/fused_join.cu``)."""
    ntiles = max(1, -(-C // FUSED_SCAN_TILE))
    return (_round4(2 * m * ntiles) + 2 * _hash_size(C) + _round4(m)
            + _round4(-(-C // 4)) + 2 * m * C + m)


def fused_join_sites(bind: torch.Tensor, valid: torch.Tensor,
                     probe: torch.Tensor, keys: torch.Tensor,
                     payload: torch.Tensor, capacity: int,
                     windows: Optional[ref.SiteWindows] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Dedup the valid rows of one gathered (C, V) binding table, then
    join-expand the survivors' ``probe`` keys against each site's sorted
    (keys -> payload) edge table, row j of the (m, W) ``keys`` /
    ``payload`` (or ``windows`` over them, payload pads -1), into
    ``capacity`` rows a site.  Returns (new_bind (m, capacity, V),
    new_col (m, capacity), new_valid (m, capacity), overflow (m,)),
    overflow counting the rows that did not fit, with the int32 wrap
    guard of ``ref.expand_from_counts``.  ``probe`` may be any 1-D view
    (a column of ``bind`` is read in place).

    On the card it replaces the TPU's ``semijoin.py::_fused_join_kernel``
    with ``csrc/fused_join.cu``, bound by memory and search latency:
    four device operations for all m sites (one memset; the hash insert
    of ``dedup_rows`` once; a single-pass scan with decoupled look-back
    over grid.y = site; an expansion by output tile).  Each site's rows
    keep the input order (survivors in input order, matches in key
    order); the plain version, a loop over
    ``fused_join_ref``, keeps the sorted dedup order: the two agree on
    each site's row multiset and overflow count."""
    _table("fused_join", bind, valid, probe)
    if keys.dim() != 2 or payload.shape != keys.shape:
        raise ValueError(f"fused_join: expected (m, W) key and payload "
                         f"tables, got {tuple(keys.shape)}, "
                         f"{tuple(payload.shape)}")
    if capacity < 0:
        raise ValueError(f"fused_join: capacity must be >= 0, got {capacity}")
    if not _on_card("fused_join", bind, valid, probe, keys, payload):
        return ref.fused_join_sites_ref(bind, valid, probe, keys, payload,
                                        capacity, windows)
    C, V = bind.shape
    if V == 0:
        raise ValueError("fused_join: the kernel needs at least one column")
    if probe.dtype != _I32:
        raise TypeError(f"fused_join: expected int32, got {probe.dtype}")
    bind, valid = _i32("fused_join", bind), _flags("fused_join", valid)
    keys = _i32("fused_join", keys)
    payload = _i32("fused_join", payload)
    m = keys.shape[0]
    offs, lives, size = _site_spans("fused_join", keys, m, windows)
    dev = bind.device
    n_scratch = _fused_join_scratch(C, m)
    scratch = torch.empty(n_scratch, dtype=_I32, device=dev)
    out_bind = torch.empty((m, capacity, V), dtype=_I32, device=dev)
    out_col = torch.empty((m, capacity), dtype=_I32, device=dev)
    out_valid = torch.empty((m, capacity), dtype=torch.bool, device=dev)
    over = torch.empty(m, dtype=_I32, device=dev)
    _launch("fused_join", bind, valid, probe, probe.stride(0), C, V, keys,
            payload, _host_array(ctypes.c_longlong, offs),
            _host_array(ctypes.c_int, lives), m, size, capacity, scratch,
            n_scratch, out_bind, out_col, out_valid, over)
    return out_bind, out_col, out_valid, over


def fused_join(bind: torch.Tensor, valid: torch.Tensor, probe: torch.Tensor,
               keys_sorted: torch.Tensor, payload: torch.Tensor,
               capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """``fused_join_sites`` for one site: dedup the valid rows of a
    gathered (C, V) binding table, then join-expand the survivors'
    ``probe`` keys against a sorted (keys -> payload) edge table into
    ``capacity`` rows.  Returns (new_bind (capacity, V), new_col,
    new_valid, overflow).  The kernel keeps the input row order and the
    plain version the sorted dedup order; both give the same row
    multiset and overflow count."""
    _table("fused_join", bind, valid, probe)
    _vectors("fused_join", keys_sorted, payload)
    if capacity < 0:
        raise ValueError(f"fused_join: capacity must be >= 0, got {capacity}")
    if not _on_card("fused_join", bind, valid, probe, keys_sorted, payload):
        return ref.fused_join_ref(bind, valid, probe, keys_sorted, payload,
                                  capacity)
    out = fused_join_sites(bind, valid, probe, keys_sorted[None],
                           payload[None], capacity)
    return out[0][0], out[1][0], out[2][0], out[3][0]


#: head dims the flash kernel is built for
ATTENTION_HEAD_DIMS = (16, 32, 64, 128)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it in place (last dimension
    contiguous, every stride and the base 16-byte aligned), else a
    fresh contiguous copy (a new allocation, so aligned)."""
    if t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1]) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention with grouped-query
    heads: q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> [B, Hq, Sq, D] in
    q.dtype.  Queries occupy the last Sq positions of the timeline; a
    row that sees no key is 0 (``ref.attention_ref``).  On the card:
    bf16 or float32, D in ``ATTENTION_HEAD_DIMS``, any Sq and Skv.

    On the card it replaces the TPU's ``flash_attention.py::
    _attn_kernel`` with ``csrc/flash_attention.cu``, bound by its
    tensor-core operations at the prefill shapes: bf16 at D 64 or 128
    (scale > 0) runs the warp-specialised wgmma + TMA kernel, the rest
    ``mma.sync`` (bf16) or FMAs (float32).  The card's result is a [B,
    Sq, Hq, D] buffer viewed as [B, Hq, Sq, D], so ``out.transpose(1,
    2)`` (the model's merge of the heads) is contiguous.

    It has no backward, on either device: with grad mode on, a q, k or
    v that requires grad is refused (``RuntimeError``), as ``jax.grad``
    through the reference's Pallas kernel fails.  Training takes the
    plain attention path (``use_flash_kernel=False``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "attention: the flash kernel has no backward; run it under "
            "torch.no_grad() or train with use_flash_kernel=False (plain "
            "attention)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"attention: expected q [B, Hq, Sq, D] and k, v "
                         f"[B, Hkv, Skv, D] with Hq % Hkv == 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"attention: window must be >= 1, got {window}")
    if not _on_card("attention", q, k, v):
        return ref.attention_ref(q, k, v, causal, window, scale)
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: expected bf16 or float32 q, k, v of "
                        f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in ATTENTION_HEAD_DIMS:
        raise ValueError(f"attention: head dim {D} not in "
                         f"{ATTENTION_HEAD_DIMS}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    _launch("flash_attention", q, k, v, out, B, Hq, Hkv, Sq, Skv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal),
            window or 0, scale if scale is not None else 1.0 / math.sqrt(D),
            int(q.dtype == torch.bfloat16))
    return out
