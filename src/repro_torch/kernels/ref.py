"""Plain PyTorch versions of the hand-written kernels.

These are the semantics of record: ``kernels.ops`` runs them for
tensors on the CPU, the tests compare them with the JAX package's
oracles, and ``chip_smoke.py`` holds every CUDA kernel against them on
the card.  They are written with ordinary tensor ops and run on any
device.  torch has no ``lexsort``, so ``lexsort`` below chains stable
sorts, last key first.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..constants import INT32_SENTINEL

_I32 = torch.int32


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Indices that sort by ``keys`` like ``numpy.lexsort``: the LAST
    key is the primary one, ties keep their original order."""
    n = keys[0].shape[0]
    order = torch.arange(n, device=keys[0].device)
    for k in keys:                      # least significant key first
        order = order[torch.argsort(k[order], stable=True)]
    return order


def semijoin_mask_ref(queries: torch.Tensor, table_sorted: torch.Tensor
                      ) -> torch.Tensor:
    """mask[i] = any(table == queries[i]) over the ascending table;
    empty sides give an all-False mask.  Pads (INT32_MIN or INT32_MAX)
    match only a query equal to the pad, which real ids never are."""
    if table_sorted.shape[0] == 0:
        return torch.zeros(queries.shape, dtype=torch.bool,
                           device=queries.device)
    pos = torch.searchsorted(table_sorted, queries)
    pos = pos.clamp(max=table_sorted.shape[0] - 1)
    return table_sorted[pos] == queries


def join_count_ref(probe: torch.Tensor, keys_sorted: torch.Tensor
                   ) -> torch.Tensor:
    """counts[i] = multiplicity of ``probe[i]`` in the ascending key
    column (the expansion size of one binding row)."""
    lo = torch.searchsorted(keys_sorted, probe, right=False)
    hi = torch.searchsorted(keys_sorted, probe, right=True)
    return (hi - lo).to(_I32)


def join_range_ref(probe: torch.Tensor, keys_sorted: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, cnt), both int32: ``probe[i]``'s run in the ascending key
    column is ``[lo[i], lo[i] + cnt[i])``, lo being searchsorted
    side="left" (the expansion's source rows of one binding row)."""
    lo = torch.searchsorted(keys_sorted, probe, right=False)
    hi = torch.searchsorted(keys_sorted, probe, right=True)
    return lo.to(_I32), (hi - lo).to(_I32)


def pair_semijoin_ref(q_s: torch.Tensor, q_o: torch.Tensor,
                      t_s: torch.Tensor, t_o: torch.Tensor) -> torch.Tensor:
    """mask[i] = some table row r has (t_s[r], t_o[r]) == (q_s[i],
    q_o[i]).  Neither side needs to be sorted: lexsort the
    concatenation with table rows ordered before equal query rows, then
    a query row hits iff the nearest preceding table row carries the
    same pair (exact int32, no 42-bit key composition)."""
    T, Q = t_s.shape[0], q_s.shape[0]
    if T == 0 or Q == 0:
        return torch.zeros(q_s.shape, dtype=torch.bool, device=q_s.device)
    cs = torch.cat([t_s, q_s]).to(_I32)
    co = torch.cat([t_o, q_o]).to(_I32)
    flag = torch.cat([torch.zeros(T, dtype=_I32, device=cs.device),
                      torch.ones(Q, dtype=_I32, device=cs.device)])
    order = lexsort((flag, co, cs))
    fs, fo, ff = cs[order], co[order], flag[order]
    idx = torch.arange(T + Q, device=cs.device)
    last_tab = torch.cummax(torch.where(ff == 0, idx, -1), 0).values
    lt = last_tab.clamp(0, T + Q - 1)
    hit = (ff == 1) & (last_tab >= 0) & (fs[lt] == fs) & (fo[lt] == fo)
    out = torch.zeros(T + Q, dtype=torch.bool, device=cs.device)
    out[order] = hit
    return out[T:]


class SiteWindows(NamedTuple):
    """Site j's table is ``size`` rows of row j of an (m, W) array,
    from column ``starts[j]``; its first ``lives[j]`` rows are stored
    rows and the rest read as pads (key ``INT32_SENTINEL``, payload the
    caller's fill).  These are the match loop's tail-masked windows
    over the store's CSR arrays, which the kernels read in place."""
    starts: Tuple[int, ...]
    lives: Tuple[int, ...]
    size: int


def site_tables(keys: torch.Tensor, payload: torch.Tensor,
                windows: Optional[SiteWindows], pay_fill: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (m, size) key and payload tables ``windows`` names in the
    (m, W) arrays (the arrays themselves without ``windows``)."""
    if windows is None:
        return keys, payload
    idx = torch.arange(windows.size, device=keys.device)
    ks, ps = [], []
    for j, (start, live) in enumerate(zip(windows.starts, windows.lives)):
        stop = start + windows.size
        ks.append(torch.where(idx < live, keys[j, start:stop],
                              INT32_SENTINEL))
        ps.append(torch.where(idx < live, payload[j, start:stop], pay_fill))
    return torch.stack(ks), torch.stack(ps)


def runs_sorted(t_s: torch.Tensor, t_o: torch.Tensor, runs: int) -> bool:
    """Every one of the ``runs`` equal runs of each table row (the last
    dimension) is lexsorted by (s, o)."""
    if t_s.numel() == 0:
        return True
    s = t_s.reshape(-1, t_s.shape[-1] // runs)
    o = t_o.reshape(s.shape)
    ok = (s[:, 1:] > s[:, :-1]) | ((s[:, 1:] == s[:, :-1])
                                  & (o[:, 1:] >= o[:, :-1]))
    return bool(ok.all())


def pair_semijoin_runs_ref(q_s: torch.Tensor, q_o: torch.Tensor,
                           t_s: torch.Tensor, t_o: torch.Tensor,
                           runs: int = 1,
                           windows: Optional[SiteWindows] = None
                           ) -> torch.Tensor:
    """``pair_semijoin_ref`` per site: queries (C,) shared or (m, C) one
    row a site; tables (T,) shared or (m, W) one row a site (through
    ``windows``, pads (INT32_SENTINEL, INT32_SENTINEL)).  Returns (C,)
    when both sides are 1-D, else (m, C).  Membership does not depend
    on order, so ``runs`` only shapes the kernel's search."""
    if q_s.dim() == 1 and t_s.dim() == 1:
        return pair_semijoin_ref(q_s, q_o, t_s, t_o)
    if t_s.dim() == 2:
        t_s, t_o = site_tables(t_s, t_o, windows, INT32_SENTINEL)
    m = t_s.shape[0] if t_s.dim() == 2 else q_s.shape[0]

    def site(a, j):
        return a[j] if a.dim() == 2 else a
    return torch.stack([pair_semijoin_ref(site(q_s, j), site(q_o, j),
                                          site(t_s, j), site(t_o, j))
                        for j in range(m)])


def dedup_padded_ref(bind: torch.Tensor, valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact dedup of a padded binding table, rows returned sorted:
    (sorted table with duplicates and invalid rows set to -1, keep mask
    in sorted positions, the sorting permutation).  Valid rows sort
    first and ties keep their original order, so the first of each
    duplicate run is the earliest index."""
    C, V = bind.shape
    if V == 0:
        keep = torch.zeros(C, dtype=torch.bool, device=bind.device)
        keep[:1] = valid.any()
        return bind, keep, torch.arange(C, device=bind.device)
    keys = tuple(bind[:, v] for v in range(V - 1, -1, -1)) \
        + ((~valid).to(_I32),)
    order = lexsort(keys)
    bs, vs = bind[order], valid[order]
    dup = torch.zeros(C, dtype=torch.bool, device=bind.device)
    dup[1:] = (bs[1:] == bs[:-1]).all(dim=1) & vs[1:] & vs[:-1]
    keep = vs & ~dup
    return torch.where(keep[:, None], bs, -1), keep, order


def dedup_rows_ref(bind: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """keep[i] = valid[i] and no earlier valid row j < i has bind[j] ==
    bind[i] (all columns): first occurrence by original index, keep
    mask in original row positions."""
    _b, keep_sorted, order = dedup_padded_ref(bind, valid)
    if bind.shape[1] == 0:
        return keep_sorted
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep


def dedup_rows_masked_ref(bind: torch.Tensor, valid: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the table with every row that ``dedup_rows_ref`` does not keep
    set to -1, keep), rows in place: the match loop's form of the
    dedup on the card."""
    keep = dedup_rows_ref(bind, valid)
    return torch.where(keep[:, None], bind, -1), keep


def row_hash_ref(bind: torch.Tensor) -> torch.Tensor:
    """The dedup kernel's 32-bit hash of each row of a (C, V) int32
    table (``csrc/dedup.cuh`` ``row_hash``), as int64 values in [0,
    2^32).  Products are taken in 16-bit halves, so no int64 product
    overflows."""
    mask = 0xFFFFFFFF

    def mul(h, k):
        return ((h * (k & 0xFFFF)) + (((h * (k >> 16)) & 0xFFFF) << 16)) \
            & mask
    h = torch.full((bind.shape[0],), 0x811C9DC5, dtype=torch.int64,
                   device=bind.device)
    for v in range(bind.shape[1]):
        h = mul(h ^ (bind[:, v].to(torch.int64) & mask), 0x9E3779B1)
        h = h ^ (h >> 15)
    h = h ^ (h >> 13)
    h = mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def expand_from_counts(bind: torch.Tensor, lo: torch.Tensor,
                       cnt: torch.Tensor, payload: torch.Tensor,
                       capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Fixed-capacity join expansion once every binding row knows its
    run ``[lo, lo + cnt)`` in the sorted edge table: exclusive scan of
    the counts, then the inverse map output slot -> source row.

    Returns (new_bind (capacity, V), new_payload_col, new_valid,
    overflow).  The scan is int32 as on the reference (x64 off):
    ``sum(cnt)`` cannot wrap while every ``cnt <= (2^31-1)/C``, and a
    larger count is reported as a conservative overflow of
    ``capacity + 1`` so the retry ladder, not silent truncation,
    handles it."""
    C = bind.shape[0]
    dev = bind.device
    T = payload.shape[0]
    if C:
        wrap_risk = cnt.max() > (2 ** 31 - 1) // C
        start = torch.cumsum(cnt, 0, dtype=_I32) - cnt
        total = start[-1] + cnt[-1]
    else:
        wrap_risk = torch.zeros((), dtype=torch.bool, device=dev)
        start = cnt
        total = torch.zeros((), dtype=_I32, device=dev)
    t = torch.arange(capacity, dtype=_I32, device=dev)
    r = (torch.searchsorted(start, t, right=True) - 1).clamp(0, max(C - 1, 0))
    k = t - start[r]
    ok = (t < total) & (k < cnt[r])
    src = (lo[r] + k).clamp(0, max(T - 1, 0))
    new_col = torch.where(ok, payload[src], -1)
    new_bind = torch.where(ok[:, None], bind[r], -1)
    over = (total - capacity).clamp(min=0).to(_I32)
    over = torch.where(wrap_risk, torch.tensor(capacity + 1, dtype=_I32,
                                               device=dev), over)
    return new_bind, new_col, ok, over


def expand_fixed_ref(bind: torch.Tensor, valid: torch.Tensor,
                     col_vals: torch.Tensor, keys_sorted: torch.Tensor,
                     payload: torch.Tensor, capacity: int):
    """Join-expand a padded binding table against a sorted (keys ->
    payload) edge table into ``capacity`` rows (see
    ``expand_from_counts`` for the outputs)."""
    probe = torch.where(valid, col_vals, INT32_SENTINEL)
    lo, cnt = join_range_ref(probe, keys_sorted)
    cnt = torch.where(valid, cnt, 0).to(_I32)
    return expand_from_counts(bind, lo, cnt, payload, capacity)


def fused_join_ref(bind: torch.Tensor, valid: torch.Tensor,
                   probe: torch.Tensor, keys_sorted: torch.Tensor,
                   payload: torch.Tensor, capacity: int):
    """Dedup, then join-expand: the composition of record for the fused
    join (``dedup_padded_ref`` + ``expand_fixed_ref``, with ``probe``
    aligned to the input rows).  Output rows follow the sorted dedup
    order; the CUDA kernel keeps the input order instead, so the two
    agree on the row multiset and the overflow count."""
    db, dv, order = dedup_padded_ref(bind, valid)
    return expand_fixed_ref(db, dv, probe[order], keys_sorted, payload,
                            capacity)


def fused_join_sites_ref(bind: torch.Tensor, valid: torch.Tensor,
                         probe: torch.Tensor, keys: torch.Tensor,
                         payload: torch.Tensor, capacity: int,
                         windows: Optional[SiteWindows] = None):
    """``fused_join_ref`` of one binding table against each site's
    table, row j of the (m, W) ``keys`` / ``payload`` (through
    ``windows``, payload pads -1).  Returns (new_bind (m, capacity, V),
    new_col (m, capacity), new_valid (m, capacity), overflow (m,))."""
    keys, payload = site_tables(keys, payload, windows, -1)
    outs = [fused_join_ref(bind, valid, probe, keys[j], payload[j], capacity)
            for j in range(keys.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention, float32 inside.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; Hq % Hkv == 0 (GQA: query
    head h reads KV head h // (Hq // Hkv)).  Queries occupy the last Sq
    positions of the Skv timeline; key j is visible to query position i
    iff j <= i (causal) and i - window < j (sliding window).  A row
    that sees no key is 0.  Returns [B, Hq, Sq, D] in q.dtype.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s.masked_fill_(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num_(nan=0.0)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
