"""Plain versions of the port's join kernels vs the JAX package.

Every comparison here is exact (integer or boolean array equality): the
same seeded numpy inputs go through ``repro_torch.kernels`` on the CPU
(where each wrapper runs its plain version) and through the JAX
package's jnp oracles, its Pallas ``join_count``/``pair_semijoin`` in
interpret mode, and its ``_dedup_padded`` + ``_expand_fixed``
composition with ``REPRO_SPMD_PALLAS=0``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import spmd as jspmd
from repro.kernels import join_count as j_join_count
from repro.kernels import pair_semijoin as j_pair_semijoin
from repro.kernels import ref as jref
from repro.kernels.ops import compact_rows as j_compact_rows
from repro_torch.core import spmd as tspmd
from repro_torch.kernels import ops, ref

INT32_MAX = np.iinfo(np.int32).max
INT32_MIN = np.iinfo(np.int32).min


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture
def no_launches():
    """Wrappers given CPU tensors run the plain version: no launch."""
    ops.reset_launches()
    yield
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


def test_lexsort_matches_numpy():
    rng = np.random.default_rng(0)
    keys = [rng.integers(0, 4, 300).astype(np.int32) for _ in range(3)]
    _eq(ref.lexsort([_t(k) for k in keys]), np.lexsort(keys))


@pytest.mark.parametrize("m,n", [(1, 1), (100, 1000), (2000, 2000),
                                 (513, 1025)])
def test_join_count_matches_reference(m, n, no_launches):
    rng = np.random.default_rng(m * 7 + n)
    table = np.sort(rng.integers(0, 400, size=n).astype(np.int32))
    queries = rng.integers(0, 500, size=m).astype(np.int32)
    got = ops.join_count(_t(queries), _t(table))
    assert got.dtype == torch.int32
    _eq(got, jref.join_count_ref(jnp.asarray(queries), jnp.asarray(table)))
    _eq(got, j_join_count(jnp.asarray(queries), jnp.asarray(table)))


@pytest.mark.parametrize("fill", [-1, INT32_MAX])
def test_join_count_padded_sentinel_parity(fill, no_launches):
    rng = np.random.default_rng(5)
    real = rng.integers(0, 300, size=700).astype(np.int32)
    table = np.sort(np.concatenate([real, np.full(345, fill, np.int32)]))
    queries = rng.integers(0, 400, size=500).astype(np.int32)
    if fill == -1:
        queries = np.concatenate([queries, np.full(77, fill, np.int32)])
    got = ops.join_count(_t(queries), _t(table))
    _eq(got, j_join_count(jnp.asarray(queries), jnp.asarray(table)))
    # all-padding tables: sentinel rows never meet a real id, -1 rows
    # count exactly the -1 probes
    sent = np.full(1000, INT32_MAX, np.int32)
    _eq(ops.join_count(_t(queries), _t(sent)), np.zeros(len(queries)))
    neg = np.full(1000, -1, np.int32)
    _eq(ops.join_count(_t(queries), _t(neg)), (queries == -1) * 1000)


@pytest.mark.parametrize("m,n", [(1, 1), (100, 1000), (513, 1025),
                                 (1500, 1000)])
def test_pair_semijoin_matches_reference(m, n, no_launches):
    rng = np.random.default_rng(m + 3 * n)
    t_s, t_o = (rng.integers(0, 60, size=n).astype(np.int32)
                for _ in range(2))
    q_s, q_o = (rng.integers(0, 70, size=m).astype(np.int32)
                for _ in range(2))
    got = ops.pair_semijoin(_t(q_s), _t(q_o), _t(t_s), _t(t_o))
    want = j_pair_semijoin(jnp.asarray(q_s), jnp.asarray(q_o),
                           jnp.asarray(t_s), jnp.asarray(t_o))
    _eq(got, want)
    _eq(got, jref.pair_semijoin_ref(jnp.asarray(q_s), jnp.asarray(q_o),
                                    jnp.asarray(t_s), jnp.asarray(t_o)))


def test_pair_semijoin_padded_and_empty(no_launches):
    rng = np.random.default_rng(9)
    pad = np.full(112, INT32_MAX, np.int32)
    t_s = np.concatenate([rng.integers(0, 50, 400).astype(np.int32), pad])
    t_o = np.concatenate([rng.integers(0, 50, 400).astype(np.int32), pad])
    q_s, q_o = (rng.integers(0, 50, 300).astype(np.int32) for _ in range(2))
    _eq(ops.pair_semijoin(_t(q_s), _t(q_o), _t(t_s), _t(t_o)),
        j_pair_semijoin(jnp.asarray(q_s), jnp.asarray(q_o),
                        jnp.asarray(t_s), jnp.asarray(t_o)))
    empty = torch.zeros(0, dtype=torch.int32)
    assert not ops.pair_semijoin(_t(q_s), _t(q_o), empty, empty).any()
    assert ops.pair_semijoin(empty, empty, _t(t_s), _t(t_o)).shape == (0,)


def _bind_case(C, V, style, seed):
    rng = np.random.default_rng(seed)
    if style == "dup_heavy":
        bind = rng.integers(0, 3, (C, V)).astype(np.int32)
        valid = rng.random(C) < 0.9
    elif style == "all_sentinel":
        bind = np.full((C, V), -1, np.int32)
        valid = np.zeros(C, bool)
    elif style == "all_valid_distinct":
        bind = np.arange(C * V, dtype=np.int32).reshape(C, V)
        valid = np.ones(C, bool)
    elif style == "gathered":
        # an all-gather of 4 replicated fragments: one site table of C/4
        # rows in each block, each block shuffled, about 30% invalid
        site = rng.integers(0, 40, (C // 4, V)).astype(np.int32)
        bind = np.concatenate([site[rng.permutation(C // 4)]
                               for _ in range(4)])
        valid = rng.random(C) < 0.7
        bind[~valid] = -1
    else:                                   # random with padding holes
        bind = rng.integers(0, 40, (C, V)).astype(np.int32)
        valid = rng.random(C) < 0.7
        bind[~valid] = -1
    return bind, valid


def _first_occurrence_keep(bind, valid):
    seen, keep = set(), np.zeros(len(valid), bool)
    for i in range(len(valid)):
        key = tuple(bind[i].tolist())
        if valid[i] and key not in seen:
            seen.add(key)
            keep[i] = True
    return keep


@pytest.mark.parametrize("C,V", [(8, 1), (64, 3), (256, 2), (128, 5),
                                 (512, 4), (16, 0), (64, 1), (64, 4),
                                 (64, 6), (1000, 1), (1000, 4), (1000, 6)])
@pytest.mark.parametrize("style", ["random", "dup_heavy", "all_sentinel",
                                   "all_valid_distinct", "gathered"])
def test_dedup_matches_reference(C, V, style, monkeypatch, no_launches):
    monkeypatch.setenv("REPRO_SPMD_PALLAS", "0")
    bind, valid = _bind_case(C, V, style, seed=C * 31 + V)
    keep = ops.dedup_rows(_t(bind), _t(valid))
    want_keep = jref.dedup_rows_ref(jnp.asarray(bind), jnp.asarray(valid))
    _eq(keep, want_keep)
    if V:
        _eq(keep, _first_occurrence_keep(bind, valid))
    # the card's path form: the reference's kernel branch of
    # _dedup_padded (its keep mask, then a where), rows in place
    got_b, got_k = ops.dedup_rows_masked(_t(bind), _t(valid))
    _eq(got_k, want_keep)
    _eq(got_b, jnp.where(want_keep[:, None], jnp.asarray(bind), -1))
    # the sorted form used on the CPU path of the match loop is the
    # reference's _dedup_padded, array for array
    got_b, got_k = tspmd._dedup_padded(_t(bind), _t(valid))
    want_b, want_k = jspmd._dedup_padded(jnp.asarray(bind),
                                         jnp.asarray(valid))
    _eq(got_b, want_b)
    _eq(got_k, want_k)


def _row_hash_py(row):
    """The dedup kernel's row hash (``csrc/dedup.cuh``) in Python ints."""
    mask = 0xFFFFFFFF
    h = 0x811C9DC5
    for x in row:
        h = ((h ^ (int(x) & mask)) * 0x9E3779B1) & mask
        h ^= h >> 15
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & mask
    return h ^ (h >> 16)


@pytest.mark.parametrize("V", [1, 4, 6])
def test_row_hash_ref_is_the_kernels_hash(V):
    """``ref.row_hash_ref`` (which counts the hash collisions of the
    card's dedup checks) is the kernel's 32-bit hash, negative ids and
    the int32 extremes included."""
    rng = np.random.default_rng(V)
    bind = rng.integers(INT32_MIN, INT32_MAX, (300, V), dtype=np.int64)
    bind[:3] = np.array([INT32_MIN, INT32_MAX, -1])[:, None]
    bind = bind.astype(np.int32)
    got = ref.row_hash_ref(_t(bind))
    assert got.dtype == torch.int64
    _eq(got, [_row_hash_py(r) for r in bind])


def _edge_table(T, n_real, key_range, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, key_range, n_real).astype(np.int32))
    keys = np.concatenate([keys, np.full(T - n_real, INT32_MAX, np.int32)])
    payload = np.concatenate([rng.integers(0, 99, n_real).astype(np.int32),
                              np.full(T - n_real, -1, np.int32)])
    return keys, payload


def _reference_join(bind, valid, keys, payload, capacity):
    """The JAX package's composition of record (REPRO_SPMD_PALLAS=0):
    dedup, then the probe column of the deduped table, then expand."""
    db, dv = jspmd._dedup_padded(jnp.asarray(bind), jnp.asarray(valid))
    return jspmd._expand_fixed(db, dv, db[:, 0], jnp.asarray(keys),
                               jnp.asarray(payload), capacity)


def _check_join(bind, valid, keys, payload, capacity):
    got = ops.fused_join(_t(bind), _t(valid), _t(bind[:, 0]), _t(keys),
                         _t(payload), capacity)
    want = _reference_join(bind, valid, keys, payload, capacity)
    for g, w in zip(got, want):
        _eq(g, w)
    return int(got[3])


@pytest.mark.parametrize("C,V,T,capacity", [
    (64, 2, 64, 256), (128, 3, 32, 512), (64, 2, 8, 256), (256, 4, 128, 1024),
])
@pytest.mark.parametrize("style", ["random", "dup_heavy", "all_sentinel"])
def test_fused_join_matches_reference_composition(C, V, T, capacity, style,
                                                  monkeypatch, no_launches):
    monkeypatch.setenv("REPRO_SPMD_PALLAS", "0")
    bind, valid = _bind_case(C, V, style, seed=C + T)
    keys, payload = _edge_table(T, max(T // 2, 1), 40, seed=C * T)
    assert _check_join(bind, valid, keys, payload, capacity) == 0


def test_fused_join_empty_property_table(monkeypatch, no_launches):
    monkeypatch.setenv("REPRO_SPMD_PALLAS", "0")
    bind, valid = _bind_case(64, 2, "random", seed=9)
    keys = np.full(16, INT32_MAX, np.int32)
    payload = np.full(16, -1, np.int32)
    assert _check_join(bind, valid, keys, payload, 128) == 0


@pytest.mark.parametrize("capacity", [1, 4, 16])
def test_fused_join_overflow_matches_reference(capacity, monkeypatch,
                                               no_launches):
    """Under overflow the truncated rows and the count both match: the
    plain version keeps the reference's sorted row order."""
    monkeypatch.setenv("REPRO_SPMD_PALLAS", "0")
    bind, valid = _bind_case(128, 2, "dup_heavy", seed=3)
    keys, payload = _edge_table(64, 64, 3, seed=4)
    assert _check_join(bind, valid, keys, payload, capacity) > 0


def test_expand_wrap_guard_reports_capacity_plus_one(monkeypatch,
                                                     no_launches):
    """A count above (2^31-1)/C could wrap the int32 scan: both packages
    report capacity + 1 instead of a count."""
    monkeypatch.setenv("REPRO_SPMD_PALLAS", "0")
    C, capacity = 1 << 16, 16
    bind = np.zeros((C, 1), np.int32)
    valid = np.zeros(C, bool)
    valid[:3] = True
    bind[:3, 0] = [5, 6, 7]
    keys = np.full(40000, 5, np.int32)           # 40000 > (2^31-1) / C
    payload = np.arange(40000, dtype=np.int32)
    assert _check_join(bind, valid, keys, payload, capacity) == capacity + 1
    got = tspmd._expand_fixed(_t(bind), _t(valid), _t(bind[:, 0]), _t(keys),
                              _t(payload), capacity)
    want = jspmd._expand_fixed(jnp.asarray(bind), jnp.asarray(valid),
                               jnp.asarray(bind[:, 0]), jnp.asarray(keys),
                               jnp.asarray(payload), capacity)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("n,size,fill", [(50, 16, -1), (50, 64, INT32_MAX),
                                         (40, 8, -1)])
def test_compact_rows_matches_reference(n, size, fill):
    rng = np.random.default_rng(n + size)
    sel = rng.random(n) < 0.4
    col = rng.integers(0, 99, n).astype(np.int32)
    tab = rng.integers(0, 99, (n, 3)).astype(np.int32)
    (gc, gt), gok = ops.compact_rows(_t(sel), (_t(col), _t(tab)), size, fill)
    (wc, wt), wok = j_compact_rows(jnp.asarray(sel),
                                   (jnp.asarray(col), jnp.asarray(tab)),
                                   size, fill)
    _eq(gc, wc)
    _eq(gt, wt)
    _eq(gok, wok)


def test_wrappers_refuse_other_devices():
    """Dispatch is by device only: no kernel for a device that is
    neither the CPU nor CUDA, and no mixing."""
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.join_count(meta, meta)
    with pytest.raises(ValueError):
        ops.join_count(torch.zeros(4, dtype=torch.int32), meta)
    with pytest.raises(ValueError):
        ops.dedup_rows_masked(torch.zeros((4, 2), dtype=torch.int32),
                              torch.zeros(4, dtype=torch.bool,
                                          device="meta"))


def test_wrappers_refuse_mismatched_shapes():
    """The kernels index their inputs in lock step; the wrappers refuse
    shapes that would make them read past an end."""
    i = torch.zeros(8, dtype=torch.int32)
    b = torch.zeros((8, 2), dtype=torch.int32)
    v = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        ops.join_count(b, i)
    with pytest.raises(ValueError):
        ops.pair_semijoin(i, i[:4], i, i)
    with pytest.raises(ValueError):
        ops.dedup_rows(b, v[:4])
    with pytest.raises(ValueError):
        ops.dedup_rows_masked(b, v[:4])
    with pytest.raises(ValueError):
        ops.dedup_rows_masked(i, v)
    with pytest.raises(ValueError):
        ops.fused_join(b, v, i[:4], i, i, 4)
    with pytest.raises(ValueError):
        ops.fused_join(b, v, i, i, i[:4], 4)
    with pytest.raises(ValueError):
        ops.fused_join(b, v, i, i, i, -1)


def _range_cases():
    """Key columns as the match loop sees them, and probes around them."""
    rng = np.random.default_rng(11)
    i32 = np.int32
    cases = {}
    # a property window: real keys, then INT32_MAX pads; probes from it,
    # around it, and the sentinel an invalid binding row probes with
    real = np.sort(rng.integers(0, 300, 700)).astype(i32)
    cases["sentinel_window"] = (
        np.concatenate([rng.integers(-20, 340, 400),
                        [INT32_MAX, INT32_MAX]]).astype(i32),
        np.concatenate([real, np.full(300, INT32_MAX, i32)]))
    # Zipf hub runs: a few keys repeat thousands of times
    runs = np.minimum(rng.zipf(1.5, 400), 3000)
    cases["hub_runs"] = (rng.integers(-3, 803, 1000).astype(i32),
                         np.repeat(np.arange(400, dtype=i32) * 2, runs))
    cases["one_long_run"] = (np.array([4, 5, 6, INT32_MIN, INT32_MAX], i32),
                             np.full(5000, 5, i32))
    cases["empty_keys"] = (rng.integers(0, 9, 50).astype(i32),
                           np.zeros(0, i32))
    cases["empty_probes"] = (np.zeros(0, i32), np.arange(10, dtype=i32))
    # probes below and above the whole key range, int32 extremes included
    cases["outside_range"] = (
        np.concatenate([rng.integers(-10 ** 9, 1000, 100),
                        rng.integers(2000, 10 ** 9, 100),
                        [INT32_MIN, INT32_MAX, 999, 2000]]).astype(i32),
        np.sort(rng.integers(1000, 2000, 500)).astype(i32))
    return cases


@pytest.mark.parametrize("name", sorted(_range_cases()))
def test_join_range_matches_searchsorted_and_jax(name, no_launches):
    """lo is searchsorted side="left" and cnt the JAX package's
    join_count (its Pallas kernel in interpret mode and its oracle)."""
    probe, keys = _range_cases()[name]
    lo, cnt = ops.join_range(_t(probe), _t(keys))
    assert lo.dtype == cnt.dtype == torch.int32
    _eq(lo, torch.searchsorted(_t(keys), _t(probe)))
    _eq(lo, np.searchsorted(keys, probe, side="left"))
    _eq(cnt, jref.join_count_ref(jnp.asarray(probe), jnp.asarray(keys)))
    # the Pallas kernel pads its blocks with INT32_MAX, so a probe equal
    # to INT32_MAX also counts that padding: compare the other probes
    real = probe != INT32_MAX
    _eq(cnt.numpy()[real],
        np.asarray(j_join_count(jnp.asarray(probe), jnp.asarray(keys)))[real])
    _eq(ops.join_count(_t(probe), _t(keys)), cnt)
    got_lo, got_cnt = ref.join_range_ref(_t(probe), _t(keys))
    _eq(got_lo, lo)
    _eq(got_cnt, cnt)


def _expand_three_searches(bind, valid, col, keys, payload, capacity):
    """``_expand_fixed`` as it was before ``join_range``: lo from its own
    searchsorted, counts from ``join_count``'s two."""
    from repro_torch.constants import INT32_SENTINEL
    probe = torch.where(valid, col, INT32_SENTINEL)
    lo = torch.searchsorted(keys, probe)
    cnt = torch.where(valid, ops.join_count(probe, keys), 0).to(torch.int32)
    return ref.expand_from_counts(bind, lo, cnt, payload, capacity)


@pytest.mark.parametrize("capacity", [4, 64, 4096])
@pytest.mark.parametrize("style", ["random", "dup_heavy", "all_sentinel"])
def test_expand_fixed_is_bit_identical_to_the_three_search_form(
        style, capacity, no_launches):
    bind, valid = _bind_case(256, 3, style, seed=capacity)
    keys, payload = _edge_table(512, 400, 40, seed=7)
    args = (_t(bind), _t(valid), _t(bind[:, 0]), _t(keys), _t(payload),
            capacity)
    got = tspmd._expand_fixed(*args)
    want = _expand_three_searches(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_expand_fixed_searches_the_key_column_only_in_join_range(
        monkeypatch, no_launches):
    """One search a probe: the only look-up of the key column is the
    join_range call (one kernel launch on the card)."""
    bind, valid = _bind_case(128, 2, "random", seed=5)
    keys, payload = _edge_table(256, 200, 40, seed=6)
    kt = _t(keys)
    calls = {"join_range": 0, "searchsorted_on_keys": 0}
    real_join_range, real_searchsorted = tspmd.join_range, torch.searchsorted

    def join_range(probe, keys_sorted):
        calls["join_range"] += 1
        calls["inside"] = True          # its plain version searches here
        try:
            return real_join_range(probe, keys_sorted)
        finally:
            calls["inside"] = False

    def searchsorted(seq, values, **kw):
        if seq is kt and not calls["inside"]:
            calls["searchsorted_on_keys"] += 1
        return real_searchsorted(seq, values, **kw)

    calls["inside"] = False
    monkeypatch.setattr(tspmd, "join_range", join_range)
    monkeypatch.setattr(torch, "searchsorted", searchsorted)
    got = tspmd._expand_fixed(_t(bind), _t(valid), _t(bind[:, 0]), kt,
                              _t(payload), 512)
    assert calls["join_range"] == 1
    assert calls["searchsorted_on_keys"] == 0
    assert int(got[3]) == 0


def _site_arrays(m, W, size, seed):
    """(m, W) CSR-like key/payload arrays holding one sorted (key,
    payload) run per site at its own offset, and the windows over them
    (one site's window empty)."""
    rng = np.random.default_rng(seed)
    keys = np.full((m, W), INT32_MAX, np.int32)
    pay = np.full((m, W), -1, np.int32)
    starts, lives = [], []
    for j in range(m):
        n = 0 if j == 1 else int(rng.integers(1, size + 1))
        start = int(rng.integers(0, W - size + 1))
        k = rng.integers(0, 40, n).astype(np.int32)
        p = rng.integers(0, 99, n).astype(np.int32)
        order = np.lexsort((p, k))
        keys[j, start:start + n], pay[j, start:start + n] = k[order], p[order]
        # the rows past the window's live part belong to other runs
        keys[j, start + n:] = rng.integers(0, 40, W - start - n)
        starts.append(start)
        lives.append(n)
    return keys, pay, ref.SiteWindows(tuple(starts), tuple(lives), size)


@pytest.mark.parametrize("C,V,capacity", [(64, 2, 256), (128, 3, 512),
                                          (256, 4, 64)])
@pytest.mark.parametrize("style", ["random", "dup_heavy", "all_sentinel"])
def test_fused_join_sites_matches_reference_per_site(C, V, capacity, style,
                                                     monkeypatch,
                                                     no_launches):
    """Each site of one call equals ``fused_join_ref`` against that
    site's window and the JAX package's ``_dedup_padded`` +
    ``_expand_fixed`` composition (REPRO_SPMD_PALLAS=0)."""
    monkeypatch.setenv("REPRO_SPMD_PALLAS", "0")
    bind, valid = _bind_case(C, V, style, seed=C + V)
    keys, pay, win = _site_arrays(4, 300, 96, seed=C * V)
    got = ops.fused_join_sites(_t(bind), _t(valid), _t(bind)[:, 0], _t(keys),
                               _t(pay), capacity, win)
    assert [tuple(g.shape) for g in got] == [(4, capacity, V),
                                             (4, capacity), (4, capacity),
                                             (4,)]
    tk, tp = ref.site_tables(_t(keys), _t(pay), win, -1)
    for j in range(4):
        one = ref.fused_join_ref(_t(bind), _t(valid), _t(bind[:, 0]), tk[j],
                                 tp[j], capacity)
        want = _reference_join(bind, valid, tk[j].numpy(), tp[j].numpy(),
                               capacity)
        for g, o, w in zip(got, one, want):
            _eq(g[j], o)
            _eq(g[j], w)


def test_fused_join_sites_overflow_and_wrap_per_site(monkeypatch,
                                                     no_launches):
    """Overflow counts are per site, the wrap guard included: only the
    site whose count could wrap the int32 scan reports capacity + 1."""
    monkeypatch.setenv("REPRO_SPMD_PALLAS", "0")
    C, capacity = 1 << 16, 16
    bind = np.zeros((C, 1), np.int32)
    valid = np.zeros(C, bool)
    valid[:3] = True
    bind[:3, 0] = [5, 6, 7]
    rng = np.random.default_rng(2)
    keys = np.sort(rng.integers(0, 12, (3, 40000)), axis=1).astype(np.int32)
    keys[0] = 5                                   # 40000 > (2^31-1) / C
    pay = np.arange(3 * 40000, dtype=np.int32).reshape(3, 40000)
    over = ops.fused_join_sites(_t(bind), _t(valid), _t(bind[:, 0]),
                                _t(keys), _t(pay), capacity)[3]
    for j in range(3):
        want = _reference_join(bind, valid, keys[j], pay[j], capacity)[3]
        assert int(over[j]) == int(want)
    assert int(over[0]) == capacity + 1
    assert bool((over[1:] != capacity + 1).all())


def _sorted_pair_table(n_rows, n_pad, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 30, n_rows).astype(np.int32)
    o = rng.integers(0, 30, n_rows).astype(np.int32)
    order = np.lexsort((o, s))
    pad = np.full(n_pad, INT32_MAX, np.int32)
    return np.concatenate([s[order], pad]), np.concatenate([o[order], pad])


def _pair_queries(C, seed):
    rng = np.random.default_rng(seed)
    q_s, q_o = (rng.integers(0, 32, C).astype(np.int32) for _ in range(2))
    q_s[:3], q_o[:3] = INT32_MAX, INT32_MAX        # the pad pair
    return q_s, q_o


def _j_pair(q_s, q_o, t_s, t_o):
    return jref.pair_semijoin_ref(jnp.asarray(q_s), jnp.asarray(q_o),
                                  jnp.asarray(t_s), jnp.asarray(t_o))


@pytest.mark.parametrize("runs", [1, 4])
@pytest.mark.parametrize("C", [0, 1, 300])
def test_pair_semijoin_runs_matches_reference(C, runs, no_launches):
    """One table of sorted runs with sentinel tails, queries shared
    (C,) and one row a site (m, C), against the JAX package's oracle."""
    parts = [_sorted_pair_table(50 + 3 * r, 14 - 3 * r, seed=r)
             for r in range(runs)]
    t_s = np.concatenate([p[0] for p in parts])
    t_o = np.concatenate([p[1] for p in parts])
    q_s, q_o = _pair_queries(C, seed=C)
    got = ops.pair_semijoin_runs(_t(q_s), _t(q_o), _t(t_s), _t(t_o), runs)
    assert got.shape == (C,)
    _eq(got, _j_pair(q_s, q_o, t_s, t_o))
    per_site = np.stack([np.roll(q_s, j) for j in range(3)])
    per_site_o = np.stack([np.roll(q_o, j) for j in range(3)])
    got = ops.pair_semijoin_runs(_t(per_site), _t(per_site_o), _t(t_s),
                                 _t(t_o), runs)
    assert got.shape == (3, C)
    for j in range(3):
        _eq(got[j], _j_pair(per_site[j], per_site_o[j], t_s, t_o))


def test_pair_semijoin_runs_sites_windows(no_launches):
    """The sites form on windows of (m, W) arrays: pads past each
    site's live rows are (INT32_MAX, INT32_MAX) rows, one window is
    empty, and an empty table matches nothing."""
    keys, pay, win = _site_arrays(4, 300, 96, seed=5)
    q_s, q_o = _pair_queries(200, seed=6)
    pick = np.random.default_rng(7).integers(0, win.lives[0], 50)
    q_s[3:53] = keys[0, win.starts[0] + pick]
    q_o[3:53] = pay[0, win.starts[0] + pick]
    got = ops.pair_semijoin_runs(_t(q_s), _t(q_o), _t(keys), _t(pay), 1,
                                 win)
    assert got.shape == (4, 200) and bool(got[0, 3:53].all())
    for j in range(4):
        s0, n = win.starts[j], win.lives[j]
        t_s = np.concatenate([keys[j, s0:s0 + n],
                              np.full(win.size - n, INT32_MAX, np.int32)])
        t_o = np.concatenate([pay[j, s0:s0 + n],
                              np.full(win.size - n, INT32_MAX, np.int32)])
        _eq(got[j], _j_pair(q_s, q_o, t_s, t_o))
    empty = torch.zeros(0, dtype=torch.int32)
    assert not ops.pair_semijoin_runs(_t(q_s), _t(q_o), empty, empty).any()


def test_pair_semijoin_runs_rejects_unsorted_runs():
    """On the CPU the entry checks the contract it relies on on the card:
    every run lexsorted by (s, o)."""
    t_s, t_o = _sorted_pair_table(40, 8, seed=1)
    q_s, q_o = _pair_queries(20, seed=2)
    both = (np.concatenate([t_s, t_s]), np.concatenate([t_o, t_o]))
    ops.pair_semijoin_runs(_t(q_s), _t(q_o), _t(both[0]), _t(both[1]), 2)
    with pytest.raises(ValueError):      # two sorted runs are not one
        ops.pair_semijoin_runs(_t(q_s), _t(q_o), _t(both[0]), _t(both[1]), 1)
    s_run = np.array([1, 1, 2, 3], np.int32)
    ops.pair_semijoin_runs(_t(q_s), _t(q_o), _t(s_run),
                           _t(np.array([5, 6, 0, 0], np.int32)))
    with pytest.raises(ValueError):      # objects out of order in a run
        ops.pair_semijoin_runs(_t(q_s), _t(q_o), _t(s_run),
                               _t(np.array([6, 5, 0, 0], np.int32)))
    with pytest.raises(ValueError):      # runs that do not split the table
        ops.pair_semijoin_runs(_t(q_s), _t(q_o), _t(t_s), _t(t_o), 7)


@pytest.mark.parametrize("m", [0, ops.MAX_SITES + 1])
def test_site_spans_refuse_more_sites_than_one_launch_serves(m):
    """The card's launchers take 1 to ``MAX_SITES`` sites a call and
    raise for any other count before launching."""
    table = torch.zeros((max(m, 1), 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="sites a call"):
        ops._site_spans("fused_join", table, m, None)
    ops._site_spans("fused_join", table[:1], 1, None)
