"""The paper's last RDF entry points in the port against the JAX
package: §4's ``mine_frequent_patterns``, the functional matcher API of
``core/spmd.py`` (``pattern_var_order``, ``local_match``,
``make_spmd_matcher`` / ``spmd_match`` over the site axis, on the
plain versions here) and the elastic re-planning of
``distributed/elastic.py`` (``plan_mesh``, ``replan_allocation``), the
JAX package's own tests of the last two run on both packages
(``torch_diff.run_reference_test``).  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import test_substrate as reference_substrate_tests
from generators import SHAPE_MAKERS, answer_set, random_graph, shape_workload
from repro.core.spmd import SiteStore as JStore
from repro.core.spmd import local_match as j_local_match
from repro.core.spmd import pattern_var_order as j_var_order
from repro.core.spmd import spmd_match as j_spmd_match
from repro.distributed import replan_allocation as j_replan
from repro.launch.mesh import make_host_mesh
from repro_torch.core import (RDFGraph, mine_frequent_patterns,
                              match_pattern)
from repro_torch.core.spmd import (SiteStore, local_match,
                                   make_spmd_matcher, pattern_var_order,
                                   spmd_match)
from repro_torch.core.workload import Workload
from repro_torch.distributed import replan_allocation
from repro_torch.kernels import ops
from torch_diff import port_query, run_reference_test

PACKAGES = ["repro", "repro_torch"]


@pytest.fixture(scope="module")
def graphs():
    """A seeded random graph in both packages."""
    g = random_graph(4321, n_verts=80, n_props=5, n_edges=500)
    return g, RDFGraph(g.s, g.p, g.o, g.num_vertices, g.num_properties)


@pytest.fixture
def no_launches():
    """Stores on the CPU run the plain versions: no kernel launches."""
    ops.reset_launches()
    yield
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


def _rows(cols, var_order):
    """Binding columns (variable -> values) as distinct rows in
    ``var_order``."""
    rows = np.stack([np.asarray(cols[v], np.int64) for v in var_order], 1) \
        if var_order else np.zeros((0, 0), np.int64)
    return np.unique(rows, axis=0) if rows.size else rows


def _edges(q):
    return [(e.src, e.dst, e.prop) for e in q.edges]


# ----------------------------------------------------------------------
# §4 mining
# ----------------------------------------------------------------------

@pytest.mark.parametrize("min_sup", [2, 5, 20, 60])
def test_mine_frequent_patterns_matches_reference(watdiv_small, min_sup):
    wl = J.generate_workload(watdiv_small, 150, seed=17)
    want = J.mine_frequent_patterns(wl, min_sup, max_edges=4)
    got = mine_frequent_patterns(
        Workload([port_query(q) for q in wl.queries]), min_sup, max_edges=4)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _edges(g.pattern) == _edges(w.pattern)
        assert g.support == w.support >= min_sup
        assert g.supporting == w.supporting


# ----------------------------------------------------------------------
# Functional matcher API
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pattern_var_order_matches_reference(graphs, seed):
    g, _ = graphs
    queries = shape_workload(g, seed, sizes=(2, 3, 4))
    rng = np.random.default_rng(seed)
    queries += [make(rng, k, g.num_properties)
                for make in SHAPE_MAKERS.values() for k in (3, 5)]
    for q in queries:
        assert pattern_var_order(port_query(q)) == j_var_order(q)


def test_local_match_equals_host_matcher_and_reference(watdiv_small,
                                                       no_launches):
    """``tests/test_substrate.py``'s local-match case on both packages:
    the port's one-site match loop over the reference store's padded
    columns gives the host matcher's rows and the JAX ``local_match``'s
    rows, in the same column order."""
    g = watdiv_small
    jstore = JStore.build(g, [np.arange(g.num_edges)])
    pat = J.QueryGraph.make([(-1, -2, 1), (-2, -3, 8)])
    jbind, jvalid, jcols = j_local_match(jstore.s[0], jstore.p[0],
                                         jstore.o[0], pat, 16384)
    s, p, o = (torch.from_numpy(np.array(a[0]))
               for a in (jstore.s, jstore.p, jstore.o))
    assert (p < 0).any()            # the padding rows are dropped
    bind, valid, cols = local_match(s, p, o, port_query(pat), 16384)
    assert cols == jcols
    assert bind.shape == (16384, len(cols)) and valid.shape == (16384,)
    got = np.unique(bind[valid].numpy(), axis=0)
    want = np.unique(np.asarray(jbind)[np.asarray(jvalid)], axis=0)
    np.testing.assert_array_equal(got, want)
    host = J.matching.match_pattern(g, pat)
    np.testing.assert_array_equal(got, _rows(host.columns, cols))


@pytest.mark.parametrize("shape", sorted(SHAPE_MAKERS))
def test_local_match_shapes_and_constants(graphs, shape, no_launches):
    g, tg = graphs
    rng = np.random.default_rng(len(shape))
    q = SHAPE_MAKERS[shape](rng, 3, g.num_properties)
    qs = [q, shape_workload(g, 5, sizes=())[0] if shape == "cycle" else q]
    for q in qs:
        tq = port_query(q)
        bind, valid, cols = local_match(torch.from_numpy(tg.s),
                                        torch.from_numpy(tg.p),
                                        torch.from_numpy(tg.o), tq, 4096)
        jbind, jvalid, jcols = j_local_match(g.s, g.p, g.o, q, 4096)
        assert cols == jcols
        got = np.unique(bind[valid].numpy(), axis=0) if valid.any() \
            else np.zeros((0, len(cols)), np.int32)
        want = np.asarray(jbind)[np.asarray(jvalid)]
        want = np.unique(want, axis=0) if want.size else want
        np.testing.assert_array_equal(got.reshape(-1, len(cols)),
                                      want.reshape(-1, len(cols)))
        np.testing.assert_array_equal(
            got.reshape(-1, len(cols)),
            _rows(match_pattern(tg, tq).columns, cols).reshape(
                -1, len(cols)))


def _site_edge_ids(g, n):
    """A seeded assignment of the edges to ``n`` sites, a fifth of them
    on a second site too."""
    rng = np.random.default_rng(n)
    home = rng.integers(0, n, g.num_edges)
    extra = (home + 1) % n
    dup = rng.random(g.num_edges) < 0.2
    return [np.unique(np.concatenate([np.flatnonzero(home == j),
                                      np.flatnonzero(dup & (extra == j))]))
            for j in range(n)]


@pytest.mark.parametrize("n_sites", [1, 2, 4])
def test_spmd_match_matches_reference(graphs, n_sites, no_launches):
    """The same per-site storage through the JAX ``spmd_match`` on a
    host mesh of ``n_sites`` devices and the port's over ``n_sites``
    sites: equal deduped rows and column order, equal to the host
    matcher; the functional matcher reports no overflow and one
    decision per join step (gathers, with more than one site)."""
    g, tg = graphs
    ids = _site_edge_ids(g, n_sites)
    jstore = JStore.build(g, ids)
    store = SiteStore.build(tg, ids, device="cpu")
    mesh = make_host_mesh(n_sites, axis="sites")
    rng = np.random.default_rng(11)
    for shape in ("star", "chain", "cycle"):
        q = SHAPE_MAKERS[shape](rng, 3, g.num_properties)
        tq = port_query(q)
        jrows, jcols = j_spmd_match(jstore, mesh, "sites", q, capacity=2048)
        rows, cols = spmd_match(store, tq, capacity=2048)
        assert cols == jcols
        np.testing.assert_array_equal(rows, np.asarray(jrows))
        _vars, want = answer_set(match_pattern(tg, tq))
        assert {tuple(r) for r in rows[:, np.argsort(cols)]} == want
        bind, valid, ovf, dec, shipped = make_spmd_matcher(tq, 2048)(store)
        assert bind.shape == (n_sites * 2048, len(cols))
        assert valid.shape == (n_sites * 2048,) and ovf.shape == (n_sites,)
        assert int(ovf.max()) == 0
        assert dec.tolist() == [0 if n_sites > 1 else 2] * (len(q.edges) - 1)
        assert shipped.shape == dec.shape


def test_spmd_match_overflow_is_reported(graphs, no_launches):
    """A capacity below the answer: the functional matcher reports the
    overflow (the engine's retry signal); ``spmd_match``, as the
    reference's, returns what fitted."""
    g, tg = graphs
    store = SiteStore.build(tg, _site_edge_ids(g, 2), device="cpu")
    q = port_query(J.QueryGraph.make([(-1, -2, 0), (-2, -3, 1)]))
    *_, ovf, _dec, _rows = make_spmd_matcher(q, 4)(store)
    assert int(ovf.max()) > 0
    rows, _cols = spmd_match(store, q, capacity=4)
    assert rows.shape[0] < match_pattern(tg, q).num_rows


def test_matcher_refuses_wildcard_properties(graphs):
    _, tg = graphs
    store = SiteStore.build(tg, [np.arange(tg.num_edges)], device="cpu")
    q = port_query(J.QueryGraph.make([(-1, -2, J.query.PROP_VAR)]))
    with pytest.raises(NotImplementedError, match="constant properties"):
        spmd_match(store, q)
    with pytest.raises(NotImplementedError, match="constant properties"):
        local_match(torch.from_numpy(tg.s), torch.from_numpy(tg.p),
                    torch.from_numpy(tg.o), q, 64)


def test_csr_arrays_are_the_store_tables(graphs):
    _, tg = graphs
    store = SiteStore.build(tg, [np.arange(tg.num_edges)], device="cpu")
    arrs = store.csr_arrays()
    assert len(arrs) == 6
    assert arrs[0] is store.csr_sub_s and arrs[4] is store.csr_offs \
        and arrs[5] is store.owned


# ----------------------------------------------------------------------
# Elastic re-planning
# ----------------------------------------------------------------------

@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("name", ["test_plan_mesh_shrinks_data_axis",
                                  "test_replan_allocation_matches_site_count"])
def test_reference_elastic_tests(name, package, monkeypatch, tmp_path):
    run_reference_test(reference_substrate_tests, name, package,
                       monkeypatch, tmp_path)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sites", [2, 3, 5])
@pytest.mark.parametrize("sized", [False, True])
def test_replan_allocation_matches_reference(seed, sites, sized):
    rng = np.random.default_rng(seed)
    A = rng.random((12, 12))
    A = A + A.T
    np.fill_diagonal(A, 0.0)
    sizes = rng.integers(1, 1000, 12).astype(np.float64) if sized else None
    got = replan_allocation(A, sites, sizes)
    np.testing.assert_array_equal(got, np.asarray(j_replan(A, sites, sizes)))
    assert len(set(got.tolist())) == sites
