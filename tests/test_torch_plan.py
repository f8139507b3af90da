"""The port's offline phase against the JAX package's, and the plan
carried across packages by ``repro_torch.convert``.

Host-side planning is numpy in both packages, so the same seeds must
give identical graphs, workloads, selected patterns, allocations and
per-site storage (exact equality throughout).
"""
import numpy as np
import pytest

from generators import SEED, answer_set, random_graph, shape_workload
import repro.core as J
from repro.core.workload import Workload as JWorkload
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core.plan import PartitionConfig as TConfig
from repro_torch.core.workload import Workload as TWorkload


def _port_graph(g):
    return T.RDFGraph(g.s, g.p, g.o, g.num_vertices, g.num_properties)


def _port_workload(wl):
    return TWorkload([T.QueryGraph.make([(e.src, e.dst, e.prop)
                                         for e in q.edges])
                      for q in wl.queries])


def _assert_same_plan(jplan, tplan):
    assert [p.canonical_code() for p in tplan.selected_patterns] \
        == [p.canonical_code() for p in jplan.selected_patterns]
    np.testing.assert_array_equal(tplan.alloc.site_of, jplan.alloc.site_of)
    assert tplan.cold_props == jplan.cold_props
    assert tplan.replicated_props == jplan.replicated_props
    ts, js = tplan.site_edge_ids(), jplan.site_edge_ids()
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a, b)
    for f in ("num_patterns_mined", "num_patterns_selected",
              "num_fragments", "redundancy_ratio", "hit_rate", "benefit"):
        assert getattr(tplan.stats, f) == getattr(jplan.stats, f), f


def test_generators_match_reference():
    jg, tg = J.generate_watdiv(6000, seed=3), T.generate_watdiv(6000, seed=3)
    for col in ("s", "p", "o"):
        np.testing.assert_array_equal(getattr(tg, col), getattr(jg, col))
    assert (tg.num_vertices, tg.num_properties) \
        == (jg.num_vertices, jg.num_properties)
    jw = J.generate_workload(jg, 120, seed=4, constant_fraction=1.0)
    tw = T.generate_workload(tg, 120, seed=4, constant_fraction=1.0)
    assert [[(e.src, e.dst, e.prop) for e in q.edges] for q in tw.queries] \
        == [[(e.src, e.dst, e.prop) for e in q.edges] for q in jw.queries]
    assert tw.template_ids == jw.template_ids
    shapes_t = T.make_shape_queries(iter(range(9)).__next__)
    shapes_j = J.workload.make_shape_queries(iter(range(9)).__next__)
    assert {k: [(e.src, e.dst, e.prop) for e in v.edges]
            for k, v in shapes_t.items()} \
        == {k: [(e.src, e.dst, e.prop) for e in v.edges]
            for k, v in shapes_j.items()}


@pytest.mark.parametrize("num_sites,budget", [(4, 0), (2, 0), (4, 20_000)])
def test_build_plan_matches_reference_random(num_sites, budget):
    g = random_graph(SEED)
    wl = JWorkload(shape_workload(g, SEED, n_props=g.num_properties))
    jplan = J.build_plan(g, wl, J.PartitionConfig(
        kind="vertical", num_sites=num_sites,
        replication_budget_bytes=budget))
    tplan = T.build_plan(_port_graph(g), _port_workload(wl), TConfig(
        kind="vertical", num_sites=num_sites,
        replication_budget_bytes=budget))
    _assert_same_plan(jplan, tplan)
    if budget:
        assert tplan.replicated_props


def test_build_plan_matches_reference_watdiv(watdiv_small):
    wl = J.generate_workload(watdiv_small, 300, seed=11)
    jplan = J.build_plan(watdiv_small, wl,
                         J.PartitionConfig(kind="vertical", num_sites=4))
    tplan = T.build_plan(_port_graph(watdiv_small), _port_workload(wl),
                         TConfig(kind="vertical", num_sites=4))
    _assert_same_plan(jplan, tplan)


def test_convert_round_trips():
    """Arrays read from either package's plan are identical, and the
    engine built from them holds the same store as the plan's own."""
    g = random_graph(SEED)
    wl = JWorkload(shape_workload(g, SEED, n_props=g.num_properties))
    cfg = dict(kind="vertical", num_sites=4, replication_budget_bytes=20_000)
    jplan = J.build_plan(g, wl, J.PartitionConfig(**cfg))
    tplan = T.build_plan(_port_graph(g), _port_workload(wl), TConfig(**cfg))
    ja, ta = convert.plan_arrays(jplan), convert.plan_arrays(tplan)
    assert ja.keys() == ta.keys()
    for k in ja:
        if k == "site_edge_ids":
            for a, b in zip(ja[k], ta[k]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(np.asarray(ja[k]),
                                          np.asarray(ta[k]))
    direct = tplan.build_spmd_engine(device="cpu").store
    carried = convert.engine_from_arrays(ja, device="cpu").store
    for f in ("csr_sub_s", "csr_sub_o", "csr_obj_o", "csr_obj_s", "owned"):
        assert bool((getattr(direct, f) == getattr(carried, f)).all()), f
    for f in ("csr_offs", "prop_dev_rows", "prop_dev_distinct",
              "prop_union_rows", "prop_dev_owned"):
        np.testing.assert_array_equal(getattr(direct, f),
                                      getattr(carried, f))
    assert convert.engine_from_arrays(ja, device="cpu").replicated_props \
        == jplan.replicated_props


def test_store_matches_reference_store():
    """The packed CSR tables and residency metadata equal the JAX
    package's ``SiteStore`` for the same folded sites."""
    from repro.core.spmd import SiteStore as JStore
    from repro_torch.core.spmd import SiteStore as TStore
    g = random_graph(SEED)
    rng = np.random.default_rng(1)
    sites = [np.unique(rng.integers(0, g.num_edges, 150)) for _ in range(3)]
    js = JStore.build(g, sites)
    ts = TStore.build(_port_graph(g), sites, device="cpu")
    assert (ts.e_max, ts.csr_pad) == (js.e_max, js.csr_pad)
    for f in ("csr_sub_s", "csr_sub_o", "csr_obj_o", "csr_obj_s", "owned",
              "csr_offs"):
        np.testing.assert_array_equal(np.asarray(getattr(ts, f)),
                                      np.asarray(getattr(js, f)))
    for f in ("prop_dev_rows", "prop_dev_distinct", "prop_union_rows",
              "prop_dev_owned"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))


def test_store_row_order_is_the_lexsort():
    """The store's packed-key sort orders rows as ``np.lexsort`` does,
    ties (a site holding an edge twice) in input order, up to the
    largest ids a graph admits."""
    from repro_torch.constants import MAX_PROPERTY_ID, MAX_VERTEX_ID
    from repro_torch.core.spmd import _row_order
    rng = np.random.default_rng(5)
    for hi_p, hi_v in ((7, 50), (MAX_PROPERTY_ID, MAX_VERTEX_ID)):
        p = rng.integers(0, hi_p + 1, 4000).astype(np.int32)
        s = rng.integers(0, hi_v + 1, 4000).astype(np.int32)
        o = rng.integers(0, hi_v + 1, 4000).astype(np.int32)
        p[:3], s[:3], o[:3] = hi_p, hi_v, hi_v
        dup = rng.integers(0, 4000, 1000)
        p, s, o = (np.concatenate([c, c[dup]]) for c in (p, s, o))
        np.testing.assert_array_equal(_row_order(p, s, o),
                                      np.lexsort((o, s, p)))
        np.testing.assert_array_equal(_row_order(p, o, s),
                                      np.lexsort((s, o, p)))


def test_match_edge_ids_matches_reference(watdiv_small):
    """The vertical fragments' edge sets: every WatDiv template, with
    constants and with a property variable, as the JAX package finds
    them."""
    from repro.core.matching import match_edge_ids as j_edge_ids
    from repro_torch.core.matching import match_edge_ids as t_edge_ids
    tg = _port_graph(watdiv_small)
    pats = list(J.watdiv_templates())
    pats += [J.QueryGraph.make([(-1, 27, pats[0].edges[0].prop)]),
             J.QueryGraph.make([(-1, -2, -1), (-2, -3, pats[1].edges[0].prop)])]
    for q in pats:
        want = j_edge_ids(watdiv_small, q)
        got = t_edge_ids(tg, T.QueryGraph.make(
            [(e.src, e.dst, e.prop) for e in q.edges]))
        np.testing.assert_array_equal(got, want)
    assert len(want)


def test_graph_rejects_ids_past_the_bound():
    from repro_torch.constants import MAX_VERTEX_ID
    with pytest.raises(ValueError):
        T.RDFGraph(np.array([MAX_VERTEX_ID + 1]), np.array([0]),
                   np.array([0]), MAX_VERTEX_ID + 2, 1)
    T.RDFGraph(np.array([MAX_VERTEX_ID]), np.array([0]), np.array([0]),
               MAX_VERTEX_ID + 1, 1)


def test_unported_strategy_and_backend_are_refused():
    """An unknown strategy and an unknown backend are refused, each
    naming what is available; the ``"adaptive"`` backend builds the
    online ``AdaptiveEngine``, which answers as the ``"local"`` backend
    does."""
    from repro_torch.online import AdaptiveEngine
    with pytest.raises(ValueError) as ei:
        TConfig(kind="metis")
    for name in ("vertical", "horizontal", "shape", "warp"):
        assert name in str(ei.value)
    g = random_graph(SEED)
    queries = shape_workload(g, SEED, n_props=g.num_properties)
    tplan = T.build_plan(_port_graph(g), _port_workload(JWorkload(queries)),
                         TConfig(num_sites=2))
    adaptive = T.Session(tplan, backend="adaptive", device="cpu")
    assert isinstance(adaptive.engine, AdaptiveEngine)
    assert "adaptive" in T.BACKENDS
    local = T.Session(tplan, backend="local", device="cpu")
    for q in queries[:4]:
        tq = T.QueryGraph.make([(e.src, e.dst, e.prop) for e in q.edges])
        want = local.execute(tq)
        got = adaptive.execute(tq)
        assert answer_set(got) == answer_set(want)
        assert got.stats.comm_bytes == want.stats.comm_bytes
    with pytest.raises(ValueError, match="unknown backend") as ei:
        T.Session(tplan, backend="gstore", device="cpu")
    for name in T.BACKENDS:
        assert name in str(ei.value)


@pytest.mark.parametrize("max_rows", [10, 333, 5000])
def test_match_pattern_truncation_matches_reference(watdiv_small, max_rows):
    """Past max_rows the port stops expanding where the reference
    truncates: the same first rows and the same truncation flag."""
    from repro.core.matching import match_pattern as j_match
    tg = _port_graph(watdiv_small)
    for t in J.watdiv_templates():
        want = j_match(watdiv_small, t, max_rows=max_rows)
        got = T.match_pattern(tg, T.QueryGraph.make(
            [(e.src, e.dst, e.prop) for e in t.edges]), max_rows=max_rows)
        assert (got.num_rows, got.truncated) \
            == (want.num_rows, want.truncated)
        for v, col in want.columns.items():
            np.testing.assert_array_equal(got.columns[v], col)


def test_build_plan_with_truncated_matches_matches_reference(watdiv_small):
    wl = J.generate_workload(watdiv_small, 300, seed=11)
    jplan = J.build_plan(watdiv_small, wl, J.PartitionConfig(
        kind="vertical", num_sites=4, max_rows=300))
    tplan = T.build_plan(_port_graph(watdiv_small), _port_workload(wl),
                         TConfig(kind="vertical", num_sites=4, max_rows=300))
    _assert_same_plan(jplan, tplan)
