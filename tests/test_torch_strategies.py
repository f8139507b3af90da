"""The port's four registered strategies against the JAX package's: the
same seeds give the same plan (fragments with their minterms,
allocation, baseline per-site storage, selected patterns, per-site
storage and its property map), and the SPMD engine serves each kind's
JAX plan, carried across with ``convert.plan_state_arrays``, exactly as
the JAX engine does at 1, 2 and 4 sites.

The JAX package's own fixture-free planning tests
(``tests/test_fragmentation_allocation.py``,
``tests/test_session_plan.py``) run here against both packages.
"""
import numpy as np
import pytest

import test_fragmentation_allocation as reference_frag_tests
import test_session_plan as reference_plan_tests
import repro.core as J
from repro.core.workload import Workload as JWorkload
import repro_torch.core as T
from repro_torch import convert
from torch_diff import (differential, rgraph, rqueries,  # noqa: F401
                        run_reference_test)

KINDS = ("vertical", "horizontal", "shape", "warp")


def _port_graph(g):
    return T.RDFGraph(g.s, g.p, g.o, g.num_vertices, g.num_properties)


def _port_workload(wl):
    return T.Workload([T.QueryGraph.make([(e.src, e.dst, e.prop)
                                          for e in q.edges])
                       for q in wl.queries])


def _design(queries):
    """The shape workload with its constant-bound queries issued twice:
    each constant then reaches the predicate miner's minimum frequency
    of 2, so the horizontal strategy splits patterns by minterms."""
    return JWorkload(list(queries) + [q for q in queries if q.constants()])


@pytest.fixture(scope="module")
def sources(rgraph, rqueries, watdiv_small):  # noqa: F811
    return {"random": (rgraph, _design(rqueries)),
            "watdiv": (watdiv_small,
                       J.generate_workload(watdiv_small, 300, seed=11))}


def _assert_same_state(a, b, where="plan"):
    """Equal nested dicts / lists of numpy arrays, ints, strings and
    ``None`` (``plan_state_arrays`` output)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _assert_same_state(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_state(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(b, a, err_msg=where)
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _assert_same_plan(jplan, tplan):
    _assert_same_state(convert.plan_state_arrays(jplan),
                       convert.plan_state_arrays(tplan))
    ts, js = tplan.site_edge_ids(), jplan.site_edge_ids()
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a, b)
    assert tplan.property_sites() == jplan.property_sites()
    assert tplan.redundancy_ratio() == jplan.redundancy_ratio()
    assert [p.canonical_code() for p in tplan.selected_patterns] \
        == [p.canonical_code() for p in jplan.selected_patterns]
    assert (tplan.stats is None) == (jplan.stats is None)
    if jplan.stats is not None:
        for f in ("num_patterns_mined", "num_patterns_selected",
                  "num_fragments", "redundancy_ratio", "hit_rate",
                  "benefit"):
            assert getattr(tplan.stats, f) == getattr(jplan.stats, f), f
    assert (tplan.dictionary is None) == (jplan.dictionary is None)
    if jplan.dictionary is not None:
        jd, td = jplan.dictionary, tplan.dictionary
        assert [vars(s) for s in td.frag_stats] \
            == [vars(s) for s in jd.frag_stats]
        assert td.frags_of_pattern == jd.frags_of_pattern
        assert td.pattern_hash == jd.pattern_hash
        assert td.cold_sites == jd.cold_sites
        assert td.avg_out_degree == jd.avg_out_degree
        np.testing.assert_array_equal(td.prop_counts, jd.prop_counts)
    if jplan.replication is not None:
        assert vars(tplan.replication) == vars(jplan.replication)


@pytest.mark.parametrize("budget", [0, 500_000])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("source", ["random", "watdiv"])
def test_build_plan_matches_reference(sources, source, kind, budget):
    g, wl = sources[source]
    jplan = J.build_plan(g, wl, J.PartitionConfig(
        kind=kind, num_sites=4, replication_budget_bytes=budget))
    tplan = T.build_plan(_port_graph(g), _port_workload(wl),
                         T.PartitionConfig(kind=kind, num_sites=4,
                                           replication_budget_bytes=budget))
    _assert_same_plan(jplan, tplan)
    if kind == "horizontal":
        assert any(f.minterm is not None and f.minterm.terms
                   for f in tplan.frag.fragments)
        assert tplan.frag.coverage_ok(tplan.graph)
    if kind in ("shape", "warp"):
        assert tplan.frag is None and tplan.baseline_frag is not None
    if budget:
        assert tplan.replicated_props


def test_plan_state_round_trips(sources):
    """A reference plan carried across equals the port's own plan of the
    same inputs, and serves the same storage."""
    g, wl = sources["watdiv"]
    for kind in KINDS:
        cfg = dict(kind=kind, num_sites=4, replication_budget_bytes=20_000)
        jplan = J.build_plan(g, wl, J.PartitionConfig(**cfg))
        carried = convert.plan_from_state_arrays(
            convert.plan_state_arrays(jplan))
        _assert_same_state(convert.plan_state_arrays(jplan),
                           convert.plan_state_arrays(carried))
        for a, b in zip(carried.site_edge_ids(), jplan.site_edge_ids()):
            np.testing.assert_array_equal(a, b)
        assert carried.property_sites() == jplan.property_sites()
        assert (carried.dictionary is None) == (jplan.dictionary is None)


def test_store_from_fragmentation_matches_reference(sources):
    """``SiteStore.from_fragmentation`` over a horizontal plan's
    overlapping minterm fragments: the same packed tables and residency
    metadata (ownership of an edge held by several sites included) as
    the JAX package's."""
    from repro.core.spmd import SiteStore as JStore
    from repro_torch.core.spmd import SiteStore as TStore
    g, wl = sources["watdiv"]
    jplan = J.build_plan(g, wl, J.PartitionConfig(kind="horizontal",
                                                  num_sites=4))
    tplan = convert.plan_from_state_arrays(convert.plan_state_arrays(jplan))
    for cold in (True, False):
        js = JStore.from_fragmentation(g, jplan.frag, jplan.alloc.site_of,
                                       4, include_cold=cold)
        ts = TStore.from_fragmentation(tplan.graph, tplan.frag,
                                       tplan.alloc.site_of, 4,
                                       include_cold=cold, device="cpu")
        for f in ("csr_sub_s", "csr_sub_o", "csr_obj_o", "csr_obj_s",
                  "owned", "csr_offs", "prop_dev_rows", "prop_dev_distinct",
                  "prop_union_rows", "prop_dev_owned"):
            np.testing.assert_array_equal(np.asarray(getattr(ts, f)),
                                          np.asarray(getattr(js, f)))


def test_planning_helpers_match_reference(sources):
    jg, tg = J.example_graph(), T.example_graph()
    for col in ("s", "p", "o"):
        np.testing.assert_array_equal(getattr(tg, col), getattr(jg, col))
    assert tg.vertex_names == jg.vertex_names
    np.testing.assert_array_equal(tg.property_counts(), jg.property_counts())
    sub = tg.subgraph(np.array([3, 0, 7]))
    np.testing.assert_array_equal(sub.s, jg.subgraph(np.array([3, 0, 7])).s)
    g, wl = sources["watdiv"]
    twl = _port_workload(wl)
    from repro.core.matching import count_matches as j_count
    from repro_torch.core.matching import count_matches as t_count
    for jq, tq in zip(wl.queries[:30], twl.queries[:30]):
        assert tq.constants() == jq.constants()
        assert tq.constant_bindings() == jq.constant_bindings()
        assert tq.is_connected() == jq.is_connected()
        assert t_count(_port_graph(g), tq, max_rows=500) \
            == j_count(g, jq, max_rows=500)
    assert [q.canonical_code() for q in twl.normalized()] \
        == [q.canonical_code() for q in wl.normalized()]
    assert not T.QueryGraph.make([(-1, -2, 0), (-3, -4, 1)]).is_connected()
    np.testing.assert_array_equal(T.class_template_probs({"S": 8.0}),
                                  J.class_template_probs({"S": 8.0}))
    jplan = J.build_plan(g, wl, J.PartitionConfig(
        num_sites=4, replication_budget_bytes=20_000))
    tplan = T.build_plan(_port_graph(g), twl, T.PartitionConfig(
        num_sites=4, replication_budget_bytes=20_000))
    assert tplan.alloc.groups() == jplan.alloc.groups()
    assert tplan.alloc.is_partition(len(tplan.frag.fragments))
    assert tplan.replication.within_budget() \
        == jplan.replication.within_budget()


@pytest.fixture(scope="module")
def kind_plans(rgraph, rqueries):  # noqa: F811
    design = _design(rqueries)
    return {kind: J.build_plan(rgraph, design,
                               J.PartitionConfig(kind=kind, num_sites=4))
            for kind in ("horizontal", "shape", "warp")}


@pytest.mark.parametrize("mesh_n", [1, 2, 4])
@pytest.mark.parametrize("kind", ["horizontal", "shape", "warp"])
def test_spmd_serves_reference_plan(kind_plans, rqueries, kind,  # noqa: F811
                                    mesh_n):
    """Answers, route plans, residency metadata, per-step decisions and
    shipped rows, tiers, ``comm_bytes`` and every ``stats().extra`` key
    equal the JAX engine's (``torch_diff.differential``).  At 4 sites
    the capacity is small enough that tiers overflow and retry."""
    st = differential(kind_plans[kind], rqueries, mesh_n,
                      capacity=64 if mesh_n == 4 else 256, via_state=True)
    if mesh_n == 4:
        assert st.extra["capacity_retries"] > 0
        assert st.comm_bytes > 0


def test_shape_and_warp_refuse_the_local_backend(kind_plans):
    for kind in ("shape", "warp"):
        tplan = convert.plan_from_state_arrays(
            convert.plan_state_arrays(kind_plans[kind]))
        with pytest.raises(ValueError, match="site-partitioned"):
            T.Session(tplan, backend="local", device="cpu")
        with pytest.raises(ValueError, match="site-partitioned"):
            J.Session(kind_plans[kind], backend="local")


def test_incomplete_plans_raise_the_reference_errors(sources):
    """A plan without a graph, or without fragments, raises what the
    reference raises (type and message) from every method that needs
    them, never an ``AttributeError``."""
    g, _wl = sources["random"]
    jshape = J.build_plan(g, _wl, J.PartitionConfig(kind="shape",
                                                    num_sites=4))
    tshape = convert.plan_from_state_arrays(convert.plan_state_arrays(jshape))
    cases = [
        (J.PartitionPlan("vertical", J.PartitionConfig()),
         T.PartitionPlan("vertical", T.PartitionConfig())),
        (J.PartitionPlan("vertical", J.PartitionConfig(), graph=g),
         T.PartitionPlan("vertical", T.PartitionConfig(),
                         graph=_port_graph(g))),
        (jshape, tshape)]
    calls = [("redundancy_ratio", {}), ("site_edge_ids", {}),
             ("property_sites", {}), ("build_local_engine", {}),
             ("build_baseline_engine", {})]
    raised = 0
    for jplan, tplan in cases:
        for name, kw in calls:
            try:
                getattr(jplan, name)(**kw)
                want = None
            except (RuntimeError, ValueError) as e:
                want = (type(e), str(e))
            try:
                getattr(tplan, name)(**kw)
                got = None
            except (RuntimeError, ValueError) as e:
                got = (type(e), str(e))
            assert got == want, (name, got, want)
            raised += want is not None
    assert raised >= 8
    with pytest.raises(RuntimeError, match="no attached graph"):
        T.PartitionPlan("vertical", T.PartitionConfig()).build_spmd_engine(
            device="cpu")


def test_unported_warm_start_is_refused(sources):
    """The warm start from an incumbent plan (ported with the online
    loop) gives the JAX package's plan."""
    g, wl = sources["random"]
    tg, twl = _port_graph(g), _port_workload(wl)
    cfg = dict(num_sites=2, replication_budget_bytes=2_000)
    jplan = J.build_plan(g, wl, J.PartitionConfig(**cfg))
    plan = T.build_plan(tg, twl, T.PartitionConfig(**cfg))
    _assert_same_plan(jplan, plan)
    jwarm = J.build_plan(g, wl, incumbent=jplan)
    warm = T.build_plan(tg, twl, incumbent=plan)
    _assert_same_plan(jwarm, warm)
    assert warm.replicated_props == jwarm.replicated_props
    assert {p.canonical_code() for p in warm.selected_patterns} \
        & {p.canonical_code() for p in plan.selected_patterns}


REFERENCE_TESTS = [
    (reference_frag_tests, "test_enumerate_minterms_complete"),
    (reference_frag_tests, "test_allocate_produces_m_nonempty_clusters"),
    (reference_frag_tests, "test_affinity_pairs_colocated"),
    (reference_plan_tests, "test_config_rejects_unknown_kind"),
    (reference_plan_tests, "test_config_error_lists_registered"),
    (reference_plan_tests, "test_config_rejects_bad_num_sites"),
]


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
@pytest.mark.parametrize("module,name", REFERENCE_TESTS,
                         ids=[n for _m, n in REFERENCE_TESTS])
def test_reference_planning_unit_tests(module, name, package, monkeypatch,
                                       tmp_path):
    run_reference_test(module, name, package, monkeypatch, tmp_path)
