"""The paper's host engines on the port against the JAX package's, on the
same plan (the reference's plan carried across with
``convert.plan_state_arrays``): the exact ``DistributedEngine``
(``Session(backend="local")``) and the SHAPE/WARP ``BaselineEngine``
(``backend="baseline"``) give the same answer sets, ``comm_bytes``,
``ExecStats`` and simulated time, exactly; so do the planner pieces
under them (``decompose``, ``optimize``, ``DataDictionary.estimate_card``),
``simulate_throughput`` and WARP's label propagation."""
import dataclasses

import numpy as np
import pytest

from generators import answer_set
import repro.core as J
from repro.core.baselines import edge_cut as j_edge_cut
from repro.core.baselines import label_propagation_partition as j_propagate
from repro.core.decomposition import enumerate_decompositions as j_enum
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core.baselines import edge_cut as t_edge_cut
from repro_torch.core.baselines import (
    label_propagation_partition as t_propagate)
from repro_torch.core.decomposition import enumerate_decompositions as t_enum
from torch_diff import port_query


def _edges(q):
    return [(e.src, e.dst, e.prop) for e in q.edges]


def _port_graph(g):
    return T.RDFGraph(g.s, g.p, g.o, g.num_vertices, g.num_properties)


@pytest.fixture(scope="module")
def workload(watdiv_small):
    return J.generate_workload(watdiv_small, 300, seed=11)


@pytest.fixture(scope="module")
def queries(watdiv_small, workload):
    """Design queries (with constants, some of them contradicting a
    minterm) and the star / chain / cycle shapes."""
    rng = np.random.default_rng(5)
    p = np.asarray(watdiv_small.p)
    shapes = J.make_shape_queries(lambda: int(p[rng.integers(0, len(p))]))
    return list(workload.queries[:40]) + list(shapes.values())


@pytest.fixture(scope="module")
def plans(watdiv_small, workload):
    """kind -> (JAX plan, the port's plan carried from it)."""
    out = {}
    for kind in ("vertical", "horizontal", "shape", "warp"):
        jplan = J.build_plan(watdiv_small, workload, J.PartitionConfig(
            kind=kind, num_sites=4, replication_budget_bytes=20_000))
        out[kind] = (jplan, convert.plan_from_state_arrays(
            convert.plan_state_arrays(jplan)))
    return out


def _assert_same_results(jres, tres):
    for a, b in zip(jres, tres):
        assert answer_set(b) == answer_set(a)
        assert dataclasses.asdict(b.stats) == dataclasses.asdict(a.stats)


def _serve_both(jplan, tplan, backend, queries):
    js = J.Session(jplan, backend=backend)
    ts = T.Session(tplan, backend=backend, device="cpu")
    jres = [js.execute(q) for q in queries]
    tres = [ts.execute(port_query(q)) for q in queries]
    return js, ts, jres, tres


@pytest.mark.parametrize("kind", ["vertical", "horizontal"])
def test_local_backend_matches_reference(plans, queries, kind):
    jplan, tplan = plans[kind]
    js, ts, jres, tres = _serve_both(jplan, tplan, "local", queries)
    _assert_same_results(jres, tres)
    jst, tst = js.stats(), ts.stats()
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.comm_bytes > 0 and tst.backend == "local"
    # the batched surface answers in input order with the same ledger
    more = ts.execute_many([port_query(q) for q in queries], batch_size=7)
    _assert_same_results(jres, more)


@pytest.mark.parametrize("kind", ["vertical", "horizontal", "shape", "warp"])
def test_baseline_backend_matches_reference(plans, queries, kind):
    jplan, tplan = plans[kind]
    js, ts, jres, tres = _serve_both(jplan, tplan, "baseline", queries)
    _assert_same_results(jres, tres)
    assert dataclasses.asdict(ts.stats()) == dataclasses.asdict(js.stats())
    assert ts.stats().comm_bytes > 0


def test_horizontal_pruning_skips_contradicted_minterms(plans, queries):
    """Fragments whose minterm contradicts a query constant are left out
    (§5.2), on the same fragments in both packages."""
    jplan, tplan = plans["horizontal"]
    jeng, teng = jplan.build_local_engine(), tplan.build_local_engine()
    pruned = 0
    for q in queries:
        jd = J.decompose(q, jplan.dictionary, jplan.cold_props)
        td = T.decompose(port_query(q), tplan.dictionary, tplan.cold_props)
        for jsq, tsq, pid in zip(jd.subqueries, td.subqueries,
                                 jd.pattern_ids):
            want = jeng._relevant_fragments(jsq, pid)
            assert teng._relevant_fragments(tsq, pid) == want
            if pid is not None:
                pruned += len(jplan.dictionary.frags_of_pattern[pid]) \
                    - len(want)
    assert pruned > 0


def test_decompose_optimize_and_estimates_match_reference(plans, queries):
    for kind in ("vertical", "horizontal"):
        jplan, tplan = plans[kind]
        jd_, td_ = jplan.dictionary, tplan.dictionary
        for q in queries:
            tq = port_query(q)
            jd = J.decompose(q, jd_, jplan.cold_props)
            td = T.decompose(tq, td_, tplan.cold_props)
            assert [_edges(s) for s in td.subqueries] \
                == [_edges(s) for s in jd.subqueries]
            assert td.pattern_ids == jd.pattern_ids
            assert td.cost == jd.cost
            assert len(t_enum(tq, td_, tplan.cold_props)) \
                == len(j_enum(q, jd_, jplan.cold_props))
            jp, tp = J.optimize(jd, jd_), T.optimize(td, td_)
            assert (tp.order, tp.cost, tp.card) == (jp.order, jp.cost,
                                                    jp.card)
            for jsq, tsq in zip(jd.subqueries + [q],
                                td.subqueries + [tq]):
                # float64 throughout: equal to the last bit
                assert td_.estimate_card(tsq) == jd_.estimate_card(jsq)
                assert td_.lookup_pattern(tsq) == jd_.lookup_pattern(jsq)
            assert td_.sites_of_pattern(0) == jd_.sites_of_pattern(0)


def test_simulate_throughput_matches_reference(plans, queries):
    jplan, tplan = plans["horizontal"]
    jq, jst = J.simulate_throughput(J.Session(jplan, backend="local"),
                                    queries)
    tq, tst = T.simulate_throughput(
        T.Session(tplan, backend="local", device="cpu"),
        [port_query(q) for q in queries])
    assert tq == jq
    assert [dataclasses.asdict(s) for s in tst] \
        == [dataclasses.asdict(s) for s in jst]


@pytest.mark.parametrize("num_parts,seed", [(2, 0), (4, 0), (4, 3)])
def test_label_propagation_matches_reference(watdiv_small, num_parts, seed):
    """WARP's capacity-bounded greedy moves visit vertices in the same
    random order, so the part vectors are identical."""
    want = j_propagate(watdiv_small, num_parts, seed=seed)
    got = t_propagate(_port_graph(watdiv_small), num_parts, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert t_edge_cut(_port_graph(watdiv_small), got) \
        == j_edge_cut(watdiv_small, want)
    assert np.bincount(got).max() <= np.ceil(
        watdiv_small.num_vertices / num_parts * 1.1)
