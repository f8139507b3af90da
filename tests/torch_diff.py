"""Shared pieces of the port's differential tests: the seeded random
graph, its shape workload and 4-site vertical plan, and the routine
that serves one plan through the JAX ``SpmdEngine`` and the port's and
compares everything both report, exactly."""
import numpy as np
import pytest

from generators import SEED, answer_set, random_graph, shape_workload
from repro.core import PartitionConfig, Session, build_plan
from repro.core.matching import match_pattern as j_match_pattern
from repro.core.query import QueryGraph as JQuery
from repro.core.workload import Workload
from repro.launch.mesh import make_host_mesh
from repro_torch import convert
from repro_torch.core import QueryGraph, RDFGraph
from repro_torch.core import match_pattern as t_match_pattern


def port_query(q):
    return QueryGraph.make([(e.src, e.dst, e.prop) for e in q.edges])


@pytest.fixture(scope="module")
def rgraph():
    return random_graph(SEED)


@pytest.fixture(scope="module")
def rqueries(rgraph):
    qs = shape_workload(rgraph, SEED, n_props=rgraph.num_properties)
    # a star whose three steps ship the same property's edges: the
    # second and third reuse the first gather (COMM_EDGE_CACHED)
    qs.append(JQuery.make([(-1, -2, 5), (-1, -3, 5), (-1, -4, 5)]))
    return qs


@pytest.fixture(scope="module")
def rplan(rgraph, rqueries):
    return build_plan(rgraph, Workload(list(rqueries)),
                      PartitionConfig(kind="vertical", num_sites=4))


def differential(plan, queries, mesh_n, capacity, comm_plan=True,
                 routing=True):
    """Serve ``queries`` through both engines and compare everything the
    engines report.  Returns the port engine's stats."""
    jeng = Session(plan, backend="spmd", mesh=make_host_mesh(mesh_n),
                   spmd_capacity=capacity, spmd_comm_plan=comm_plan,
                   spmd_routing=routing).engine
    teng = convert.engine_from_arrays(
        convert.plan_arrays(plan), device="cpu", num_devices=mesh_n,
        capacity=capacity, comm_plan=comm_plan, routing=routing)
    tgraph = RDFGraph(plan.graph.s, plan.graph.p, plan.graph.o,
                      plan.graph.num_vertices, plan.graph.num_properties)
    for q in queries:
        tq = port_query(q)
        jr, tr = jeng.execute(q), teng.execute(tq)
        want = answer_set(jr)
        assert answer_set(tr) == want, f"answers diverged on {q.edges}"
        assert answer_set(j_match_pattern(plan.graph, q)) == want
        assert answer_set(t_match_pattern(tgraph, tq)) == want
        assert tr.stats.comm_bytes == jr.stats.comm_bytes, q.edges
        assert tr.stats.sites_touched == jr.stats.sites_touched
        # the final tier again (warm hints): identical step vectors
        _jb, _jv, jcaps, jatt = jeng._run_exact(q.normalize())
        _out, tcaps, tatt = teng._run_exact(tq.normalize())
        assert tcaps == jcaps
        for (jd, jrows, jn), (td, trows, tn) in zip(jatt, tatt):
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(trows, jrows)
            assert tn == jn
    js, ts = jeng.stats(), teng.stats()
    assert ts.comm_bytes == js.comm_bytes
    assert ts.result_rows == js.result_rows
    assert ts.extra == js.extra
    return ts
