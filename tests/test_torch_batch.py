"""Differential tests of the port's ``execute_many`` against the JAX
package's.

Both ``SpmdEngine``s serve the seeded shape workload in batches: every
query twice in one batch of 64, and the same doubled stream cut into
batches of 5.  Queries of one normalized shape inside a batch run the
match loop once; the later ones reuse its output, ship nothing and
count a ``batch_shape_hits``.  Every comparison is exact: answer sets,
per-query ledger bytes, the total ledger and every engine counter.
"""
import pytest

from generators import answer_set
from repro.core import Session
from repro.core.query import PROP_VAR
from repro.core.query import QueryGraph as JQuery
from repro.launch.mesh import make_host_mesh
from repro_torch import convert
from torch_diff import port_query, rgraph, rplan, rqueries  # noqa: F401


def _engines(plan, mesh_n, capacity=64):
    jeng = Session(plan, backend="spmd", mesh=make_host_mesh(mesh_n),
                   spmd_capacity=capacity).engine
    teng = convert.engine_from_arrays(
        convert.plan_arrays(plan), device="cpu", num_devices=mesh_n,
        capacity=capacity)
    return jeng, teng


@pytest.mark.parametrize("batch_size", [64, 5])
@pytest.mark.parametrize("mesh_n", [1, 2, 4])
def test_execute_many_matches_reference(rplan, rqueries, mesh_n, batch_size):
    stream = list(rqueries) + list(rqueries)
    assert len(stream) <= 64
    jeng, teng = _engines(rplan, mesh_n)
    jres = jeng.execute_many(stream, batch_size=batch_size)
    tres = teng.execute_many([port_query(q) for q in stream],
                             batch_size=batch_size)
    assert len(tres) == len(jres) == len(stream)
    for q, jr, tr in zip(stream, jres, tres):
        assert answer_set(tr) == answer_set(jr), q.edges
        assert tr.stats.comm_bytes == jr.stats.comm_bytes, q.edges
    js, ts = jeng.stats(), teng.stats()
    assert ts.comm_bytes == js.comm_bytes
    assert ts.result_rows == js.result_rows
    assert ts.extra == js.extra
    if batch_size == 64:
        # each query's twin reuses its run
        assert ts.extra["batch_shape_hits"] >= len(rqueries)
    if mesh_n > 1:
        assert ts.comm_bytes > 0


def test_execute_many_wildcard_property_raises_alike(rplan, rqueries):
    """A wildcard-property query stays alone in its group and raises the
    same exception in both engines."""
    wild = JQuery.make([(-1, -2, PROP_VAR)])
    batch = [rqueries[0], wild, rqueries[0]]
    jeng, teng = _engines(rplan, 2)
    with pytest.raises(Exception) as jerr:
        jeng.execute_many(batch, batch_size=64)
    with pytest.raises(Exception) as terr:
        teng.execute_many([port_query(q) for q in batch], batch_size=64)
    assert terr.type is jerr.type
    # the group of rqueries[0] ran before the wildcard's (first
    # appearance order), and the shared run was cleared on the way out
    assert teng._shared_run is None and teng._shared_run_key is None
    assert teng.stats().extra == jeng.stats().extra
