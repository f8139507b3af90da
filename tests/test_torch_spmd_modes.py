"""Differential tests of the port's SPMD slice against the JAX package,
in the other serving modes (planner or routing off) and on a WatDiv
plan; see ``test_torch_spmd.py`` for what is compared (all of it
exactly)."""
import pytest

from repro.core import PartitionConfig, build_plan
from repro.core import generate_workload as j_generate_workload
from torch_diff import differential, rgraph, rplan, rqueries  # noqa: F401


@pytest.mark.parametrize("mesh_n,comm_plan,routing",
                         [(2, True, False), (4, True, False),
                          (4, False, True)],
                         ids=["2-planned-unrouted", "4-planned-unrouted",
                              "4-naive"])
def test_slice_modes_match_reference(rplan, rqueries, mesh_n, comm_plan,
                                     routing):
    st = differential(rplan, rqueries, mesh_n, capacity=4096,
                      comm_plan=comm_plan, routing=routing)
    assert st.extra["gather_steps"] > 0


def test_watdiv_slice_matches_reference(watdiv_small):
    """A 4-site vertical plan of the WatDiv graph, served with one term
    of each template bound to a data constant."""
    wl = j_generate_workload(watdiv_small, 200, seed=11)
    plan = build_plan(watdiv_small, wl,
                      PartitionConfig(kind="vertical", num_sites=4))
    served = j_generate_workload(watdiv_small, 24, seed=5,
                                 constant_fraction=1.0, cold_fraction=0.0)
    st = differential(plan, served.queries, 4, capacity=4096)
    assert st.queries == len(served.queries)
