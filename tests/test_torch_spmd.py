"""Differential tests of the port's SPMD slice against the JAX package.

The same plan (built by the JAX package, carried across as numpy arrays
by ``repro_torch.convert``) is served by the JAX ``SpmdEngine`` on a
host mesh of 1, 2 or 4 devices and by the port on a site axis of the
same width, on the CPU.  Every comparison is exact: answer sets (also
against both packages' host ``match_pattern``), per-query ledger bytes,
every engine counter, and the final run's per-step decision and
shipped-row vectors and capacity tiers.
"""
import pytest

from torch_diff import differential, rgraph, rplan, rqueries  # noqa: F401


@pytest.mark.parametrize("mesh_n", [1, 2, 4])
def test_slice_matches_reference(rplan, rqueries, mesh_n):
    """Planner and routing on, starting below the answer sizes so the
    capacity ladder climbs."""
    st = differential(rplan, rqueries, mesh_n, capacity=64)
    assert st.extra["capacity_retries"] > 0
    if mesh_n == 4:
        assert st.extra["edge_cache_hits"] > 0
        assert st.extra["edge_shipped_steps"] > 0
        assert st.extra["routed_queries"] > 0
