"""The port's plan lifecycle against the JAX package's: plans of all four
strategies and checkpoints with a bfloat16 leaf written by either
package load in the other and compare equal, a plan repository
published by one is read by the other, and ``ingest_delta`` gives the
same ``DeltaPlan``.  The JAX package's lifecycle tests and its plan
round-trip tests (``tests/test_lifecycle.py``,
``tests/test_session_plan.py``) run against the port
(``torch_diff.run_reference_test``); the ones that serve on the SPMD
engine run on the port only, since ``tests/test_lifecycle.py`` runs them
on the JAX package.
"""
import dataclasses
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
import repro.online as JO
import repro_torch.core as T
import repro_torch.online as TO
import test_lifecycle as reference_lifecycle_tests
import test_session_plan as reference_plan_tests
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint as t_load
from repro_torch.checkpoint import save_checkpoint as t_save
from test_torch_online import run_on
from test_torch_strategies import _assert_same_state

PACKAGES = ["repro", "repro_torch"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here are many small tensor operations: one
    intra-op thread a test process keeps parallel test workers from
    oversubscribing the cores (several times slower otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the reference's tests that serve on the SPMD engine: on the port here,
# on the JAX package in tests/test_lifecycle.py
_SPMD_SERVING = ("test_adaptive_spmd_parity_through_repartition",
                 "test_frontdoor_serves_across_requested_swap",
                 "test_ingest_delta_served_through_hot_swap")
LIFECYCLE_TESTS = sorted(n for n in vars(reference_lifecycle_tests)
                         if n.startswith("test_"))
# tests/test_session_plan.py's save/load round trips and wrong-graph
# checks
PLAN_TESTS = ["test_plan_save_load_roundtrip",
              "test_horizontal_plan_roundtrip_with_minterms",
              "test_warp_plan_roundtrip", "test_replicated_plan_roundtrip",
              "test_unreplicated_plans_differ_from_replicated",
              "test_pr4_era_plan_loads_with_empty_replication",
              "test_plan_load_rejects_wrong_graph",
              "test_plan_load_rejects_same_size_different_content"]
CASES = ([(reference_lifecycle_tests, n, p) for n in LIFECYCLE_TESTS
          for p in (["repro_torch"] if n in _SPMD_SERVING else PACKAGES)]
         + [(reference_plan_tests, n, p) for n in PLAN_TESTS
            for p in PACKAGES])


@pytest.mark.parametrize("module,name,package", CASES,
                         ids=[f"{n}-{p}" for _m, n, p in CASES])
def test_reference_lifecycle_tests(module, name, package, monkeypatch,
                                   tmp_path, request):
    run_on(module, name, package, monkeypatch, tmp_path, request)


# ----------------------------------------------------------------------
# (c) plans saved by either package load in the other
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    """``tests/test_session_plan.py``'s ``tiny`` inputs in each package
    (3,000 triples, 300 queries)."""
    jg = J.generate_watdiv(3_000, seed=21)
    tg = T.generate_watdiv(3_000, seed=21)
    return ((jg, J.generate_workload(jg, 300, seed=22)),
            (tg, T.generate_workload(tg, 300, seed=22)))


KIND_CASES = [("vertical", 0), ("vertical", 300_000), ("horizontal", 0),
              ("shape", 0), ("warp", 0)]


@pytest.mark.parametrize("kind,budget", KIND_CASES,
                         ids=[f"{k}-{b}" for k, b in KIND_CASES])
def test_plans_cross_packages(tiny_pair, tmp_path, kind, budget):
    (jg, jwl), (tg, twl) = tiny_pair
    jplan = J.build_plan(jg, jwl, J.PartitionConfig(
        kind=kind, num_sites=4, replication_budget_bytes=budget))
    tplan = T.build_plan(tg, twl, T.PartitionConfig(
        kind=kind, num_sites=4, replication_budget_bytes=budget))
    if kind == "horizontal":
        assert any(f.minterm is not None and f.minterm.terms
                   for f in tplan.frag.fragments)
    if budget:
        assert tplan.replicated_props
    from_jax = T.PartitionPlan.load(jplan.save(tmp_path / "j"), tg)
    from_port = J.PartitionPlan.load(tplan.save(tmp_path / "t"), jg)
    assert from_jax == tplan
    assert from_port == jplan
    # the offline stats ride along as written (their seconds are the
    # writer's)
    for loaded, writer in ((from_jax, jplan), (from_port, tplan)):
        assert (loaded.stats is None) == (writer.stats is None)
        if writer.stats is not None:
            assert dataclasses.asdict(loaded.stats) == \
                dataclasses.asdict(writer.stats)
    _assert_same_state(convert.plan_state_arrays(from_port),
                       convert.plan_state_arrays(from_jax))
    # the same plan writes the same manifest and arrays in both packages
    jm = json.loads((tmp_path / "j" / "plan.json").read_text())
    tm = json.loads((tmp_path / "t" / "plan.json").read_text())
    for m in (jm, tm):
        m.pop("stats")
    assert tm == jm
    jl = json.loads((tmp_path / "j" / "step_0" / "manifest.json")
                    .read_text())
    tl = json.loads((tmp_path / "t" / "step_0" / "manifest.json")
                    .read_text())
    assert tl == jl
    for e in tl["leaves"]:
        np.testing.assert_array_equal(
            np.load(tmp_path / "t" / "step_0" / e["file"]),
            np.load(tmp_path / "j" / "step_0" / e["file"]))
    # a loaded plan serves: the port's spmd engine on the CPU
    q = T.QueryGraph.make([(e.src, e.dst, e.prop)
                           for e in twl.queries[0].edges])
    assert T.Session(from_jax, backend="spmd", device="cpu").execute(
        q).num_rows == T.match_pattern(tg, q).num_rows


def test_plan_repository_cross_packages(tiny_pair, tmp_path):
    """Versions and monitor state published by one package load in the
    other: the latest plan equals the publisher's, provenance chains,
    the monitor resumes with the same statistics."""
    (jg, jwl), (tg, twl) = tiny_pair
    jplan = J.build_plan(jg, jwl, J.PartitionConfig(num_sites=4))
    tplan = T.build_plan(tg, twl, T.PartitionConfig(num_sites=4))
    jmon = JO.WorkloadMonitor(jg.num_properties)
    jmon.bulk_load(jwl)
    jrepo = JO.PlanRepository(tmp_path / "repo")
    jrepo.publish(jplan, reason="initial build")
    trepo = TO.PlanRepository(tmp_path / "repo")
    assert trepo.publish(tplan, monitor=jmon, reason="port") == 2
    assert jrepo.provenance(2)["parent"] == 1
    assert trepo.provenance(2) == jrepo.provenance(2)
    assert trepo.load_latest(tg) == tplan
    assert jrepo.load_version(1, jg) == jplan
    assert trepo.load_version(1, tg) == tplan
    for repo in (jrepo, trepo):
        mon = repo.load_monitor(2)
        u1, w1 = jmon.snapshot()
        u2, w2 = mon.snapshot()
        assert [q.canonical_code() for q in u2] == \
            [q.canonical_code() for q in u1]
        np.testing.assert_array_equal(w2, w1)


# ----------------------------------------------------------------------
# (d) checkpoints with a bfloat16 leaf cross packages
# ----------------------------------------------------------------------

def _tree(rng, bf16):
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return {"frag_10": np.arange(4, dtype=np.int64),
            "frag_2": rng.integers(0, 9, (2, 3)).astype(np.int32),
            "layers": [{"w": bf16(w)}, {"b": np.float32(1.5)}],
            "skip": None}, w


def test_bf16_checkpoint_cross_packages(tmp_path):
    rng = np.random.default_rng(0)
    jtree, w = _tree(rng, lambda a: jnp.asarray(a, jnp.bfloat16))
    ttree = {**jtree, "layers": [{"w": torch.from_numpy(w).to(
        torch.bfloat16)}, jtree["layers"][1]]}
    j_save(tmp_path / "j", 3, jtree)
    t_save(tmp_path / "t", 3, ttree)
    jm = json.loads((tmp_path / "j" / "step_3" / "manifest.json")
                    .read_text())
    tm = json.loads((tmp_path / "t" / "step_3" / "manifest.json")
                    .read_text())
    assert tm == jm
    assert [e["name"] for e in tm["leaves"]] == \
        ["frag_10", "frag_2", "layers/0/w", "layers/1/b"]
    assert tm["leaves"][2]["dtype"] == "bfloat16"
    want = w.astype(ml_dtypes.bfloat16).astype(np.float32)
    # the JAX package's checkpoint into the port and the port's into
    # the JAX package
    got = t_load(tmp_path / "j", 3, ttree)
    assert got["layers"][0]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["layers"][0]["w"].float().numpy(),
                                  want)
    np.testing.assert_array_equal(got["frag_2"], jtree["frag_2"])
    assert got["skip"] is None
    back = j_load(tmp_path / "t", 3, jtree)
    assert back["layers"][0]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["layers"][0]["w"]).astype(np.float32), want)
    np.testing.assert_array_equal(np.asarray(back["frag_10"]),
                                  jtree["frag_10"])
    with pytest.raises(ValueError, match="shape"):
        t_load(tmp_path / "j", 3, {**ttree, "frag_2": np.zeros((3, 3))})
    with pytest.raises(KeyError, match="missing"):
        t_load(tmp_path / "j", 3, {**ttree, "extra": np.zeros(1)})


# ----------------------------------------------------------------------
# (e) ingest_delta
# ----------------------------------------------------------------------

def test_ingest_delta_matches_reference():
    """``tests/test_lifecycle.py``'s setup and seeded delta in each
    package: the new graph, every fragment diff, the shipped and
    whole-fragment bytes, the migration and the rebuilt plan equal."""
    out = []
    for core, online in ((J, JO), (T, TO)):
        g = core.generate_watdiv(3_000, seed=3)
        wl = core.generate_drifting_workload(g, [(300, {})], seed=11)
        plan = core.build_plan(g, wl, core.PartitionConfig(
            kind="vertical", num_sites=4))
        add, rem = reference_lifecycle_tests._delta(g)
        g2 = g.apply_delta(added_edges=add, removed_edges=rem)
        out.append((g2, online.ingest_delta(plan, g2, budget_bytes=10**6)))
    (jg2, jdp), (tg2, tdp) = out
    for f in ("s", "p", "o"):
        np.testing.assert_array_equal(getattr(tg2, f), getattr(jg2, f))
    assert tg2.num_vertices == jg2.num_vertices
    assert len(tdp.deltas) == len(jdp.deltas) > 0
    for a, b in zip(tdp.deltas, jdp.deltas):
        assert (a.frag_idx, a.site, a.removed, a.nbytes) == \
            (b.frag_idx, b.site, b.removed, b.nbytes)
        np.testing.assert_array_equal(a.added, b.added)
    for f in ("shipped_bytes", "whole_bytes", "added_edges",
              "removed_edges", "unassigned", "makespan_sec"):
        assert getattr(tdp, f) == getattr(jdp, f), f
    assert tdp.within_budget() == jdp.within_budget()
    assert [dataclasses.astuple(m) for m in tdp.migration.applied] == \
        [dataclasses.astuple(m) for m in jdp.migration.applied]
    np.testing.assert_array_equal(tdp.migration.final_site_of,
                                  jdp.migration.final_site_of)
    _assert_same_state(convert.plan_state_arrays(jdp.plan),
                       convert.plan_state_arrays(tdp.plan))
    assert tdp.plan.frag.coverage_ok(tg2)
