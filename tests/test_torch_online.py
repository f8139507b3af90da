"""The port's online control plane (``repro_torch.online``) against the
JAX package's (``repro.online``): the same seeded stream gives the same
monitor state, drift reports, re-fragmentation, migration plan and, through
``AdaptiveEngine`` on the local and the SPMD data plane, the same answers,
per-query bytes, epoch reports and realized plans.  The JAX package's own
online, straggler and checkpoint-manager tests run against both packages
(``torch_diff.run_reference_test``), and the chip smoke's constants of the
JAX package's online benches are held to that package's run.
"""
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro.online as JO
import repro_torch.core as T
import repro_torch.online as TO
import test_checkpoint_manager as reference_ckpt_tests
import test_online_adaptive as reference_online_tests
import test_straggler_work_queue as reference_straggler_tests
from generators import answer_set
from repro.core.allocation import fragment_affinity as j_affinity
from repro_torch import convert
from repro_torch.core.allocation import fragment_affinity as t_affinity
from torch_diff import fixture_args, port_query, run_reference_test

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

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


# ----------------------------------------------------------------------
# The JAX package's tests, on both packages
# ----------------------------------------------------------------------

def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn()


_PORT_CONFTEST = {}


def _port_conftest(name):
    """The port's values of the conftest fixtures the reference tests
    take (``tests/conftest.py``'s seeds and sizes)."""
    if name not in _PORT_CONFTEST:
        if name == "watdiv_small":
            value = T.generate_watdiv(8000, seed=7)
        elif name == "workload_small":
            value = T.generate_workload(_port_conftest("watdiv_small"), 800,
                                        seed=11)
        else:
            kind = {"partitioner_v": "vertical",
                    "partitioner_h": "horizontal"}[name]
            value = _quiet(lambda: T.WorkloadPartitioner(
                _port_conftest("watdiv_small"),
                _port_conftest("workload_small"),
                T.PartitionConfig(kind=kind, num_sites=6)).run())
        _PORT_CONFTEST[name] = value
    return _PORT_CONFTEST[name]


def conftest_for(package, request):
    """name -> zero-argument callable giving ``package``'s value of a
    conftest fixture."""
    names = ("watdiv_small", "workload_small", "partitioner_v",
             "partitioner_h")
    if package == "repro":
        return {n: (lambda n=n: request.getfixturevalue(n)) for n in names}
    return {n: (lambda n=n: _port_conftest(n)) for n in names}


def run_on(module, name, package, monkeypatch, tmp_path, request,
           given=None):
    args = fixture_args(module, getattr(module, name), package,
                        conftest_for(package, request), given)
    _quiet(lambda: run_reference_test(module, name, package, monkeypatch,
                                      tmp_path, **args))


def reference_cases(module, skip=()):
    """(module, test name, parameters) of every test of a reference
    module, one entry per case of a parametrized test."""
    out = []
    for name in sorted(vars(module)):
        fn = vars(module)[name]
        if not name.startswith("test_") or name in skip:
            continue
        params = [m for m in getattr(fn, "pytestmark", [])
                  if m.name == "parametrize"]
        if not params:
            out.append((module, name, {}))
            continue
        (mark,) = params
        out += [(module, name, {mark.args[0]: v}) for v in mark.args[1]]
    return out


# these two import the JAX package inside the test body, where no name
# can be swapped; the port's counterparts follow below
_LOCAL_IMPORTS = ("test_sketch_key_stable_across_hash_seeds",
                  "test_refragment_dispatches_through_strategy_registry")
REFERENCE_TESTS = (reference_cases(reference_online_tests, _LOCAL_IMPORTS)
                   + reference_cases(reference_straggler_tests)
                   + reference_cases(reference_ckpt_tests))


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize(
    "module,name,given", REFERENCE_TESTS,
    ids=[n + "".join(f"[{v}]" for v in g.values())
         for _m, n, g in REFERENCE_TESTS])
def test_reference_online_tests(module, name, given, package, monkeypatch,
                                tmp_path, request):
    run_on(module, name, package, monkeypatch, tmp_path, request, given)


def test_sketch_key_stable_across_hash_seeds_in_the_port():
    """The port's sketch keys equal the JAX package's and do not move
    with ``PYTHONHASHSEED`` (monitor state restored in another process,
    or by the other package, re-admits evicted shapes' mass)."""
    from repro.online.monitor import sketch_key as j_key
    from repro_torch.online.monitor import sketch_key as t_key
    code = T.QueryGraph.make([(-1, -2, 3), (-2, -3, 1)]).canonical_code()
    jcode = J.QueryGraph.make([(-1, -2, 3), (-2, -3, 1)]).canonical_code()
    assert code == jcode and t_key(code) == j_key(jcode)
    prog = ("from repro_torch.core.query import QueryGraph;"
            "from repro_torch.online.monitor import sketch_key;"
            "q = QueryGraph.make([(-1, -2, 3), (-2, -3, 1)]);"
            "print(sketch_key(q.canonical_code()))")
    for seed in ("0", "4242"):
        env = dict(os.environ, PYTHONHASHSEED=seed,
                   PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run([sys.executable, "-c", prog], env=env,
                             capture_output=True, text=True, check=True)
        assert int(out.stdout.strip()) == t_key(code)


def test_refragment_dispatches_through_the_port_registry():
    """The reference's registry test on the port's registry: a strategy
    without a refragment hook is refused naming the hook-bearing kinds,
    and registering a hook lets it re-fragment."""
    from repro_torch.core.fragmentation import vertical_fragmentation
    from repro_torch.core.plan import STRATEGIES
    g = T.generate_watdiv(2000, seed=3)
    wl = T.generate_drifting_workload(g, [(200, {})], seed=5)
    base = T.build_plan(g, wl, T.PartitionConfig(kind="vertical",
                                                 num_sites=4))
    mon = TO.WorkloadMonitor(g.num_properties, decay=0.995, capacity=128)
    mon.bulk_load(wl)

    @STRATEGIES.register("dummy-rf")
    def _dummy_builder(graph, workload, cfg):     # pragma: no cover
        raise AssertionError("builder is not exercised here")

    try:
        cfg = T.PartitionConfig(kind="dummy-rf", num_sites=4)
        with pytest.raises(ValueError) as ei:
            TO.refragment(g, mon, cfg, base.selected_patterns)
        for name in ("dummy-rf", "vertical", "horizontal"):
            assert name in str(ei.value)

        @STRATEGIES.register_refragment("dummy-rf")
        def _dummy_refragment(graph, selected, sample, c, cold_ids, index):
            return vertical_fragmentation(graph, selected, cold_ids,
                                          c.num_cold_parts, index=index,
                                          max_rows=c.max_rows)

        res = TO.refragment(g, mon, cfg, base.selected_patterns)
        assert res.frag.coverage_ok(g)
    finally:
        STRATEGIES.unregister("dummy-rf")
    assert "dummy-rf" not in STRATEGIES.refragment_names()


# ----------------------------------------------------------------------
# (a) monitor, drift, re-fragmentation and migration against the JAX
# package's, on the same seeded stream
# ----------------------------------------------------------------------

def _same_graph(jg, tg):
    for f in ("s", "p", "o"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
    assert (tg.num_vertices, tg.num_properties) == (jg.num_vertices,
                                                    jg.num_properties)


def _same_queries(jqs, tqs):
    assert [q.edges for q in tqs] == [port_query(q).edges for q in jqs]


@pytest.fixture(scope="module")
def control_plane():
    """Each package's graph (6,000 triples), 4-site vertical plan with a
    replication budget, and a monitor fed its design workload and then a
    star-heavy stream with site heat; the monitors' drift reports, one
    re-fragmentation and its migration plan under a tight budget."""
    out = {}
    for name, core, online, aff in (("jax", J, JO, j_affinity),
                                    ("port", T, TO, t_affinity)):
        g = core.generate_watdiv(6000, seed=3)
        wl = core.generate_drifting_workload(g, [(500, {})], seed=5)
        cfg = core.PartitionConfig(kind="vertical", num_sites=4,
                                   replication_budget_bytes=40_000)
        plan = core.build_plan(g, wl, cfg)
        mon = online.WorkloadMonitor(g.num_properties, decay=0.995,
                                     capacity=64, reservoir_size=32)
        mon.bulk_load(wl)
        det = online.DriftDetector(min_effective_weight=10.0)
        det.set_reference(mon, plan.selected_patterns)
        stream = core.generate_drifting_workload(g, [(400, {"S": 12.0})],
                                                 seed=9).queries
        reports = []
        for i, q in enumerate(stream):
            mon.observe(q, sites=[i % 4, (3 * i) % 4])
            if i % 100 == 99:
                reports.append(det.check(mon))
        res = online.refragment(g, mon, cfg, plan.selected_patterns,
                                replica_bytes_per_edge=12.0)
        mig = online.plan_migration(
            plan.frag, plan.alloc, res.frag, res.desired_alloc,
            aff(res.frag, res.sel_usage, res.weights), 150_000, 12.0,
            old_replicated=set(plan.replicated_props),
            desired_replication=res.desired_replication)
        out[name] = dict(graph=g, design=wl, stream=stream, plan=plan,
                         monitor=mon, reports=reports, res=res, mig=mig,
                         makespan=online.schedule_migration(mig, 4))
    _same_graph(out["jax"]["graph"], out["port"]["graph"])
    _same_queries(out["jax"]["design"].queries, out["port"]["design"].queries)
    _same_queries(out["jax"]["stream"], out["port"]["stream"])
    return out["jax"], out["port"]


def test_monitor_state_matches_reference(control_plane):
    jx, pt = control_plane
    js, ts = jx["monitor"].state(), pt["monitor"].state()
    assert js.keys() == ts.keys()
    for k in js:
        assert ts[k].dtype == js[k].dtype, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    assert pt["monitor"].site_heat() == jx["monitor"].site_heat()
    assert pt["monitor"].hot_sites() == jx["monitor"].hot_sites()
    # and a monitor restored by the other package continues the same way
    for src, dst_cls in ((jx, TO.WorkloadMonitor), (pt, JO.WorkloadMonitor)):
        clone = dst_cls.from_state(src["monitor"].state())
        u1, w1 = src["monitor"].snapshot()
        u2, w2 = clone.snapshot()
        assert [q.canonical_code() for q in u2] == \
            [q.canonical_code() for q in u1]
        np.testing.assert_array_equal(w2, w1)


def test_drift_reports_match_reference(control_plane):
    jx, pt = control_plane
    assert [dataclasses.asdict(r) for r in pt["reports"]] == \
        [dataclasses.asdict(r) for r in jx["reports"]]
    assert any(r.fired for r in pt["reports"])


def test_refragment_matches_reference(control_plane):
    jx, pt = control_plane
    jr, tr = jx["res"], pt["res"]
    assert [p.canonical_code() for p in tr.selected_patterns] == \
        [p.canonical_code() for p in jr.selected_patterns]
    assert len(tr.frag.fragments) == len(jr.frag.fragments)
    for a, b in zip(tr.frag.fragments + tr.frag.cold_fragments,
                    jr.frag.fragments + jr.frag.cold_fragments):
        np.testing.assert_array_equal(a.edge_ids, b.edge_ids)
        assert (a.pattern_idx, a.card, a.kind) == (b.pattern_idx, b.card,
                                                   b.kind)
    np.testing.assert_array_equal(tr.desired_alloc.site_of,
                                  jr.desired_alloc.site_of)
    assert tr.cold_props == jr.cold_props
    np.testing.assert_array_equal(tr.sel_usage, jr.sel_usage)
    np.testing.assert_array_equal(tr.weights, jr.weights)
    assert (tr.num_mined, tr.num_incumbents_kept, tr.hot_sites) == \
        (jr.num_mined, jr.num_incumbents_kept, jr.hot_sites)
    assert jr.desired_replication is not None
    assert dataclasses.asdict(tr.desired_replication) == \
        dataclasses.asdict(jr.desired_replication)


def test_migration_plan_matches_reference(control_plane):
    jx, pt = control_plane
    jm, tm = jx["mig"], pt["mig"]

    def moves(ms):
        return [dataclasses.astuple(m) for m in ms]

    assert moves(tm.applied) == moves(jm.applied)
    assert moves(tm.deferred) == moves(jm.deferred)
    assert moves(tm.replica_ships) == moves(jm.replica_ships)
    np.testing.assert_array_equal(tm.final_site_of, jm.final_site_of)
    assert (tm.moved_bytes, tm.budget_bytes, tm.replica_bytes) == \
        (jm.moved_bytes, jm.budget_bytes, jm.replica_bytes)
    assert tm.replicated_props == jm.replicated_props
    assert tm.deferred_replications == jm.deferred_replications
    assert pt["makespan"] == jx["makespan"]
    # the budget bites: something is deferred, nothing strands
    assert tm.deferred and tm.strands_none(len(pt["res"].frag.fragments), 4)
    assert [dataclasses.astuple(w)[:3] for w in
            TO.migration_work_items(tm)] == \
        [dataclasses.astuple(w)[:3] for w in JO.migration_work_items(jm)]


# ----------------------------------------------------------------------
# (b) AdaptiveEngine on both data planes against the JAX package's
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def lifecycle_inputs():
    """``tests/test_lifecycle.py``'s setup in each package: 3,000
    triples, a 300-query design workload, a 4-site vertical plan, and
    its drifting stream (100 uniform, 300 star-heavy queries)."""
    out = {}
    for name, core in (("jax", J), ("port", T)):
        g = core.generate_watdiv(3_000, seed=3)
        wl = core.generate_drifting_workload(g, [(300, {})], seed=11)
        plan = core.build_plan(g, wl, core.PartitionConfig(
            kind="vertical", num_sites=4))
        stream = core.generate_drifting_workload(
            g, [(100, {}), (300, {"S": 12.0})], seed=23).queries
        out[name] = (g, plan, stream)
    _same_graph(out["jax"][0], out["port"][0])
    _same_queries(out["jax"][2], out["port"][2])
    return out["jax"], out["port"]


def _drive(engine, stream):
    """Answer sets and bytes per query, and the realized plan's state
    after every re-partition."""
    answers, comm, plans = [], [], []
    for q in stream:
        n = engine.num_repartitions
        r = engine.execute(q)
        answers.append(answer_set(r))
        comm.append(r.stats.comm_bytes)
        if engine.num_repartitions > n:
            plans.append(convert.plan_state_arrays(engine.plan))
    return answers, comm, plans


def _epochs(engine, wall_clock):
    out = []
    for ep in engine.epochs:
        d = dataclasses.asdict(ep)
        if wall_clock:
            # the SPMD engine's response time is measured, not modelled
            d.pop("response_time")
        out.append(d)
    return out


@pytest.mark.parametrize("serve_backend", ["local", "spmd"])
def test_adaptive_engine_matches_reference(lifecycle_inputs, serve_backend):
    from test_torch_strategies import _assert_same_state
    (jg, jplan, jstream), (tg, tplan, tstream) = lifecycle_inputs
    cfg = dict(epoch_len=100, serve_backend=serve_backend,
               migration_budget_bytes=2_000_000)
    jeng = JO.AdaptiveEngine(jplan, JO.AdaptiveConfig(**cfg))
    teng = T.Session(tplan, backend="adaptive", device="cpu",
                     adaptive_config=TO.AdaptiveConfig(**cfg)).engine
    assert isinstance(teng, TO.AdaptiveEngine)
    ja, jc, jp = _drive(jeng, jstream)
    ta, tc, tp = _drive(teng, tstream)
    assert ta == ja
    assert tc == jc
    spmd = serve_backend == "spmd"
    assert _epochs(teng, spmd) == _epochs(jeng, spmd)
    assert teng.num_repartitions == jeng.num_repartitions >= 1
    assert len(tp) == len(jp) == teng.num_repartitions
    for a, b in zip(jp, tp):
        _assert_same_state(a, b)
    assert (teng.total_comm_bytes, teng.total_moved_bytes) == \
        (jeng.total_comm_bytes, jeng.total_moved_bytes)
    assert teng.stats().extra == jeng.stats().extra
    if spmd:
        assert teng.engine.store_generation == \
            jeng.engine.store_generation == teng.num_repartitions
        assert teng.engine.stats().extra["store_swaps"] == \
            jeng.engine.stats().extra["store_swaps"]
        assert teng.engine.stats().comm_bytes == \
            jeng.engine.stats().comm_bytes


def test_adaptive_backend_keeps_the_device_rule(lifecycle_inputs):
    """``device`` reaches the SPMD data plane; the default asks for CUDA
    on either data plane and raises where there is none."""
    import torch
    (_jg, _jplan, _js), (tg, tplan, tstream) = lifecycle_inputs
    eng = TO.AdaptiveEngine(tplan, TO.AdaptiveConfig(serve_backend="spmd"),
                            device="cpu")
    assert eng.engine.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    for backend in ("local", "spmd"):
        with pytest.raises(RuntimeError, match="CUDA"):
            T.Session(tplan, backend="adaptive", adaptive_config=
                      TO.AdaptiveConfig(serve_backend=backend))


# ----------------------------------------------------------------------
# (f) the chip smoke's constants of the online benches
# ----------------------------------------------------------------------

def test_online_bench_constants_match_reference():
    """``chip_smoke.ONLINE_REFERENCE`` is the JAX package's run of
    ``bench_adaptive`` and ``bench_lifecycle`` (``online_bench_runs``
    through ``repro.core`` / ``repro.online``), so the card is held to
    the reference's numbers."""
    got = chip_smoke.online_bench_runs(J, JO)
    assert got == chip_smoke.ONLINE_REFERENCE
    assert got["lifecycle"]["shipped_bytes"] \
        < got["lifecycle"]["whole_fragment_bytes"]
