"""The SPMD engine across a process group: gloo ranks on the CPU, each
holding a contiguous block of the site axis, against the JAX
``SpmdEngine`` on a host mesh and the one-process port engine.

The ranks run the bodies of ``torch_dist_ranks`` (a module that imports
no JAX) through ``repro_torch.launch.mesh.launch``; each returns what
it served and the parent compares, exactly: answer sets, per-query
ledger bytes and sites touched, the final tier's per-step decision and
shipped-row vectors and capacity tiers, the engine's totals and every
``stats().extra`` key, through ``execute`` and ``execute_many``.  Every
rank must report the same.  Also ``spmd_match`` over a 4-rank group,
the elastic manager (the JAX package's own tests on the port, and a
site lost then re-planned onto a 3-rank group), the launcher's failure
handling, the site mesh's rules and the kernel launcher's device
check."""
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait

import numpy as np
import pytest
import torch

import repro.core as J
import test_substrate as reference_substrate_tests
import torch_dist_ranks as ranks
from repro.core.allocation import fragment_affinity as j_fragment_affinity
from repro.core.spmd import SiteStore as JStore
from repro.core.spmd import SpmdEngine as JEngine
from repro.core.spmd import spmd_match as j_spmd_match
from repro.distributed import replan_allocation as j_replan
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro_torch import convert
from repro_torch.core import RDFGraph
from repro_torch.core.spmd import (SiteStore, SpmdEngine,
                                   fragment_site_edge_ids)
from repro_torch.distributed import ElasticMeshManager, replan_allocation
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (SiteMesh, launch, launch_device,
                                     make_host_mesh, mesh_axis_sizes)
from torch_diff import port_query, run_reference_test

CAPACITY = 1024          # below the largest answer: its retry ladder climbs
BATCH = 8                # execute_many's batches: shapes share inside one
# (capacity, comm_plan, routing) served by every group
CONFIGS = [(CAPACITY, True, True), (CAPACITY, True, False)]
# (world, slots): 4 slots over 1, 2 and 4 ranks, and 2 slots over 2
SERVE_CASES = [(1, 4), (2, 4), (4, 4), (2, 2)]
DEADLINE_S = 120.0
SHAPE_PROPS = ("follows", "locatedIn", "friendOf", "makesReview",
               "reviewOf", "hasGenre", "friendOf", "friendOf", "follows")


@pytest.fixture(scope="module")
def jplan(watdiv_small):
    """A 4-site vertical plan of the WatDiv fixture (JAX package)."""
    return J.build_plan(watdiv_small,
                        J.generate_workload(watdiv_small, 200, seed=11),
                        J.PartitionConfig(kind="vertical", num_sites=4))


@pytest.fixture(scope="module")
def queries(watdiv_small):
    """WatDiv template queries, half with a constant, then a star, a
    chain and a cycle."""
    served = J.generate_workload(watdiv_small, 9, seed=5,
                                 constant_fraction=0.5,
                                 cold_fraction=0.0).queries
    props = iter(J.workload.PROP[n] for n in SHAPE_PROPS)
    shapes = J.make_shape_queries(lambda: next(props), k=3)
    return list(served) + [shapes["star"], shapes["chain"], shapes["cycle"]]


@pytest.fixture(scope="module")
def edges(queries):
    return [[(e.src, e.dst, e.prop) for e in q.edges] for q in queries]


@pytest.fixture(scope="module")
def arrays(jplan):
    return convert.plan_arrays(jplan)


def jax_record(engine, queries):
    """``torch_dist_ranks.engine_record`` of a JAX engine."""
    per_query = []
    for q in queries:
        r = engine.execute(q)
        _b, _v, caps, attempts = engine._run_exact(q.normalize())
        per_query.append({
            "answer": ranks.answer(r), "comm_bytes": int(r.stats.comm_bytes),
            "touched": sorted(r.stats.sites_touched), "caps": list(caps),
            "attempts": [(np.asarray(d).tolist(), np.asarray(rows).tolist(),
                          int(n)) for d, rows, n in attempts]})
    return per_query, ranks.totals(engine)


@pytest.fixture(scope="module")
def expected(jplan, queries):
    """The JAX engine's record on a ``slots``-device host mesh, once per
    (slots, routing)."""
    cache = {}

    def get(slots, routing):
        if (slots, routing) not in cache:
            eng = J.Session(jplan, backend="spmd", mesh=j_host_mesh(slots),
                            spmd_capacity=CAPACITY,
                            spmd_routing=routing).engine
            cache[slots, routing] = jax_record(eng, queries)
        return cache[slots, routing]
    return get


@pytest.fixture(scope="module")
def one_process(arrays, queries):
    """The one-process port engine's records (``execute`` and
    ``execute_many``), once per (slots, config)."""
    cache = {}
    port_qs = [port_query(q) for q in queries]

    def get(slots, cfg):
        if (slots, cfg) not in cache:
            cap, comm_plan, routing = cfg

            def engine():
                return convert.engine_from_arrays(
                    arrays, device="cpu", num_devices=slots, capacity=cap,
                    comm_plan=comm_plan, routing=routing)
            cache[slots, cfg] = {
                "execute": ranks.engine_record(engine(), port_qs),
                "execute_many": ranks.many_record(engine(), port_qs, BATCH)}
        return cache[slots, cfg]
    return get


def in_background(fn, *args, **kwargs) -> Future:
    """``fn(*args, **kwargs)`` on a thread of its own: a ``launch``
    whose ranks start while the parent compiles the JAX engine."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(fn, *args, **kwargs)
    pool.shutdown(wait=False)
    return fut


@pytest.fixture(scope="module")
def served(arrays, edges, tmp_path_factory):
    """The serve cases' groups, one per world size, all started at the
    first serve test so that their ranks' start-up overlaps the JAX
    engine's compiles in the parent: world -> a future of its ranks'
    outputs, each rank serving every slot count of its world."""
    futs = {world: in_background(
        launch, ranks.serve_rank, world,
        tmp_path_factory.mktemp(f"world{world}"), backend="gloo",
        args=(arrays, edges, [s for w, s in SERVE_CASES if w == world],
              CONFIGS, BATCH), deadline_s=DEADLINE_S)
        for world in dict.fromkeys(w for w, _s in SERVE_CASES)}
    yield futs
    wait(list(futs.values()))


@pytest.mark.parametrize("world,slots", SERVE_CASES,
                         ids=[f"world{w}-slots{s}" for w, s in SERVE_CASES])
def test_ranks_serve_like_the_reference(world, slots, served, expected,
                                        one_process):
    ranks_out = served[world].result()
    assert [o["rank"] for o in ranks_out] == list(range(world))
    out = [o[slots] for o in ranks_out]
    k = slots // world
    assert [o["local_slots"] for o in out] == [
        list(range(r * k, (r + 1) * k)) for r in range(world)]
    for cfg in CONFIGS:
        want = expected(slots, cfg[2])
        one = one_process(slots, cfg)
        assert one["execute"] == want
        per_query, tot = want
        assert tot["extra"]["capacity_retries"] > 0
        answers = [r["answer"] for r in per_query]
        assert [a for a, _b in one["execute_many"][0]] == answers
        assert one["execute_many"][1]["extra"]["batch_shape_hits"] > 0
        for r, o in enumerate(out):
            assert o[cfg]["execute"] == want, (r, cfg)
            assert o[cfg]["execute_many"] == one["execute_many"], (r, cfg)
    calls = [o["collectives"] for o in out]
    assert calls == [calls[0]] * world
    assert calls[0]["all_gather"] > 0 and calls[0]["all_reduce"] > 0
    last = want[0][-1]["answer"]
    assert [o["swap"] for o in out] == [(1, r * k, k, last)
                                        for r in range(world)]


def _site_edge_ids(n_edges, n, seed):
    """A seeded assignment of the edges to ``n`` sites, a fifth of them
    on a second site too."""
    rng = np.random.default_rng(seed)
    home = rng.integers(0, n, n_edges)
    extra = (home + 1) % n
    dup = rng.random(n_edges) < 0.2
    return [np.unique(np.concatenate([np.flatnonzero(home == j),
                                      np.flatnonzero(dup & (extra == j))]))
            for j in range(n)]


def test_spmd_match_over_a_group_matches_reference(watdiv_small, queries,
                                                   tmp_path):
    """``spmd_match`` / ``make_spmd_matcher`` on each rank's shard of a
    4-rank mesh against the reference's ``spmd_match`` on a 4-device
    mesh; in the ranks, the mesh's rules hold."""
    g = watdiv_small
    ids = _site_edge_ids(g.num_edges, 4, seed=3)
    shapes = queries[-3:]
    cols = (g.s, g.p, g.o, g.num_vertices, g.num_properties)
    run = in_background(
        launch, ranks.match_rank, 4, tmp_path, backend="gloo",
        args=(cols, ids, [[(e.src, e.dst, e.prop) for e in q.edges]
                          for q in shapes], 2048), deadline_s=DEADLINE_S)
    jstore = JStore.build(g, ids)
    mesh = j_host_mesh(4)
    want = []
    for q in shapes:
        rows, var_order = j_spmd_match(jstore, mesh, "sites", q,
                                       capacity=2048)
        want.append((np.asarray(rows).tolist(), var_order))
    assert all(len(r) > 0 for r, _v in want)
    for rank, o in enumerate(run.result()):
        assert o["shard"] == (rank, 1, 4) and o["slots"] == [rank]
        assert o["refused"] == ["uneven", "backend", "whole store"]
        for (rows, var_order, ovf, dec, shipped), w, q in zip(
                o["matches"], want, shapes):
            assert (rows, var_order) == w
            assert ovf == [0] * 4
            assert dec == [0] * (len(q.edges) - 1)    # gathers
            assert len(shipped) == len(dec)


@pytest.mark.parametrize("name", ["test_plan_mesh_shrinks_data_axis",
                                  "test_elastic_manager_rebuilds_mesh"])
def test_reference_elastic_tests_on_the_port(name, monkeypatch, tmp_path):
    run_reference_test(reference_substrate_tests, name, "repro_torch",
                       monkeypatch, tmp_path)


def test_site_loss_replans_onto_a_smaller_group(jplan, queries, tmp_path):
    """One of 4 devices fails; the fragments are re-allocated onto the 3
    survivors (Algorithm 2) and a 3-rank group serves the plan like the
    JAX engine on a 3-device host mesh."""
    mgr = ElasticMeshManager(model_parallel=1, devices=[
        torch.device("cpu") for _ in range(4)])
    assert mgr.current_plan().devices_used == 4
    lost = [1]
    mgr.fail([mgr.live[i] for i in lost])
    assert mgr.current_plan().devices_used == 3 and mgr.generation == 1
    aff = j_fragment_affinity(jplan.frag, jplan.sel_usage, jplan.weights)
    sizes = np.array([f.size for f in jplan.frag.fragments], np.float64)
    site_of = replan_allocation(aff, 3, sizes)
    np.testing.assert_array_equal(site_of, j_replan(aff, 3, sizes))
    ids = fragment_site_edge_ids(jplan.frag, site_of, 3)
    g = jplan.graph
    run = in_background(
        launch, ranks.elastic_rank, 3, tmp_path, backend="gloo",
        args=((g.s, g.p, g.o, g.num_vertices, g.num_properties), ids,
              [[(e.src, e.dst, e.prop) for e in q.edges] for q in queries],
              lost, CAPACITY), deadline_s=DEADLINE_S)
    want = jax_record(JEngine(g, ids, mesh=j_host_mesh(3),
                              capacity=CAPACITY), queries)
    assert want[1]["extra"]["devices"] == 3.0
    for o in run.result():
        assert o == want
    mgr.recover()
    assert len(mgr.live) == 4 and mgr.generation == 2


def test_launcher_raises_when_a_rank_fails(tmp_path):
    """Rank 1 raises while rank 0 blocks in a collective: the launcher
    terminates both and raises with rank 1's traceback, long before the
    group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(ranks.failing_rank, 2, tmp_path, backend="gloo",
               timeout_s=300.0, deadline_s=DEADLINE_S)
    assert time.monotonic() - t0 < 60.0


def test_launcher_deadline_terminates_the_ranks(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] gave no"):
        launch(ranks.stalled_rank, 2, tmp_path, backend="gloo",
               deadline_s=5.0)
    assert time.monotonic() - t0 < 30.0
    assert not list(tmp_path.iterdir())      # the store file is gone


# ----------------------------------------------------------------------
# The site mesh, the manager and the launch device check, in process
# ----------------------------------------------------------------------

def test_one_process_mesh():
    mesh = make_host_mesh(4, device="cpu")
    assert (mesh.slots, mesh.world, mesh.rank) == (4, 1, 0)
    assert mesh.local_slots == range(4) and mesh.devices.size == 1
    assert mesh.device == torch.device("cpu")
    assert mesh_axis_sizes(mesh) == {"sites": 4}
    assert mesh_axis_sizes(make_host_mesh(2, axis="x", device="cpu")) \
        == {"x": 2}
    with pytest.raises(ValueError, match="at least one slot"):
        make_host_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="2 devices for 1 ranks"):
        SiteMesh(4, (torch.device("cpu"),) * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_host_mesh(4)


def test_engine_on_a_one_process_mesh(arrays, queries, one_process):
    """A mesh without a group is the one-process axis: the same record
    as ``num_devices``; a mesh that disagrees with the other arguments
    is refused."""
    cfg = CONFIGS[0]
    eng = convert.engine_from_arrays(
        arrays, device="cpu", mesh=make_host_mesh(4, device="cpu"),
        capacity=cfg[0])
    assert ranks.engine_record(eng, [port_query(q) for q in queries]) \
        == one_process(4, cfg)["execute"]
    with pytest.raises(ValueError, match="num_devices=2"):
        convert.engine_from_arrays(arrays, device="cpu", num_devices=2,
                                   mesh=make_host_mesh(4, device="cpu"))


def test_elastic_manager_devices_and_reshard():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ElasticMeshManager(model_parallel=1)
    devs = [torch.device("cpu") for _ in range(3)]
    mgr = ElasticMeshManager(model_parallel=1, devices=devs)
    mesh = mgr.make_mesh()
    assert (mesh.slots, mesh.world, mesh.device) == (3, 1, devs[0])
    mgr.fail(devs[:1])
    assert mgr.live == devs[1:] and mgr.make_mesh().slots == 2
    tree = {"w": torch.ones(2), "opt": [torch.zeros(3), torch.arange(2)]}
    placed = mgr.reshard(tree, {"w": "meta", "opt": ["cpu", "meta"]})
    assert [placed["w"].device.type, placed["opt"][0].device.type,
            placed["opt"][1].device.type] == ["meta", "cpu", "meta"]


def test_survivors_mesh_and_launcher_agree_on_cards(monkeypatch):
    """After cuda:1 of 4 fails, rank r of the survivors' group is on the
    r-th survivor in the mesh the manager builds and in the launcher
    (``launch(..., devices=mgr.rank_devices)``); a rank launched on
    ``cuda:<rank>`` (the default) while its shard is on another card
    is refused.  The cards are device objects and the group a stand-in:
    the check needs neither a card nor a group."""
    cards = [torch.device("cuda", i) for i in range(4)]
    mgr = ElasticMeshManager(model_parallel=1, devices=cards)
    mgr.fail([cards[1]])
    assert mgr.rank_devices == [cards[0], cards[2], cards[3]]
    group, state = object(), {}
    monkeypatch.setattr(torch.distributed, "get_backend", lambda g: "nccl")
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda g: 3)
    monkeypatch.setattr(torch.distributed, "get_rank",
                        lambda g: state["rank"])
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: state["card"].index)
    for rank in range(3):
        state["rank"] = rank
        state["card"] = launch_device("nccl", rank, mgr.rank_devices)
        mesh = mgr.make_mesh(group)
        assert mesh.device == state["card"] == mgr.rank_devices[rank]
        assert mesh.local_slots == range(rank, rank + 1)
        state["card"] = launch_device("nccl", rank)
        if state["card"] != mgr.rank_devices[rank]:
            with pytest.raises(ValueError, match="launch the ranks"):
                mgr.make_mesh(group)
    assert launch_device("gloo", 0, None) is None
    with pytest.raises(ValueError, match="one card for each"):
        launch(ranks.stalled_rank, 2, ".", backend="gloo",
               devices=mgr.rank_devices[:2])


def test_launch_refuses_tensors_off_one_card():
    cpu, meta = torch.zeros(4, dtype=torch.int32), \
        torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        ops._launch("join_count", cpu, 4, meta)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops._launch("join_count", cpu, 4, cpu)
    with pytest.raises(ValueError, match="one device"):
        ops.join_range(cpu, meta)
    # the plain versions are unaffected
    lo, cnt = ops.join_range(torch.tensor([1, 2], dtype=torch.int32),
                             torch.tensor([1, 1, 2], dtype=torch.int32))
    assert lo.tolist() == [0, 2] and cnt.tolist() == [2, 1]


def test_engine_rejects_a_store_mesh_mismatch(watdiv_small):
    g = watdiv_small
    tg = RDFGraph(g.s, g.p, g.o, g.num_vertices, g.num_properties)
    with pytest.raises(ValueError, match="3 sites for a mesh of 4 slots"):
        SiteStore.build(tg, _site_edge_ids(g.num_edges, 3, seed=1),
                        mesh=make_host_mesh(4, device="cpu"))
    eng = SpmdEngine(tg, _site_edge_ids(g.num_edges, 4, seed=1),
                     device="cpu", mesh=make_host_mesh(2, device="cpu"))
    assert eng.store.num_sites == eng.store.num_local == 2
