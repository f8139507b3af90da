"""One front door and one online control plane over a process group:
rank 0's ``Session`` leads (``Session.lead()``), announcing every engine
call to the other ranks, which follow (``Session.follow()``); every rank
serves its block of a 4-slot site axis.  Gloo ranks on the CPU, against
the one-process port and the JAX package:

* (a) the door in manual-pump mode at world 1, 2 and 4: every rank's
  engine log (answers and bytes per query, in engine order) and
  ``stats().extra`` equal the one-process port door's with the same
  batches, and the answers equal the JAX ``SpmdEngine``'s on a 4-device
  host mesh;
* (b) the threaded door at world 2: answers equal, the ranks equal one
  another;
* (c) a poison query overflowing a small ``spmd_max_capacity`` in a
  bucket with other shapes (a door keyed by edge count): its future
  fails, its bucket-mates complete on the per-request retry, a later
  query is still answered alike on every rank;
* (d) a hot swap through the door (``Session.swap_store``) against
  ``tests/test_torch_serve.py``'s JAX reference;
* (e) ``AdaptiveEngine`` on the SPMD data plane at world 2 and 4,
  rank 0 running the control plane, against the JAX ``AdaptiveEngine``
  on ``tests/test_torch_online.py``'s drifting stream: answers, bytes,
  epoch reports and the realized placement on every rank;
* (f) a failure on one rank ends the group through ``launch``.

Each world is spawned once for the module, at the first test that
needs it, so that the ranks run while the parent builds the JAX
references.
"""
import dataclasses
import time
from concurrent.futures import wait
from pathlib import Path

import pytest
import torch

import repro.core as J
import repro.online as JO
import repro_torch.core as T
import test_torch_isolation as isolation
import torch_dist_ranks as ranks
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro_torch import convert
from repro_torch.launch.mesh import launch, make_host_mesh
from repro_torch.online import AdaptiveConfig, AdaptiveEngine
from test_torch_distributed import in_background
from test_torch_serve import reference  # noqa: F401 (a fixture)
from torch_diff import rgraph, rplan, rqueries, tplan  # noqa: F401

CAPACITY = 1024
DEADLINE_S = 240.0
SHAPE_PROPS = ("follows", "locatedIn", "friendOf", "makesReview",
               "reviewOf", "hasGenre", "friendOf", "friendOf", "follows")
# queries of the poison part: mates of one bucket (two edges each), the
# poison (its answer needs 4,096 rows a site), then a later query
POISON = (0, 4, 8, 2, 10)
ADAPTIVE_CFG = dict(epoch_len=100, serve_backend="spmd",
                    migration_budget_bytes=2_000_000)
EARLY = 0                 # the direct end_epoch() comes before the stream
AFTER = slice(300, 350)   # star-heavy queries served again after the swap
WORLDS = {1: ("door",), 2: ("door", "threaded", "poison", "swap",
                            "adaptive"), 4: ("door", "adaptive")}
FAILURES = ("leader", "follower", "diverged")


@pytest.fixture(scope="module")
def jplan(watdiv_small):
    return J.build_plan(watdiv_small,
                        J.generate_workload(watdiv_small, 200, seed=11),
                        J.PartitionConfig(kind="vertical", num_sites=4))


@pytest.fixture(scope="module")
def queries(watdiv_small):
    served = J.generate_workload(watdiv_small, 9, seed=5,
                                 constant_fraction=0.5,
                                 cold_fraction=0.0).queries
    props = iter(J.workload.PROP[n] for n in SHAPE_PROPS)
    shapes = J.make_shape_queries(lambda: next(props), k=3)
    return list(served) + [shapes["star"], shapes["chain"], shapes["cycle"]]


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    """``tests/test_torch_online.py``'s adaptive inputs in both packages
    (3,000 triples, a 4-site vertical plan, 100 uniform then 300
    star-heavy queries), the port's plan saved for the ranks to load,
    and the stream served: the stream, then ``AFTER`` again."""
    out = {}
    for name, core in (("jax", J), ("port", T)):
        g = core.generate_watdiv(3_000, seed=3)
        wl = core.generate_drifting_workload(g, [(300, {})], seed=11)
        plan = core.build_plan(g, wl, core.PartitionConfig(
            kind="vertical", num_sites=4))
        stream = core.generate_drifting_workload(
            g, [(100, {}), (300, {"S": 12.0})], seed=23).queries
        out[name] = (g, plan, stream + stream[AFTER])
    g, plan, stream = out["port"]
    d = tmp_path_factory.mktemp("adaptive_plan") / "plan"
    plan.save(d)
    out["spec"] = ("adaptive", (str(d), (g.s, g.p, g.o, g.num_vertices,
                                         g.num_properties),
                                [ranks.edges_of(q) for q in stream], EARLY,
                                ADAPTIVE_CFG))
    assert [ranks.edges_of(q) for q in out["jax"][2]] == out["spec"][1][2]
    return out


@pytest.fixture(scope="module")
def parts(jplan, queries, tplan, rqueries, lifecycle):  # noqa: F811
    state = convert.plan_state_arrays(jplan)
    edges = [ranks.edges_of(q) for q in queries]
    door = {"spmd_capacity": CAPACITY}
    return {
        "door": ("door", (state, edges, door)),
        "threaded": ("threaded", (state, edges, door)),
        "poison": ("poison", (state, [edges[i] for i in POISON],
                              dict(zip(("spmd_capacity",
                                        "spmd_max_capacity"),
                                       ranks.POISON_CAPACITY)))),
        "swap": ("swap", (convert.plan_state_arrays(tplan),
                          [ranks.edges_of(q) for q in rqueries], {})),
        "adaptive": lifecycle["spec"]}


@pytest.fixture(scope="module")
def groups(parts, tmp_path_factory):
    """world -> a future of its ranks' records, every world started
    at once."""
    futs = {world: in_background(
        launch, ranks.group_serve_rank, world,
        tmp_path_factory.mktemp(f"group{world}"), backend="gloo",
        args=({n: parts[n] for n in names},), deadline_s=DEADLINE_S)
        for world, names in WORLDS.items()}
    yield futs
    wait(list(futs.values()))


@pytest.fixture(scope="module")
def one_process(parts):
    """The one-process port record of each part (no mesh, 4 slots)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = ranks.run_part(name, parts[name], None)
        return cache[name]
    return get


@pytest.fixture(scope="module")
def jax_answers(jplan, queries):
    sess = J.Session(jplan, backend="spmd", mesh=j_host_mesh(4),
                     spmd_capacity=CAPACITY)
    return [ranks.answer(sess.execute(q)) for q in queries]


def _records(groups, world, name):
    outs = groups[world].result()
    assert [o["rank"] for o in outs] == list(range(world))
    assert [o["slots"] for o in outs] == [
        list(range(r * 4 // world, (r + 1) * 4 // world))
        for r in range(world)]
    return [o[name] for o in outs]


def _completed(rec):
    assert all(o == "completed" for o, _a in rec["out"]["futures"])
    return [a for _o, a in rec["out"]["futures"]]


def _followers_in_step(recs):
    """Every rank's engine log, counters and collective calls equal
    rank 0's; the followers followed every announced call."""
    for r, rec in enumerate(recs):
        assert rec["log"] == recs[0]["log"], r
        assert rec["extra"] == recs[0]["extra"], r
        assert rec["comm_bytes"] == recs[0]["comm_bytes"], r
        assert rec["collectives"] == recs[0]["collectives"], r
        if r:
            assert len(rec["out"]["followed"]) == \
                recs[0]["collectives"]["broadcast"] - 1 \
                - len([e for e in recs[0].get("epochs", ())])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_door_leads_the_group(world, groups, one_process, jax_answers):
    recs = _records(groups, world, "door")
    one = one_process("door")
    _followers_in_step(recs)
    assert recs[0]["log"] == one["log"]
    assert recs[0]["extra"] == one["extra"]
    assert recs[0]["comm_bytes"] == one["comm_bytes"]
    assert recs[0]["out"] == one["out"]
    assert _completed(recs[0]) == jax_answers * 2
    assert recs[0]["extra"]["batch_shape_hits"] > 0
    assert recs[0]["extra"]["capacity_retries"] > 0
    # one announcement per batch, then the release
    assert recs[0]["collectives"]["broadcast"] == \
        recs[0]["out"]["door"]["batches"] + 1
    assert all(f == ("execute_many", None)
               for rec in recs[1:] for f in rec["out"]["followed"])


def test_threaded_door_leads_the_group(groups, jax_answers):
    recs = _records(groups, 2, "threaded")
    _followers_in_step(recs)
    assert _completed(recs[0]) == jax_answers
    assert recs[0]["out"]["door"]["failed"] == 0


def test_poison_query_fails_alone_on_the_group(groups, one_process,
                                               jax_answers):
    recs = _records(groups, 2, "poison")
    one = one_process("poison")
    _followers_in_step(recs)
    assert recs[0]["log"] == one["log"] and recs[0]["out"] == one["out"]
    outcomes = [o for o, _a in recs[0]["out"]["futures"]]
    assert outcomes == ["completed", "failed", "completed", "completed",
                        "completed"]
    assert recs[0]["out"]["futures"][1][1] == "RuntimeError"
    assert recs[0]["out"]["door"]["batch_fallbacks"] == 1
    answers = [a for o, a in recs[0]["out"]["futures"] if o == "completed"]
    assert answers == [jax_answers[i] for i in POISON if i != POISON[3]]
    errors = [e for _c, e in recs[1]["out"]["followed"] if e]
    # the batch and the poison's retry, on the follower as on the leader
    assert [e[0] for e in errors] == ["RuntimeError"] * 2
    assert all("overflow at max_capacity=1024" in e[1] for e in errors)


def test_hot_swap_through_the_door_on_the_group(
        groups, reference):  # noqa: F811
    recs = _records(groups, 2, "swap")
    _followers_in_step(recs)
    got, want = recs[0]["out"], reference

    def sets(answers):
        return [(list(vs), set(rows)) for vs, rows in answers]
    assert got["route_keyed"] and want["route_keyed"]
    assert got["buckets"] == got["shapes"] == want["buckets"]
    assert got["hits"] == want["hits"]
    assert sets(got["routed"]) == want["routed"]
    assert got["gen_queued"] == want["gen_queued"] == 0
    assert got["swaps_applied"] == want["swaps_applied"] == 1
    assert got["outcomes"] == ["completed"] * len(got["outcomes"])
    assert got["door"] == want["door"]
    assert sets(got["swap_answers"]) == want["swap_answers"]
    assert got["swap_comm"] == want["swap_comm"]
    assert [r["store_generation"] for r in recs] == [want["gen"]] * 2
    assert recs[0]["comm_bytes"] == want["comm_bytes"]
    assert recs[0]["extra"] == want["extra"]
    assert ("swap_store", None) in recs[1]["out"]["followed"]


@pytest.fixture(scope="module")
def jax_adaptive(lifecycle):
    g, plan, stream = lifecycle["jax"]
    eng = JO.AdaptiveEngine(plan, JO.AdaptiveConfig(**ADAPTIVE_CFG))
    log = []
    for i, q in enumerate(stream):
        if i == EARLY:
            eng.end_epoch()
        r = eng.execute(q)
        log.append((ranks.edges_of(q), ranks.answer(r),
                    int(r.stats.comm_bytes)))
    return {"log": log, "eng": eng,
            "epochs": [dataclasses.asdict(e) for e in eng.epochs],
            "site_edge_ids": [a.tolist() for a in eng.plan.site_edge_ids()]}


def _no_time(epochs):
    # the SPMD engine's response time is measured, not modelled
    return [{k: v for k, v in e.items() if k != "response_time"}
            for e in epochs]


@pytest.mark.parametrize("world", [2, 4])
def test_adaptive_control_plane_on_rank_0(world, groups, jax_adaptive):
    recs = _records(groups, world, "adaptive")
    want = jax_adaptive
    _followers_in_step(recs)
    jeng = want["eng"]
    assert jeng.num_repartitions >= 1
    for r, rec in enumerate(recs):
        assert rec["log"] == want["log"], r
        assert rec["epochs"] == recs[0]["epochs"], r
        assert _no_time(rec["epochs"]) == _no_time(want["epochs"]), r
        assert rec["site_edge_ids"] == want["site_edge_ids"], r
        assert rec["totals"] == (jeng.total_comm_bytes,
                                 jeng.total_moved_bytes,
                                 jeng.num_repartitions), r
        assert rec["extra"] == jeng.stats().extra, r
        assert rec["inner_extra"] == recs[0]["inner_extra"], r
        assert rec["inner_extra"]["store_swaps"] == \
            jeng.engine.stats().extra["store_swaps"], r
        assert rec["store_generation"] == jeng.engine.store_generation, r
    followed = recs[1]["out"]["followed"]
    assert followed[0] == ("end_epoch", None)
    assert [c for c, _e in followed[1:]] == ["execute"] * len(want["log"])
    # one announcement per call, one outcome per epoch, one release
    assert recs[0]["collectives"]["broadcast"] == \
        len(want["log"]) + 1 + len(want["epochs"]) + 1


def _failing_launch(state, edges, where, store_dir):
    """``launch`` of ``lead_failure_rank``: (its error, seconds)."""
    t0 = time.monotonic()
    try:
        launch(ranks.lead_failure_rank, 2, store_dir, backend="gloo",
               args=(state, edges, where), timeout_s=300.0,
               deadline_s=DEADLINE_S)
    except Exception as exc:            # the error is the result
        return exc, time.monotonic() - t0
    return None, time.monotonic() - t0


@pytest.fixture(scope="module")
def failures(jplan, queries, tmp_path_factory):
    """Every failure case launched at once: where -> a future of
    (error, seconds)."""
    state = convert.plan_state_arrays(jplan)
    edges = [ranks.edges_of(q) for q in queries[:4]]
    futs = {where: in_background(_failing_launch, state, edges, where,
                                 tmp_path_factory.mktemp(where))
            for where in FAILURES}
    yield futs
    wait(list(futs.values()))


@pytest.mark.parametrize("where", FAILURES)
def test_a_failure_on_one_rank_ends_the_group(where, failures):
    """Rank 0 raising in its lead block, a follower's engine failing,
    or the leader's engine failing under its door (the follower then
    finds the outcomes differ): the launcher raises long before the
    group's 300 s collective timeout."""
    exc, secs = failures[where].result()
    want = {"leader": "rank 0 fails inside its lead block",
            "follower": "rank 1's engine fails on purpose",
            "diverged": "GroupDivergedError"}[where]
    assert isinstance(exc, RuntimeError) and want in str(exc), exc
    assert secs < 60.0


# ----------------------------------------------------------------------
# In one process: what a session without a group refuses
# ----------------------------------------------------------------------

def test_rank_bodies_import_no_jax():
    """The ranks import ``torch_dist_ranks``: never JAX or the JAX
    package."""
    isolation.test_no_jax_or_reference_import_in_source(
        Path(ranks.__file__))


def test_host_backends_refuse_a_mesh(tplan):  # noqa: F811
    mesh = make_host_mesh(4, device="cpu")
    for backend in ("local", "baseline"):
        with pytest.raises(ValueError, match=repr(backend)):
            T.Session(tplan, backend=backend, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="serve_backend"):
        AdaptiveEngine(tplan, AdaptiveConfig(), device="cpu", mesh=mesh)


def test_lead_and_follow_need_a_group(lifecycle):
    _g, plan, _s = lifecycle["port"]
    for mesh in (None, make_host_mesh(4, device="cpu")):
        sess = T.Session(plan, device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="process group"):
            with sess.lead():
                pass
        with pytest.raises(ValueError, match="process group"):
            sess.follow()
        assert sess._leader is None
    with pytest.raises(ValueError, match="no epochs"):
        sess.end_epoch()
    eng = T.Session(plan, backend="adaptive", device="cpu",
                    mesh=make_host_mesh(4, device="cpu"),
                    adaptive_config=AdaptiveConfig(**ADAPTIVE_CFG))
    assert eng.engine.controls and eng.device == torch.device("cpu")
    assert eng.engine.engine.store.num_sites == 4
    with pytest.raises(ValueError, match="no store"):
        eng.swap_store(plan.site_edge_ids())
    assert eng.end_epoch().epoch == 0


@pytest.mark.parametrize("device,made_current", [
    ("cuda:2", [torch.device("cuda", 2)]), ("cuda", []), ("cpu", [])])
def test_dispatcher_makes_the_engines_card_current(device, made_current,
                                                   monkeypatch):
    """``torch.cuda.current_device()`` is per thread: the door's
    dispatcher makes a numbered card current before its first engine
    call, and leaves a bare ``cuda`` (the current card) or the CPU
    alone.  The engine is a stand-in and the card a device object."""
    from repro_torch.serve import FrontDoor
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)

    class Engine:
        def __init__(self):
            self.device = torch.device(device)
            self.seen = []

        def execute_many(self, queries, batch_size=64):
            self.seen.append(list(calls))
            return [len(q.edges) for q in queries]

    eng = Engine()
    q = T.QueryGraph.make([(-1, -2, 0)])
    with FrontDoor(eng, start=True) as door:
        assert door.submit(q).result(timeout=60) == 1
    assert calls == made_current and eng.seen == [made_current]
