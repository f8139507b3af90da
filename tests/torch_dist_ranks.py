"""Rank bodies of the port's process-group tests
(``tests/test_torch_distributed.py``: every rank makes the same calls;
``tests/test_torch_group_serve.py``: rank 0 leads, the others follow),
run by ``repro_torch.launch.mesh.launch`` on gloo ranks on the CPU.

The ranks are spawned processes that import this module, so it imports
torch, numpy and ``repro_torch`` only: never JAX, the JAX package or a
test module.  Every body returns plain picklable values (answer rows as
sorted tuples, ledgers as ints), for the parent to hold against the JAX
engine and the one-process port engine."""
import dataclasses
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core import PartitionPlan, QueryGraph, RDFGraph, Session
from repro_torch.core.spmd import (COLLECTIVES, SiteStore, SpmdEngine,
                                   make_spmd_matcher, reset_collectives,
                                   spmd_match)
from repro_torch.distributed import ElasticMeshManager
from repro_torch.launch.mesh import SiteMesh, make_host_mesh
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.online import AdaptiveConfig
from repro_torch.serve import FrontDoor, FrontDoorConfig
from repro_torch.serve import batcher as batcher_module


def _mesh(slots):
    torch.set_num_threads(1)
    return make_host_mesh(slots, group=dist.group.WORLD, device="cpu")


def answer(result):
    """(sorted variables, sorted distinct binding tuples)."""
    vs = sorted(result.bindings)
    rows = sorted({tuple(int(result.bindings[v][i]) for v in vs)
                   for i in range(result.num_rows)})
    return vs, rows


def engine_record(engine, queries):
    """Serve ``queries`` with ``execute`` and, per query, the answer,
    the ledger, the sites touched and the final tier replayed (warm
    hints): its capacities and each attempt's decisions, shipped rows
    and final rows.  Then the engine's totals and counters."""
    per_query = []
    for q in queries:
        r = engine.execute(q)
        _out, caps, attempts = engine._run_exact(q.normalize())
        per_query.append({
            "answer": answer(r), "comm_bytes": int(r.stats.comm_bytes),
            "touched": sorted(r.stats.sites_touched), "caps": list(caps),
            "attempts": [(d.tolist(), rows.tolist(), int(n))
                         for d, rows, n in attempts]})
    return per_query, totals(engine)


def totals(engine):
    st = engine.stats()
    return {"comm_bytes": int(st.comm_bytes),
            "result_rows": int(st.result_rows), "extra": dict(st.extra)}


def many_record(engine, queries, batch_size):
    """``execute_many`` over ``queries``: answers and per-query ledger,
    then the engine's totals."""
    got = engine.execute_many(queries, batch_size=batch_size)
    return ([(answer(r), int(r.stats.comm_bytes)) for r in got],
            totals(engine))


def serve_rank(arrays, query_edges, widths, configs, batch_size):
    """One rank serving ``plan_arrays`` output on a mesh of the whole
    group for each slot count in ``widths``, once per (capacity,
    comm_plan, routing) config: ``execute`` on one engine,
    ``execute_many`` on a fresh one; the collective calls of each width.
    Then a hot swap to the same placement on the width's last engine:
    the new store generation, the rebuilt shard's slots and the last
    query's answer on it.  Returns ``{"rank": r, slots: record}``."""
    queries = [QueryGraph.make(e) for e in query_edges]
    out = {"rank": dist.get_rank()}
    for slots in widths:
        mesh = _mesh(slots)
        rec = out[slots] = {"local_slots": list(mesh.local_slots)}
        reset_collectives()
        for cap, comm_plan, routing in configs:
            kw = dict(device="cpu", mesh=mesh, capacity=cap,
                      comm_plan=comm_plan, routing=routing)
            eng = convert.engine_from_arrays(arrays, **kw)
            rec[(cap, comm_plan, routing)] = {
                "execute": engine_record(eng, queries),
                "execute_many": many_record(convert.engine_from_arrays(
                    arrays, **kw), queries, batch_size)}
        rec["collectives"] = dict(COLLECTIVES)
        gen = eng.swap_store(arrays["site_edge_ids"])
        rec["swap"] = (gen, eng.store.slot0, eng.store.num_local,
                       answer(eng.execute(queries[-1])))
    return out


def match_rank(cols, site_ids, pattern_edges, capacity):
    """``spmd_match`` and ``make_spmd_matcher`` over this rank's shard
    of the store (built with the group's mesh); also the shard's place
    on the axis, and what the group refuses: a mesh that does not split
    evenly, a CPU group named for cards, and a whole store handed to a
    matcher of the mesh."""
    mesh = _mesh(len(site_ids))
    graph = RDFGraph(*cols)
    store = SiteStore.build(graph, site_ids, mesh=mesh)
    whole = SiteStore.build(graph, site_ids, device="cpu")
    refused = []
    for what, make in (("uneven", lambda: _mesh(len(site_ids) + 1)),
                       ("backend", lambda: SiteMesh(
                           len(site_ids), (torch.device("cuda", 0),)
                           * mesh.world, dist.group.WORLD)),
                       ("whole store", lambda: spmd_match(
                           whole, QueryGraph.make(pattern_edges[0]),
                           capacity, mesh=mesh))):
        try:
            make()
        except ValueError:
            refused.append(what)
    matches = []
    for edges in pattern_edges:
        q = QueryGraph.make(edges)
        rows, var_order = spmd_match(store, q, capacity, mesh=mesh)
        _b, _v, ovf, dec, shipped = make_spmd_matcher(q, capacity,
                                                      mesh)(store)
        matches.append((rows.tolist(), var_order, ovf.tolist(),
                        dec.tolist(), shipped.tolist()))
    return {"matches": matches,
            "shard": (store.slot0, store.num_local, store.num_sites),
            "slots": list(mesh.local_slots), "refused": refused}


def elastic_rank(cols, site_ids, query_edges, lost, capacity):
    """An engine on the survivors' mesh: the manager over 4 CPU devices
    loses ``lost`` of them, and the group (one rank per survivor) serves
    the re-allocated ``site_ids``."""
    torch.set_num_threads(1)
    mgr = ElasticMeshManager(model_parallel=1,
                             devices=[torch.device("cpu") for _ in range(4)])
    mgr.fail([mgr.live[i] for i in lost])
    mesh = mgr.make_mesh(group=dist.group.WORLD)
    eng = SpmdEngine(RDFGraph(*cols), site_ids, device="cpu", mesh=mesh,
                     capacity=capacity)
    return engine_record(eng, [QueryGraph.make(e) for e in query_edges])


def failing_rank():
    """Rank 1 raises while rank 0 waits in a collective."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return "unreachable"


def stalled_rank():
    """Rank 0 answers, rank 1 never does."""
    if dist.get_rank() == 1:
        time.sleep(600)
    return "answered"


# ----------------------------------------------------------------------
# Rank 0 leads, the other ranks follow (tests/test_torch_group_serve.py)
# ----------------------------------------------------------------------

DOOR_BATCH = 4           # the doors' max_batch
POISON_CAPACITY = (512, 1024)    # the poison part's (start, max) tiers


def edges_of(q):
    return tuple((int(e.src), int(e.dst), int(e.prop)) for e in q.edges)


def engine_log(sess):
    """Every query the session's engine answers, in the engine's order
    (the same on every rank of a group): edges, answer, bytes."""
    log = []
    sess.post_execute_hooks.append(lambda q, r: log.append(
        (edges_of(q), answer(r), int(r.stats.comm_bytes))))
    return log


def led(sess, body):
    """``body(sess)`` inside ``sess.lead()`` on rank 0 of the session's
    group, or on a session without one; the calls followed elsewhere."""
    mesh = sess.mesh
    if mesh is None or mesh.group is None or mesh.rank == 0:
        if mesh is None or mesh.group is None:
            return body(sess)
        with sess.lead():
            return body(sess)
    return {"followed": [(f.call, f.error)
                         for f in sess.follow()]}


def _settled(futs):
    out = []
    for f in futs:
        try:
            out.append(("completed", answer(f.result(timeout=120.0))))
        except Exception as exc:            # the outcome is compared
            out.append((f.outcome, type(exc).__name__))
    return out


def door_manual(queries, reps=2):
    """The queries ``reps`` times through a manual-pump door, drained
    at once: buckets of ``DOOR_BATCH``, then the rest."""
    def body(sess):
        qs = list(queries) * reps
        door = sess.serve(max_batch=DOOR_BATCH, max_delay_ms=1e7,
                          max_queue=len(qs) + 1)
        futs = [door.submit(q, deadline_s=300.0) for q in qs]
        door.close(drain=True)
        return {"futures": _settled(futs), "door": door.stats()}
    return body


def door_threaded(queries):
    """The queries through a door with its dispatcher thread."""
    def body(sess):
        with sess.serve(max_batch=DOOR_BATCH, max_delay_ms=2.0) as door:
            futs = [door.submit(q, deadline_s=300.0) for q in queries]
            out = _settled(futs)
        return {"futures": out, "door": door.stats()}
    return body


def door_poison(mates, poison, later):
    """``mates`` and ``poison`` in one bucket of a door keyed by edge
    count (so that one bucket holds several shapes), drained; then
    ``later`` alone."""
    def body(sess):
        door = sess.serve(max_batch=len(mates) + 2, max_delay_ms=1e7,
                          max_queue=64)
        door.batcher.route_key = None
        with mock.patch.object(batcher_module, "shape_key",
                               lambda q: len(q.edges)):
            futs = [door.submit(q, deadline_s=300.0)
                    for q in mates[:1] + [poison] + mates[1:]]
            door.drain()
            futs.append(door.submit(later, deadline_s=300.0))
            door.close(drain=True)
        return {"futures": _settled(futs), "door": door.stats()}
    return body


def door_swap(queries, replicated):
    """``tests/test_torch_serve.py``'s manual serve and hot swap, the
    swap through ``Session.swap_store`` (announced by its arguments)."""
    def body(sess):
        out = {}
        qs = list(queries) * 2
        door = sess.serve(max_batch=len(qs) + 1, max_delay_ms=10_000.0,
                          max_queue=len(qs) + 1)
        out["route_keyed"] = door.batcher.route_key is not None
        futs = [door.submit(q, deadline_s=300.0) for q in qs]
        door.close(drain=True)
        out["routed"] = [answer(f.result(timeout=5.0)) for f in futs]
        out["buckets"] = len({(batcher_module.shape_key(q),
                               sess.route_key(q)) for q in qs})
        out["shapes"] = len({batcher_module.shape_key(q) for q in qs})
        out["hits"] = sess.stats().extra["batch_shape_hits"]
        sids = sess.plan.site_edge_ids()
        door = FrontDoor(sess, FrontDoorConfig(max_queue=64, max_batch=4),
                         start=False, registry=MetricsRegistry())
        half = len(queries) // 2
        futs = [door.submit(q) for q in queries[:half]]
        door.drain()
        door.request_swap(lambda: sess.swap_store(
            sids[1:] + sids[:1], replicated_props=set(replicated)))
        out["gen_queued"] = sess.engine.store_generation
        futs += [door.submit(q) for q in queries[half:]]
        door.drain()
        out["outcomes"] = [f.outcome for f in futs]
        res = [f.result(0) for f in futs]
        out["swap_answers"] = [answer(r) for r in res]
        out["swap_comm"] = [int(r.stats.comm_bytes) for r in res]
        out["swaps_applied"] = door.swaps_applied
        out["door"] = {k: door.stats()[k] for k in ("failed",
                                                    "batch_fallbacks",
                                                    "completed")}
        return out
    return body


def adaptive_stream(stream, early):
    """The stream through the adaptive session, with a direct
    ``end_epoch()`` after its first ``early`` queries."""
    def body(sess):
        for i, q in enumerate(stream):
            if i == early:
                sess.end_epoch()
            sess.execute(q)
        return {"streamed": len(stream)}
    return body


def session_record(sess, log, out):
    """What every rank reports of a session after a part: its engine
    log, its counters and, for the adaptive backend, its epochs and
    realized placement."""
    st = sess.stats()
    rec = {"out": out, "log": log, "extra": dict(st.extra),
           "comm_bytes": int(st.comm_bytes),
           "store_generation": None}
    eng = sess.engine
    if sess.backend == "adaptive":
        rec["epochs"] = [dataclasses.asdict(e) for e in eng.epochs]
        rec["site_edge_ids"] = [a.tolist() for a in eng.plan.site_edge_ids()]
        rec["inner_extra"] = dict(eng.engine.stats().extra)
        rec["store_generation"] = eng.engine.store_generation
        rec["totals"] = (eng.total_comm_bytes, eng.total_moved_bytes,
                         eng.num_repartitions)
    else:
        rec["store_generation"] = eng.store_generation
    return rec


def run_part(part, spec, mesh, dev="cpu"):
    """One part of ``group_serve_rank`` on ``mesh`` (or, with ``mesh``
    None, in one process): its session, its body led or followed, the
    record."""
    kind, args = spec
    if kind == "adaptive":
        plan_dir, cols, stream_edges, early, cfg = args
        plan = PartitionPlan.load(plan_dir, RDFGraph(*cols))
        sess = Session(plan, backend="adaptive", device=dev, mesh=mesh,
                       adaptive_config=AdaptiveConfig(**cfg),
                       metrics_registry=MetricsRegistry())
        body = adaptive_stream([QueryGraph.make(e) for e in stream_edges],
                               early)
    else:
        state, query_edges, kw = args
        sess = Session(convert.plan_from_state_arrays(state),
                       backend="spmd", device=dev, mesh=mesh,
                       metrics_registry=MetricsRegistry(), **kw)
        qs = [QueryGraph.make(e) for e in query_edges]
        if kind == "door":
            body = door_manual(qs)
        elif kind == "threaded":
            body = door_threaded(qs)
        elif kind == "poison":
            body = door_poison(qs[:-2], qs[-2], qs[-1])
        else:
            body = door_swap(qs, sess.plan.replicated_props)
    log = engine_log(sess)
    reset_collectives()
    out = led(sess, body)
    rec = session_record(sess, log, out)
    rec["collectives"] = dict(COLLECTIVES)
    return rec


def group_serve_rank(parts):
    """Every part of ``parts`` ({name: (kind, args)}) on a 4-slot mesh
    of the whole group, rank 0 leading each part's session."""
    mesh = _mesh(4)
    out = {"rank": dist.get_rank(), "slots": list(mesh.local_slots)}
    for name, spec in parts.items():
        out[name] = run_part(name, spec, mesh)
    return out


def lead_failure_rank(state, query_edges, where):
    """A failure on one rank of a led group: ``"leader"`` raises inside
    its lead block; ``"follower"``'s engine fails on its second call;
    ``"diverged"``: the leader's engine fails on its second call under
    its door, which records the failure and serves on, so that its
    outcome and the follower's differ."""
    mesh = _mesh(4)
    sess = Session(convert.plan_from_state_arrays(state), backend="spmd",
                   device="cpu", mesh=mesh)
    qs = [QueryGraph.make(e) for e in query_edges]
    rank = dist.get_rank()
    calls = {"n": 0}
    run = sess.engine.execute

    def failing(q):
        # after the call's collectives: the group stays in step until
        # the outcomes are compared
        r = run(q)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError(f"rank {rank}'s engine fails on purpose")
        return r

    if (where, rank) in (("follower", 1), ("diverged", 0)):
        sess.engine.execute = failing
    if rank != 0:
        sess.follow()
        return "released"
    with sess.lead():
        if where == "diverged":
            with sess.serve(max_batch=1, max_delay_ms=0.0) as door:
                futs = [door.submit(q) for q in qs]
                _settled(futs)
        else:
            for q in qs:
                sess.execute(q)
            if where == "leader":
                raise ValueError("rank 0 fails inside its lead block")
    return "led"


# ----------------------------------------------------------------------
# The LM substrate on a (2, 2) ("data", "model") DeviceMesh
# (tests/test_torch_sharded_steps.py)
# ----------------------------------------------------------------------

def _full_numpy(t):
    """A DTensor (or plain tensor) gathered whole, as a float32 or int
    numpy array."""
    from repro_torch.models.common import is_dtensor
    t = t.full_tensor() if is_dtensor(t) else t
    t = t.detach()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _local_shapes(named):
    return {k: tuple(v.to_local().shape) for k, v in named.items()}


def _tree_numpy(tree):
    from repro_torch.tree import tree_map
    return tree_map(_full_numpy, tree)


def sharded_case(case, mesh):
    """One model config of ``case`` through the sharded forward, train
    and serve steps (each in ``case["kinds"]``) from the JAX-layout
    weights ``case["params"]``, and through the unsharded serve step
    for the decode state the JAX package carries differently (jamba's
    conv context)."""
    from repro_torch.launch.steps import (make_forward_step,
                                          make_serve_step, make_train_step)
    from repro_torch.models import get_api
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = case["cfg"]
    api = get_api(cfg)
    B, S = case["toks"].shape
    toks = torch.from_numpy(case["toks"])
    out = {}

    def model():
        return convert.lm_params_from_numpy(case["params"], cfg, "cpu")

    if "forward" in case["kinds"]:
        fb = make_forward_step(cfg, mesh=mesh, batch=B, seq=S)
        logits = fb.fn(model(), toks)
        out["forward"] = {"logits": _full_numpy(logits),
                          "local": tuple(logits.to_local().shape)}
    if "train" in case["kinds"]:
        opt = AdamWConfig()
        tb = make_train_step(cfg, opt, batch=B, seq=S,
                             total_steps=case["total_steps"], mesh=mesh)
        m = model()
        state = adamw_init(dict(m.named_parameters()), opt)
        metrics = []
        for x, y in case["batches"]:
            m, state, met = tb.fn(m, state, torch.from_numpy(x),
                                  torch.from_numpy(y))
            metrics.append({k: float(_full_numpy(v)) for k, v in met.items()})
        named = dict(m.named_parameters())
        out["train"] = {
            "metrics": metrics,
            "params": convert._stack_named(
                {k: torch.from_numpy(_full_numpy(v))
                 for k, v in named.items()}, cfg),
            "m": convert._stack_named(
                {k: torch.from_numpy(_full_numpy(v))
                 for k, v in state["m"].items()}, cfg),
            "local": _local_shapes(named),
            "m_local": _local_shapes(state["m"])}
    if "serve" in case["kinds"]:
        L = case["max_len"]
        sb = make_serve_step(cfg, mesh=mesh, batch=B, max_len=L)
        plain = make_serve_step(cfg)
        m, ref = model(), model()
        cache = api.init_cache(cfg, B, L, "cpu")
        ref_cache = api.init_cache(cfg, B, L, "cpu")
        tok = ref_tok = toks[:, 0]
        steps = []
        for pos in range(case["serve_steps"]):
            tok, cache = sb.fn(m, tok, cache, pos)
            ref_tok, ref_cache = plain(ref, ref_tok, ref_cache, pos)
            steps.append((_full_numpy(tok), ref_tok.numpy()))
        from repro_torch.tree import tree_leaves
        out["serve"] = {"tokens": steps, "cache": _tree_numpy(cache),
                        "plain_cache": _tree_numpy(ref_cache),
                        "local": [tuple(t.to_local().shape)
                                  for t in tree_leaves(cache)]}
    return out


def sharded_steps_rank(cases):
    """Every case of ``tests/test_torch_sharded_steps.py`` on this rank
    of a 4-rank gloo group, on its (2, 2) ("data", "model") mesh: rank r
    at mesh coordinate (r // 2, r % 2).  Returns each case's record
    (whole tensors on every rank; local shard shapes of this rank)."""
    import logging
    from repro_torch.launch.mesh import make_grid_mesh
    torch.set_num_threads(1)
    # DTensor logs every two-step Partial reduction it schedules
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    mesh = make_grid_mesh((2, 2), ("data", "model"), device="cpu")
    return {"rank": dist.get_rank(),
            "coord": tuple(int(c) for c in mesh.get_coordinate()),
            "cases": {name: sharded_case(case, mesh)
                      for name, case in cases.items()}}
