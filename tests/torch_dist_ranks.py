"""Rank bodies of the port's process-group tests
(``tests/test_torch_distributed.py``), run by
``repro_torch.launch.mesh.launch`` on gloo ranks on the CPU.

The ranks are spawned processes that import this module, so it imports
torch, numpy and ``repro_torch`` only: never JAX, the JAX package or a
test module.  Every body returns plain picklable values (answer rows as
sorted tuples, ledgers as ints), for the parent to hold against the JAX
engine and the one-process port engine."""
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core import QueryGraph, RDFGraph
from repro_torch.core.spmd import (COLLECTIVES, SiteStore, SpmdEngine,
                                   make_spmd_matcher, reset_collectives,
                                   spmd_match)
from repro_torch.distributed import ElasticMeshManager
from repro_torch.launch.mesh import SiteMesh, make_host_mesh


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
