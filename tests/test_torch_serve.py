"""Differential tests of the port's serving front door
(``repro_torch.serve``) against the JAX package's ``repro.serve``.

* The front door's state machine: ``tests/test_serve.py``'s unit tests
  (fake clock, fake engine, manual pump; the dispatcher thread and the
  load generator on the fake engine) run against both packages.
* Served vs direct: the seeded shape workload through the port's
  ``"spmd"`` ``Session.serve()`` with a real dispatcher thread answers
  as direct ``execute`` does, and as the JAX session's door does.
* Routed buckets and a hot swap, in manual-pump mode so that both
  packages batch alike: route-keyed buckets still coalesce into one
  dispatch per shape; ``request_swap`` of ``swap_store`` applies between
  the same two halves of a stream; the answers, the ledger and every
  engine counter equal the JAX engine's, and the answers equal
  ``match_pattern``'s.
* The CLI: ``python -m repro_torch.serve --smoke --device cpu`` exits 0,
  in one process and on two gloo ranks (``--world 2``: rank 0 leads,
  rank 1 follows).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import test_serve as reference_serve_tests
from generators import answer_set
from repro import serve as jserve
from repro.core import Session as JSession
from repro.core.matching import match_pattern as j_match_pattern
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro_torch import serve as tserve
from repro_torch.core import Session
from repro_torch.obs.metrics import MetricsRegistry
from torch_diff import (port_query, reference_unit_tests,  # noqa: F401
                        rgraph, rplan, rqueries, run_reference_test, tplan)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
@pytest.mark.parametrize("name", reference_unit_tests(reference_serve_tests))
def test_reference_serve_unit_tests(name, package, monkeypatch, tmp_path):
    """``tests/test_serve.py``'s front-door state-machine tests, on the
    JAX package's modules and on the port's."""
    run_reference_test(reference_serve_tests, name, package, monkeypatch,
                       tmp_path)


def _threaded_serve(sess, queries):
    """Direct answers, then the same queries through a running door;
    returns (direct, served, door)."""
    direct = [sess.execute(q) for q in queries]
    with sess.serve(max_batch=4, max_delay_ms=2.0) as door:
        futs = [door.submit(q, deadline_s=300.0) for q in queries]
        served = [f.result(timeout=300.0) for f in futs]
    assert all(f.outcome == "completed" for f in futs)
    return direct, served, door


def _manual_serve_and_swap(sess, serve_mod, queries, plan, registry):
    """Route-keyed buckets drained at once, then a hot swap between two
    halves of the stream, both in manual-pump mode.  Returns what the
    comparison reads."""
    out = {}
    qs = list(queries) * 2
    door = sess.serve(max_batch=len(qs) + 1, max_delay_ms=10_000.0,
                      max_queue=len(qs) + 1)
    out["route_keyed"] = door.batcher.route_key is not None
    futs = [door.submit(q, deadline_s=300.0) for q in qs]
    door.close(drain=True)            # manual mode: drains synchronously
    out["routed"] = [answer_set(f.result(timeout=5.0)) for f in futs]
    out["buckets"] = len({(serve_mod.shape_key(q), sess.route_key(q))
                          for q in qs})
    out["shapes"] = len({serve_mod.shape_key(q) for q in qs})
    out["hits"] = sess.stats().extra["batch_shape_hits"]

    eng = sess.engine
    sids = plan.site_edge_ids()
    door = serve_mod.FrontDoor(sess, serve_mod.FrontDoorConfig(
        max_queue=64, max_batch=4), start=False, registry=registry)
    half = len(queries) // 2
    futs = [door.submit(q) for q in queries[:half]]
    door.drain()
    door.request_swap(lambda: eng.swap_store(
        sids[1:] + sids[:1], replicated_props=set(plan.replicated_props)))
    # queued, not applied: it runs on the dispatch path only
    out["gen_queued"] = eng.store_generation
    futs += [door.submit(q) for q in queries[half:]]
    door.drain()
    assert all(f.outcome == "completed" for f in futs)
    res = [f.result(0) for f in futs]
    out["swap_answers"] = [answer_set(r) for r in res]
    out["swap_comm"] = [r.stats.comm_bytes for r in res]
    out["swaps_applied"] = door.swaps_applied
    out["door"] = {k: door.stats()[k] for k in ("failed", "batch_fallbacks",
                                                "completed")}
    out["gen"] = eng.store_generation
    st = sess.stats()
    out["comm_bytes"], out["extra"] = st.comm_bytes, st.extra
    return out


@pytest.fixture(scope="module")
def reference(rplan, rqueries):
    """The JAX package's side of every comparison, computed once (the
    threaded pass last, on the swapped store: its batching depends on
    timing, so it must not feed the counters compared)."""
    sess = JSession(rplan, backend="spmd")
    manual = _manual_serve_and_swap(sess, jserve, rqueries, rplan,
                                    JRegistry())
    direct, served, _ = _threaded_serve(sess, rqueries)
    return {"direct": [answer_set(r) for r in direct],
            "served": [answer_set(r) for r in served], **manual}


def test_served_answers_match_direct_and_reference(tplan, rqueries,
                                                   reference):
    qs = [port_query(q) for q in rqueries]
    sess = Session(tplan, device="cpu", metrics_registry=MetricsRegistry())
    direct, served, door = _threaded_serve(sess, qs)
    assert door.metrics is sess.metrics and door.engine is sess
    st = door.stats()
    assert st["failed"] == 0 and st["batch_fallbacks"] == 0
    assert st["completed"] == len(qs)
    for i, (a, b) in enumerate(zip(direct, served)):
        assert answer_set(a) == answer_set(b), qs[i].edges
        assert answer_set(b) == reference["served"][i], qs[i].edges
    assert reference["served"] == reference["direct"]


@pytest.fixture(scope="module")
def port_manual(tplan, rqueries):
    return _manual_serve_and_swap(
        Session(tplan, device="cpu", metrics_registry=MetricsRegistry()),
        tserve, [port_query(q) for q in rqueries], tplan, MetricsRegistry())


def test_routed_buckets_batch_exactly_as_reference(port_manual, reference):
    """The bucket key gains the route token, which never splits a
    shape's bucket: one dispatch per shape, every later member a
    ``batch_shape_hits``, equal between the packages."""
    got = port_manual
    assert got["route_keyed"] and reference["route_keyed"]
    assert got["buckets"] == got["shapes"] == reference["buckets"]
    assert got["hits"] == len(got["routed"]) - got["buckets"]
    assert got["hits"] == reference["hits"]
    assert got["routed"] == reference["routed"]


def test_hot_swap_through_the_door_matches_reference(port_manual, reference,
                                                     rgraph, rqueries):
    got = port_manual
    assert got["gen_queued"] == 0 == reference["gen_queued"]
    assert got["swaps_applied"] == reference["swaps_applied"] == 1
    assert got["gen"] == reference["gen"] == 1
    assert got["extra"]["store_swaps"] == 1
    assert got["door"] == reference["door"]
    assert got["door"]["failed"] == got["door"]["batch_fallbacks"] == 0
    assert got["swap_answers"] == reference["swap_answers"]
    assert got["swap_answers"] == [answer_set(j_match_pattern(rgraph, q))
                                   for q in rqueries]
    assert got["swap_comm"] == reference["swap_comm"]
    assert got["comm_bytes"] == reference["comm_bytes"]
    assert got["extra"] == reference["extra"]


def test_session_serve_knobs(tplan):
    sess = Session(tplan, device="cpu", metrics_registry=MetricsRegistry())
    with pytest.raises(ValueError):
        sess.serve(tserve.FrontDoorConfig(), max_queue=4)   # both given
    door = sess.serve(max_queue=4)
    assert door.config.max_queue == 4
    assert door.metrics is sess.metrics and door.tracer is sess.tracer
    assert door.engine is sess and door._thread is None


def _cli_smoke(tmp_path, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    out = tmp_path / "serve_smoke.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--smoke", "--device",
         "cpu", "--triples", "3000", "--duration", "0.2", "--out",
         str(out), *extra], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "smoke OK" in run.stderr
    assert out.exists()
    return run.stderr


def test_cli_smoke_on_the_cpu(tmp_path):
    _cli_smoke(tmp_path)


def test_cli_smoke_on_a_group(tmp_path):
    """``--world 2``: two gloo ranks, each serving 2 of the 4 sites;
    rank 0 runs the gates, rank 1 follows every engine call."""
    err = _cli_smoke(tmp_path, "--world", "2")
    assert "2 ranks, 4 slots" in err
    assert "rank 1: followed" in err and "exit codes [0, 0]" in err
