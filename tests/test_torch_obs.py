"""Differential tests of the port's telemetry layer (``repro_torch.obs``
and the engine's wiring of it) against the JAX package's.

The seeded random graph's 4-site vertical plan is served by the JAX
``SpmdEngine`` and the port's, each with an enabled tracer and a fresh
metrics registry, at site-axis widths 1, 2 and 4, starting below one
answer's size so the capacity ladder climbs:

* every root span's ``comm_step`` records are equal field for field
  (``occupancy`` within 1e-12), and so are the root spans' annotations
  apart from the measured time;
* the registries' counters are equal by name, labels and value (the
  summed response time by name and labels only: it is a clock
  reading), and the gauges and histograms by name, labels and value
  or count.

The port alone (``tests/test_obs_spmd.py`` mirrored): the trace<->ledger
delta is 0 per query and in aggregate, the per-decision record counts
equal the counter deltas, one ``final_gather`` per attempted tier,
``route_width`` within [1, m], nothing recorded by a disabled tracer,
and the ledger identical traced and untraced.  The snapshot validates,
and exports round-trip, also across the packages.  Last, the JAX
package's own telemetry unit tests run against both packages.
"""
import json

import pytest

import test_obs as reference_obs_tests
from repro.core import Session as JSession
from repro.launch.mesh import make_host_mesh
from repro.obs import export as jexport
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.trace import Tracer as JTracer
from repro_torch import convert
from repro_torch.core import Session
from repro_torch.obs import export as texport
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from torch_diff import (port_query, reference_unit_tests,  # noqa: F401
                        rgraph, rplan, rqueries, run_reference_test, tplan)

WIDTHS = [1, 2, 4]
DECISION_COUNTERS = {"gather": "gather_steps",
                     "edge_ship": "edge_shipped_steps",
                     "skip": "skipped_gathers",
                     "edge_cached": "edge_cache_hits"}
TIMED_ATTRS = {"response_time"}
TIMED_COUNTERS = {"repro_response_time_seconds_total"}


def _traced_engines(plan, mesh_n, capacity=128):
    jtr, ttr = JTracer(enabled=True, capacity=1024), Tracer(enabled=True,
                                                             capacity=1024)
    jreg, treg = JRegistry(), MetricsRegistry()
    jeng = JSession(plan, backend="spmd", mesh=make_host_mesh(mesh_n),
                    spmd_capacity=capacity, tracer=jtr,
                    metrics_registry=jreg).engine
    teng = convert.engine_from_arrays(
        convert.plan_arrays(plan), device="cpu", num_devices=mesh_n,
        capacity=capacity)
    teng.set_tracer(ttr)
    teng.set_metrics_registry(treg)
    return jeng, teng


def _series(doc, section):
    return {(e["name"], tuple(sorted(e["labels"].items()))): e
            for e in doc[section]}


@pytest.mark.parametrize("mesh_n", WIDTHS)
def test_trace_and_metrics_match_reference(rplan, rqueries, mesh_n):
    jeng, teng = _traced_engines(rplan, mesh_n)
    stream = list(rqueries)
    jeng.execute_many(stream, batch_size=1)
    # the doubled stream in one batch: shape-shared members annotate
    # ``shape_reused`` and carry no records
    jeng.execute_many(stream + stream, batch_size=64)
    teng.execute_many([port_query(q) for q in stream], batch_size=1)
    teng.execute_many([port_query(q) for q in stream + stream],
                      batch_size=64)
    jroots, troots = jeng.tracer.store.spans(), teng.tracer.store.spans()
    assert len(troots) == len(jroots) == 3 * len(stream)
    n_records = 0
    for i, (js, ts) in enumerate(zip(jroots, troots)):
        assert ts.name == js.name == "query"
        assert {k: v for k, v in ts.attrs.items() if k not in TIMED_ATTRS} \
            == {k: v for k, v in js.attrs.items() if k not in TIMED_ATTRS}, i
        assert len(ts.records) == len(js.records), i
        for tr, jr in zip(ts.records, js.records):
            assert tr.keys() == jr.keys()
            assert tr["occupancy"] == pytest.approx(jr["occupancy"],
                                                    abs=1e-12, rel=0)
            assert {k: v for k, v in tr.items() if k != "occupancy"} \
                == {k: v for k, v in jr.items() if k != "occupancy"}
        n_records += len(ts.records)
    assert (n_records > 0) == (mesh_n > 1)
    # one query climbed the capacity ladder: its attempts were compared
    assert any(len(s.attrs["capacity_tiers"]) > 1 for s in troots)

    jdoc = jexport.snapshot(jeng.metrics)
    tdoc = texport.snapshot(teng.metrics)
    jc, tc = _series(jdoc, "counters"), _series(tdoc, "counters")
    assert tc.keys() == jc.keys()
    for key in tc:
        if key[0] not in TIMED_COUNTERS:
            assert tc[key]["value"] == jc[key]["value"], key
    jg, tg = _series(jdoc, "gauges"), _series(tdoc, "gauges")
    assert tg.keys() == jg.keys()
    for key in tg:
        assert tg[key]["value"] == jg[key]["value"], key
    jh, th = _series(jdoc, "histograms"), _series(tdoc, "histograms")
    assert th.keys() == jh.keys()
    for key in th:
        assert th[key]["count"] == jh[key]["count"], key
        assert th[key]["buckets"] == jh[key]["buckets"], key


def _decision_counters(sess):
    extra = sess.stats().extra
    return {k: extra[k] for k in DECISION_COUNTERS.values()}


@pytest.mark.parametrize("mesh_n", WIDTHS)
def test_trace_reconciles_with_ledger(tplan, rqueries, mesh_n):
    """Per query: traced step bytes sum to the ledger delta, and the
    per-decision record counts equal the counter deltas; one final
    gather per attempted tier; every record carries the route width its
    byte formula used."""
    tracer = Tracer(enabled=True, capacity=256)
    sess = Session(tplan, device="cpu", spmd_devices=mesh_n,
                   spmd_capacity=16, tracer=tracer,
                   metrics_registry=MetricsRegistry())
    m = sess.engine.store.num_sites
    total, saw_retry, saw_routed = 0, False, False
    for q in rqueries:
        before_comm = sess.stats().comm_bytes
        before = _decision_counters(sess)
        sess.execute(port_query(q))
        delta = sess.stats().comm_bytes - before_comm
        after = _decision_counters(sess)
        root = tracer.store.spans()[-1]
        assert root.name == "query" and root.attrs["backend"] == "spmd"
        assert root.attrs["devices"] == m
        recs = [r for r in root.records if r["kind"] == "comm_step"]
        assert sum(r["bytes"] for r in recs) - delta == 0
        total += delta
        for decision, counter in DECISION_COUNTERS.items():
            n_rec = sum(1 for r in recs if r["decision"] == decision)
            assert n_rec == after[counter] - before[counter], decision
        tiers = root.attrs["capacity_tiers"]
        assert tiers == sorted(tiers)
        assert root.attrs["capacity_retries"] == len(tiers) - 1
        saw_retry |= len(tiers) > 1
        w = root.attrs["route_width"]
        assert 1 <= w <= m
        assert root.attrs["routed"] == (w < m and m > 1)
        saw_routed |= bool(root.attrs["routed"])
        if m > 1:
            finals = [r for r in recs if r["decision"] == "final_gather"]
            assert len(finals) == len(tiers)
            assert {r["attempt"] for r in recs} == set(range(len(tiers)))
            assert {r["capacity"] for r in recs} == set(tiers)
            for r in recs:
                assert r["route_width"] == w and r["bytes"] >= 0
                assert 0.0 <= r["occupancy"] <= 1.0
        else:
            assert recs == [] and delta == 0
    assert total == sess.stats().comm_bytes
    assert saw_retry
    assert saw_routed == (m > 1)


@pytest.mark.parametrize("mesh_n", WIDTHS)
def test_tracing_changes_nothing_and_disabled_records_nothing(
        tplan, rqueries, mesh_n):
    off = Tracer(enabled=False)
    plain = Session(tplan, device="cpu", spmd_devices=mesh_n,
                    spmd_capacity=16, tracer=off,
                    metrics_registry=MetricsRegistry())
    traced = Session(tplan, device="cpu", spmd_devices=mesh_n,
                     spmd_capacity=16, trace=True,
                     metrics_registry=MetricsRegistry())
    assert traced.tracer.enabled and plain.tracer is off
    qs = [port_query(q) for q in rqueries]
    rows_plain = [plain.execute(q).num_rows for q in qs]
    rows_traced = [traced.execute(q).num_rows for q in qs]
    assert rows_plain == rows_traced
    assert len(off.store) == 0 and off.store.finished_total == 0
    assert traced.tracer.store.finished_total == len(qs)
    sp, st = plain.stats(), traced.stats()
    assert sp.comm_bytes == st.comm_bytes
    assert sp.extra == st.extra


def test_snapshot_validates_and_exports_round_trip(tplan, rqueries,
                                                   tmp_path):
    registry = MetricsRegistry()
    sess = Session(tplan, device="cpu", trace=True,
                   metrics_registry=registry)
    for q in rqueries:
        sess.execute(port_query(q))
    assert sess.metrics is registry
    doc = texport.snapshot(registry, tracer=sess.tracer)
    texport.validate_snapshot(doc, texport.REQUIRED_METRICS)
    assert texport.REQUIRED_METRICS == jexport.REQUIRED_METRICS
    assert texport.REQUIRED_SERVE_METRICS == jexport.REQUIRED_SERVE_METRICS
    assert doc["traces"]["finished_total"] == len(rqueries)
    assert json.loads(json.dumps(doc)) == doc
    # snapshot -> registry -> snapshot is exact, in either package
    assert texport.snapshot(texport.registry_from_snapshot(doc)) \
        == {k: v for k, v in doc.items() if k != "traces"}
    assert jexport.snapshot(jexport.registry_from_snapshot(doc)) \
        == {k: v for k, v in doc.items() if k != "traces"}
    text = texport.to_prom_text(registry)
    assert text == jexport.to_prom_text(jexport.registry_from_snapshot(doc))
    assert 'repro_queries_total{backend="spmd"} %d' % len(rqueries) in text
    path = tmp_path / "spans.jsonl"
    n = texport.dump_spans(sess.tracer, str(path))
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert n == len(lines) == len(rqueries)
    assert [ln["name"] for ln in lines] == ["query"] * len(rqueries)
    assert [ln["records"] for ln in lines] \
        == [s.records for s in sess.tracer.store.spans()]


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
@pytest.mark.parametrize("name", reference_unit_tests(reference_obs_tests))
def test_reference_obs_unit_tests(name, package, monkeypatch, tmp_path):
    """``tests/test_obs.py``'s tracer, metrics and exporter unit tests,
    on the JAX package's modules and on the port's."""
    run_reference_test(reference_obs_tests, name, package, monkeypatch,
                       tmp_path)
