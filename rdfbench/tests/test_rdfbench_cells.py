"""BENCHMARK.json keeps to its contract, cells are made of files found
by name, and the result's line has exactly its keys."""
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from rdfbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def check_spec(spec, root, bench_dir):
    assert set(spec) == KEYS
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert "setup_s" in names
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert (bench_dir / "metrics" / f"{m['name']}.py").is_file()
        for c in m.get("workloads", []):
            assert c in cells
    configs = {c["name"]: c for c in spec["configs"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        cell = harness.load_cell(w["name"], root / "BENCHMARK.json",
                                 bench_dir)
        shown = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in shown and len(shown) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in shown
        if configs:
            assert w["config"] in configs
    for c in configs.values():
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert all(k in cfg for k in c["reduced"])


def test_the_benchmark_keeps_its_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["command"] == ["python3", "rdfbench/run.py"]
    assert spec["paths"] == ["rdfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    check_spec(spec, ROOT, ROOT / "rdfbench")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_tiny_benchmark_keeps_it_too(tiny_bench):
    spec = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    check_spec(spec, tiny_bench, tiny_bench)


def digest(d: Path):
    return {p.relative_to(d): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_adding_files(tiny_bench, run_cell):
    before = digest(tiny_bench)
    spec = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_bench / "configs" / "tiny-vertical.json")
                     .read_text())
    cfg.update(name="tiny-extra", triples_drawn=4000, num_sites=2)
    mix = json.loads((tiny_bench / "traffic" / "tiny-closed64.json")
                     .read_text())
    mix.update(clients=3, class_weights={"S": 6.0})
    (tiny_bench / "configs" / "tiny-extra.json").write_text(json.dumps(cfg))
    (tiny_bench / "traffic" / "tiny-extra.json").write_text(json.dumps(mix))
    (tiny_bench / "metrics" / "probe_rows.py").write_text(
        "def read(run):\n    return float(run.completed)\n")
    spec["workloads"].append({"name": "tiny-extra.extra",
                              "config": "tiny-extra", "traffic": "tiny-extra",
                              "chips": 1, "why": "added as files"})
    spec["per_layer"].append({"name": "probe_rows", "unit": "requests",
                              "better": "higher",
                              "source": "program_counter", "layer": "probe",
                              "moves": "shipped_bytes_per_query",
                              "workloads": ["tiny-extra.extra"]})
    for m in spec["end_to_end"]:
        if m["name"] == "qps":
            m["workloads"].append("tiny-extra.extra")
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, out = run_cell(tiny_bench, "tiny-extra.extra", trace=1)
    assert rc == 0 and out["correct"]
    assert out["metrics"]["probe_rows"]["value"] > 0
    assert "door_batch_size.closed" not in out["metrics"]
    after = digest(tiny_bench)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {Path("BENCHMARK.json")}


@pytest.mark.parametrize("cell,trace", [("tiny-vertical.closed", 0),
                                        ("tiny-horizontal.open", 1)])
def test_the_result_line_has_exactly_its_keys(tiny_bench, run_cell, cell,
                                              trace):
    rc, out = run_cell(tiny_bench, cell, trace=trace)
    assert rc == 0
    want = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        want.append("breakdown")
    assert list(out) == want + ["checks"]
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cellspec = harness.load_cell(cell, tiny_bench / "BENCHMARK.json",
                                 tiny_bench)
    wanted = cellspec.per_layer if trace else cellspec.end_to_end
    on_card = {m["name"] for m in wanted if m["source"] == "device_trace"}
    assert set(out["metrics"]) == {m["name"] for m in wanted} - on_card
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"}


def test_no_card_no_result(tiny_bench, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        harness.main(["--workload", "tiny-vertical.closed", "--seed", "1",
                      "--seconds", "1"], benchmark=tiny_bench /
                     "BENCHMARK.json", bench_dir=tiny_bench)
    assert capsys.readouterr().out == ""


@pytest.mark.card
def test_the_tiny_cell_on_the_card(tiny_bench, run_cell, card):
    rc, out = run_cell(tiny_bench, "tiny-vertical.closed", trace=1,
                       device=card)
    assert rc == 0 and out["correct"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
