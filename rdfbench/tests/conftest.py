"""Shared set-up of the benchmark's tests: the checkout's root and
``src`` on the path, the ``card`` marker, and a copy of the tiny test
cells (``data/``) with the real metric readers, run on the CPU."""
import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """The card's device name, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def tiny_bench(tmp_path):
    """A benchmark directory of the tiny cells: their configurations,
    mixes and BENCHMARK.json from ``data/``, the real readers."""
    bench = tmp_path / "bench"
    shutil.copytree(DATA / "configs", bench / "configs")
    shutil.copytree(DATA / "traffic", bench / "traffic")
    shutil.copytree(ROOT / "rdfbench" / "metrics", bench / "metrics")
    shutil.copy(DATA / "BENCHMARK.json", bench / "BENCHMARK.json")
    return bench


def _run_cell(bench: Path, cell: str, seed: int = 5, seconds: float = 2.0,
              trace: int = 0, device: str = "cpu"):
    """(exit code, the result's line as a dict or None) of one harness
    run in this process, with the look for a card replaced by
    ``device``."""
    from rdfbench import harness
    out = io.StringIO()
    saved = harness.require_device
    harness.require_device = lambda chips: device
    try:
        with contextlib.redirect_stdout(out):
            rc = harness.main(["--workload", cell, "--seed", str(seed),
                               "--seconds", str(seconds), "--trace",
                               str(trace)],
                              benchmark=bench / "BENCHMARK.json",
                              bench_dir=bench)
    finally:
        harness.require_device = saved
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture
def run_cell():
    """``_run_cell``: one harness run in this process."""
    return _run_cell
