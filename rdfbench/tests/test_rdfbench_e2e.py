"""The harness end to end on the CPU, in a process of its own: the
look for a card replaced, a tiny cell run, and no module of JAX or of
the JAX package ``repro`` loaded (top-level names compared whole, since
``repro_torch`` begins with ``repro``)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

DRIVER = """
import json, sys, time
t = time.monotonic()
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
from rdfbench import harness
harness.require_device = lambda chips: "cpu"
bench = Path({bench!r})
rc = harness.main(sys.argv[1:], t_start=t, benchmark=bench / "BENCHMARK.json",
                  bench_dir=bench)
top = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(json.dumps({{"rc": rc, "modules": top}}))
"""


@pytest.mark.parametrize("cell,trace", [("tiny-vertical.closed", 1),
                                        ("tiny-horizontal.open", 0)])
def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_bench, cell,
                                                     trace):
    code = DRIVER.format(root=str(ROOT), src=str(ROOT / "src"),
                         bench=str(tiny_bench))
    proc = subprocess.run(
        [sys.executable, "-c", code, "--workload", cell, "--seed",
         str(2 ** 31 + 77), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    result, tail = json.loads(lines[-2]), json.loads(lines[-1])
    assert tail["rc"] == 0 and result["correct"] is True
    assert "repro_torch" in tail["modules"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tail["modules"])
    assert proc.stderr.strip().splitlines()[-1].startswith("check compared")
