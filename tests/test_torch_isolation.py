"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the card when there is none."""
import ast
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BLOCKED = ("jax", "jaxlib", "repro")

_BLOCKING_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
# the serve CLI is imported like any module: importing it runs nothing
assert "repro_torch.serve.__main__" in names, names
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names), "modules")
"""


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_baseline.py"]


def test_port_imports_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", _BLOCKING_IMPORT % (BLOCKED,)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "modules" in out.stdout


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, (
                f"{path.name}:{node.lineno} imports {name}")


def test_entry_points_default_to_the_card():
    """With no device given every entry point asks for CUDA, and raises
    where there is none instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from repro_torch import convert
    from repro_torch.core import QueryGraph, RDFGraph, SpmdEngine
    from repro_torch.core.spmd import SiteStore
    g = RDFGraph(np.array([0, 1]), np.array([0, 0]), np.array([1, 2]), 3, 1)
    sites = [np.array([0]), np.array([1])]
    with pytest.raises(RuntimeError, match="CUDA"):
        SpmdEngine(g, sites)
    with pytest.raises(RuntimeError, match="CUDA"):
        SiteStore.build(g, sites)
    arrays = {"s": g.s, "p": g.p, "o": g.o, "num_vertices": 3,
              "num_properties": 1, "site_edge_ids": sites,
              "replicated_props": []}
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.engine_from_arrays(arrays)
    q = QueryGraph.make([(-1, -2, 0)])
    assert SpmdEngine(g, sites, device="cpu").execute(q).num_rows == 2

    # the session and its front door: the door serves the session's
    # engine and builds none of its own; the serve CLI asks for CUDA
    from repro_torch.core import PartitionConfig, Session, build_plan
    from repro_torch.core.workload import Workload
    from repro_torch.serve.__main__ import main as serve_main
    plan = build_plan(g, Workload([q]), PartitionConfig(num_sites=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(plan)
    # the host backends keep the device contract too: they compute in
    # numpy on the host, but only where the caller asked for the CPU
    for backend in ("local", "baseline"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Session(plan, backend=backend)
        assert Session(plan, backend=backend,
                       device="cpu").execute(q).num_rows == 2
    sess = Session(plan, device="cpu")
    built = []
    orig_init = SpmdEngine.__init__

    def counting_init(self, *a, **kw):
        built.append(kw.get("device"))
        orig_init(self, *a, **kw)

    with mock.patch.object(SpmdEngine, "__init__", counting_init):
        with sess.serve(max_batch=2) as door:
            assert door.submit(q).result(timeout=60).num_rows == 2
    assert built == [] and door.engine is sess
    assert door.stats()["completed"] == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--smoke"])

    # the LM substrate: building the model, its cache, loading weights,
    # the forward and the serve loop
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_forward_step
    from repro_torch.models import build_lm, get_api
    cfg = get_arch("qwen3-1.7b").smoke
    api = get_api(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_lm(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("qwen3-1.7b")
    model = build_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_params_from_numpy({}, cfg)
    logits = make_forward_step(cfg)(model, torch.zeros((1, 4), dtype=torch.int32))
    assert logits.device.type == "cpu"
    assert serve("qwen3-1.7b", batch=1, prompt_len=2, gen_len=2,
                 device="cpu").tokens.shape == (1, 2)
