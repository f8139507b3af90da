"""The comparison that decides ``correct`` fails the control, and fails
a run whose timed path is broken underneath, on the tiny cells on the
CPU.  At the cells' own sizes ``tools/control.py`` reads the control on
the chip."""
import numpy as np
import pytest
import torch

from rdfbench import harness
from rdfbench.tools import control as control_tool


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_control_is_not_correct(tiny_bench, seed):
    cell = harness.load_cell("tiny-vertical.closed",
                             tiny_bench / "BENCHMARK.json", tiny_bench)
    r = control_tool.readings(cell, seed, 1.5, "cpu")
    assert r["program_wrong"] == 0 and r["program_compared"] > 0
    assert r["control_wrong"] > 0
    assert r["swapped_wrong"] > 0


def stale_answers(monkeypatch):
    """A step that returns its state unchanged: the engine answers every
    query of a shape with its first answer to that shape."""
    from repro_torch.core import spmd
    first = {}
    real = spmd.SpmdEngine.execute

    def execute(self, query):
        key = query.normalize().edges
        if key not in first:
            first[key] = real(self, query)
        return first[key]
    monkeypatch.setattr(spmd.SpmdEngine, "execute", execute)


def half_batch(monkeypatch):
    """Half of each batch left out: its requests get the first one's
    answer."""
    from repro_torch.core import spmd
    real = spmd.SpmdEngine.execute_many

    def execute_many(self, queries, batch_size=64):
        kept = real(self, queries[:(len(queries) + 1) // 2], batch_size)
        return kept + [kept[0]] * (len(queries) - len(kept))
    monkeypatch.setattr(spmd.SpmdEngine, "execute_many", execute_many)


def no_exchange(monkeypatch):
    """The exchange between sites left out: every gather returns the
    first site's part and nothing of the others'."""
    from repro_torch.core import spmd

    def all_gather(self, parts):
        return torch.cat([parts[0]] + [torch.zeros_like(p)
                                       for p in parts[1:]], 0)
    monkeypatch.setattr(spmd.SiteAxis, "all_gather", all_gather)


def altered_answer(monkeypatch):
    """An answer altered where it is produced: the last row of every
    non-empty answer dropped."""
    from repro_torch.core import spmd
    real = spmd.SpmdEngine._execute

    def _execute(self, query):
        res = real(self, query)
        if res.num_rows:
            res.bindings = {v: c[:-1] for v, c in res.bindings.items()}
            res.num_rows -= 1
        return res
    monkeypatch.setattr(spmd.SpmdEngine, "_execute", _execute)


def refuse_all(monkeypatch):
    """Every query refused as if it overflowed."""
    from repro_torch.core import spmd

    def _execute(self, query):
        raise RuntimeError("SPMD binding tables still overflow")
    monkeypatch.setattr(spmd.SpmdEngine, "_execute", _execute)


@pytest.mark.parametrize("fault", [stale_answers, half_batch, no_exchange,
                                   altered_answer, refuse_all])
def test_a_broken_timed_path_is_not_correct(tiny_bench, run_cell,
                                            monkeypatch, fault):
    fault(monkeypatch)
    rc, out = run_cell(tiny_bench, "tiny-vertical.closed", seed=31,
                       seconds=1.5)
    assert rc == 0
    assert out["correct"] is False
    assert out["checks"]["wrong_outcomes"]["value"] > 0


def test_the_sound_path_is_correct_on_a_dozen_seeds(tiny_bench, run_cell):
    for seed in range(40, 52):
        rc, out = run_cell(tiny_bench, "tiny-vertical.closed", seed=seed,
                           seconds=0.5)
        assert rc == 0 and out["correct"], seed
        assert out["checks"]["compared"]["value"] > 0
