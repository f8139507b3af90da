"""The JAX package's seeded ledger bench ``spmd_comm``
(``benchmarks/paper_benches.py``: the local host engine, the naive and
the planned SPMD engine on one vertical plan) through the port's
``Session`` on the CPU, against the same comparison through the JAX
package's ``Session``: bytes per session and shape, the totals, the
answers and every session's ``stats().extra`` are equal, and the bench's
own properties hold.  ``tests/test_torch_ledger_replication.py`` and
``tests/test_torch_ledger_routing.py`` do the same for
``spmd_replication`` and ``spmd_routing``.

The comparison is ``chip_smoke.ledger_runs``, which the chip smoke runs
on the card; here both packages go through it.
"""
import copy
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from torch_diff import assert_same_ledger  # noqa: E402

BENCHES = ("spmd_comm",)


@pytest.fixture(scope="module")
def reference_runs():
    return chip_smoke.ledger_runs(J, benches=BENCHES)


@pytest.fixture(scope="module")
def port_runs():
    return chip_smoke.ledger_runs(T, benches=BENCHES, device="cpu")


@pytest.mark.parametrize("bench", BENCHES)
def test_ledger_matches_reference(reference_runs, port_runs, bench):
    assert_same_ledger(reference_runs, port_runs, bench,
                       chip_smoke.LEDGER_REFERENCE[bench])


def test_ledger_properties_hold(reference_runs, port_runs):
    assert chip_smoke.ledger_failures(reference_runs) == []
    assert chip_smoke.ledger_failures(port_runs) == []
    planned = port_runs["spmd_comm"]["extra"]["spmd_planned"]
    # the JAX package's 4-device run: 13 gather steps, 9 edge-shipped
    # steps, 2 skipped gathers, 0 retries
    assert [int(planned[k]) for k in ("gather_steps", "edge_shipped_steps",
                                      "skipped_gathers",
                                      "capacity_retries")] == [13, 9, 2, 0]


def test_ledger_failures_reports_a_broken_ledger(port_runs):
    """The checker the chip smoke relies on catches a changed total, a
    planned ledger above the naive one and a retry."""
    runs = copy.deepcopy(port_runs)
    runs["spmd_comm"]["per_shape"]["star"]["spmd_planned"] += 10**6
    runs["spmd_comm"]["extra"]["spmd_planned"]["capacity_retries"] = 1.0
    bad = chip_smoke.ledger_failures(runs)
    assert any("totals" in b for b in bad)
    assert "spmd_comm: planned above naive" in bad
    assert "spmd_comm: capacity retries on the planned session" in bad


def test_compare_ledgers_fails_only_on_queries_without_a_retry(capsys):
    """The smoke's per-query comparison of the card's ledger with the
    plain versions': a difference on a query that retried on neither
    side fails; a retried query that differs is printed, not failed."""
    qs = [J.QueryGraph.make([(-1, -2, p)]) for p in range(3)]
    chip_smoke.compare_ledgers(qs, [10, 20, 30], [0, 1, 0],
                               [10, 25, 30], [0, 1, 0])
    out = capsys.readouterr().out
    assert "2 queries without a retry equal; 1 retried" in out
    assert "1 of them differ, by -5 bytes" in out
    assert "ledger differs: query 1" in out
    with pytest.raises(SystemExit, match="query 2 .* made no retry"):
        chip_smoke.compare_ledgers(qs, [10, 20, 31], [0, 1, 0],
                                   [10, 20, 30], [0, 1, 0])
    with pytest.raises(SystemExit, match="query 0"):
        chip_smoke.compare_ledgers(qs, [10, 20, 30], [0, 0, 0],
                                   [11, 20, 30], [0, 0, 0])
