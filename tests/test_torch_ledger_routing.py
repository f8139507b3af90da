"""The JAX package's seeded ledger bench ``spmd_routing`` (the
replicated vertical plan served whole-mesh and routed, both at an
oversized capacity) through the port's ``Session`` on the CPU, against
the same comparison through the JAX package's ``Session``
(``chip_smoke.ledger_runs``): bytes per session and shape, the totals,
the answers and every session's ``stats().extra`` are equal, and the
bench's own properties hold."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from torch_diff import (assert_ledger_checker_catches,  # noqa: E402
                        assert_same_ledger)

BENCH = "spmd_routing"


@pytest.fixture(scope="module")
def reference_runs():
    return chip_smoke.ledger_runs(J, benches=(BENCH,))


@pytest.fixture(scope="module")
def port_runs():
    return chip_smoke.ledger_runs(T, benches=(BENCH,), device="cpu")


def test_ledger_matches_reference(reference_runs, port_runs):
    assert_same_ledger(reference_runs, port_runs, BENCH,
                       chip_smoke.LEDGER_REFERENCE[BENCH])


def test_ledger_properties_hold(reference_runs, port_runs):
    assert chip_smoke.ledger_failures(reference_runs) == []
    assert chip_smoke.ledger_failures(port_runs) == []


def test_ledger_failures_reports_a_broken_ledger(port_runs):
    """The checker the chip smoke relies on catches a changed total, a
    ledger above its baseline on one shape, and one below it on none."""
    assert_ledger_checker_catches(port_runs, BENCH, "spmd_routed",
                                  "spmd_unrouted", chip_smoke.ledger_failures)
