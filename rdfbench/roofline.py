"""The join kernels' roofline: peaks, the bytes each call needs, and the
kernels' names in a device trace.

A call's bound time is the bytes its inputs and outputs need, each read
or written once, at the card's memory bandwidth; the join kernels do a
few integer operations per byte and are bound by memory.  The byte
formulas are those of the program's kernel table (``PERF.md``, rows 1
to 4), frozen here; each counts what the call's arguments and returned
counts need, not what an implementation touches:

1. ``join_range(probe, keys)``: probes and keys read, ``lo`` and ``cnt``
   written, 4 bytes each: ``4 (n + T) + 8 n``;
2. ``pair_semijoin_runs``: query pairs and the live table rows read, 8
   bytes a pair, one mask byte written per query and site;
3. ``dedup_rows_masked(bind, valid)``: the (C, V) table read and
   written, its flags read and the keep mask written: ``8 C V + 2 C``;
4. ``fused_join_sites``: the table, its flags and probes, each site's
   live key rows, and for each row a site produces its payload, its
   row of V + 1 columns and its flag, and the m overflow counts:
   ``4 C V + 5 C + 4 sum(live) + sum(r_j) (4 V + 9) + 4 m``; row 4's
   ``m cap`` rows were the ``sum(r_j)`` of a call whose sites were full.

``CountingJoins`` wraps the four names the match loop
(``repro_torch.core.spmd``) imports from ``kernels/ops.py`` and sums
their bytes while it records.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, List, Optional

#: published memory bandwidth by the name ``torch.cuda.get_device_name``
#: gives (NVIDIA's H100 data sheet, SXM part)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

#: the device functions the join kernels launch, by base name
#: (namespace ``rt`` or an anonymous one, arguments dropped):
#: ``csrc/join_count.cu``, ``pair_semijoin.cu``, ``dedup_rows.cu`` and
#: ``fused_join.cu`` (``dedup.cuh``'s insert serves the last two)
JOIN_FUNCTIONS = frozenset({
    "join_range_direct_kernel", "join_range_staged_kernel",
    "gather_samples_kernel", "pair_direct_kernel", "pair_staged_kernel",
    "gather_kernel", "dedup_insert_kernel", "dedup_finish_kernel",
    "scan_kernel", "expand_kernel"})


def base_name(name: str) -> Optional[str]:
    """A device function's name without its arguments and without the
    namespaces the join kernels live in; ``None`` for a name in any
    other namespace (PyTorch's own kernels)."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    n = n.split("(", 1)[0].split("<", 1)[0].strip()
    prefix, _, base = n.rpartition("::")
    return base if prefix in ("", "rt") else None


def is_join_kernel(name: str) -> bool:
    return base_name(name) in JOIN_FUNCTIONS


def join_range_bytes(n: int, t: int) -> int:
    return 4 * (n + t) + 8 * n


def pair_semijoin_bytes(queries: int, table_rows: int, mask: int) -> int:
    return 8 * queries + 8 * table_rows + mask


def dedup_masked_bytes(c: int, v: int) -> int:
    return 8 * c * v + 2 * c


def fused_join_bytes(c: int, v: int, live: List[int],
                     produced: List[int]) -> int:
    return (4 * c * v + 5 * c + 4 * sum(live)
            + sum(produced) * (4 * v + 9) + 4 * len(live))


class CountingJoins:
    """Sums the bytes of the match loop's join calls while ``recording``
    is set (the traced window's profiled part).  ``bytes()`` reads the
    counts the calls returned on the device, so call it after the work
    ends."""

    NAMES = ("join_range", "pair_semijoin_runs", "dedup_rows_masked",
             "fused_join_sites")

    def __init__(self) -> None:
        self.recording = False
        self.calls = 0
        self._fixed = 0
        self._pending: List = []     # (C, V, live, produced rows tensor)

    def _join_range(self, fn, probe, keys):
        out = fn(probe, keys)
        if self.recording:
            self.calls += 1
            self._fixed += join_range_bytes(probe.numel(), keys.numel())
        return out

    def _pair(self, fn, q_s, q_o, t_s, t_o, runs=1, windows=None):
        out = fn(q_s, q_o, t_s, t_o, runs, windows)
        if self.recording:
            self.calls += 1
            rows = sum(windows.lives) if windows is not None \
                else t_s.numel()
            self._fixed += pair_semijoin_bytes(q_s.numel(), rows,
                                               out.numel())
        return out

    def _dedup(self, fn, bind, valid):
        out = fn(bind, valid)
        if self.recording:
            self.calls += 1
            self._fixed += dedup_masked_bytes(*bind.shape)
        return out

    def _fused(self, fn, bind, valid, probe, keys, payload, capacity,
               windows=None):
        out = fn(bind, valid, probe, keys, payload, capacity, windows)
        if self.recording:
            self.calls += 1
            live = list(windows.lives) if windows is not None \
                else [keys.shape[1]] * keys.shape[0]
            self._pending.append((bind.shape[0], bind.shape[1], live,
                                  out[2].sum(1)))
        return out

    def bytes(self) -> int:
        """Bytes of every recorded call."""
        total = self._fixed
        for c, v, live, produced in self._pending:
            total += fused_join_bytes(c, v, live,
                                      [int(x) for x in produced.tolist()])
        return total

    @contextlib.contextmanager
    def installed(self, module) -> Iterator["CountingJoins"]:
        """Wrap the four names in ``module`` (the match loop's module)
        for the block."""
        saved: Dict[str, object] = {n: getattr(module, n)
                                    for n in self.NAMES}
        wraps = {"join_range": self._join_range,
                 "pair_semijoin_runs": self._pair,
                 "dedup_rows_masked": self._dedup,
                 "fused_join_sites": self._fused}
        for n, w in wraps.items():
            setattr(module, n, functools.partial(w, saved[n]))
        try:
            yield self
        finally:
            for n, f in saved.items():
                setattr(module, n, f)
