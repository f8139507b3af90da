"""The control: the reference in the program's place, with one of the
configuration's guarantees broken.

The configuration guarantees exact answers: an engine whose binding
tables overflow retries at a larger capacity, up to
``spmd_max_capacity``, or refuses; it never answers truncated.  The
control answers as an engine would that kept its first capacity tier
(``spmd_capacity`` rows) and skipped the retries: the whole graph's
answer, cut to its first ``spmd_capacity`` rows.  So the comparison that
decides ``correct`` has to find it wrong on every answer longer than
that.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import reference


class Truncated:
    """The reference's answers, at most ``rows`` rows each."""

    def __init__(self, index: reference.GraphIndex, rows: int):
        self.index = index
        self.rows = int(rows)

    def answer(self, edges) -> Tuple[List[int], np.ndarray]:
        variables, rows = reference.match(self.index, edges)
        return variables, rows[:self.rows]
