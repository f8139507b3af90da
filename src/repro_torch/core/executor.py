"""Result and cost records shared by the execution backends.

Only the records the SPMD backend needs are ported so far; the exact
host ``DistributedEngine`` (Algorithms 3+4) is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Set

import numpy as np


@dataclasses.dataclass
class CostModel:
    """Cost-model constants for the timing/byte ledger (relative
    numbers: orderings, not absolute cluster wall-clock)."""
    sec_per_edge_scan: float = 2.0e-8      # per fragment edge visited
    sec_per_result_row: float = 5.0e-8     # per binding row produced
    bytes_per_row_col: float = 4.0         # int32 columns
    network_bytes_per_sec: float = 1.0e9   # 1 GB/s cluster links
    network_latency_sec: float = 2.0e-4    # per message
    join_sec_per_row: float = 3.0e-8


@dataclasses.dataclass
class ExecStats:
    response_time: float
    comm_bytes: int
    sites_touched: Set[int]
    per_site_busy: Dict[int, float]
    result_rows: int
    decomposition_size: int


@dataclasses.dataclass
class QueryResult:
    bindings: Dict[int, np.ndarray]
    num_rows: int
    stats: ExecStats
