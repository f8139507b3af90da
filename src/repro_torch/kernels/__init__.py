"""Hand-written CUDA kernels (``csrc/``: the joins and flash
attention), their wrappers (``ops``) and plain PyTorch versions
(``ref``)."""
from .ops import (LAUNCHES, attention, compact_rows, dedup_rows,
                  dedup_rows_masked, fused_join, join_count, join_range,
                  pair_semijoin, reset_launches, semijoin)

__all__ = ["LAUNCHES", "attention", "compact_rows", "dedup_rows",
           "dedup_rows_masked", "fused_join", "join_count", "join_range",
           "pair_semijoin", "reset_launches", "semijoin"]
