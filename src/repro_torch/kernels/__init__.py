"""Hand-written CUDA join kernels (``csrc/``), their wrappers
(``ops``) and plain PyTorch versions (``ref``)."""
from .ops import (LAUNCHES, compact_rows, dedup_rows, fused_join,
                  join_count, pair_semijoin, reset_launches)

__all__ = ["LAUNCHES", "compact_rows", "dedup_rows", "fused_join",
           "join_count", "pair_semijoin", "reset_launches"]
