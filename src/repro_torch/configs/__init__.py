"""Config registry: ``--arch <id>`` resolution for the launchers.  Only
qwen3-1.7b is ported; the JAX package's other architectures wait for
their families (ROADMAP queue 1 item 5)."""
from __future__ import annotations

from typing import Dict

from .base import ArchSpec, ShapeSpec, lm_shapes
from .qwen3_1_7b import SPEC as _qwen3

ARCHS: Dict[str, ArchSpec] = {s.arch_id: s for s in [_qwen3]}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ArchSpec", "ShapeSpec", "get_arch", "lm_shapes"]
