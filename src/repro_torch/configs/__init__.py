"""Config registry: ``--arch <id>`` resolution for the launchers, the
JAX package's ten archs."""
from __future__ import annotations

from typing import Dict, List

from .base import ArchSpec, ShapeSpec, input_specs, lm_shapes
from .mixtral_8x7b import SPEC as _mixtral
from .qwen2_moe_a2_7b import SPEC as _qwen2moe
from .qwen3_1_7b import SPEC as _qwen3
from .llama3_405b import SPEC as _llama3
from .nemotron_4_15b import SPEC as _nemotron
from .qwen2_5_3b import SPEC as _qwen25
from .musicgen_medium import SPEC as _musicgen
from .pixtral_12b import SPEC as _pixtral
from .rwkv6_1_6b import SPEC as _rwkv6
from .jamba_1_5_large import SPEC as _jamba

ARCHS: Dict[str, ArchSpec] = {
    s.arch_id: s for s in [
        _mixtral, _qwen2moe, _qwen3, _llama3, _nemotron, _qwen25,
        _musicgen, _pixtral, _rwkv6, _jamba,
    ]
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells(include_skipped: bool = False) -> List[tuple]:
    """Every (arch_id, shape_name) cell of the registered archs."""
    out = []
    for aid, spec in ARCHS.items():
        for sname, sh in spec.shapes.items():
            if sh.skip and not include_skipped:
                continue
            out.append((aid, sname))
    return out


__all__ = ["ARCHS", "ArchSpec", "ShapeSpec", "get_arch", "all_cells",
           "input_specs", "lm_shapes"]
