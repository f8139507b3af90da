"""Architecture and shape records, as in the JAX package's
``configs/base.py`` (without the dry-run's ``input_specs``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ..models import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    skip: bool = False             # e.g. long_500k on full-attention archs
    skip_reason: str = ""


def lm_shapes(long_ok: bool, long_reason: str = "") -> Dict[str, ShapeSpec]:
    return {
        "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
        "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
        "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
        "long_500k": ShapeSpec(
            "long_500k", 524288, 1, "decode", skip=not long_ok,
            skip_reason="" if long_ok else
            (long_reason or "pure full attention: O(seq) KV state at 500k "
             "has no sub-quadratic path")),
    }


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    shapes: Dict[str, ShapeSpec]
    source: str = ""
    notes: str = ""
    # config overrides of the production profile (the plain ``config``
    # stays the baseline)
    optimized: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def shape(self, name: str) -> ShapeSpec:
        return self.shapes[name]

    def optimized_config(self) -> ModelConfig:
        return dataclasses.replace(self.config, **self.optimized) \
            if self.optimized else self.config
