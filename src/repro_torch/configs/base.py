"""Architecture and shape records, as in the JAX package's
``configs/base.py``; ``input_specs`` gives every model input of a cell
as a meta tensor (shape and dtype, no storage)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models import ModelConfig, get_api


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


# ----------------------------------------------------------------------

def input_specs(spec: ArchSpec, shape_name: str,
                smoke: bool = False) -> Dict[str, Any]:
    """Meta tensors (``device="meta"``: shape and dtype, nothing
    allocated) for every model input of this cell, with the shapes and
    dtypes of the reference's ``ShapeDtypeStruct`` stand-ins: ``inputs``
    (and ``targets`` for train) for train and prefill; ``token``, the
    decode ``cache`` (capped by a sliding window) and ``pos`` for
    decode."""
    cfg = spec.smoke if smoke else spec.config
    sh = spec.shapes[shape_name]
    B, S = sh.global_batch, sh.seq_len
    if smoke:
        B, S = 2, min(S, 64)
    meta = torch.device("meta")
    if sh.kind in ("train", "prefill"):
        if cfg.embed_inputs:
            ins = {"inputs": torch.empty((B, S, cfg.d_model),
                                         dtype=cfg.dtype, device=meta)}
        else:
            ins = {"inputs": torch.empty((B, S), dtype=torch.int32,
                                         device=meta)}
        if sh.kind == "train":
            ins["targets"] = torch.empty((B, S), dtype=torch.int32,
                                         device=meta)
        return ins
    # decode: one new token against a cache of length seq_len
    tok = (torch.empty((B, cfg.d_model), dtype=cfg.dtype, device=meta)
           if cfg.embed_inputs
           else torch.empty((B,), dtype=torch.int32, device=meta))
    cache = get_api(cfg).init_cache(cfg, B, S, meta)
    return {"token": tok, "cache": cache,
            "pos": torch.empty((), dtype=torch.int32, device=meta)}
