"""Model API by family, as in the JAX package's registry.  The dense
and MoE transformers share one API; rwkv and hybrid (jamba) are not
ported yet and raise, naming the ROADMAP entry that covers them.

  defs(cfg)                          -> ParamDef tree (stacked layers)
  build(cfg, device, seed)           -> the parameter module
  apply(cfg, params, inputs)         -> (logits, aux)      [prefill]
  loss(cfg, params, inputs, targets) -> scalar loss        [train]
  init_cache(cfg, batch, max_len, device) -> decode state
  decode(cfg, params, token, cache, pos)  -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from . import lm as _lm
from .common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    defs: Callable
    build: Callable
    apply: Callable
    loss: Callable
    init_cache: Callable
    decode: Callable


_TRANSFORMER = ModelApi(_lm.lm_defs, _lm.build_lm, _lm.lm_apply,
                        _lm.lm_loss, _lm.lm_init_cache, _lm.lm_decode)

_REGISTRY: Dict[str, ModelApi] = {"dense": _TRANSFORMER, "moe": _TRANSFORMER}

def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family not in _REGISTRY:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP "
            f"queue 1, \"The other families\"); have {sorted(_REGISTRY)}")
    return _REGISTRY[cfg.family]
