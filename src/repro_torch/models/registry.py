"""Model API by family, as in the JAX package's registry: the dense and
MoE transformers share one API; rwkv and hybrid (jamba) have their own.

  defs(cfg)                          -> ParamDef tree (stacked layers)
  module(cfg, device)                -> the parameter module, uninitialised
  build(cfg, device, seed)           -> the parameter module, drawn
  apply(cfg, params, inputs)         -> (logits, aux)      [prefill]
  loss(cfg, params, inputs, targets) -> scalar loss        [train]
  init_cache(cfg, batch, max_len, device) -> decode state
  cache_axes(cfg)                    -> logical axes of the decode state
  decode(cfg, params, token, cache, pos)  -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

from . import jamba as _jamba
from . import lm as _lm
from . import rwkv as _rwkv
from .common import ModelConfig, build_model


@dataclasses.dataclass(frozen=True)
class ModelApi:
    defs: Callable
    module: Callable
    build: Callable
    apply: Callable
    loss: Callable
    init_cache: Callable
    cache_axes: Callable
    decode: Callable


_TRANSFORMER = ModelApi(_lm.lm_defs, _lm.LM, _lm.build_lm, _lm.lm_apply,
                        _lm.lm_loss, _lm.lm_init_cache, _lm.lm_cache_axes,
                        _lm.lm_decode)

_REGISTRY: Dict[str, ModelApi] = {
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "rwkv": ModelApi(_rwkv.rwkv_defs, _rwkv.RWKV,
                     functools.partial(build_model, _rwkv.RWKV),
                     _rwkv.rwkv_apply, _rwkv.rwkv_loss,
                     _rwkv.rwkv_init_cache, _rwkv.rwkv_cache_axes,
                     _rwkv.rwkv_decode),
    "hybrid": ModelApi(_jamba.jamba_defs, _jamba.Jamba,
                       functools.partial(build_model, _jamba.Jamba),
                       _jamba.jamba_apply, _jamba.jamba_loss,
                       _jamba.jamba_init_cache, _jamba.jamba_cache_axes,
                       _jamba.jamba_decode),
}


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family not in _REGISTRY:
        raise KeyError(f"unknown model family {cfg.family!r}; "
                       f"have {sorted(_REGISTRY)}")
    return _REGISTRY[cfg.family]
