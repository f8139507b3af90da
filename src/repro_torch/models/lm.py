"""Decoder-only transformer LM of the dense family (qwen3, qwen2.5,
llama3 shapes without their unported options).

``lm_defs`` gives the JAX package's parameter tree, with the stacked
leading ``layers`` axis (it is what ``convert.lm_params_from_numpy``
reads and what ``param_count`` counts); the module ``LM`` holds the
same parameters with one ``Block`` per layer in a ``ModuleList``, the
reference's ``lax.scan`` over layers becoming a Python loop.

``lm_apply`` and ``lm_decode`` serve under ``torch.no_grad``;
``lm_forward`` is the same forward keeping the autograd graph, each
block wrapped by ``maybe_remat(cfg.remat)``, and ``lm_loss`` trains
through it.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .common import (ModelConfig, ParamDef, init_params, maybe_remat,
                     register_params, rms_norm, softcap)
from .layers import (MLP, Attention, attn_apply, attn_decode, attn_defs,
                     make_kv_cache, mlp_apply, mlp_defs)


def stack_defs(defs: Any, n: int) -> Any:
    """Prepend a stacked 'layers' dim to every ParamDef in the tree."""
    if isinstance(defs, ParamDef):
        return ParamDef((n,) + defs.shape, ("layers",) + defs.axes,
                        defs.init, defs.scale, defs.dtype)
    return {k: stack_defs(v, n) for k, v in defs.items()}


def _norm_def(cfg: ModelConfig) -> ParamDef:
    return ParamDef((cfg.d_model,), ("embed",), init="ones",
                    dtype=torch.float32)


def _top_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, V = cfg.d_model, cfg.vocab_size
    out = {"final_norm": _norm_def(cfg),
           "embed": ParamDef((V, D), ("vocab", "embed"), dtype=cfg.dtype)}
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((D, V), ("embed", "vocab"), dtype=cfg.dtype)
    return out


def lm_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX package's parameter tree (stacked layers)."""
    layer = {"ln1": _norm_def(cfg), "ln2": _norm_def(cfg),
             "attn": attn_defs(cfg), "mlp": mlp_defs(cfg)}
    return {"layers": stack_defs(layer, cfg.num_layers), **_top_defs(cfg)}


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        register_params(self, {"ln1": _norm_def(cfg), "ln2": _norm_def(cfg)},
                        device)
        self.attn = Attention(cfg, device)
        self.mlp = MLP(cfg, device)


class LM(nn.Module):
    """Parameters of the whole model (``lm_apply`` and ``lm_decode``
    run it); ``cfg`` is the config it was built for."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet (ROADMAP "
                f"queue 1 item 5); only 'dense' is")
        self.cfg = cfg
        register_params(self, _top_defs(cfg), device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))


def build_lm(cfg: ModelConfig, device: Union[str, torch.device] = "cuda",
             seed: int = 0) -> LM:
    """The model with weights drawn on ``device`` from
    ``torch.Generator(device).manual_seed(seed)`` (``init_params``).
    Raises without CUDA unless ``device="cpu"`` is asked for."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(LM(cfg, dev), gen)


# ----------------------------------------------------------------------
# Forward (prefill)
# ----------------------------------------------------------------------

def _block(cfg: ModelConfig, p: Block, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = x + attn_apply(cfg, p.attn, rms_norm(x, p.ln1, cfg.norm_eps),
                       positions)
    return x + mlp_apply(cfg, p.mlp, rms_norm(x, p.ln2, cfg.norm_eps))


def _logits(cfg: ModelConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.head
    return softcap(x @ head, cfg.logit_softcap)


@torch.no_grad()
def lm_apply(cfg: ModelConfig, params: LM, inputs: torch.Tensor,
             positions: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs: int tokens [B, S].  Returns (logits [B, S, V], aux_loss);
    the dense family has no auxiliary loss, so it is 0."""
    x = params.embed[inputs.long()]
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    for blk in params.blocks:
        x = _block(cfg, blk, x, positions)
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


def lm_forward(cfg: ModelConfig, params: LM, inputs: torch.Tensor,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lm_apply`` keeping the autograd graph (training): each block
    runs under ``maybe_remat(cfg.remat)``.  Returns (logits [B, S, V],
    aux_loss)."""
    x = F.embedding(inputs.long(), params.embed)
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    for blk in params.blocks:
        x = maybe_remat(functools.partial(_block, cfg, blk),
                        cfg.remat)(x, positions)
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


def lm_loss(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
            targets: torch.Tensor, aux_weight: float = 0.01
            ) -> torch.Tensor:
    """Mean next-token cross-entropy (the log-softmax in float32) plus
    ``aux_weight`` times the auxiliary loss."""
    logits, aux = lm_forward(cfg, params, tokens)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean() + aux_weight * aux


# ----------------------------------------------------------------------
# Decode (serve step)
# ----------------------------------------------------------------------

def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: Union[str, torch.device] = "cuda"
                  ) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache {k, v: [layers, B, max_len, Hkv, Dh]}."""
    return make_kv_cache(cfg, batch, max_len, resolve_device(device),
                         stacked_layers=cfg.num_layers)


@torch.no_grad()
def lm_decode(cfg: ModelConfig, params: LM, token: torch.Tensor,
              cache: Dict[str, torch.Tensor], pos: int
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token: [B] int; pos: the timeline index of this token.  Returns
    (logits [B, V], cache), the cache updated in place."""
    x = params.embed[token.long()][:, None]
    for i, blk in enumerate(params.blocks):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        h, _ = attn_decode(cfg, blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps),
                           layer_cache, pos)
        x = x + h
        x = x + mlp_apply(cfg, blk.mlp, rms_norm(x, blk.ln2, cfg.norm_eps))
    return _logits(cfg, params, x[:, 0]), cache

