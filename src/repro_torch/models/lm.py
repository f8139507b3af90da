"""Decoder-only transformer LM of the dense and MoE families (qwen3,
qwen2.5, llama3, nemotron, mixtral, qwen2-moe, and the musicgen and
pixtral backbones, whose frontends are stubs: ``embed_inputs`` takes
[B, S, D] embeddings in place of tokens).

``lm_defs`` gives the JAX package's parameter tree, with the stacked
leading ``layers`` axis (it is what ``convert.lm_params_from_numpy``
reads and what ``param_count`` counts); the module ``LM`` holds the
same parameters with one ``Block`` per layer in a ``ModuleList``, the
reference's ``lax.scan`` over layers becoming a Python loop.

``lm_apply`` and ``lm_decode`` serve under ``torch.no_grad``;
``lm_forward`` is the same forward keeping the autograd graph, each
block wrapped by ``maybe_remat(cfg.remat)``, and ``lm_loss`` trains
through it.  On a mesh the residual stream stays at the activation
layout (``common.residual``: a block's row-parallel contribution is
summed there), the embedding lookup and the loss are explicit per
vocabulary shard (``common.embed_tokens``, ``common.next_token_nll``),
and the layers do what ``layers.py`` says.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from .common import (ModelConfig, ParamDef, build_model, cache_device,
                     embed_tokens, maybe_remat, next_token_nll,
                     register_params, residual, rms_norm, softcap)
from .layers import (MLP, Attention, MoE, attn_apply, attn_decode,
                     attn_defs, kv_cache_axes, make_kv_cache, mlp_apply,
                     mlp_defs, moe_apply, moe_defs)


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
    out = {"final_norm": _norm_def(cfg)}
    if not cfg.embed_inputs:
        out["embed"] = ParamDef((V, D), ("vocab", "embed"), dtype=cfg.dtype)
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((D, V), ("embed", "vocab"), dtype=cfg.dtype)
    return out


def lm_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX package's parameter tree (stacked layers)."""
    layer = {"ln1": _norm_def(cfg), "ln2": _norm_def(cfg),
             "attn": attn_defs(cfg)}
    if cfg.num_experts > 0:
        layer["moe"] = moe_defs(cfg)
    else:
        layer["mlp"] = mlp_defs(cfg)
    return {"layers": stack_defs(layer, cfg.num_layers), **_top_defs(cfg)}


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        register_params(self, {"ln1": _norm_def(cfg), "ln2": _norm_def(cfg)},
                        device)
        self.attn = Attention(cfg, device)
        if cfg.num_experts > 0:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)


class LM(nn.Module):
    """Parameters of the whole model (``lm_apply`` and ``lm_decode``
    run it); ``cfg`` is the config it was built for."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"LM is the dense and MoE transformer; family "
                f"{cfg.family!r} has its own model: get_api(cfg).build")
        self.cfg = cfg
        register_params(self, _top_defs(cfg), device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))


def build_lm(cfg: ModelConfig, device: Union[str, torch.device] = "cuda",
             seed: int = 0) -> LM:
    """The model with weights drawn on ``device`` from ``seed``
    (``build_model``).  Raises without CUDA unless ``device="cpu"`` is
    asked for."""
    return build_model(LM, cfg, device, seed)


# ----------------------------------------------------------------------
# Forward (prefill)
# ----------------------------------------------------------------------

def _ffn(cfg: ModelConfig, p: Block, x: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's MoE or MLP on the normed x: (output, aux loss; 0
    for an MLP)."""
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    if cfg.num_experts > 0:
        return moe_apply(cfg, p.moe, h)
    return mlp_apply(cfg, p.mlp, h), torch.zeros((), device=x.device)


def _block(cfg: ModelConfig, p: Block, x: torch.Tensor,
           positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = residual(x, attn_apply(cfg, p.attn, rms_norm(x, p.ln1, cfg.norm_eps),
                               positions))
    h, aux = _ffn(cfg, p, x)
    return residual(x, h), aux


def _embed(cfg: ModelConfig, params: LM, inputs: torch.Tensor
           ) -> torch.Tensor:
    """Token ids [B, S] through the embedding table, or, with
    ``embed_inputs``, the [B, S, D] embeddings cast to the model's
    dtype."""
    if cfg.embed_inputs:
        return inputs.to(cfg.dtype)
    return embed_tokens(params.embed, inputs)


def _logits(cfg: ModelConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.head
    return softcap(x @ head, cfg.logit_softcap)


@torch.no_grad()
def lm_apply(cfg: ModelConfig, params: LM, inputs: torch.Tensor,
             positions: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs: int tokens [B, S] or embeddings [B, S, D]
    (``embed_inputs``).  Returns (logits [B, S, V], aux_loss): the mean
    of the layers' MoE load-balancing losses, 0 for the dense family."""
    x = _embed(cfg, params, inputs)
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    auxs = []
    for blk in params.blocks:
        x, aux = _block(cfg, blk, x, positions)
        auxs.append(aux)
    return _logits(cfg, params, x), torch.stack(auxs).mean()


def lm_forward(cfg: ModelConfig, params: LM, inputs: torch.Tensor,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lm_apply`` keeping the autograd graph (training): each block
    runs under ``maybe_remat(cfg.remat)``.  Returns (logits [B, S, V],
    aux_loss)."""
    x = _embed(cfg, params, inputs)
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    auxs = []
    for blk in params.blocks:
        x, aux = maybe_remat(functools.partial(_block, cfg, blk),
                             cfg.remat)(x, positions)
        auxs.append(aux)
    return _logits(cfg, params, x), torch.stack(auxs).mean()


def lm_loss(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
            targets: torch.Tensor, aux_weight: float = 0.01
            ) -> torch.Tensor:
    """Mean next-token cross-entropy (the log-softmax in float32) plus
    ``aux_weight`` times the auxiliary loss."""
    logits, aux = lm_forward(cfg, params, tokens)
    return next_token_nll(logits, targets) + aux_weight * aux


# ----------------------------------------------------------------------
# Decode (serve step)
# ----------------------------------------------------------------------

def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: Union[str, torch.device] = "cuda"
                  ) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache {k, v: [layers, B, cap, Hkv, Dh]}: ``cap`` is
    ``max_len``, or ``min(max_len, window)`` with a sliding window (a
    rolling buffer)."""
    return make_kv_cache(cfg, batch, max_len, cache_device(device),
                         stacked_layers=cfg.num_layers)


def lm_cache_axes(cfg: ModelConfig):
    return kv_cache_axes(cfg, stacked=True)


@torch.no_grad()
def lm_decode(cfg: ModelConfig, params: LM, token: torch.Tensor,
              cache: Dict[str, torch.Tensor], pos: int
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token: [B] int (or [B, D] embeddings with ``embed_inputs``); pos:
    the timeline index of this token.  Returns (logits [B, V], cache),
    the cache updated in place."""
    x = _embed(cfg, params, token[:, None])
    for i, blk in enumerate(params.blocks):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        h, _ = attn_decode(cfg, blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps),
                           layer_cache, pos)
        x = residual(x, h)
        x = residual(x, _ffn(cfg, blk, x)[0])
    return _logits(cfg, params, x[:, 0]), cache

