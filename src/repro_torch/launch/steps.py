"""Train, forward (prefill) and serve (decode) steps of the LM
substrate.

The JAX package's factories also return shardings and input
shape-structs for ``jit``; the port runs eagerly on one device, so a
step is a plain function of (parameters, inputs).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..models import ModelConfig, get_api
from ..optim import (AdamWConfig, CompressionConfig, adamw_update,
                     compress_gradients, cosine_schedule)


def make_train_step(cfg: ModelConfig, opt: Optional[AdamWConfig] = None,
                    compression: Optional[CompressionConfig] = None,
                    batch: int = 8, seq: int = 128,
                    total_steps: int = 10000) -> Callable:
    """train_step(params, opt_state, inputs [batch, seq], targets) ->
    (params, opt_state, {"loss", "grad_norm", "lr"}).

    ``params`` is the model (``get_api(cfg).build``); the gradients and
    the AdamW state (``adamw_init`` of ``dict(params.named_parameters())``)
    are keyed by its parameter names.  The loss's gradients go through
    ``compress_gradients`` (a no-op unless enabled) and ``adamw_update``
    at the cosine schedule's lr of the step *before* the update (warmup
    ``min(1000, total_steps // 10)``); the new weights are written into
    ``params`` and it is returned with the new state.  The metrics are
    0-dim tensors on the parameters' device."""
    api = get_api(cfg)
    opt = opt or AdamWConfig()
    compression = compression or CompressionConfig()
    lr_fn = cosine_schedule(opt.lr, warmup=min(1000, total_steps // 10),
                            total=total_steps)

    def train_step(params: nn.Module, opt_state: Dict[str, Any],
                   inputs: torch.Tensor, targets: torch.Tensor
                   ) -> Tuple[nn.Module, Dict[str, Any],
                              Dict[str, torch.Tensor]]:
        if tuple(inputs.shape) != (batch, seq) \
                or tuple(targets.shape) != (batch, seq):
            raise ValueError(f"train_step: expected inputs and targets of "
                             f"shape {(batch, seq)}, got "
                             f"{tuple(inputs.shape)}, {tuple(targets.shape)}")
        named = dict(params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        loss = api.loss(cfg, params, inputs, targets)
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        grads, _ = compress_gradients(grads, None, compression)
        lr = lr_fn(opt_state["step"])
        new, new_state, gnorm = adamw_update(named, grads, opt_state, opt,
                                             lr)
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(new[name])
        return params, new_state, {"loss": loss.detach(), "grad_norm": gnorm,
                                   "lr": lr}

    return train_step


def make_forward_step(cfg: ModelConfig) -> Callable:
    """forward(params, inputs) -> logits [B, S, V]; inputs are token
    ids [B, S], or embeddings [B, S, D] for an ``embed_inputs`` arch."""
    api = get_api(cfg)

    def forward(params, inputs: torch.Tensor) -> torch.Tensor:
        logits, _ = api.apply(cfg, params, inputs)
        return logits

    return forward


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, token, cache, pos) -> (next_token [B] int32,
    cache): one greedy decode step; ``token`` is [B] ids, or [B, D]
    embeddings for an ``embed_inputs`` arch."""
    api = get_api(cfg)

    def serve_step(params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                   pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, cache = api.decode(cfg, params, token, cache, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
