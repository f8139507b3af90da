"""Forward (prefill) and serve (decode) steps of the LM substrate.

The JAX package's factories also return shardings and input
shape-structs for ``jit``; the port runs eagerly on one device, so a
step is a plain function of (parameters, inputs).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models import ModelConfig, get_api


def make_forward_step(cfg: ModelConfig) -> Callable:
    """forward(params, inputs [B, S]) -> logits [B, S, V]."""
    api = get_api(cfg)

    def forward(params, inputs: torch.Tensor) -> torch.Tensor:
        logits, _ = api.apply(cfg, params, inputs)
        return logits

    return forward


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, token [B], cache, pos) -> (next_token [B]
    int32, cache): one greedy decode step."""
    api = get_api(cfg)

    def serve_step(params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                   pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, cache = api.decode(cfg, params, token, cache, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
