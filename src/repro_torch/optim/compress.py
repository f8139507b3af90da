"""Error-feedback int8 gradient compression for the data-parallel
all-reduce, as the JAX package writes it.

int8 quantization with per-tensor scales and an error-feedback
residual halves the bytes of a bf16 all-reduce while keeping
convergence (1-bit-Adam-family result).  The hook wraps the gradient
tree between backward and optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..tree import tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    bits: int = 8


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    # torch.round, like jnp.round, rounds half to even
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_gradients(grads: Any, residual: Optional[Any],
                       cfg: CompressionConfig) -> Tuple[Any, Any]:
    """Simulate the compress -> all-reduce -> decompress path with error
    feedback: the quantized tree is what would cross the data axis; the
    residual keeps the quantization error local and re-injects it next
    step.

    Returns (decompressed_grads, new_residual).
    """
    if not cfg.enabled:
        return grads, residual

    if residual is None:
        residual = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                  device=g.device), grads)

    def one(g, r):
        g32 = g.float() + r
        q, scale = _quantize(g32)
        deq = _dequantize(q, scale)
        return deq.to(g.dtype), g32 - deq

    outs = tree_map(one, grads, residual)
    return (tree_map(lambda _g, o: o[0], grads, outs),
            tree_map(lambda _g, o: o[1], grads, outs))
