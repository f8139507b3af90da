"""AdamW over a tree of tensors, computed as the JAX package computes
it: every leaf updated in float32, the new parameter cast back to its
dtype, the moments stored in ``state_dtype`` (float32; bf16 for
100B+ models), weight decay inside the update, the bias corrections
taken from the step after it is incremented.  ``torch.optim.AdamW``
keeps its state in the parameter dtype and rounds differently, so it
is not used.

A tree is what ``repro_torch.tree`` walks: the train step passes the
model's parameters as a dict keyed by their module names.  On a mesh
the leaves are DTensors: each gradient is first brought to its
parameter's placements (a Partial gradient is reduced there once, as
GSPMD reduce-scatters it; left Partial, the global norm and the update
would each reduce it again), the moments take the parameters'
placements, and every update is local to a shard, but for the global
norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: torch.dtype = torch.float32   # bf16 for 100B+ models
    clip_norm: Optional[float] = 1.0


def adamw_init(params: Any, cfg: AdamWConfig) -> Any:
    """Zero moments of ``params``' shapes in ``cfg.state_dtype``, each on
    its parameter's device (a DTensor parameter's moments are DTensors
    on its placements), and an int32 step (on the first leaf's
    device)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p, dtype=cfg.state_dtype,
                                memory_format=torch.contiguous_format)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the per-leaf float32 sums of squares, summed in leaf
    order.  A DTensor leaf's sum reduces across its shards (its local
    sums come out Partial and are all-reduced where they are added), so
    the norm is the whole tree's on every rank."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    gn = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _at_param_placements(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements;
    a plain one as it is."""
    pl = getattr(p, "placements", None)
    if pl is None or tuple(g.placements) == tuple(pl):
        return g
    return g.redistribute(p.device_mesh, pl)


def adamw_update(params: Any, grads: Any, state: Any, cfg: AdamWConfig,
                 lr: Optional[Union[float, torch.Tensor]] = None
                 ) -> Tuple[Any, Any, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm); the inputs are left
    as they are."""
    grads = tree_map(_at_param_placements, params, grads)
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = _global_norm(grads)
    step = state["step"] + 1
    lr_t = cfg.lr if lr is None else lr
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        # the reference's arithmetic, operation for operation; the
        # in-place steps write only this function's own temporaries, so
        # fewer leaf-sized buffers are alive at once
        g32 = g.float()
        m32 = m.float() * cfg.b1
        m32 += g32 * (1 - cfg.b1)
        v32 = v.float() * cfg.b2
        v32 += g32 * g32 * (1 - cfg.b2)
        del g32
        delta = m32 / b1c                               # mh
        delta /= (v32 / b2c).sqrt_().add_(cfg.eps)      # sqrt(vh) + eps
        delta += cfg.weight_decay * p.float()
        newp = (p.float() - delta.mul_(lr_t)).to(p.dtype)
        return newp, m32.to(cfg.state_dtype), v32.to(cfg.state_dtype)

    news = tree_map(upd, params, grads, state["m"], state["v"])

    def part(i: int) -> Any:
        return tree_map(lambda _p, n: n[i], params, news)

    return part(0), {"m": part(1), "v": part(2), "step": step}, gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``: a function of the int step tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr
