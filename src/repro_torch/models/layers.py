"""Transformer layers of the dense family: GQA attention (qk-norm,
RoPE, causal) and the gated SiLU MLP.

As in the JAX package, ``*_defs`` gives the parameter definitions and
``*_apply`` is a function of (config, parameters, activations); here the
parameters live on an ``nn.Module`` (``Attention``, ``MLP``) whose
attributes carry the same names (``p.wq`` for ``p["wq"]``).  Prefill
attention goes through the flash kernel (``kernels.ops.attention``) when
``cfg.use_flash_kernel`` is set; decode attention over the KV cache is
plain tensor code, as it is plain jnp in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops as kops
from .common import ModelConfig, ParamDef, apply_rope, register_params, rms_norm


# ======================================================================
# Attention
# ======================================================================

def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, Q, KV, Dh = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    d = {
        "wq": ParamDef((D, Q), ("embed", "heads"), dtype=cfg.dtype),
        "wk": ParamDef((D, KV), ("embed", "kv_heads"), dtype=cfg.dtype),
        "wv": ParamDef((D, KV), ("embed", "kv_heads"), dtype=cfg.dtype),
        "wo": ParamDef((Q, D), ("heads", "embed"), dtype=cfg.dtype),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((Dh,), (None,), init="ones",
                               dtype=torch.float32)
        d["k_norm"] = ParamDef((Dh,), (None,), init="ones",
                               dtype=torch.float32)
    return d


class Attention(nn.Module):
    """Parameters of one attention layer (``attn_defs``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        register_params(self, attn_defs(cfg), device)


def _project_qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(B, S, H, Dh)
    k = (x @ p.wk).reshape(B, S, Hkv, Dh)
    v = (x @ p.wv).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
          v: torch.Tensor, q_offset: int = 0,
          kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sq,H,Dh]; k/v: [B,Skv,Hkv,Dh] -> [B,Sq,H*Dh].

    With ``cfg.use_flash_kernel`` a full causal sequence goes through
    ``kernels.ops.attention`` (the CUDA flash kernel for tensors on the
    card); otherwise, and for decode, plain float32 attention.
    """
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if cfg.use_flash_kernel and Sq == Skv and kv_valid_len is None:
        out = kops.attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True)
        return out.transpose(1, 2).reshape(B, Sq, H * Dh)
    g = H // Hkv
    qh = q.reshape(B, Sq, Hkv, g, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(),
                     k.float()) / math.sqrt(Dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset \
        + (Skv - Sq if kv_valid_len is None else 0)
    kpos = torch.arange(Skv, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    if kv_valid_len is not None:
        mask &= kpos[None, :] < kv_valid_len
    s = torch.where(mask[None, None, None], s, -1e30)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", a, v.float())
    return out.reshape(B, Sq, H * Dh).to(q.dtype)


def attn_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (prefill)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    return _sdpa(cfg, q, k, v) @ p.wo


def attn_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode with KV cache.

    x: [B, 1, D]; cache: {k, v: [B, Smax, Hkv, Dh]}; pos: the timeline
    position of this token.  The reference returns an updated copy of
    the cache; here the new key and value are written into ``cache`` in
    place (it is also returned), which saves a copy of the cache per
    layer and step.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    cache["k"][:, pos:pos + 1] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v.to(cache["v"].dtype)
    out = _sdpa(cfg, q, cache["k"], cache["v"], q_offset=pos,
                kv_valid_len=pos + 1)
    return out @ p.wo, cache


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device,
                  stacked_layers: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if stacked_layers is not None:
        shape = (stacked_layers,) + shape
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


# ======================================================================
# MLP
# ======================================================================

def mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamDef((D, Fd), ("embed", "mlp"), dtype=cfg.dtype),
        "w3": ParamDef((D, Fd), ("embed", "mlp"), dtype=cfg.dtype),
        "w2": ParamDef((Fd, D), ("mlp", "embed"), dtype=cfg.dtype),
    }


class MLP(nn.Module):
    """Parameters of one gated SiLU MLP (``mlp_defs``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        register_params(self, mlp_defs(cfg), device)


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.w1) * (x @ p.w3)) @ p.w2
