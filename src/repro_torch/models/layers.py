"""Transformer layers: GQA attention (qk-norm, QKV bias, sliding
window, RoPE, causal), the gated SiLU and squared-ReLU MLPs, and top-k
MoE with capacity and optional shared experts.

As in the JAX package, ``*_defs`` gives the parameter definitions and
``*_apply`` is a function of (config, parameters, activations); here the
parameters live on an ``nn.Module`` (``Attention``, ``MLP``, ``MoE``)
whose attributes carry the same names (``p.wq`` for ``p["wq"]``).
Prefill attention goes through the flash kernel
(``kernels.ops.attention``) when ``cfg.use_flash_kernel`` is set;
decode attention over the KV cache is plain tensor code, as it is plain
jnp in the reference.  So are the MoE's routing and expert products:
the reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

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
    if cfg.qkv_bias:
        d["bq"] = ParamDef((Q,), ("heads",), init="zeros", dtype=cfg.dtype)
        d["bk"] = ParamDef((KV,), ("kv_heads",), init="zeros",
                           dtype=cfg.dtype)
        d["bv"] = ParamDef((KV,), ("kv_heads",), init="zeros",
                           dtype=cfg.dtype)
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
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Plain float32 GQA attention: q [B,Sq,H,Dh], k/v [B,Skv,Hkv,Dh],
    mask [Sq, Skv] (True = visible) -> [B,Sq,H*Dh] in q.dtype."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    qh = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(),
                     k.float()) / math.sqrt(Dh)
    s = torch.where(mask[None, None, None], s, -1e30)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", a, v.float())
    return out.reshape(B, Sq, H * Dh).to(q.dtype)


def _sdpa(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
          v: torch.Tensor, q_offset: int = 0,
          kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sq,H,Dh]; k/v: [B,Skv,Hkv,Dh] -> [B,Sq,H*Dh].

    With ``cfg.use_flash_kernel`` a full causal sequence goes through
    ``kernels.ops.attention`` (the CUDA flash kernel for tensors on the
    card, ``cfg.window`` passed on); otherwise, and for decode, plain
    float32 attention with the same causal and window mask.
    """
    B, Sq, H, Dh = q.shape
    Skv = k.shape[1]
    if cfg.use_flash_kernel and Sq == Skv and kv_valid_len is None:
        out = kops.attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True,
                             window=cfg.window)
        return out.transpose(1, 2).reshape(B, Sq, H * Dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset \
        + (Skv - Sq if kv_valid_len is None else 0)
    kpos = torch.arange(Skv, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    if cfg.window is not None:
        mask &= kpos[None, :] > qpos[:, None] - cfg.window
    if kv_valid_len is not None:
        mask &= kpos[None, :] < kv_valid_len
    return _attend(q, k, v, mask)


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
    position of this token.  With a sliding window the cache is a
    rolling buffer of ``min(max_len, window)`` slots: the token goes to
    slot ``pos % Smax`` and attends to every written slot (all of them
    lie within the window), as the reference's
    ``_sdpa_decode_rolling``.  The reference returns an updated copy of
    the cache; here the new key and value are written into ``cache`` in
    place (it is also returned), which saves a copy of the cache per
    layer and step.
    """
    B = x.shape[0]
    Smax = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    slot = pos % Smax if cfg.window is not None else pos
    cache["k"][:, slot:slot + 1] = k.to(cache["k"].dtype)
    cache["v"][:, slot:slot + 1] = v.to(cache["v"].dtype)
    if cfg.window is not None:
        kpos = torch.arange(Smax, device=x.device)
        out = _attend(q, cache["k"], cache["v"],
                      (kpos < min(pos + 1, Smax))[None, :])
    else:
        out = _sdpa(cfg, q, cache["k"], cache["v"], q_offset=pos,
                    kv_valid_len=pos + 1)
    return out @ p.wo, cache


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device,
                  stacked_layers: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """Zeroed {k, v: [(layers,) batch, cap, Hkv, Dh]}, ``cap`` being
    ``min(max_len, window)`` with a sliding window, else ``max_len``
    (``device="meta"`` allocates nothing)."""
    cap = min(max_len, cfg.window) if cfg.window is not None else max_len
    shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
    if stacked_layers is not None:
        shape = (stacked_layers,) + shape
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


# ======================================================================
# MLPs
# ======================================================================

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None
             ) -> Dict[str, ParamDef]:
    """Gated SiLU (w1, w3, w2) or, for ``mlp_act="sq_relu"``, squared
    ReLU without a gate (w1, w2); ``d_ff`` defaults to ``cfg.d_ff``."""
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    d = {"w1": ParamDef((D, Fd), ("embed", "mlp"), dtype=cfg.dtype),
         "w2": ParamDef((Fd, D), ("mlp", "embed"), dtype=cfg.dtype)}
    if cfg.mlp_act == "silu_glu":
        d["w3"] = ParamDef((D, Fd), ("embed", "mlp"), dtype=cfg.dtype)
    return d


class MLP(nn.Module):
    """Parameters of one MLP (``mlp_defs``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 d_ff: Optional[int] = None):
        super().__init__()
        register_params(self, mlp_defs(cfg, d_ff), device)


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "silu_glu":
        h = F.silu(x @ p.w1) * (x @ p.w3)
    else:
        r = F.relu(x @ p.w1)
        h = r * r
    return h @ p.w2


# ======================================================================
# MoE (top-k dispatch with capacity)
# ======================================================================

def moe_defs(cfg: ModelConfig) -> Dict[str, object]:
    """The float32 router (scale 0.1), the experts' [E, D, F] / [E, F, D]
    weights and, with shared experts, one MLP of ``F * num_shared``."""
    D, E = cfg.d_model, cfg.num_experts
    Fe = cfg.effective_moe_ff()
    d: Dict[str, object] = {
        "router": ParamDef((D, E), ("embed", None), dtype=torch.float32,
                           scale=0.1),
        "w1": ParamDef((E, D, Fe), ("experts", "embed", "expert_mlp"),
                       dtype=cfg.dtype),
        "w3": ParamDef((E, D, Fe), ("experts", "embed", "expert_mlp"),
                       dtype=cfg.dtype),
        "w2": ParamDef((E, Fe, D), ("experts", "expert_mlp", "embed"),
                       dtype=cfg.dtype),
    }
    if cfg.num_shared_experts > 0:
        d["shared"] = mlp_defs(cfg, Fe * cfg.num_shared_experts)
    return d


class MoE(nn.Module):
    """Parameters of one MoE layer (``moe_defs``): ``router``, ``w1``,
    ``w3``, ``w2`` and the ``shared`` MLP module."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        defs = moe_defs(cfg)
        shared = defs.pop("shared", None)
        register_params(self, defs, device)
        if shared is not None:
            self.shared = MLP(cfg, device,
                              cfg.effective_moe_ff() * cfg.num_shared_experts)


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(math.ceil(num_tokens * cfg.top_k / max(cfg.num_experts, 1)
                      * cfg.capacity_factor))
    return max(int(math.ceil(c / 8) * 8), 8)  # pad for lane alignment


def _groups(cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, int, bool]:
    """The dispatch groups of ``moe_apply``: (x as [R, T, D], capacity
    per expert and group, whether the aux loss is a mean over groups).

    One group of all B*S tokens (the reference's flat
    ``_moe_route_group``), unless S > 1 and ``moe_shard_map`` or
    ``moe_sharded_ffn`` is set (``_moe_route_batched``: a group per
    sequence, one aux loss over all of them; ``_moe_shard_map`` takes
    that path on one device) or ``moe_grouped_dispatch`` is (a group per
    sequence, the mean of their aux losses).  Decode (S = 1) stays
    flat."""
    B, S, D = x.shape
    if S > 1 and (cfg.moe_shard_map or cfg.moe_sharded_ffn):
        return x, moe_capacity(cfg, S), False
    if S > 1 and cfg.moe_grouped_dispatch:
        return x, moe_capacity(cfg, S), True
    return x.reshape(1, B * S, D), moe_capacity(cfg, B * S), False


def _route(cfg: ModelConfig, p: MoE, x: torch.Tensor,
           expert_perm: Optional[Union[torch.Tensor, Sequence[int]]]):
    """Top-k routing of x [R, T, D]: (probs [R, T, E] float32, expert
    ids [R, T, K], renormalised weights [R, T, K]).  A stable descending
    sort picks the experts, so a tie goes to the lower id, as
    ``jax.lax.top_k`` does."""
    gates = x.float() @ p.router.float()
    if expert_perm is not None:
        gates = gates[..., torch.as_tensor(expert_perm, dtype=torch.long,
                                           device=gates.device)]
    probs = torch.softmax(gates, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    w = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, idx, w


def _slots(idx: torch.Tensor, E: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert loads [R, E] and each assignment's place among its
    expert's [R, T*K], in token order: the reference's stable sort by
    expert, then the position past the expert's first sorted slot.
    Positions at or past the capacity are dropped."""
    e_flat = idx.reshape(idx.shape[0], -1)
    R, N = e_flat.shape
    loads = torch.zeros((R, E), dtype=torch.long, device=idx.device)
    loads.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    order = torch.argsort(e_flat, dim=-1, stable=True)
    start = loads.cumsum(-1) - loads
    pos_sorted = torch.arange(N, device=idx.device) \
        - start.gather(1, e_flat.gather(1, order))
    return loads, torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)


def _aux(probs: torch.Tensor, loads: torch.Tensor, K: int) -> torch.Tensor:
    """Switch-style load-balancing loss per group (probs [R, T, E],
    loads [R, E]): E * sum_e(mean router probability of e * share of
    assignments to e)."""
    me = probs.mean(1)
    ce = loads.float() / (probs.shape[1] * K)
    return (me * ce).sum(-1) * probs.shape[-1]


def moe_routing(cfg: ModelConfig, p: MoE, x: torch.Tensor,
                expert_perm=None) -> Dict[str, object]:
    """What ``moe_apply`` routes for x [B, S, D], per dispatch group
    (``_groups``): the router's ``probs`` [R, T, E], expert ids ``idx``
    [R, T, K], ``keep`` [R, T, K] (False where the expert was full),
    expert ``loads`` [R, E] (before the capacity cut) and
    ``capacity``."""
    xr, C, _ = _groups(cfg, x)
    probs, idx, _w = _route(cfg, p, xr, expert_perm)
    loads, pos = _slots(idx, cfg.num_experts)
    return {"probs": probs, "idx": idx, "keep": (pos < C).reshape(idx.shape),
            "loads": loads, "capacity": C}


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor,
              expert_perm=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss).

    Route top-k, give each (token, expert) assignment its place among
    the expert's in token order, drop those past the capacity, run every
    expert's FFN on its [C, D] slots as one batched product, and add
    each token's K weighted results (summed per token over its K
    assignments, so the result does not depend on the order of atomic
    adds).  ``expert_perm`` (``p[new_id] = old_id``, from
    ``placement.affinity_expert_permutation``) relabels experts at the
    router, so checkpointed expert weights stay put.
    """
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    xr, C, mean_of_groups = _groups(cfg, x)
    R, T, _ = xr.shape
    probs, idx, w = _route(cfg, p, xr, expert_perm)
    loads, pos = _slots(idx, E)
    e_flat = idx.reshape(R, T * K)
    keep = pos < C
    slot = (e_flat * C + pos).clamp(0, E * C - 1)

    # dispatch: kept assignments to their unique slots, dropped ones to
    # a spare row past the end
    dest = torch.where(keep, slot, E * C)
    xa = xr.repeat_interleave(K, dim=1).to(cfg.dtype)      # [R, T*K, D]
    xs = xr.new_zeros((R, E * C + 1, D), dtype=cfg.dtype)
    xs.scatter_(1, dest[..., None].expand(-1, -1, D), xa)
    xe = xs[:, :E * C].reshape(R, E, C, D).transpose(0, 1).reshape(
        E, R * C, D)
    h = F.silu(torch.bmm(xe, p.w1)) * torch.bmm(xe, p.w3)
    ye = torch.bmm(h, p.w2).reshape(E, R, C, D).transpose(0, 1).reshape(
        R, E * C, D)

    # combine
    back = torch.gather(ye, 1, slot[..., None].expand(-1, -1, D))
    back = back * (w.reshape(R, T * K) * keep).to(ye.dtype)[..., None]
    y = back.reshape(R, T, K, D).sum(2).reshape(B, S, D)
    if mean_of_groups:
        aux = _aux(probs, loads, K).mean()
    else:
        aux = _aux(probs.reshape(1, R * T, E), loads.sum(0, keepdim=True),
                   K)[0]
    if cfg.num_shared_experts > 0:
        y = y + mlp_apply(cfg, p.shared, x)
    return y.to(x.dtype), aux
