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

On a mesh (DTensor parameters and activations, ``launch.steps`` with
``mesh=``) most operations run through DTensor's sharding propagation.
Where an operation has no DTensor strategy, or one that gathers what
GSPMD would keep sharded, the code says what it does instead:

- attention (``_attend``, and the flash kernel in ``_sdpa``) runs on
  each rank's local batch rows and heads (``common.map_local``, torch's
  ``local_map``): DTensor's einsum merges the sharded batch and head
  dimensions and gathers them;
- the head split of q / k / v (``reshape``) gathers when the head
  shards do not divide the heads (llama3-405b's 8 kv heads over 16),
  and ``_attend`` then expands k and v to the query heads;
- the decode cache write (``_write_slot``) is each rank's write into
  its local shard: a slice assignment has no strategy on a sharded
  sequence (``seq_shard_decode``);
- the MoE's routing (the sort, ``scatter_add_`` / ``scatter_``,
  ``gather``, ``repeat_interleave``) runs on the replicated plain
  tokens (``_moe_global``: the global routing and capacity of the
  jitted reference), its expert products on DTensors under the
  reference's constraints; ``moe_shard_map`` runs on each rank's local
  shards with explicit collectives (``_moe_shard_map``, also through
  ``map_local``).
"""
from __future__ import annotations

import functools
import math
import types
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops as kops
from .common import (ModelConfig, ParamDef, SumOverRanks, apply_rope,
                     constrain, current_sharding_ctx, is_dtensor,
                     local_shards, map_local, mesh_sizes, no_constraints,
                     register_params, reshape, rms_norm, shard_index)


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
    q = reshape(q, (B, S, H, Dh))
    k = reshape(k, (B, S, Hkv, Dh))
    v = reshape(v, (B, S, Hkv, Dh))
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Plain float32 GQA attention: q [B,Sq,H,Dh], k/v [B,Skv,Hkv,Dh],
    mask [Sq, Skv] (True = visible) -> [B,Sq,H*Dh] in q.dtype.

    On a mesh (DTensors) it runs on each rank's local batch rows and
    heads (``local_shards``: the heads split on "model" when it divides
    H and Hkv); DTensor's einsum would merge the sharded batch and head
    dimensions into one and gather them.  When the head shards do not
    divide Hkv (llama3-405b: 128 heads over 16 ranks, 8 kv heads) k and
    v are expanded to the H heads first, so the attention stays split
    by head."""
    if not is_dtensor(q):
        return _attend_local(q, k, v, mask)
    from torch.distributed.tensor import Replicate, Shard
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    n = mesh_sizes(q.device_mesh).get("model", 1)
    if Hkv != H and H % n == 0 and Hkv % n:
        # gather a sequence-sharded cache before the expansion, not after
        k, v = (t.redistribute(t.device_mesh, [
            Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
            for pl in t.placements]) for t in (k, v))
        k, v = (reshape(t[:, :, :, None].expand(B, t.shape[1], Hkv,
                                                H // Hkv, Dh),
                        (B, t.shape[1], H, Dh)) for t in (k, v))
        Hkv = H
    return local_shards(lambda *qkv: (_attend_local(*qkv, mask),),
                        (q, k, v), ((0, 2),) * 3, ((0, 2),), batch=B,
                        chans=math.gcd(H, Hkv))[0]


def _attend_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
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
        attend = functools.partial(kops.attention, causal=True,
                                   window=cfg.window)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        out = (_local_heads(attend, qt, kt, vt) if is_dtensor(qt)
               else attend(qt, kt, vt))
        return reshape(out.transpose(1, 2), (B, Sq, H * Dh))
    qpos = torch.arange(Sq, device=q.device) + q_offset \
        + (Skv - Sq if kv_valid_len is None else 0)
    kpos = torch.arange(Skv, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    if cfg.window is not None:
        mask &= kpos[None, :] > qpos[:, None] - cfg.window
    if kv_valid_len is not None:
        mask &= kpos[None, :] < kv_valid_len
    return _attend(q, k, v, mask)


def _local_heads(attend: Callable, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """``attend`` (the flash kernel's wrapper) on each rank's local batch
    rows and heads of DTensors q [B, H, S, Dh], k / v [B, Hkv, S, Dh]
    (``map_local``): the batch keeps q's data sharding, the heads are
    split on "model" when it divides both H and Hkv (each rank then
    holds whole GQA groups) and gathered otherwise.  No collective runs
    inside; the output comes out at the same layout."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    H, Hkv = q.shape[1], k.shape[1]
    lay = []
    for d, pl in enumerate(q.placements):
        n = mesh.shape[d]
        if isinstance(pl, Shard) and pl.dim == 0:
            lay.append(Shard(0))
        elif mesh.mesh_dim_names[d] == "model" and H % n == 0 \
                and Hkv % n == 0:
            lay.append(Shard(1))
        else:
            lay.append(Replicate())
    return map_local(attend, (q, k, v), (lay,) * 3, lay)


def attn_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (prefill)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    return _sdpa(cfg, q, k, v) @ p.wo


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """cache [B, Smax, ...][:, slot] = new [B, 1, ...], in place.  On a
    mesh (a DTensor cache, its sequence possibly sharded on "model")
    each rank writes its local shard, and only the rank whose sequence
    shard holds ``slot``: a slice assignment has no DTensor strategy on
    a sharded dimension, and a ``where`` over the positions gathers the
    whole cache."""
    new = new.to(cache.dtype)
    if not is_dtensor(cache):
        cache[:, slot:slot + 1] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    local = cache.to_local()
    new = new.redistribute(mesh, [
        Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
        for pl in cache.placements]).to_local()
    seq = [d for d, pl in enumerate(cache.placements)
           if isinstance(pl, Shard) and pl.dim == 1]
    at = slot - shard_index(mesh, seq) * local.shape[1]
    if 0 <= at < local.shape[1]:
        local[:, at:at + 1] = new


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
    _write_slot(cache["k"], k, slot)
    _write_slot(cache["v"], v, slot)
    if cfg.window is not None:
        kpos = torch.arange(Smax, device=x.device)
        out = _attend(q, cache["k"], cache["v"],
                      (kpos < min(pos + 1, Smax))[None, :])
    else:
        out = _sdpa(cfg, q, cache["k"], cache["v"], q_offset=pos,
                    kv_valid_len=pos + 1)
    return out @ p.wo, cache


def kv_cache_axes(cfg: ModelConfig, stacked: bool = True):
    """Logical axes for the cache (rules map cache_seq -> model when the
    long-context seq-sharding option is on)."""
    axes = ("batch", "cache_seq", "kv_heads", None)
    if stacked:
        axes = ("layers",) + axes
    return {"k": axes, "v": axes}


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
    """Top-k routing of x [R, T, D] by ``p.router``: (probs [R, T, E]
    float32, expert ids [R, T, K], renormalised weights [R, T, K]).  A
    stable descending sort picks the experts, so a tie goes to the lower
    id, as ``jax.lax.top_k`` does."""
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


def _expert_ffn(cfg: ModelConfig, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor, xs: torch.Tensor, C: int) -> torch.Tensor:
    """Every expert's gated FFN on its slots: xs [R, E*C, D] -> [R, E*C,
    D].  With DTensor weights (a mesh) the replicated slots become a
    DTensor and the products run as the reference's batched [R, E, C, D]
    products (``matmul``: DTensor's ``einsum`` has no backward for a
    sharded R), under its constraints (``layers.py:321-332``: the
    buffers keep "batch" sharded, the intermediate ``expert_mlp``-sharded
    in the model's dtype); the result comes back replicated for the
    combine."""
    R, N, D = xs.shape
    E = w1.shape[0]
    if is_dtensor(w1):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = w1.device_mesh
        xs = constrain(DTensor.from_local(xs, mesh,
                                          [Replicate()] * mesh.ndim,
                                          run_check=False),
                       ("batch", None, None))
        xe = xs.reshape(R, E, C, D)
        h = F.silu(torch.matmul(xe, w1)) * torch.matmul(xe, w3)
        h = constrain(h.to(cfg.dtype), ("batch", None, None, "expert_mlp"))
        ye = torch.matmul(h, w2).to(cfg.dtype)
        return constrain(ye.reshape(R, N, D), ("batch", None, None)
                         ).full_tensor()
    xe = xs.reshape(R, E, C, D).transpose(0, 1).reshape(E, R * C, D)
    h = F.silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3)
    return torch.bmm(h, w2).reshape(E, R, C, D).transpose(0, 1).reshape(
        R, N, D)


def _dispatch(cfg: ModelConfig, p: Any, xr: torch.Tensor, C: int,
              mean_of_groups: bool, expert_perm=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route (``_route``), dispatch, run the experts and combine for the
    groups xr [R, T, D], a plain tensor; ``p`` holds ``router``, ``w1``,
    ``w3`` and ``w2`` (plain tensors, or the experts' DTensors): (y [R,
    T, D], aux loss)."""
    E, K = cfg.num_experts, cfg.top_k
    R, T, D = xr.shape
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
    ye = _expert_ffn(cfg, p.w1, p.w3, p.w2, xs[:, :E * C], C)

    # combine
    back = torch.gather(ye, 1, slot[..., None].expand(-1, -1, D))
    back = back * (w.reshape(R, T * K) * keep).to(ye.dtype)[..., None]
    y = back.reshape(R, T, K, D).sum(2)
    if mean_of_groups:
        aux = _aux(probs, loads, K).mean()
    else:
        aux = _aux(probs.reshape(1, R * T, E), loads.sum(0, keepdim=True),
                   K)[0]
    return y, aux


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (differentiably); a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _moe_global(cfg: ModelConfig, p: MoE, x: torch.Tensor, expert_perm
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply``'s dispatch of a DTensor x with the reference's
    global routing: every rank routes all B*S tokens (the capacity and
    the aux loss those of the whole batch, as the jitted reference
    computes them), the experts run on their weights' shards
    (``_expert_ffn``), and y comes back at x's placements.  The sorts,
    scatters and gathers of the routing have no DTensor strategy, so
    they run on the replicated plain tensors."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    xf = x.full_tensor()
    xr, C, mean_of_groups = _groups(cfg, xf)
    weights = types.SimpleNamespace(router=_full(p.router), w1=p.w1,
                                    w3=p.w3, w2=p.w2)
    y, aux = _dispatch(cfg, weights, xr, C, mean_of_groups, expert_perm)
    rep = [Replicate()] * mesh.ndim
    y = DTensor.from_local(y.reshape(xf.shape), mesh, rep, run_check=False)
    return (y.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                  for pl in x.placements]),
            DTensor.from_local(aux, mesh, rep, run_check=False))


def _moe_shard_map(cfg: ModelConfig, p: MoE, x: torch.Tensor, C: int,
                   expert_perm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Manual-collective MoE (the reference's ``_moe_shard_map``,
    ``layers.py:335-392``): each rank routes its data shard of the batch
    (replicated over "model": identical inputs and a replicated router)
    with the capacity ``C`` of the global shape, runs every expert's FFN
    on its local d_ff shard, combines the partial results, and one
    all-reduce over "model" sums the combined [B, S, D]; the aux loss is
    averaged over the data axes.  Without a "model" or data axis larger
    than 1, or with a batch the data axes do not divide, it is the
    global path, as the reference falls back to ``_moe_route_batched``.

    The local products run under ``map_local``, which gives x a Partial
    gradient over "model", the weights one over the data axes and the
    router one over both."""
    from torch.distributed.tensor import Replicate, Shard
    ctx = current_sharding_ctx()
    if ctx is None:
        return _moe_global(cfg, p, x, expert_perm)
    mesh, _rules = ctx
    sizes = mesh_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    dp = [names.index(a) for a in ("pod", "data") if sizes.get(a, 1) > 1]
    tp = names.index("model") if sizes.get("model", 1) > 1 else None
    ndp = math.prod(mesh.shape[d] for d in dp)
    if (tp is None and not dp) or x.shape[0] % ndp:
        return _moe_global(cfg, p, x, expert_perm)

    def lay(shard_dp, shard_tp):
        return [shard_dp if d in dp and shard_dp is not None else
                shard_tp if d == tp and shard_tp is not None else
                Replicate() for d in range(mesh.ndim)]

    def local_moe(x_loc, router, w1, w3, w2):
        weights = types.SimpleNamespace(router=router, w1=w1, w3=w3, w2=w2)
        with no_constraints():
            y, aux = _dispatch(cfg, weights, x_loc, C, False, expert_perm)
        if tp is not None:
            y = SumOverRanks.apply(y, mesh, (tp,))
            # each "model" rank holds the whole aux: its gradient is
            # shared among them, as the router's Partial gradient sums them
            ntp = mesh.shape[tp]
            aux = aux.detach() + (aux - aux.detach()) / ntp
        if dp:
            aux = SumOverRanks.apply(aux, mesh, tuple(dp)) / ndp
        return y, aux

    return map_local(
        local_moe, (x, p.router, p.w1, p.w3, p.w2),
        (lay(Shard(0), None), lay(None, None), lay(None, Shard(2)),
         lay(None, Shard(2)), lay(None, Shard(1))),
        (lay(Shard(0), None), lay(None, None)))


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

    On a mesh (x a DTensor) ``moe_shard_map`` with S > 1 runs
    ``_moe_shard_map``; every other dispatch routes globally
    (``_moe_global``).
    """
    B, S, D = x.shape
    if is_dtensor(x):
        if cfg.moe_shard_map and S > 1:
            y, aux = _moe_shard_map(cfg, p, x, moe_capacity(cfg, S),
                                    expert_perm)
        else:
            y, aux = _moe_global(cfg, p, x, expert_perm)
    else:
        xr, C, mean_of_groups = _groups(cfg, x)
        y, aux = _dispatch(cfg, p, xr, C, mean_of_groups, expert_perm)
        y = y.reshape(B, S, D)
    if cfg.num_shared_experts > 0:
        y = y + constrain(mlp_apply(cfg, p.shared, x), ("batch", None, None))
    return y.to(x.dtype), aux
