"""RWKV6 (Finch, arXiv:2404.05892): the attention-free LM with
data-dependent per-channel decay, as the JAX package's ``models/rwkv.py``.

The WKV6 recurrence runs in chunked form: a scan inside each chunk
(sequential over its positions, parallel over chunks, batch and heads),
then the propagation of the state across chunks.  Every decay applied
is a product of w in (0, 1), so the chunked form is stable without the
divide trick.  The reference's ``lax.scan``s become Python loops.

The reference's dtype promotion is part of the function: in a bf16
model the token-shift lerps multiply bf16 activations by float32
``mu_*``, which promotes them to float32, so every projection is a
float32 product against its bf16 weight cast up (``_dot``) and
``time_mix`` / ``channel_mix`` return float32.

On a mesh the chunked recurrence and the decode step run on each
rank's local shards of the batch and the heads
(``common.local_shards``): they are independent along both, DTensor
would dispatch each small op of every step on its own, and its
propagation of the step's 5-dimensional products on a 3-axis mesh
searches redistribution paths for minutes.  The token shift, the projections and the
group norm run on DTensors.

Decode state per layer: the WKV state [B, H, N, N] (float32) and the
last token's normed features for the time-mix and channel-mix shifts.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .common import (ModelConfig, ParamDef, cache_device, embed_tokens,
                     is_dtensor, local_shards, maybe_remat, reshape,
                     residual,
                     next_token_nll, register_params, rms_norm, softcap)
from .lm import stack_defs


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------

def rwkv_layer_defs(cfg: ModelConfig) -> Dict[str, Any]:
    D, Fd = cfg.d_model, cfg.d_ff
    N = cfg.rwkv_head_dim
    H = D // N
    lora = 64
    f32 = torch.float32
    return {
        "ln1": ParamDef((D,), ("embed",), init="ones", dtype=f32),
        "ln2": ParamDef((D,), ("embed",), init="ones", dtype=f32),
        "tm": {
            # per-channel lerp coefficients of the r, k, v, w, g shifts
            "mu_r": ParamDef((D,), ("embed",), init="zeros", dtype=f32),
            "mu_k": ParamDef((D,), ("embed",), init="zeros", dtype=f32),
            "mu_v": ParamDef((D,), ("embed",), init="zeros", dtype=f32),
            "mu_w": ParamDef((D,), ("embed",), init="zeros", dtype=f32),
            "mu_g": ParamDef((D,), ("embed",), init="zeros", dtype=f32),
            "wr": ParamDef((D, D), ("embed", "heads"), dtype=cfg.dtype),
            "wk": ParamDef((D, D), ("embed", "heads"), dtype=cfg.dtype),
            "wv": ParamDef((D, D), ("embed", "heads"), dtype=cfg.dtype),
            "wg": ParamDef((D, D), ("embed", "heads"), dtype=cfg.dtype),
            "wo": ParamDef((D, D), ("heads", "embed"), dtype=cfg.dtype),
            # data-dependent decay: w = exp(-exp(w0 + tanh(xw A) B))
            "w0": ParamDef((D,), ("embed",), init="zeros", dtype=f32),
            "wA": ParamDef((D, lora), ("embed", None), dtype=f32, scale=0.1),
            "wB": ParamDef((lora, D), (None, "embed"), dtype=f32, scale=0.1),
            "u": ParamDef((H, N), ("heads", None), init="zeros", dtype=f32),
            "ln_x": ParamDef((D,), ("embed",), init="ones", dtype=f32),
        },
        "cm": {
            "mu_k": ParamDef((D,), ("embed",), init="zeros", dtype=f32),
            "mu_r": ParamDef((D,), ("embed",), init="zeros", dtype=f32),
            "wk": ParamDef((D, Fd), ("embed", "mlp"), dtype=cfg.dtype),
            "wv": ParamDef((Fd, D), ("mlp", "embed"), dtype=cfg.dtype),
            "wr": ParamDef((D, D), ("embed", "heads"), dtype=cfg.dtype),
        },
    }


def _top_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, V = cfg.d_model, cfg.vocab_size
    return {"embed": ParamDef((V, D), ("vocab", "embed"), dtype=cfg.dtype),
            "final_norm": ParamDef((D,), ("embed",), init="ones",
                                   dtype=torch.float32),
            "head": ParamDef((D, V), ("embed", "vocab"), dtype=cfg.dtype)}


def rwkv_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX package's parameter tree (layers stacked on a leading
    axis)."""
    return {"layers": stack_defs(rwkv_layer_defs(cfg), cfg.num_layers),
            **_top_defs(cfg)}


class TimeMix(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        register_params(self, rwkv_layer_defs(cfg)["tm"], device)


class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        register_params(self, rwkv_layer_defs(cfg)["cm"], device)


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        defs = rwkv_layer_defs(cfg)
        register_params(self, {"ln1": defs["ln1"], "ln2": defs["ln2"]},
                        device)
        self.tm = TimeMix(cfg, device)
        self.cm = ChannelMix(cfg, device)


class RWKV(nn.Module):
    """Parameters of the whole model, one ``RWKVBlock`` per layer in
    ``blocks``; ``cfg`` is the config it was built for."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        register_params(self, _top_defs(cfg), device)
        self.blocks = nn.ModuleList(RWKVBlock(cfg, device)
                                    for _ in range(cfg.num_layers))


# ----------------------------------------------------------------------
# WKV6 chunked recurrence
# ----------------------------------------------------------------------

def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: [B, T, H, N] (w in (0, 1)); u: [H, N].  Returns the
    output [B, T, H, N] and the final state [B, H, N, N], float32.

    out_t = r_t S_t + (r_t . (u * k_t)) v_t;  S_{t+1} = diag(w_t) S_t +
    k_t (x) v_t.  When T is not a multiple of the chunk, k and v are
    padded with zeros (nothing enters the state) and w with ones (the
    state is kept); the padded outputs are cut off."""
    B, T, H, N = r.shape
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (T + pad) // C
    shp = (B, nc, C, H, N)
    rc, kc, vc, wc = (a.reshape(shp).float() for a in (r, k, v, w))

    # inside each chunk: a scan over its C positions
    S = rc.new_zeros((B, nc, H, N, N))
    outs = []
    for t in range(C):
        rt, kt, vt, wt = rc[:, :, t], kc[:, :, t], vc[:, :, t], wc[:, :, t]
        out = (rt[..., None, :] @ S)[..., 0, :]
        diag = (rt * u * kt).sum(-1, keepdim=True) * vt
        S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
        outs.append(out + diag)
    out_intra = torch.stack(outs, 2)                     # [B, nc, C, H, N]

    # across chunks: the state entering each chunk, decayed to each
    # position by the product of the w before it in the chunk
    lw = torch.log(wc.clamp(1e-38, 1.0))
    cum_incl = lw.cumsum(2)
    cum_excl = cum_incl - lw
    chunk_decay = torch.exp(cum_incl[:, :, -1])          # [B, nc, H, N]
    r_decayed = rc * torch.exp(cum_excl)                 # factors <= 1
    Sg = rc.new_zeros((B, H, N, N))
    outs = []
    for c in range(nc):
        outs.append(torch.einsum("bthn,bhnm->bthm", r_decayed[:, c], Sg))
        Sg = chunk_decay[:, c][..., None] * Sg + S[:, c]
    out_inter = torch.stack(outs, 1)                     # [B, nc, C, H, N]
    out = (out_intra + out_inter).reshape(B, T + pad, H, N)
    return out[:, :T], Sg


def wkv_step(S: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, w: torch.Tensor, u: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  r, k, v, w: [B, H, N]; S: [B, H, N, N].
    Returns (new state, output [B, H, N])."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    out = (r[..., None, :] @ S)[..., 0, :]
    out = out + (r * u[None] * k).sum(-1, keepdim=True) * v
    S = w[..., None] * S + k[..., None] * v[..., None, :]
    return S, out


# ----------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------

def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype of the two, as ``jnp.matmul``
    computes a float32 activation against a bf16 weight."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: the previous token's features (zeros, or the carried
    ``last`` [B, D] in decode)."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _decay(p: TimeMix, xw: torch.Tensor) -> torch.Tensor:
    z = xw.float()
    lora = torch.tanh(z @ p.wA) @ p.wB
    return torch.exp(-torch.exp(p.w0 + lora))           # (0, 1)


def time_mix(cfg: ModelConfig, p: TimeMix, x: torch.Tensor,
             state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """x: [B, T, D].  state (decode): (S [B, H, N, N], last [B, D]).
    Returns (output [B, T, D] float32, (S, x's last token))."""
    B, T, D = x.shape
    N = cfg.rwkv_head_dim
    H = D // N
    xx = _shift(x, None if state is None else state[1])

    def lerp(mu):
        return x + (xx - x) * mu

    r = _dot(lerp(p.mu_r), p.wr)
    k = _dot(lerp(p.mu_k), p.wk)
    v = _dot(lerp(p.mu_v), p.wv)
    g = F.silu(_dot(lerp(p.mu_g), p.wg))
    w = _decay(p, lerp(p.mu_w))                          # [B, T, D] f32

    r4, k4, v4, w4 = (reshape(a, (B, T, H, N)) for a in (r, k, v, w))
    if state is None and is_dtensor(r4):
        wkv, S_final = local_shards(
            functools.partial(wkv_chunked, chunk=cfg.chunk_size),
            (r4, k4, v4, w4, p.u), ((0, 2),) * 4 + ((None, 0),),
            ((0, 2), (0, 1)), batch=B, chans=H)
    elif state is None:
        wkv, S_final = wkv_chunked(r4, k4, v4, w4, p.u, cfg.chunk_size)
    else:
        step_args = (state[0], r4[:, 0], k4[:, 0], v4[:, 0], w4[:, 0], p.u)
        if is_dtensor(r4):
            S_final, out = local_shards(wkv_step, step_args,
                                        ((0, 1),) * 5 + ((None, 0),),
                                        ((0, 1), (0, 1)), batch=B, chans=H)
        else:
            S_final, out = wkv_step(*step_args)
        wkv = out[:, None]
    # per-head group norm
    mu = wkv.mean(-1, keepdim=True)
    var = wkv.var(-1, keepdim=True, correction=0)
    wkv = (wkv - mu) * torch.rsqrt(var + 64e-5)
    wkv = reshape(wkv, (B, T, D)) * p.ln_x
    out = _dot(wkv.to(x.dtype) * g, p.wo)
    return out, (S_final, x[:, -1])


def channel_mix(cfg: ModelConfig, p: ChannelMix, x: torch.Tensor,
                last: Optional[torch.Tensor] = None):
    """Returns (output [B, T, D] float32, x's last token)."""
    xx = _shift(x, last)
    xk = x + (xx - x) * p.mu_k
    xr = x + (xx - x) * p.mu_r
    kk = torch.square(F.relu(_dot(xk, p.wk)))
    return _dot(kk, p.wv) * torch.sigmoid(_dot(xr, p.wr)), x[:, -1]


# ----------------------------------------------------------------------
# Model
# ----------------------------------------------------------------------

def _block(cfg: ModelConfig, p: RWKVBlock, x: torch.Tensor) -> torch.Tensor:
    h, _ = time_mix(cfg, p.tm, rms_norm(x, p.ln1, cfg.norm_eps))
    x = residual(x, h.to(x.dtype))
    h, _ = channel_mix(cfg, p.cm, rms_norm(x, p.ln2, cfg.norm_eps))
    return residual(x, h.to(x.dtype))


def _logits(cfg: ModelConfig, params: RWKV, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return softcap(x @ params.head, cfg.logit_softcap)


@torch.no_grad()
def rwkv_apply(cfg: ModelConfig, params: RWKV, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] -> (logits [B, T, V], 0): rwkv has no aux loss."""
    x = embed_tokens(params.embed, tokens)
    for blk in params.blocks:
        x = _block(cfg, blk, x)
    return _logits(cfg, params, x), x.new_zeros((), dtype=torch.float32)


def rwkv_forward(cfg: ModelConfig, params: RWKV, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rwkv_apply`` keeping the autograd graph (training): each block
    runs under ``maybe_remat(cfg.remat)``."""
    x = embed_tokens(params.embed, tokens)
    for blk in params.blocks:
        x = maybe_remat(functools.partial(_block, cfg, blk), cfg.remat)(x)
    return _logits(cfg, params, x), x.new_zeros((), dtype=torch.float32)


def rwkv_loss(cfg: ModelConfig, params: RWKV, tokens: torch.Tensor,
              targets: torch.Tensor, aux_weight: float = 0.0
              ) -> torch.Tensor:
    """Mean next-token cross-entropy (the log-softmax in float32)."""
    return next_token_nll(rwkv_forward(cfg, params, tokens)[0], targets)


def rwkv_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """Zeroed decode state {S: [L, B, H, N, N] float32, tm_last,
    cm_last: [L, B, D] in the model's dtype}.  ``max_len`` changes
    nothing: the state is O(1) in the context length."""
    dev = cache_device(device)
    D, N, L = cfg.d_model, cfg.rwkv_head_dim, cfg.num_layers
    H = D // N
    return {"S": torch.zeros((L, batch, H, N, N), dtype=torch.float32,
                             device=dev),
            "tm_last": torch.zeros((L, batch, D), dtype=cfg.dtype,
                                   device=dev),
            "cm_last": torch.zeros((L, batch, D), dtype=cfg.dtype,
                                   device=dev)}


def rwkv_cache_axes(cfg: ModelConfig):
    return {"S": ("layers", "batch", "heads", None, None),
            "tm_last": ("layers", "batch", "embed"),
            "cm_last": ("layers", "batch", "embed")}


@torch.no_grad()
def rwkv_decode(cfg: ModelConfig, params: RWKV, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token: [B] int.  Returns (logits [B, V], cache), the cache
    updated in place."""
    x = embed_tokens(params.embed, token[:, None])      # [B, 1, D]
    for i, blk in enumerate(params.blocks):
        h, (S, tml) = time_mix(cfg, blk.tm,
                               rms_norm(x, blk.ln1, cfg.norm_eps),
                               state=(cache["S"][i], cache["tm_last"][i]))
        x = residual(x, h.to(x.dtype))
        h, cml = channel_mix(cfg, blk.cm, rms_norm(x, blk.ln2, cfg.norm_eps),
                             cache["cm_last"][i])
        x = residual(x, h.to(x.dtype))
        cache["S"][i].copy_(S)
        cache["tm_last"][i].copy_(tml)
        cache["cm_last"][i].copy_(cml)
    return _logits(cfg, params, x[:, 0]), cache
