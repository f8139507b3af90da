"""Jamba-1.5-style hybrid (arXiv:2403.19887): mamba and attention at a
1:7 ratio, an MoE FFN on every other layer, as the JAX package's
``models/jamba.py``.

One super-block of ``attn_every`` layers (8 for jamba) runs attention
with a dense FFN, then ``attn_every // moe_every`` mamba + MoE
sublayers, then the rest as mamba + dense-FFN sublayers.  The counts
match the published interleave (9 attention, 63 mamba, 36 MoE and 36
dense layers at 72), the order within a block is the reference's
regrouping, not the published one.  The reference's scans over blocks
and sublayers become Python loops over ``blocks`` and each block's
``moe_layers`` and ``dense_layers``.  On a mesh the residual stream
stays at the activation layout (``common.residual``) and the layers do
what ``layers.py`` and ``ssm.py`` say.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from .common import (ModelConfig, ParamDef, cache_device, embed_tokens,
                     maybe_remat, next_token_nll, register_params, residual,
                     rms_norm, softcap)
from .layers import (MLP, Attention, MoE, attn_apply, attn_decode,
                     attn_defs, kv_cache_axes, make_kv_cache, mlp_apply,
                     mlp_defs, moe_apply, moe_defs)
from .lm import _norm_def, stack_defs
from .ssm import Mamba, mamba_apply, mamba_defs, mamba_state


def _n_blocks(cfg: ModelConfig) -> int:
    if cfg.num_layers % cfg.attn_every != 0:
        raise ValueError(f"num_layers ({cfg.num_layers}) must be a multiple "
                         f"of attn_every ({cfg.attn_every})")
    return cfg.num_layers // cfg.attn_every


def _moe_per_block(cfg: ModelConfig) -> int:
    return cfg.attn_every // cfg.moe_every        # 4 for 8 / 2


def jamba_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    n_moe = _moe_per_block(cfg)                   # mamba + MoE sublayers
    n_dense = cfg.attn_every - 1 - n_moe          # mamba + dense sublayers
    sub_moe = {"ln1": _norm_def(cfg), "ln2": _norm_def(cfg),
               "mamba": mamba_defs(cfg), "moe": moe_defs(cfg)}
    sub_dense = {"ln1": _norm_def(cfg), "ln2": _norm_def(cfg),
                 "mamba": mamba_defs(cfg), "mlp": mlp_defs(cfg)}
    return {"attn_ln1": _norm_def(cfg), "attn_ln2": _norm_def(cfg),
            "attn": attn_defs(cfg), "attn_mlp": mlp_defs(cfg),
            "moe_layers": stack_defs(sub_moe, n_moe),
            "dense_layers": stack_defs(sub_dense, n_dense)}


def _top_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, V = cfg.d_model, cfg.vocab_size
    return {"embed": ParamDef((V, D), ("vocab", "embed"), dtype=cfg.dtype),
            "final_norm": _norm_def(cfg),
            "head": ParamDef((D, V), ("embed", "vocab"), dtype=cfg.dtype)}


def jamba_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX package's parameter tree: blocks stacked on a leading
    axis, a block's sublayers on a second ([nb, n_sub, ...])."""
    return {"blocks": stack_defs(jamba_block_defs(cfg), _n_blocks(cfg)),
            **_top_defs(cfg)}


class MambaSublayer(nn.Module):
    """A mamba layer and its FFN: ``moe`` (an ``MoE``) or ``mlp``."""

    def __init__(self, cfg: ModelConfig, device: torch.device, moe: bool):
        super().__init__()
        register_params(self, {"ln1": _norm_def(cfg), "ln2": _norm_def(cfg)},
                        device)
        self.mamba = Mamba(cfg, device)
        if moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)


class JambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        register_params(self, {"attn_ln1": _norm_def(cfg),
                               "attn_ln2": _norm_def(cfg)}, device)
        self.attn = Attention(cfg, device)
        self.attn_mlp = MLP(cfg, device)
        n_moe = _moe_per_block(cfg)
        self.moe_layers = nn.ModuleList(MambaSublayer(cfg, device, True)
                                        for _ in range(n_moe))
        self.dense_layers = nn.ModuleList(
            MambaSublayer(cfg, device, False)
            for _ in range(cfg.attn_every - 1 - n_moe))


class Jamba(nn.Module):
    """Parameters of the whole model, one ``JambaBlock`` per super-block
    in ``blocks``; ``cfg`` is the config it was built for."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        register_params(self, _top_defs(cfg), device)
        self.blocks = nn.ModuleList(JambaBlock(cfg, device)
                                    for _ in range(_n_blocks(cfg)))


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------

def _mean(auxs, device: torch.device) -> torch.Tensor:
    """The mean of a list of 0-dim losses (NaN for none, as the mean of
    an empty array)."""
    if not auxs:
        return torch.full((), float("nan"), device=device)
    return torch.stack(auxs).mean()


def _block(cfg: ModelConfig, pb: JambaBlock, x: torch.Tensor,
           positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One super-block: (x, the mean aux loss of its MoE sublayers)."""
    eps = cfg.norm_eps
    x = residual(x, attn_apply(cfg, pb.attn, rms_norm(x, pb.attn_ln1, eps),
                               positions))
    x = residual(x, mlp_apply(cfg, pb.attn_mlp,
                              rms_norm(x, pb.attn_ln2, eps)))
    auxs = []
    for pl in pb.moe_layers:
        h, _ = mamba_apply(cfg, pl.mamba, rms_norm(x, pl.ln1, eps))
        x = residual(x, h)
        h, aux = moe_apply(cfg, pl.moe, rms_norm(x, pl.ln2, eps))
        x = residual(x, h)
        auxs.append(aux)
    for pl in pb.dense_layers:
        h, _ = mamba_apply(cfg, pl.mamba, rms_norm(x, pl.ln1, eps))
        x = residual(x, h)
        x = residual(x, mlp_apply(cfg, pl.mlp, rms_norm(x, pl.ln2, eps)))
    return x, _mean(auxs, x.device)


def _run(cfg: ModelConfig, params: Jamba, tokens: torch.Tensor,
         positions: Optional[torch.Tensor], remat: bool
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = embed_tokens(params.embed, tokens)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    auxs = []
    for pb in params.blocks:
        fn = functools.partial(_block, cfg, pb)
        x, aux = (maybe_remat(fn, cfg.remat) if remat else fn)(x, positions)
        auxs.append(aux)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return softcap(x @ params.head, cfg.logit_softcap), _mean(auxs, x.device)


@torch.no_grad()
def jamba_apply(cfg: ModelConfig, params: Jamba, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux loss: the mean over the
    blocks of each block's mean over its MoE sublayers)."""
    return _run(cfg, params, tokens, positions, remat=False)


def jamba_forward(cfg: ModelConfig, params: Jamba, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jamba_apply`` keeping the autograd graph (training): each block
    runs under ``maybe_remat(cfg.remat)``."""
    return _run(cfg, params, tokens, positions, remat=True)


def jamba_loss(cfg: ModelConfig, params: Jamba, tokens: torch.Tensor,
               targets: torch.Tensor, aux_weight: float = 0.01
               ) -> torch.Tensor:
    """Mean next-token cross-entropy (the log-softmax in float32) plus
    ``aux_weight`` times the aux loss."""
    logits, aux = jamba_forward(cfg, params, tokens)
    return next_token_nll(logits, targets) + aux_weight * aux


# ----------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------

def jamba_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: Union[str, torch.device] = "cuda"
                     ) -> Dict[str, Any]:
    """Zeroed decode state: ``kv`` {k, v: [nb, B, max_len, Hkv, Dh]} for
    the blocks' attention layers, and per mamba sublayer its scan state
    (``moe_h`` / ``dense_h``: [nb, n_sub, B, d_in, N] float32) and conv
    context (``moe_conv`` / ``dense_conv``: [nb, n_sub, B, K - 1,
    d_in])."""
    dev = cache_device(device)
    nb = _n_blocks(cfg)
    n_moe = _moe_per_block(cfg)
    n_dense = cfg.attn_every - 1 - n_moe
    kv = make_kv_cache(cfg, batch, max_len, dev, stacked_layers=nb)
    hm, cm = mamba_state(cfg, batch, dev, lead=(nb, n_moe))
    hd, cd = mamba_state(cfg, batch, dev, lead=(nb, n_dense))
    return {"kv": kv, "moe_h": hm, "moe_conv": cm,
            "dense_h": hd, "dense_conv": cd}


def jamba_cache_axes(cfg: ModelConfig):
    kv = kv_cache_axes(cfg, stacked=True)
    m = ("layers", None, "batch", "mlp", "state")
    c = ("layers", None, "batch", None, "mlp")
    return {"kv": kv, "moe_h": m, "moe_conv": c,
            "dense_h": m, "dense_conv": c}


def _mamba_step(cfg: ModelConfig, pl: MambaSublayer, x: torch.Tensor,
                h_state: torch.Tensor, conv_state: torch.Tensor
                ) -> torch.Tensor:
    """A sublayer's mamba on one token, its state updated in place."""
    h, (h2, c2) = mamba_apply(cfg, pl.mamba,
                              rms_norm(x, pl.ln1, cfg.norm_eps),
                              state=(h_state, conv_state))
    h_state.copy_(h2)
    conv_state.copy_(c2)
    return residual(x, h)


@torch.no_grad()
def jamba_decode(cfg: ModelConfig, params: Jamba, token: torch.Tensor,
                 cache: Dict[str, Any], pos: int
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: [B] int; pos: the timeline index of this token.  Returns
    (logits [B, V], cache), the cache updated in place."""
    eps = cfg.norm_eps
    x = embed_tokens(params.embed, token[:, None])
    for i, pb in enumerate(params.blocks):
        kv = {"k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i]}
        h, _ = attn_decode(cfg, pb.attn, rms_norm(x, pb.attn_ln1, eps), kv,
                           pos)
        x = residual(x, h)
        x = residual(x, mlp_apply(cfg, pb.attn_mlp,
                                  rms_norm(x, pb.attn_ln2, eps)))
        for j, pl in enumerate(pb.moe_layers):
            x = _mamba_step(cfg, pl, x, cache["moe_h"][i, j],
                            cache["moe_conv"][i, j])
            x = residual(x, moe_apply(cfg, pl.moe,
                                      rms_norm(x, pl.ln2, eps))[0])
        for j, pl in enumerate(pb.dense_layers):
            x = _mamba_step(cfg, pl, x, cache["dense_h"][i, j],
                            cache["dense_conv"][i, j])
            x = residual(x, mlp_apply(cfg, pl.mlp,
                                      rms_norm(x, pl.ln2, eps)))
    x = rms_norm(x[:, 0], params.final_norm, eps)
    return softcap(x @ params.head, cfg.logit_softcap), cache
