"""Mamba selective-SSM block (for the jamba hybrid), as the JAX package's
``models/ssm.py``.

The selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t is a loop
over time with each step's decay computed inside it: materialising
exp(dt A) over the whole sequence would be [B, T, d_in, N], 4.3 GB at
jamba's width for one 4096-token sequence.

On a mesh the loop runs on each rank's local shards of the batch and
of d_in (``common.local_shards``): every step is independent along
both, and DTensor would dispatch each of its small ops on its own.

One departure from the reference: the decode state carries the causal
convolution's last K - 1 *inputs*, the context the prefill convolution
reads.  The reference's ``mamba_apply`` carries its last K - 1 outputs
(``ssm.py:69-72``), so its decode steps part from its own forward from
the second token on; ``tests/test_torch_jamba.py`` shows both.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .common import (ModelConfig, ParamDef, cache_device, is_dtensor,
                     local_shards, register_params)


def mamba_defs(cfg: ModelConfig) -> Dict[str, Any]:
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    N = cfg.ssm_d_state
    K = cfg.ssm_conv
    dt_rank = max(D // 16, 8)
    f32 = torch.float32
    return {
        "in_proj": ParamDef((D, 2 * d_in), ("embed", "mlp"), dtype=cfg.dtype),
        "conv_w": ParamDef((K, d_in), ("conv", "mlp"), dtype=cfg.dtype,
                           scale=0.5),
        "conv_b": ParamDef((d_in,), ("mlp",), init="zeros", dtype=cfg.dtype),
        "x_proj": ParamDef((d_in, dt_rank + 2 * N), ("mlp", None),
                           dtype=cfg.dtype),
        "dt_proj": ParamDef((dt_rank, d_in), (None, "mlp"), dtype=f32),
        "dt_bias": ParamDef((d_in,), ("mlp",), init="zeros", dtype=f32),
        "A_log": ParamDef((d_in, N), ("mlp", "state"), init="zeros",
                          dtype=f32),
        "D_skip": ParamDef((d_in,), ("mlp",), init="ones", dtype=f32),
        "out_proj": ParamDef((d_in, D), ("mlp", "embed"), dtype=cfg.dtype),
    }


class Mamba(nn.Module):
    """Parameters of one mamba layer (``mamba_defs``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        register_params(self, mamba_defs(cfg), device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal convolution along T.  x: [B, T, C]; w: [K, C];
    prev: [B, K - 1, C], the carried context in decode.  The K products
    are summed in order, then the bias added, each rounded to x's
    dtype."""
    K = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    out = sum(xp[:, k:k + x.shape[1]] * w[k] for k in range(K))
    return out + b


def _selective_scan(dt: torch.Tensor, dx: torch.Tensor, Bf: torch.Tensor,
                    Cf: torch.Tensor, A: torch.Tensor,
                    h: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = h_t C_t over the
    T steps of dt, dx [B, T, d_in], B / C [B, T, N] (float32), from h
    [B, d_in, N] (zeros for ``None``): (y [B, T, d_in], the last h)."""
    Bn, T, d_in = dt.shape
    if h is None:
        h = dt.new_zeros((Bn, d_in, A.shape[-1]))
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t, :, None] * A)             # [B, d_in, N]
        h = decay * h + dx[:, t, :, None] * Bf[:, t, None, :]
        ys.append((h @ Cf[:, t, :, None])[..., 0])
    return torch.stack(ys, dim=1), h


def mamba_apply(cfg: ModelConfig, p: Mamba, x: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x: [B, T, D].  state (decode): (h [B, d_in, N] float32, conv
    context [B, K - 1, d_in]).  Returns (y [B, T, D] in x's dtype, the
    new state)."""
    B, T, D = x.shape
    d_in = cfg.ssm_expand * D
    N = cfg.ssm_d_state
    K = cfg.ssm_conv
    prev = None if state is None else state[1]

    xz = x @ p.in_proj
    x1, z = xz.split(d_in, dim=-1)
    ctx = torch.cat([x1.new_zeros((B, K - 1, d_in)) if prev is None
                     else prev.to(x1.dtype), x1], dim=1)[:, -(K - 1):]
    x1 = F.silu(_causal_conv(x1, p.conv_w, p.conv_b, prev))

    dbc = x1 @ p.x_proj
    dt_rank = p.dt_proj.shape[0]
    dt_r, Bc, Cc = dbc.split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_r.float() @ p.dt_proj + p.dt_bias)    # [B, T, d_in]
    A = -torch.exp(p.A_log)                                  # [d_in, N]

    xf = x1.float()
    scan_args = (dt, dt * xf, Bc.float(), Cc.float(), A,
                 None if state is None else state[0])
    if is_dtensor(x1):
        ys, h = local_shards(_selective_scan, scan_args,
                             ((0, 2), (0, 2), (0, None), (0, None),
                              (None, 0), (0, 1)), ((0, 2), (0, 1)),
                             batch=B, chans=d_in)
    else:
        ys, h = _selective_scan(*scan_args)
    y = ys + xf * p.D_skip
    y = y.to(x.dtype) * F.silu(z)
    return y @ p.out_proj, (h, ctx)


def mamba_state(cfg: ModelConfig, batch: int,
                device: Union[str, torch.device] = "cuda",
                lead: Tuple[int, ...] = ()
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (h [*lead, B, d_in, N] float32, conv context [*lead, B,
    K - 1, d_in] in the model's dtype)."""
    dev = cache_device(device)
    d_in = cfg.ssm_expand * cfg.d_model
    N, K = cfg.ssm_d_state, cfg.ssm_conv
    return (torch.zeros(lead + (batch, d_in, N), dtype=torch.float32,
                        device=dev),
            torch.zeros(lead + (batch, K - 1, d_in), dtype=cfg.dtype,
                        device=dev))
