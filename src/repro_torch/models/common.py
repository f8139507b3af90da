"""Model-stack foundations: the config, parameter definitions and the
shared layers (RMSNorm, RoPE, logit softcap).

Parameters are declared once as ``ParamDef`` trees (nested dicts), as in
the JAX package; the modules of ``layers.py`` and ``lm.py`` register one
``nn.Parameter`` per definition and ``init_params`` fills them from an
explicit ``torch.Generator``.  The JAX package's sharding rules engine
has no counterpart here: the port runs on one device.  Its
rematerialisation does (``remat_policy`` / ``maybe_remat``): the model
serves (``lm_apply``) and trains (``lm_forward``, ``lm_loss``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device


# ======================================================================
# Config
# ======================================================================

@dataclasses.dataclass
class ModelConfig:
    """Field names and defaults follow the JAX package's ``ModelConfig``
    for the four families (dense and MoE transformers, rwkv, hybrid).
    Fields that nothing in the port reads have no counterpart, so a
    config that sets one is refused (``TypeError``) when it is made:

    - ``expert_affinity_placement``: nothing in the reference reads it
      either; placement is ``moe_apply``'s ``expert_perm`` argument
      (``models/placement.py``);
    - ``fsdp`` and ``seq_shard_decode``: they feed the reference's
      sharding rules engine, which has no counterpart on one device.

    ``remat`` (none | full | dots) is read by the training forward
    only.  ``moe_sharded_ffn`` and ``moe_shard_map`` select the batched
    dispatch, which is what the reference runs on one device.
    ``ssm_scan_unroll`` changes only how XLA schedules the reference's
    selective scan, not its result; the port's scan is a Python loop
    and reads nothing from it (the field stays so that jamba's
    production profile loads)."""
    name: str = "model"
    family: str = "dense"          # dense | moe | rwkv | hybrid
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 256
    vocab_size: int = 256
    # attention options
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2.5 / qwen2-moe
    window: Optional[int] = None   # mixtral sliding window
    rope_theta: float = 1e4
    # mlp options
    mlp_act: str = "silu_glu"      # silu_glu | sq_relu
    # MoE options
    num_experts: int = 0
    top_k: int = 2
    num_shared_experts: int = 0
    moe_d_ff: Optional[int] = None  # per-expert ff (qwen2-moe: 1408)
    capacity_factor: float = 1.25
    moe_grouped_dispatch: bool = False   # per-sequence routing
    moe_sharded_ffn: bool = False        # batched dispatch
    moe_shard_map: bool = False          # batched dispatch on one device
    # rwkv / ssm options
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_scan_unroll: int = 1       # XLA's schedule only; unread here
    rwkv_head_dim: int = 64
    chunk_size: int = 128
    # hybrid (jamba) options
    attn_every: int = 8            # 1 attention layer per this many
    moe_every: int = 2             # MoE FFN on every other layer
    # io
    embed_inputs: bool = False     # modality-frontend stub ([B,S,D] in)
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    # numerics
    dtype: torch.dtype = torch.bfloat16
    norm_eps: float = 1e-5
    remat: str = "none"            # none | full | dots
    use_flash_kernel: bool = False  # attention through kernels.ops

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def effective_moe_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff


# ======================================================================
# ParamDef trees
# ======================================================================

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical axis per dim (documentation)
    init: str = "normal"                # normal | zeros | ones
    scale: float = 1.0                  # stddev multiplier for normal
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes rank mismatch: shape={self.shape}, "
                             f"axes={self.axes}")


def iter_defs(defs: Any, prefix: str = "") -> Iterator[Tuple[str, ParamDef]]:
    """(dotted path, ParamDef) over a tree in sorted key order (the
    order ``jax.tree.flatten`` walks a dict)."""
    if isinstance(defs, ParamDef):
        yield prefix, defs
        return
    for key in sorted(defs):
        yield from iter_defs(defs[key], f"{prefix}.{key}" if prefix else key)


def param_count(defs: Any) -> int:
    return sum(math.prod(d.shape) for _, d in iter_defs(defs))


def register_params(module: nn.Module, defs: Dict[str, ParamDef],
                    device: torch.device) -> None:
    """One uninitialised, frozen ``nn.Parameter`` per definition of a
    flat ``defs`` dict; ``module.defs`` keeps the definitions for
    ``init_params``."""
    module.defs = defs
    for name, d in defs.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(d.shape, dtype=d.dtype, device=device),
            requires_grad=False))


def cache_device(device: Union[str, torch.device]) -> torch.device:
    """The device a decode state is made on: ``"meta"`` (shapes and
    dtypes, no storage: ``configs.input_specs``) or a device that
    ``resolve_device`` admits."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def build_model(module: Callable[[Any, torch.device], nn.Module], cfg: Any,
                device: Union[str, torch.device] = "cuda",
                seed: int = 0) -> nn.Module:
    """``module(cfg, device)`` with weights drawn on ``device`` from
    ``torch.Generator(device).manual_seed(seed)`` (``init_params``).
    Raises without CUDA unless ``device="cpu"`` is asked for."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(module(cfg, dev), gen)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every registered parameter by its ``ParamDef``: zeros, ones,
    or ``normal * scale / sqrt(fan_in)`` drawn in float32 and cast, with
    ``fan_in = shape[-2]`` for matrices and ``shape[-1]`` for vectors
    (the rule of the JAX package's ``init_params``; the numbers differ,
    the generators being different).  Modules are visited in
    registration order, parameters in sorted name order, so one seed
    gives one model."""
    for mod in model.modules():
        for name, d in sorted(getattr(mod, "defs", {}).items()):
            p = getattr(mod, name)
            if d.init == "zeros":
                p.zero_()
            elif d.init == "ones":
                p.fill_(1)
            else:
                fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
                std = d.scale / math.sqrt(max(fan_in, 1))
                p.copy_(torch.randn(d.shape, generator=generator,
                                    dtype=torch.float32, device=p.device)
                        .mul_(std))
    return model


# ======================================================================
# Shared layers
# ======================================================================

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [S] or [B, S].  Half-split rotation
    (first half against second half), computed in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [D/2]
    ang = positions[..., None].float() * freqs               # [.., S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if ang.dim() == 2:                                      # [S, D/2]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                                                   # [B, S, D/2]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap


def next_token_nll(logits: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """Mean cross-entropy of ``targets`` under ``logits`` [..., V], the
    log-softmax in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0].mean()


# ======================================================================
# Rematerialisation
# ======================================================================

# the 2-D matmuls: the reference's ``checkpoint_dots_with_no_batch_dims``
# saves the dots without batch dimensions (a [B, S, D] @ [D, F] product
# reaches aten as ``mm``); batched attention products are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _nothing_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(name: str) -> Optional[Callable[..., CheckpointPolicy]]:
    """The selective-checkpoint policy of a ``remat`` name: ``None`` for
    "none" (everything saved), nothing saved for "full", the 2-D
    matmul outputs saved for "dots"."""
    if name == "none":
        return None
    if name == "full":
        return _nothing_saveable
    if name == "dots":
        return _dots_saveable
    raise ValueError(name)


def maybe_remat(fn: Callable, name: str) -> Callable:
    """``fn`` recomputed in the backward pass by ``remat_policy(name)``:
    "full" is ``torch.utils.checkpoint.checkpoint`` (only the inputs
    kept), "dots" selective activation checkpointing."""
    policy = remat_policy(name)
    if policy is None:
        return fn
    kw = {}
    if name == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            policy)

    def remat(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return remat
