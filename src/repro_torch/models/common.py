"""Model-stack foundations: the config, parameter definitions with
their logical sharding axes, the logical-axis -> ``PartitionSpec`` rules
engine, the activation constraints, and the shared layers (RMSNorm,
RoPE, logit softcap).

Parameters are declared once as ``ParamDef`` trees (nested dicts), as in
the JAX package; the modules of ``layers.py`` and ``lm.py`` register one
``nn.Parameter`` per definition and ``init_params`` fills them from an
explicit ``torch.Generator``.  The rules engine (``make_rules``,
``spec_for``, ``param_pspecs``) is the reference's, entry for entry; a
spec becomes DTensor placements on a ``DeviceMesh`` through
``placements_for`` (a mesh axis -> ``Shard(dim)`` on that mesh
dimension, a tuple of axes -> ``Shard(dim)`` on each, an axis not named
-> ``Replicate()``), which is how ``launch.steps`` distributes a model
(``param_placements``) and how ``constrain`` redistributes an
activation under ``activation_sharding``.  Its rematerialisation is
here too (``remat_policy`` / ``maybe_remat``): the model serves
(``lm_apply``) and trains (``lm_forward``, ``lm_loss``).
"""
from __future__ import annotations

import dataclasses
import math
import contextlib
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import torch
import torch.nn.functional as F
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
    ``expert_affinity_placement`` has no counterpart: nothing in the
    reference reads it either (placement is ``moe_apply``'s
    ``expert_perm`` argument, ``models/placement.py``), so a config that
    sets it is refused (``TypeError``) when it is made.  ``fsdp`` and
    ``seq_shard_decode`` feed the rules engine (``launch.steps``'s
    ``_rules_for``) and change nothing without a mesh.

    ``remat`` (none | full | dots) is read by the training forward
    only.  ``moe_sharded_ffn`` and ``moe_shard_map`` select the batched
    dispatch, which is what the reference runs on one device; on a mesh
    ``moe_shard_map`` runs the manual-collective MoE
    (``layers._moe_shard_map``).
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
    moe_shard_map: bool = False          # manual-collective MoE on a mesh
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
    # sequence-parallel / fsdp toggles consumed by the rules engine
    fsdp: bool = False
    seq_shard_decode: bool = False  # shard long KV caches along seq

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
    axes: Tuple[Optional[str], ...]     # logical axis per dim (None: none)
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
# Logical-axis -> PartitionSpec rules engine
# ======================================================================
# A rule maps a logical axis name to a priority list of mesh-axis tuples;
# the first candidate whose total size divides the dimension (and whose
# mesh axes are still unused in this spec) wins.  Unknown axes or no fit
# -> replicated (None).

Rules = Dict[str, Sequence[Tuple[str, ...]]]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh
    axis name, or a tuple of names (sharded over their product, the
    first the major).  It is a tuple, so it compares equal with the JAX
    package's ``PartitionSpec`` taken as one."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# TP on "model"; DP on ("pod","data"); FSDP shards the embed/ff dims of
# params over "data" too (and "pod" when present).
def make_rules(fsdp: bool = False, seq_model_shard: bool = False,
               expert_axis: Optional[str] = None) -> Rules:
    fsdp_c = [("data",), ("pod",)] if fsdp else []
    rules: Dict[str, List[Tuple[str, ...]]] = {
        "batch":   [("pod", "data"), ("data",)],
        "seq":     [("model",)] if seq_model_shard else [],
        "vocab":   [("model",)],
        "embed":   list(fsdp_c),
        "heads":   [("model",)],
        "kv_heads": [("model",)],
        "mlp":     [("model",)],
        "experts": [(expert_axis,)] if expert_axis else [],
        "expert_mlp": [("model",)],
        "layers":  [],
        "conv":    [],
        "state":   [],
        "cache_seq": [("model",)] if seq_model_shard else [],
    }
    return rules


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (its ``mesh_dim_names``
    and ``shape``, and nothing else of it)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             mesh: Any, rules: Rules) -> PartitionSpec:
    used: set = set()
    parts: List[Any] = []
    sizes = mesh_sizes(mesh)
    for dim, ax in zip(shape, axes):
        chosen = None
        for cand in rules.get(ax, []) if ax else []:
            if any(c in used or c not in sizes for c in cand):
                continue
            total = math.prod(sizes[c] for c in cand)
            if total > 1 and dim % total == 0:
                chosen = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        parts.append(chosen)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def _map_defs(fn: Callable[[ParamDef], Any], defs: Any) -> Any:
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def param_pspecs(defs: Any, mesh: Any, rules: Rules) -> Any:
    return _map_defs(lambda d: spec_for(d.shape, d.axes, mesh, rules), defs)


def placements_for(spec: Sequence[Any], mesh: Any) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh
    dimension: ``Shard(dim)`` on every mesh axis that tensor dimension
    ``dim`` names, ``Replicate()`` on the others.  A tuple of axes must
    name them in the mesh's order (the major first, as the JAX mesh
    lays out a tuple entry)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def param_placements(defs: Any, mesh: Any, rules: Rules) -> Any:
    """The counterpart of the reference's ``param_shardings``: the
    placements of every definition of ``defs`` on ``mesh``."""
    return _map_defs(lambda d: placements_for(
        spec_for(d.shape, d.axes, mesh, rules), mesh), defs)


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _reshape_gathered(t: torch.Tensor, shape: Sequence[int]
                      ) -> torch.Tensor:
    """A DTensor's ``reshape``, gathering first the dimensions from the
    first one the reshape changes when DTensor refuses the view."""
    try:
        return t.reshape(shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate, Shard
        keep = 0
        while keep < min(t.dim(), len(shape)) \
                and t.shape[keep] == shape[keep]:
            keep += 1
        pl = [Replicate() if isinstance(p, Shard) and p.dim >= keep else p
              for p in t.placements]
        return t.redistribute(t.device_mesh, pl).reshape(shape)


class _Reshape(torch.autograd.Function):
    """``_reshape_gathered`` both ways: the gradient arrives at its own
    placements and may need the gather the forward did not."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, shape: Tuple[int, ...]):
        ctx.in_shape = tuple(t.shape)
        return _reshape_gathered(t, shape)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _reshape_gathered(grad, ctx.in_shape), None


def reshape(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``t.reshape(shape)``.  A DTensor whose sharded dimension the new
    shape cuts where its shards do not fall (a [.., H*Dh] projection
    sharded over more ranks than H heads divide) is first gathered on
    the dimensions from the first one the reshape changes, in the
    forward and in the backward: DTensor refuses such a view, where
    GSPMD would reshard."""
    if not is_dtensor(t):
        return t.reshape(shape)
    return _Reshape.apply(t, tuple(shape))


class SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) of a partial result over mesh dimensions, whose
    gradient is the identity: the sum's consumers hold it replicated,
    so each partial's cotangent is theirs (the transpose of shard_map's
    ``psum`` of a replicated output)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Any, dims: Tuple[int, ...]
                ) -> torch.Tensor:
        import torch.distributed._functional_collectives as funcol
        for d in dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum", (mesh, d)))
        return t

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None, None


class ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a local shard's
    gradient becomes a DTensor's again, whose global strides DTensor
    takes as contiguous (a permuted local, as an einsum's backward
    gives, would break the next view)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad.contiguous()


def shard_index(mesh: Any, dims: Sequence[int]) -> int:
    """This rank's linear shard index over the mesh dimensions ``dims``,
    row-major in the order given (the order in which ``Shard``
    placements of one tensor dimension on several mesh dimensions split
    it)."""
    coord = mesh.get_coordinate()
    idx = 0
    for d in dims:
        idx = idx * mesh.shape[d] + coord[d]
    return idx


def map_local(fn: Callable, args: Sequence[Any],
              in_placements: Sequence[Optional[Sequence[Any]]],
              out_placements: Any) -> Any:
    """``fn`` on this rank's local shards of ``args`` (torch's
    ``local_map``): each DTensor arg is redistributed to its
    ``in_placements`` entry (``None`` for an arg that is not a DTensor,
    passed as it is) and each output of ``fn`` becomes a DTensor at its
    ``out_placements`` entry (one placement list for a single output, a
    tuple of them for a tuple).

    This is where an input's gradient layout is decided: an input
    replicated along a mesh dimension on which another input is sharded
    gets a Partial gradient there (each rank's part of the computation
    contributes to it, and the backward sums them); elsewhere the
    gradient takes the input's placements.  Each local input's gradient
    is made contiguous (``ContiguousGrad``).  No collective runs here
    besides the redistributions; ``fn`` may run its own
    (``SumOverRanks``)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    split = {d for pl in in_placements if pl is not None
             for d, p in enumerate(pl) if isinstance(p, Shard)}
    grads = tuple(None if pl is None else
                  [Partial() if d in split and not isinstance(p, Shard)
                   else p for d, p in enumerate(pl)]
                  for pl in in_placements)

    def body(*loc):
        return fn(*(ContiguousGrad.apply(t) if isinstance(t, torch.Tensor)
                    and t.requires_grad else t for t in loc))

    return local_map(body, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def local_shards(fn: Callable, args: Sequence[Optional[torch.Tensor]],
                 dims: Sequence[Tuple[Optional[int], Optional[int]]],
                 out_dims: Sequence[Tuple[Optional[int], Optional[int]]],
                 batch: int, chans: int) -> Tuple[torch.Tensor, ...]:
    """``fn`` on this rank's local shards of the DTensors ``args``
    (``map_local``), for a computation independent along a batch and a
    channel axis (the attention's heads, the scans' per-step loops:
    every step an elementwise or per-channel update, which DTensor would
    dispatch op by op).

    ``dims[i]`` names arg i's (batch dim, channel dim), ``None`` where
    it has none (the arg is then replicated along that axis); the
    outputs of ``fn`` are laid out by ``out_dims``.  The batch splits on
    ("pod", "data") when their product divides ``batch`` (else on
    "data", else not at all), the channels on "model" when it divides
    ``chans``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = next(a for a in args if a is not None).device_mesh
    sizes = mesh_sizes(mesh)
    bat = [a for a in ("pod", "data") if sizes.get(a, 1) > 1]
    if batch % math.prod(sizes[a] for a in bat):
        bat = ["data"] if sizes.get("data", 1) > 1 \
            and batch % sizes["data"] == 0 else []
    chan = ["model"] if sizes.get("model", 1) > 1 \
        and chans % sizes["model"] == 0 else []

    def lay(d):
        out = []
        for n in mesh.mesh_dim_names:
            k = d[0] if n in bat else d[1] if n in chan else None
            out.append(Shard(k) if k is not None else Replicate())
        return out

    return map_local(fn, args,
                     [None if a is None else lay(d)
                      for a, d in zip(args, dims)],
                     tuple(lay(d) for d in out_dims))


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


def residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x + h.  On a mesh the sum comes out at the activation layout
    (``constrain`` to ("batch", ..., None)): a block's contribution from
    a row-parallel projection (``wo``, ``w2``, ``out_proj``) is Partial
    over "model", and this is where it is summed, the all-reduce of the
    Megatron pattern.  Left Partial, it would make the next norm's output
    Partial and DTensor would gather the next weights whole.  h is
    summed before the add: added to a replicated x while Partial, its
    gradient would come back Partial too, and the row-parallel
    projection's backward would gather its weight whole."""
    axes = ("batch",) + (None,) * (x.dim() - 1)
    return constrain(x + constrain(h, axes), axes)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, D] for the ids ``tokens`` [...].

    On a mesh (a DTensor table) the rows come out at the tokens'
    placements, the batch sharded as they are: a table sharded along D
    (FSDP) is gathered along D first, as FSDP gathers a weight before
    its use; then each rank looks its tokens up in its vocabulary shard
    (rows outside it zero) and one all-reduce over the vocabulary's
    mesh axes sums the shards' rows.  DTensor's own embedding cannot
    take the gradient of that partial lookup (it cannot turn a Partial
    gradient into its masked partial), so the lookup is explicit; the
    table's gradient is Partial over the mesh axes that shard the
    tokens."""
    if not is_dtensor(table):
        return constrain(F.embedding(tokens.long(), table),
                         ("batch",) + (None,) * tokens.dim())
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    tab_pl = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
              for pl in table.placements]
    vocab = tuple(d for d, pl in enumerate(tab_pl) if isinstance(pl, Shard))
    tok_pl = ([pl if isinstance(pl, Shard) else Replicate()
               for pl in tokens.placements] if is_dtensor(tokens) else None)

    def lookup(local: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        ids = tok.long()
        if not vocab:
            return F.embedding(ids, local)
        ids = ids - shard_index(mesh, vocab) * local.shape[0]
        inside = (ids >= 0) & (ids < local.shape[0])
        rows = F.embedding(ids.clamp(0, local.shape[0] - 1), local)
        return SumOverRanks.apply(rows * inside[..., None].to(rows.dtype),
                                  mesh, vocab)

    return map_local(lookup, (table, tokens), (tab_pl, tok_pl),
                     tok_pl or [Replicate()] * mesh.ndim)


def next_token_nll(logits: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """Mean cross-entropy of ``targets`` under ``logits`` [..., V], the
    log-softmax in float32.  On a mesh with the vocabulary sharded the
    loss is vocabulary-parallel (``_sharded_nll``)."""
    if is_dtensor(logits):
        from torch.distributed.tensor import Shard
        if any(isinstance(pl, Shard) and pl.dim == logits.dim() - 1
               for pl in logits.placements):
            return _sharded_nll(logits, targets)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0].mean()


def _sharded_nll(logits: torch.Tensor, targets: torch.Tensor
                 ) -> torch.Tensor:
    """``next_token_nll`` of a DTensor with the vocabulary sharded, on
    each rank's shard (the Megatron vocabulary-parallel cross-entropy):
    the max, the sum of exponentials and the target's logit are reduced
    over the vocabulary's mesh axes, so no rank holds the whole
    vocabulary; DTensor's ``log_softmax`` would gather it.  The same
    function as the float32 log-softmax, summed in another order."""
    from torch.distributed.tensor import Replicate, Shard
    import torch.distributed._functional_collectives as funcol
    mesh = logits.device_mesh
    last = logits.dim() - 1
    log_pl = [pl if isinstance(pl, Shard) else Replicate()
              for pl in logits.placements]
    vocab = tuple(d for d, pl in enumerate(log_pl)
                  if isinstance(pl, Shard) and pl.dim == last)
    rows = [Replicate() if d in vocab else pl for d, pl in enumerate(log_pl)]
    rows_mesh = tuple(d for d, pl in enumerate(rows) if isinstance(pl, Shard))
    n = targets.numel()

    def nll(local: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        local = local.float()
        ids = tgt.long() - shard_index(mesh, vocab) * local.shape[-1]
        inside = (ids >= 0) & (ids < local.shape[-1])
        m = local.detach().amax(-1, keepdim=True)
        for d in vocab:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", (mesh, d)))
        sumexp = SumOverRanks.apply(torch.exp(local - m).sum(-1), mesh,
                                    vocab)
        picked = torch.gather(local, -1, ids.clamp(0, local.shape[-1] - 1)
                              [..., None])[..., 0] * inside
        picked = SumOverRanks.apply(picked, mesh, vocab)
        total = (m[..., 0] + torch.log(sumexp) - picked).sum()
        if rows_mesh:
            total = SumOverRanks.apply(total, mesh, rows_mesh)
        return total / n

    return map_local(nll, (logits, targets),
                     (log_pl, rows if is_dtensor(targets) else None),
                     [Replicate()] * mesh.ndim)


# ======================================================================
# Activation sharding constraints (MaxText-style logical annotations)
# ======================================================================
# The step factories (launch/steps.py) install the (mesh, rules) pair for
# the duration of a step; model code calls ``constrain(x, axes)`` where
# the reference steers XLA's sharding propagation (the MoE dispatch
# buffers).  Here it redistributes a DTensor to the rules' placements.
# Outside any context, or on a plain (local) tensor, it is a no-op, so
# model code stays mesh-agnostic.

_ACT_CTX: List[Tuple[Any, Rules]] = []


@contextlib.contextmanager
def activation_sharding(mesh: Any, rules: Rules):
    _ACT_CTX.append((mesh, rules))
    try:
        yield
    finally:
        _ACT_CTX.pop()


def constrain(x: torch.Tensor, axes: Tuple[Optional[str], ...]
              ) -> torch.Tensor:
    ctx = current_sharding_ctx()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    return x.redistribute(
        mesh, placements_for(spec_for(x.shape, axes, mesh, rules), mesh))


def current_sharding_ctx() -> Optional[Tuple[Any, Rules]]:
    if not _ACT_CTX or _ACT_CTX[-1][0] is None:
        return None
    return _ACT_CTX[-1]


@contextlib.contextmanager
def no_constraints():
    """Silence constraints (inside a ``local_map`` everything is
    local)."""
    _ACT_CTX.append((None, {}))
    try:
        yield
    finally:
        _ACT_CTX.pop()


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
