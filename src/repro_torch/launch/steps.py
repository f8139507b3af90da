"""Train, forward (prefill) and serve (decode) steps of the LM
substrate, on one device or across a ``DeviceMesh``.

Without a mesh a step is a plain function of (parameters, inputs) on
the parameters' device.  With ``mesh=`` the factories mirror the JAX
package's: they return a ``StepBundle`` (the step, its in/out
placements and the inputs' meta shapes), every sharding comes from the
logical-axis rules engine (``models/common.py``), and nothing here
hard-codes a mesh shape:

- the parameters are distributed by ``_rules_for(cfg, decode)``
  (``shard_params``; a model built or converted unsharded carries over);
- the AdamW moments take the parameters' placements and ``step`` is
  replicated;
- inputs are placed by the ("batch", None) spec and logits by
  ("batch", None, "vocab"); decode caches by the family's
  ``cache_axes`` with ``seq_model_shard`` on decode;
- the step runs under ``activation_sharding`` (the model's
  ``constrain`` points) and ``implicit_replication`` (plain tensors the
  model makes, positions and masks, count as replicated).

A step takes global tensors (every rank holding the same one: each
rank keeps its own shard, no collective) or DTensors, which it
redistributes to its placements, and returns DTensors at its out
placements.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..models import ModelConfig, get_api
from ..models.common import (activation_sharding, is_dtensor, make_rules,
                             placements_for, spec_for)
from ..optim import (AdamWConfig, CompressionConfig, adamw_update,
                     compress_gradients, cosine_schedule)
from ..tree import tree_map


@dataclasses.dataclass
class StepBundle:
    """A step + its in/out placements + its inputs' meta shapes (the
    counterpart of the reference's jit-able step with its in/out
    shardings and shape-structs)."""
    fn: Callable
    in_placements: Any
    out_placements: Any
    input_shapes: Dict[str, Any]


def _rules_for(cfg: ModelConfig, decode: bool):
    return make_rules(fsdp=cfg.fsdp,
                      seq_model_shard=decode and cfg.seq_shard_decode)


def _replicated(mesh: Any) -> Tuple[Any, ...]:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def _place(t: torch.Tensor, mesh: Any, placements: Any) -> torch.Tensor:
    """``t`` as a DTensor at ``placements``: a DTensor redistributed, a
    global tensor (the same on every rank) cut to this rank's shard
    without a collective."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(t, DTensor):
        if tuple(t.placements) == tuple(placements):
            return t
        return t.redistribute(mesh, placements)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _param_placements(model: nn.Module, mesh: Any, rules) -> Dict[str, Any]:
    """Module parameter name -> placements.  A module's ``defs`` are one
    layer's, the reference's stacked ones without the leading "layers"
    axes, which no rule shards: the spec is the same."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, d in getattr(mod, "defs", {}).items():
            key = f"{prefix}.{name}" if prefix else name
            out[key] = placements_for(spec_for(d.shape, d.axes, mesh, rules),
                                      mesh)
    return out


def shard_params(model: nn.Module, mesh: Any, rules) -> nn.Module:
    """Distribute ``model``'s parameters on ``mesh`` by ``rules`` (each
    rank keeps its shard of its own copy: build or convert the same
    weights on every rank, e.g. ``lm_params_from_numpy``); parameters
    already placed stay, misplaced DTensors are redistributed.  Returns
    the model, its parameters replaced in place."""
    places = _param_placements(model, mesh, rules)
    for prefix, mod in model.named_modules():
        for name in getattr(mod, "defs", {}):
            p = mod._parameters[name]
            pl = places[f"{prefix}.{name}" if prefix else name]
            if is_dtensor(p) and tuple(p.placements) == pl:
                continue
            with torch.no_grad():
                t = _place(p.detach(), mesh, pl)
            mod._parameters[name] = nn.Parameter(
                t, requires_grad=p.requires_grad)
    return model


def _meta_params(model_fn: Callable, cfg: ModelConfig, mesh: Any, rules
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The model's parameters as global meta tensors, and their
    placements, by parameter name."""
    model = model_fn(cfg, torch.device("meta"))
    return ({k: v.detach() for k, v in model.named_parameters()},
            _param_placements(model, mesh, rules))


@contextlib.contextmanager
def _on_mesh(mesh: Any, rules):
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), activation_sharding(mesh, rules):
        yield


def _input_shape(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.embed_inputs:
        return torch.empty((batch, seq, cfg.d_model), dtype=cfg.dtype,
                           device="meta")
    return torch.empty((batch, seq), dtype=torch.int32, device="meta")


def _input_placements(cfg: ModelConfig, mesh: Any, rules, batch: int,
                      seq: int):
    if cfg.embed_inputs:
        return placements_for(spec_for((batch, seq, cfg.d_model),
                                       ("batch", None, None), mesh, rules),
                              mesh)
    return placements_for(spec_for((batch, seq), ("batch", None), mesh,
                                   rules), mesh)


# ----------------------------------------------------------------------
# Train
# ----------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, opt: Optional[AdamWConfig] = None,
                    compression: Optional[CompressionConfig] = None,
                    batch: int = 8, seq: int = 128,
                    total_steps: int = 10000, *, mesh: Any = None):
    """train_step(params, opt_state, inputs [batch, seq], targets) ->
    (params, opt_state, {"loss", "grad_norm", "lr"}).

    ``params`` is the model (``get_api(cfg).build``); the gradients and
    the AdamW state (``adamw_init`` of ``dict(params.named_parameters())``)
    are keyed by its parameter names.  The loss's gradients go through
    ``compress_gradients`` (a no-op unless enabled) and ``adamw_update``
    at the cosine schedule's lr of the step *before* the update (warmup
    ``min(1000, total_steps // 10)``); the new weights are written into
    ``params`` and it is returned with the new state.  The metrics are
    0-dim tensors on the parameters' device.

    With ``mesh`` a ``StepBundle`` whose step first distributes the
    model (``shard_params``), the state and the batch (see the module's
    docstring)."""
    api = get_api(cfg)
    opt = opt or AdamWConfig()
    compression = compression or CompressionConfig()
    lr_fn = cosine_schedule(opt.lr, warmup=min(1000, total_steps // 10),
                            total=total_steps)

    def train_step(params: nn.Module, opt_state: Dict[str, Any],
                   inputs: torch.Tensor, targets: torch.Tensor
                   ) -> Tuple[nn.Module, Dict[str, Any],
                              Dict[str, torch.Tensor]]:
        if tuple(inputs.shape[:2]) != (batch, seq) \
                or tuple(targets.shape) != (batch, seq):
            raise ValueError(f"train_step: expected inputs and targets of "
                             f"shape {(batch, seq)}, got "
                             f"{tuple(inputs.shape)}, {tuple(targets.shape)}")
        named = dict(params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        loss = api.loss(cfg, params, inputs, targets)
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        grads, _ = compress_gradients(grads, None, compression)
        lr = lr_fn(opt_state["step"])
        new, new_state, gnorm = adamw_update(named, grads, opt_state, opt,
                                             lr)
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(new[name])
        return params, new_state, {"loss": loss.detach(), "grad_norm": gnorm,
                                   "lr": lr}

    if mesh is None:
        return train_step
    rules = _rules_for(cfg, decode=False)
    meta, p_pl = _meta_params(api.module, cfg, mesh, rules)
    rep = _replicated(mesh)
    in_pl = _input_placements(cfg, mesh, rules, batch, seq)
    tgt_pl = placements_for(spec_for((batch, seq), ("batch", None), mesh,
                                     rules), mesh)

    def sharded_step(params, opt_state, inputs, targets):
        shard_params(params, mesh, rules)
        state = {"m": {k: _place(v, mesh, p_pl[k])
                       for k, v in opt_state["m"].items()},
                 "v": {k: _place(v, mesh, p_pl[k])
                       for k, v in opt_state["v"].items()},
                 "step": _place(opt_state["step"], mesh, rep)}
        with _on_mesh(mesh, rules):
            return train_step(params, state, _place(inputs, mesh, in_pl),
                              _place(targets, mesh, tgt_pl))

    o_pl = {"m": p_pl, "v": p_pl, "step": rep}
    o_shapes = {"m": tree_map(lambda t: torch.empty_like(
                    t, dtype=opt.state_dtype), meta),
                "v": tree_map(lambda t: torch.empty_like(
                    t, dtype=opt.state_dtype), meta),
                "step": torch.empty((), dtype=torch.int32, device="meta")}
    return StepBundle(
        sharded_step, (p_pl, o_pl, in_pl, tgt_pl),
        (p_pl, o_pl, {"loss": rep, "grad_norm": rep, "lr": rep}),
        {"params": meta, "opt_state": o_shapes,
         "inputs": _input_shape(cfg, batch, seq),
         "targets": torch.empty((batch, seq), dtype=torch.int32,
                                device="meta")})


# ----------------------------------------------------------------------
# Prefill / forward (throughput shape)
# ----------------------------------------------------------------------

def make_forward_step(cfg: ModelConfig, *, mesh: Any = None,
                      batch: Optional[int] = None,
                      seq: Optional[int] = None):
    """forward(params, inputs) -> logits [B, S, V]; inputs are token
    ids [B, S], or embeddings [B, S, D] for an ``embed_inputs`` arch.
    With ``mesh`` (and the ``batch`` x ``seq`` shape it places) a
    ``StepBundle``; with ``use_flash_kernel`` each rank's attention runs
    the flash kernel on its local heads."""
    api = get_api(cfg)

    def forward(params, inputs: torch.Tensor) -> torch.Tensor:
        logits, _ = api.apply(cfg, params, inputs)
        return logits

    if mesh is None:
        return forward
    if batch is None or seq is None:
        raise ValueError("make_forward_step on a mesh needs batch and seq")
    rules = _rules_for(cfg, decode=False)
    in_pl = _input_placements(cfg, mesh, rules, batch, seq)
    out_pl = placements_for(spec_for((batch, seq, cfg.vocab_size),
                                     ("batch", None, "vocab"), mesh, rules),
                            mesh)

    def sharded_forward(params, inputs):
        shard_params(params, mesh, rules)
        with _on_mesh(mesh, rules):
            logits = forward(params, _place(inputs, mesh, in_pl))
            return _place(logits, mesh, out_pl)

    meta, p_pl = _meta_params(api.module, cfg, mesh, rules)
    return StepBundle(sharded_forward, (p_pl, in_pl), out_pl,
                      {"params": meta, "inputs": _input_shape(cfg, batch,
                                                              seq)})


# ----------------------------------------------------------------------
# Decode (serve step)
# ----------------------------------------------------------------------

def _cache_placements(cache: Any, axes: Any, mesh: Any, rules) -> Any:
    """Placements of a decode-state tree by its logical-axes tree."""
    return tree_map(lambda t, ax: placements_for(
        spec_for(tuple(t.shape), ax, mesh, rules), mesh), cache, axes)


def make_serve_step(cfg: ModelConfig, *, mesh: Any = None,
                    batch: Optional[int] = None,
                    max_len: Optional[int] = None):
    """serve_step(params, token, cache, pos) -> (next_token [B] int32,
    cache): one greedy decode step; ``token`` is [B] ids, or [B, D]
    embeddings for an ``embed_inputs`` arch.  With ``mesh`` (and the
    ``batch`` and ``max_len`` of the cache it places) a ``StepBundle``;
    the cache is placed by the family's ``cache_axes``, the sequence
    sharded on "model" when ``cfg.seq_shard_decode`` is set, and the
    step returns the DTensor cache it updated."""
    api = get_api(cfg)

    def serve_step(params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                   pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, cache = api.decode(cfg, params, token, cache, pos)
        if is_dtensor(logits):
            # DTensor's sharded argmax fails on some shapes (a batch
            # of 1): the [B, V] logits are small, gather the vocabulary
            from torch.distributed.tensor import Replicate, Shard
            logits = logits.redistribute(logits.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                for p in logits.placements])
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    if mesh is None:
        return serve_step
    if batch is None or max_len is None:
        raise ValueError("make_serve_step on a mesh needs batch and max_len")
    rules = _rules_for(cfg, decode=True)
    cache_shapes = api.init_cache(cfg, batch, max_len, "meta")
    cache_pl = _cache_placements(cache_shapes, api.cache_axes(cfg), mesh,
                                 rules)
    if cfg.embed_inputs:
        tok_shape = torch.empty((batch, cfg.d_model), dtype=cfg.dtype,
                                device="meta")
        tok_pl = placements_for(spec_for((batch, cfg.d_model),
                                         ("batch", None), mesh, rules), mesh)
    else:
        tok_shape = torch.empty((batch,), dtype=torch.int32, device="meta")
        tok_pl = placements_for(spec_for((batch,), ("batch",), mesh, rules),
                                mesh)
    out_tok_pl = placements_for(spec_for((batch,), ("batch",), mesh, rules),
                                mesh)

    def sharded_serve(params, token, cache, pos):
        shard_params(params, mesh, rules)
        cache = tree_map(lambda t, pl: _place(t, mesh, pl), cache, cache_pl)
        with _on_mesh(mesh, rules):
            nxt, cache = serve_step(params, _place(token, mesh, tok_pl),
                                    cache, pos)
            return _place(nxt, mesh, out_tok_pl), cache

    meta, p_pl = _meta_params(api.module, cfg, mesh, rules)
    return StepBundle(
        sharded_serve, (p_pl, tok_pl, cache_pl, _replicated(mesh)),
        (out_tok_pl, cache_pl),
        {"params": meta, "token": tok_shape, "cache": cache_shapes,
         "pos": 0})
