"""Carry a plan, or an LM's weights, across packages as plain numpy
arrays.

``plan_arrays`` reads what the SPMD engine needs from a plan of either
package (graph triples and id-space sizes, per-site edge ids, the
replicated properties) without importing the other package: it only
reads attributes.  ``engine_from_arrays`` builds this package's
``SpmdEngine`` from those arrays, so a reference plan and the port are
served from identical per-site storage.  ``plan_state_arrays`` reads a
whole plan of any strategy the same way (fragments with their minterms,
allocation, baseline per-site storage, selected patterns, config) and
``plan_from_state_arrays`` rebuilds this package's ``PartitionPlan``
from it, data dictionary included, so one plan is served by every
backend of either package.  ``lm_params_from_numpy`` loads a JAX-layout
parameter tree of any model family (numpy arrays, layers stacked) into
this package's model and ``lm_params_to_numpy`` is its inverse;
``adamw_state_to_numpy`` / ``adamw_state_from_numpy`` do the same for
the optimizer state, so a ``{params, opt}`` checkpoint has the same
leaf names in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .core.allocation import Allocation
from .core.baselines import BaselineFragmentation
from .core.dictionary import DataDictionary
from .core.fragmentation import (Fragment, Fragmentation, MintermPredicate,
                                 SimplePredicate)
from .core.graph import RDFGraph
from .core.plan import PartitionConfig, PartitionPlan
from .core.query import QueryGraph
from .core.spmd import SpmdEngine
from .device import resolve_device
from .models import ModelConfig, get_api
from .models.common import ParamDef, iter_defs

PlanArrays = Dict[str, object]


def plan_arrays(plan) -> PlanArrays:
    """The plan's serving state as numpy arrays and ints."""
    g = plan.graph
    return {"s": np.asarray(g.s, np.int32), "p": np.asarray(g.p, np.int32),
            "o": np.asarray(g.o, np.int32),
            "num_vertices": int(g.num_vertices),
            "num_properties": int(g.num_properties),
            "site_edge_ids": [np.asarray(e, np.int64)
                              for e in plan.site_edge_ids()],
            "replicated_props": sorted(int(p)
                                       for p in plan.replicated_props)}


def engine_from_arrays(arrays: PlanArrays,
                       device: Union[str, torch.device] = "cuda",
                       **engine_kw) -> SpmdEngine:
    """Build an ``SpmdEngine`` from ``plan_arrays`` output.
    ``engine_kw`` are ``SpmdEngine`` arguments (``num_devices``,
    ``capacity``, ``max_capacity``, ``comm_plan``, ``routing``)."""
    graph = RDFGraph(arrays["s"], arrays["p"], arrays["o"],
                     arrays["num_vertices"], arrays["num_properties"])
    site_edge_ids: List[np.ndarray] = list(arrays["site_edge_ids"])
    return SpmdEngine(graph, site_edge_ids, device=device,
                      replicated_props=set(arrays["replicated_props"]),
                      **engine_kw)


def _edges_array(q) -> np.ndarray:
    """A query graph's edges as an (n, 3) int64 array of (src, dst,
    prop)."""
    return np.asarray([(e.src, e.dst, e.prop) for e in q.edges],
                      np.int64).reshape(-1, 3)


def _minterm_array(mt) -> Optional[np.ndarray]:
    """A minterm's terms as a (k, 3) int64 array of (var, value, equal),
    or ``None`` for a fragment without one."""
    if mt is None:
        return None
    return np.asarray([(t.var, t.value, int(bool(t.equal)))
                       for t in mt.terms], np.int64).reshape(-1, 3)


def plan_state_arrays(plan) -> PlanArrays:
    """A plan of either package, of any strategy, as numpy arrays, ints,
    strings and lists of them: the graph, the fragments (edge ids,
    pattern index, minterm, card, kind) and cold fragments, the
    allocation's ``site_of``, the baseline per-site storage and its
    name, the selected patterns' edges, the cold and replicated
    properties and the config's fields.  Reads attributes only."""
    g = plan.graph
    out: PlanArrays = {
        "strategy": str(plan.strategy),
        "config": dict(dataclasses.asdict(plan.config)),
        "s": np.asarray(g.s, np.int32), "p": np.asarray(g.p, np.int32),
        "o": np.asarray(g.o, np.int32),
        "num_vertices": int(g.num_vertices),
        "num_properties": int(g.num_properties),
        "selected_patterns": [_edges_array(q)
                              for q in plan.selected_patterns],
        "cold_props": sorted(int(p) for p in plan.cold_props),
        "replicated_props": sorted(int(p) for p in plan.replicated_props),
        "frag": None, "site_of": None, "baseline": None}
    if plan.frag is not None:
        out["frag"] = {
            "kind": str(plan.frag.kind),
            "edge_ids": [np.asarray(f.edge_ids, np.int64)
                         for f in plan.frag.fragments],
            "pattern_idx": [int(f.pattern_idx) for f in plan.frag.fragments],
            "minterm_terms": [_minterm_array(f.minterm)
                              for f in plan.frag.fragments],
            "card": [int(f.card) for f in plan.frag.fragments],
            "kinds": [str(f.kind) for f in plan.frag.fragments],
            "cold_edge_ids": [np.asarray(f.edge_ids, np.int64)
                              for f in plan.frag.cold_fragments],
            "cold_kinds": [str(f.kind) for f in plan.frag.cold_fragments]}
    if plan.alloc is not None:
        out["site_of"] = np.asarray(plan.alloc.site_of, np.int64)
    if plan.baseline_frag is not None:
        out["baseline"] = {
            "name": str(plan.baseline_frag.name),
            "site_edges": [np.asarray(e, np.int64)
                           for e in plan.baseline_frag.site_edges]}
    return out


def plan_from_state_arrays(arrays: PlanArrays) -> PartitionPlan:
    """This package's ``PartitionPlan`` from ``plan_state_arrays``
    output, with its ``DataDictionary`` rebuilt (the offline phase does
    not run again).  The design workload and selection provenance are
    not carried."""
    cfg = PartitionConfig(**arrays["config"])
    graph = RDFGraph(arrays["s"], arrays["p"], arrays["o"],
                     arrays["num_vertices"], arrays["num_properties"])
    patterns = [QueryGraph.make(tuple(int(x) for x in row) for row in e)
                for e in arrays["selected_patterns"]]
    frag = alloc = dictionary = baseline = None
    fa = arrays["frag"]
    if fa is not None:
        frags = []
        for i, eids in enumerate(fa["edge_ids"]):
            terms = fa["minterm_terms"][i]
            # a minterm splits its own fragment's pattern
            mt = None if terms is None else MintermPredicate(
                fa["pattern_idx"][i],
                tuple(SimplePredicate(int(v), int(val), bool(eq))
                      for v, val, eq in terms))
            frags.append(Fragment(np.asarray(eids, np.int64),
                                  fa["pattern_idx"][i], mt, fa["card"][i],
                                  fa["kinds"][i]))
        cold = [Fragment(np.asarray(e, np.int64), -1, None, 0, k)
                for e, k in zip(fa["cold_edge_ids"], fa["cold_kinds"])]
        frag = Fragmentation(frags, list(patterns), fa["kind"], cold)
    if arrays["site_of"] is not None:
        alloc = Allocation(np.asarray(arrays["site_of"], np.int64),
                           cfg.num_sites)
    if frag is not None and alloc is not None:
        dictionary = DataDictionary.build(graph, frag, alloc, cfg.num_sites)
    if arrays["baseline"] is not None:
        b = arrays["baseline"]
        baseline = BaselineFragmentation(
            [np.asarray(e, np.int64) for e in b["site_edges"]], b["name"])
    return PartitionPlan(
        strategy=arrays["strategy"], config=cfg, graph=graph,
        selected_patterns=patterns, frag=frag, alloc=alloc,
        dictionary=dictionary, cold_props=set(arrays["cold_props"]),
        baseline_frag=baseline,
        replicated_props=set(arrays["replicated_props"]))


def _tensor(a: Any) -> torch.Tensor:
    """A host array as a CPU tensor: a torch tensor as it is, a numpy
    array copied, numpy's bfloat16 extension type (which torch cannot
    read) through its 16-bit pattern."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.array(a)                 # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# The JAX trees stack layers on a leading axis: ``layers.*`` (the
# transformer LM, rwkv) and ``blocks.*`` (jamba's super-blocks), each
# index a module of the port's ``blocks`` list; jamba's
# ``blocks.moe_layers.*`` and ``blocks.dense_layers.*`` stack the
# sublayers of a block on a second axis ([nb, n_sub, ...]), each a
# module of that block's list of the same name.
_STACKED = ("layers", "blocks")
_SUBLAYERS = ("moe_layers", "dense_layers")


def _leaf_names(keys: List[str], d: ParamDef
                ) -> List[Tuple[Tuple[int, ...], str]]:
    """The port's parameter names holding the JAX leaf at ``keys``, each
    with its index into the leaf's stacked axes (``()`` for an
    unstacked leaf), in row-major order."""
    if keys[0] not in _STACKED:
        return [((), ".".join(keys))]
    if len(keys) > 2 and keys[1] in _SUBLAYERS:
        return [((i, j), ".".join(["blocks", str(i), keys[1], str(j)]
                                  + keys[2:]))
                for i in range(d.shape[0]) for j in range(d.shape[1])]
    return [((i,), ".".join(["blocks", str(i)] + keys[1:]))
            for i in range(d.shape[0])]


def _tree_leaf(tree: Dict[str, Any], path: str, d: ParamDef) -> torch.Tensor:
    leaf = tree
    for k in path.split("."):
        leaf = leaf[k]
    src = _tensor(leaf)
    if tuple(src.shape) != d.shape:
        raise ValueError(f"{path}: shape {tuple(src.shape)}, expected "
                         f"{d.shape}")
    return src


@torch.no_grad()
def lm_params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                         device: Union[str, torch.device] = "cuda"
                         ) -> nn.Module:
    """Build the port's model for ``cfg`` (``get_api(cfg).module``: the
    ``LM``, ``RWKV`` or ``Jamba``) on ``device`` holding the weights of
    a JAX-layout tree (the family's ``defs`` structure, numpy leaves,
    stacked as ``_leaf_names`` reads them), each cast to the dtype of
    its port ``ParamDef``.  The tree is the config's: MoE layers
    (``layers.moe``: the float32 router, [L, E, D, F] experts,
    ``shared``), QKV biases, no ``embed`` with ``embed_inputs``."""
    api = get_api(cfg)
    model = api.module(cfg, resolve_device(device))
    named = dict(model.named_parameters())
    for path, d in iter_defs(api.defs(cfg)):
        src = _tree_leaf(tree, path, d)
        for idx, name in _leaf_names(path.split("."), d):
            named[name].copy_(src[idx])
    return model


def _host_leaf(t: torch.Tensor) -> Any:
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _stack_named(named: Dict[str, torch.Tensor], cfg: ModelConfig
                 ) -> Dict[str, Any]:
    """A dict keyed by the model's parameter names as the JAX-layout
    tree, stacked leaves stacked on the host."""
    tree: Dict[str, Any] = {}
    for path, d in iter_defs(get_api(cfg).defs(cfg)):
        keys = path.split(".")
        names = _leaf_names(keys, d)
        if names == [((), path)]:
            leaf = named[path]
        else:
            leaf = torch.stack([named[n].detach().cpu() for _, n in names]
                               ).reshape(d.shape)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _host_leaf(leaf)
    return tree


def _unstack(tree: Dict[str, Any], cfg: ModelConfig,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """The inverse of ``_stack_named``, each leaf copied to ``device``
    in the dtype it has in ``tree``."""
    named: Dict[str, torch.Tensor] = {}
    for path, d in iter_defs(get_api(cfg).defs(cfg)):
        src = _tree_leaf(tree, path, d)
        for idx, name in _leaf_names(path.split("."), d):
            named[name] = src[idx].to(device, copy=True)
    return named


def lm_params_to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The model's weights (any family) as a JAX-layout tree on the host
    (the inverse of ``lm_params_from_numpy``): stacked leaves stacked
    again; numpy arrays, except bf16 leaves, which numpy cannot hold and
    stay CPU ``torch.bfloat16`` tensors (``save_checkpoint`` writes them
    as the JAX package's bfloat16 leaves)."""
    return _stack_named(dict(model.named_parameters()), model.cfg)


def adamw_state_to_numpy(state: Dict[str, Any], cfg: ModelConfig
                         ) -> Dict[str, Any]:
    """The train step's AdamW state (moments keyed by the model's
    parameter names) in the JAX package's layout: ``m`` and ``v`` as
    ``lm_params_to_numpy`` lays out the weights, ``step`` an int32
    scalar."""
    return {"m": _stack_named(state["m"], cfg),
            "v": _stack_named(state["v"], cfg),
            "step": np.asarray(int(state["step"]), np.int32)}


def adamw_state_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                           device: Union[str, torch.device] = "cuda"
                           ) -> Dict[str, Any]:
    """The inverse of ``adamw_state_to_numpy`` on ``device``: the moments
    in the dtype the tree holds them, the step an int32 scalar."""
    dev = resolve_device(device)
    return {"m": _unstack(tree["m"], cfg, dev),
            "v": _unstack(tree["v"], cfg, dev),
            "step": torch.tensor(int(_tensor(tree["step"])),
                                 dtype=torch.int32, device=dev)}
