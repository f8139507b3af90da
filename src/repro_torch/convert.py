"""Carry a plan, or an LM's weights, across packages as plain numpy
arrays.

``plan_arrays`` reads what the SPMD engine needs from a plan of either
package (graph triples and id-space sizes, per-site edge ids, the
replicated properties) without importing the other package: it only
reads attributes.  ``engine_from_arrays`` builds this package's
``SpmdEngine`` from those arrays, so a reference plan and the port are
served from identical per-site storage.  ``lm_params_from_numpy`` loads
a JAX-layout parameter tree (numpy arrays, stacked ``layers`` axis)
into this package's ``LM``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np
import torch

from .core.graph import RDFGraph
from .core.spmd import SpmdEngine
from .device import resolve_device
from .models import LM, ModelConfig
from .models.common import iter_defs
from .models.lm import lm_defs

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


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor; numpy's bfloat16 extension type
    (which torch cannot read) goes through its 16-bit pattern."""
    a = np.array(a)                 # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def lm_params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                         device: Union[str, torch.device] = "cuda") -> LM:
    """Build the port's ``LM`` for ``cfg`` on ``device`` holding the
    weights of a JAX-layout tree (``repro.models.lm.lm_defs`` structure,
    numpy leaves, layer leaves stacked on a leading ``layers`` axis),
    each cast to the dtype of its port ``ParamDef``."""
    model = LM(cfg, resolve_device(device))
    for path, d in iter_defs(lm_defs(cfg)):
        keys = path.split(".")
        leaf = tree
        for k in keys:
            leaf = leaf[k]
        src = _tensor(np.asarray(leaf))
        if tuple(src.shape) != d.shape:
            raise ValueError(f"{path}: shape {tuple(src.shape)}, expected "
                             f"{d.shape}")
        if keys[0] == "layers":
            for i, blk in enumerate(model.blocks):
                getattr(blk.get_submodule(".".join(keys[1:-1])),
                        keys[-1]).copy_(src[i])
        else:
            getattr(model, keys[0]).copy_(src)
    return model
