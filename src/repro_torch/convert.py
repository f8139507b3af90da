"""Carry a plan across packages as plain numpy arrays.

``plan_arrays`` reads what the SPMD engine needs from a plan of either
package (graph triples and id-space sizes, per-site edge ids, the
replicated properties) without importing the other package: it only
reads attributes.  ``engine_from_arrays`` builds this package's
``SpmdEngine`` from those arrays, so a reference plan and the port are
served from identical per-site storage.
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from .core.graph import RDFGraph
from .core.spmd import SpmdEngine

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
