"""Expert placement from token co-activation: the paper's bridge from
the LM to the RDF side, copied from the JAX package (numpy).

The paper's fragment affinity (Def. 13) and Algorithm 2 clustering
apply verbatim to MoE experts: tokens are the workload, experts are the
fragments, and aff(e, e') = # tokens routing to both.  Clustering
co-activated experts onto the same shard turns cross-shard combine
traffic into local adds under expert-parallel layouts.

Usage: collect routing statistics (top-k indices, e.g.
``layers.moe_routing``'s ``idx``) from calibration batches, build the
co-activation matrix, and relabel experts with the returned permutation
(contiguous ids land on the same shard under contiguous expert
sharding).  ``moe_apply(..., expert_perm=...)`` applies the relabeling
at the router, so checkpointed expert weights stay put.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.allocation import allocate_experts


def coactivation_from_topk(idx: np.ndarray, num_experts: int) -> np.ndarray:
    """idx: [T, K] routed expert ids per token -> [E, E] co-activation."""
    T, _K = idx.shape
    onehot = np.zeros((T, num_experts), np.float64)
    np.put_along_axis(onehot, idx, 1.0, axis=1)
    co = onehot.T @ onehot
    np.fill_diagonal(co, 0.0)
    return co


def affinity_expert_permutation(coactivation: np.ndarray,
                                num_shards: int) -> np.ndarray:
    """Permutation p with p[new_id] = old_id: experts clustered by
    Algorithm 2 get contiguous new ids (same shard)."""
    shard_of = allocate_experts(coactivation, num_shards)
    # stable order: by (shard, old id)
    order = np.lexsort((np.arange(len(shard_of)), shard_of))
    return order.astype(np.int64)


def cross_shard_traffic(coactivation: np.ndarray, shard_of: np.ndarray
                        ) -> float:
    """Σ co-activations between experts on different shards -- the
    objective Algorithm 2 minimizes (lower = fewer cross-shard combines)."""
    diff = shard_of[:, None] != shard_of[None, :]
    return float((coactivation * diff).sum()) / 2.0


def placement_report(idx: np.ndarray, num_experts: int,
                     num_shards: int) -> Dict[str, object]:
    """Compare naive (contiguous id) placement vs affinity placement."""
    co = coactivation_from_topk(idx, num_experts)
    naive = np.arange(num_experts) * num_shards // num_experts
    smart = allocate_experts(co, num_shards)
    return {
        "naive_cross_traffic": cross_shard_traffic(co, naive),
        "affinity_cross_traffic": cross_shard_traffic(co, smart),
        "permutation": affinity_expert_permutation(co, num_shards),
    }
