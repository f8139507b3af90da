"""Expert placement (the paper's Def. 13 + Algorithm 2 applied to MoE
experts): the port's numpy copy against the JAX package's on the same
routing, exactly, and the JAX package's own placement tests on the
port.

Routings: ``tests/test_placement.py``'s ``_clustered_routing`` (two
cliques of interleaved expert ids), uniform random top-k, and the
port's own MoE router on the qwen2-moe smoke config.
"""
import numpy as np
import pytest
import torch

import test_placement as reference_placement_tests
from repro.core.allocation import allocate_experts as j_allocate_experts
from repro.models import placement as jp
from repro_torch.configs import qwen2_moe_a2_7b as tqwen2moe
from repro_torch.core import allocate_experts
from repro_torch.models import build_lm
from repro_torch.models import placement as tp
from repro_torch.models.layers import moe_routing

_clustered_routing = reference_placement_tests._clustered_routing


def _uniform_routing(T=1500, E=16, K=4, seed=3):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(E, size=K, replace=False)
                     for _ in range(T)]).astype(np.int64)


def _model_routing():
    """Top-4 of 8 experts from the port's router on layer 0 of a seeded
    qwen2-moe smoke model, for 256 seeded hidden states."""
    cfg = tqwen2moe.SMOKE
    model = build_lm(cfg, device="cpu", seed=4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 256, cfg.d_model)).astype(np.float32)).to(cfg.dtype)
    return moe_routing(cfg, model.blocks[0].moe, x)["idx"].reshape(
        -1, cfg.top_k).numpy().astype(np.int64)


ROUTINGS = {"clustered": (_clustered_routing, 8),
            "uniform": (_uniform_routing, 16),
            "model": (_model_routing, 8)}


@pytest.mark.parametrize("num_shards", [2, 4])
@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_placement_matches_jax(routing, num_shards):
    make, E = ROUTINGS[routing]
    idx = make()
    co = tp.coactivation_from_topk(idx, E)
    np.testing.assert_array_equal(co, jp.coactivation_from_topk(idx, E))
    shard_of = allocate_experts(co, num_shards)
    np.testing.assert_array_equal(shard_of, j_allocate_experts(co,
                                                               num_shards))
    assert np.bincount(shard_of, minlength=num_shards).tolist() == \
        [E // num_shards] * num_shards
    np.testing.assert_array_equal(
        tp.affinity_expert_permutation(co, num_shards),
        jp.affinity_expert_permutation(co, num_shards))
    assert tp.cross_shard_traffic(co, shard_of) == \
        jp.cross_shard_traffic(co, shard_of)
    got = tp.placement_report(idx, E, num_shards)
    want = jp.placement_report(idx, E, num_shards)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", ["test_coactivation_symmetric",
                                  "test_affinity_placement_beats_naive",
                                  "test_permutation_is_valid"])
def test_reference_placement_tests_on_the_port(name, monkeypatch):
    """The JAX package's placement tests with the port's functions in
    place of the names they imported (the two cliques come out as
    contiguous halves; affinity placement cuts cross-shard traffic
    below a fifth of the naive placement's)."""
    for fn in ("affinity_expert_permutation", "coactivation_from_topk",
               "cross_shard_traffic", "placement_report"):
        monkeypatch.setattr(reference_placement_tests, fn, getattr(tp, fn))
    getattr(reference_placement_tests, name)()
