"""The port's MoE layer against the JAX package's ``moe_apply`` on the
same layer weights (the reference's ``init_params`` draw, carried with
``convert.lm_params_from_numpy``) and the same seeded numpy inputs.

In float32 the routing is held exactly: the experts each assignment
goes to, and which assignments the capacity drops.  The reference's
drops are read from its own output: a token whose y at the tested
capacity differs from its y at an ample one (8.0: no expert can fill)
lost an assignment.  y and the aux loss agree within 1e-4 in float32 in
all four dispatch modes (flat, grouped, batched, ``moe_shard_map`` on
one device) and at S = 1.  bf16 routing is checked at the model level
only (``test_torch_archs.py``): the two packages round RMSNorm's bf16
output apart by an ulp, which can flip a near-tie in the top-k.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_moe_a2_7b as jqwen2moe
from repro.models import ModelConfig as JModelConfig
from repro.models import get_api as j_get_api
from repro.models import init_params as j_init_params
from repro.models.layers import moe_apply as j_moe_apply
from repro.models.layers import moe_capacity as j_moe_capacity
from repro_torch import convert
from repro_torch.configs import qwen2_moe_a2_7b as tqwen2moe
from repro_torch.models import ModelConfig, build_lm, get_api
from repro_torch.models.layers import moe_apply, moe_capacity, moe_routing

TOL = 1e-4
# tests/test_moe_paths.py's BASE config (float32 here)
BASE = dict(name="moe", family="moe", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            num_experts=8, top_k=2, moe_d_ff=64, capacity_factor=8.0)
MODES = {"flat": {}, "grouped": {"moe_grouped_dispatch": True},
         "batched": {"moe_sharded_ffn": True},
         "shard_map": {"moe_shard_map": True}}
# test_moe_paths.py holds the dispatches to each other at this tolerance
PATHS_ATOL = 1e-6


def _configs(dtype="float32", base=BASE, **changes):
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    return (JModelConfig(**{**base, "dtype": jd, **changes}),
            ModelConfig(**{**base, "dtype": td, **changes}))


def _layer(jcfg, tcfg, seed=0):
    """Layer 0's MoE weights of both packages, from one JAX draw."""
    params = j_init_params(j_get_api(jcfg).defs(jcfg),
                           jax.random.PRNGKey(seed))
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return jax.tree.map(lambda a: a[0], params["layers"]["moe"]), \
        model.blocks[0].moe


@pytest.fixture(scope="module")
def base_layer():
    jcfg, tcfg = _configs()
    return _layer(jcfg, tcfg)


@pytest.fixture(scope="module")
def qwen2moe_layer():
    """The qwen2-moe smoke config's layer: 8 experts, top-4, 2 shared."""
    base = {f.name: getattr(tqwen2moe.SMOKE, f.name)
            for f in dataclasses.fields(tqwen2moe.SMOKE)
            if f.name != "dtype"}
    jcfg, tcfg = _configs(base=base)
    return base, _layer(jcfg, tcfg, seed=1)


def _x(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _run_both(jcfg, tcfg, jl, tl, x, perm=None):
    jy, jaux = j_moe_apply(jcfg, jl, jnp.asarray(x),
                           expert_perm=None if perm is None
                           else jnp.asarray(perm))
    ty, taux = moe_apply(tcfg, tl, torch.from_numpy(x), expert_perm=perm)
    return (_f32(jy), float(jaux)), (_f32(ty), float(taux))


def _jax_topk(jcfg, jl, x):
    """The reference's routing of every token (gates, softmax,
    ``jax.lax.top_k``) as [B*S, K] expert ids."""
    gates = jnp.asarray(x).reshape(-1, x.shape[-1]) @ jl["router"]
    return np.asarray(jax.lax.top_k(jax.nn.softmax(gates, -1),
                                    jcfg.top_k)[1])


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
@pytest.mark.parametrize("mode", list(MODES))
def test_moe_apply_matches_jax(mode, capacity_factor, base_layer):
    """y and aux within 1e-4; the same experts for every token; the
    same tokens lose an assignment to the capacity; at 8.0 none does."""
    jl, tl = base_layer
    jcfg, tcfg = _configs(capacity_factor=capacity_factor, **MODES[mode])
    x = _x((4, 32, 64))
    (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, jl, tl, x)
    np.testing.assert_allclose(ty, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(taux, jaux, atol=TOL, rtol=TOL)

    route = moe_routing(tcfg, tl, torch.from_numpy(x))
    np.testing.assert_array_equal(route["idx"].reshape(-1, 2).numpy(),
                                  _jax_topk(jcfg, jl, x))
    lost = ~route["keep"].reshape(4, 32, 2).numpy().all(-1)
    jfull, _ = j_moe_apply(dataclasses.replace(jcfg, capacity_factor=8.0),
                           jl, jnp.asarray(x))
    jlost = np.abs(_f32(jfull) - jy).max(-1) > TOL
    np.testing.assert_array_equal(lost, jlost)
    if capacity_factor == 8.0:
        assert not lost.any()
    else:
        assert lost.any()
        assert int(route["loads"].max()) > route["capacity"]


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
@pytest.mark.parametrize("mode", list(MODES))
def test_moe_decode_step_matches_jax(mode, capacity_factor, base_layer):
    """S = 1 (decode) is flat in every mode."""
    jl, tl = base_layer
    jcfg, tcfg = _configs(capacity_factor=capacity_factor, **MODES[mode])
    x = _x((12, 1, 64), seed=6)
    (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, jl, tl, x)
    np.testing.assert_allclose(ty, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(taux, jaux, atol=TOL, rtol=TOL)
    assert moe_routing(tcfg, tl, torch.from_numpy(x))["idx"].shape[0] == 1


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_shared_experts_top4_match_jax(capacity_factor, qwen2moe_layer):
    """qwen2-moe's layer (top-4 of 8, two shared experts) in the flat and
    the production (``moe_shard_map``) dispatch."""
    base, (jl, tl) = qwen2moe_layer
    x = _x((2, 24, base["d_model"]), seed=7)
    for changes in ({}, {"moe_shard_map": True}):
        jcfg, tcfg = _configs(base=base, capacity_factor=capacity_factor,
                              **changes)
        (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, jl, tl, x)
        np.testing.assert_allclose(ty, jy, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(taux, jaux, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cfg_name", ["base", "qwen2-moe"])
def test_moe_capacity_matches_jax(cfg_name):
    if cfg_name == "base":
        jcfg, tcfg = _configs()
    else:
        jcfg, tcfg = jqwen2moe.CONFIG, tqwen2moe.CONFIG
    for cf in (1.0, 1.25, 8.0):
        jc = dataclasses.replace(jcfg, capacity_factor=cf)
        tc = dataclasses.replace(tcfg, capacity_factor=cf)
        for n in list(range(1, 70)) + [512, 4096, 8192, 32768]:
            assert moe_capacity(tc, n) == j_moe_capacity(jc, n), (cf, n)
            assert moe_capacity(tc, n) % 8 == 0
    # the chip smoke's production shapes
    assert moe_capacity(tqwen2moe.CONFIG, 2 * 4096) == 688
    assert moe_capacity(tqwen2moe.CONFIG, 4096) == 344


# ----------------------------------------------------------------------
# tests/test_moe_paths.py's equivalences, on the port (bf16, as there)
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def paths_setup():
    _jcfg, tcfg = _configs("bfloat16")
    model = build_lm(tcfg, device="cpu", seed=0)
    x = torch.from_numpy(_x((4, 16, 64))).to(torch.bfloat16)
    return tcfg, model.blocks[0].moe, x


@pytest.mark.parametrize("mode", ["grouped", "batched", "shard_map"])
def test_dispatch_paths_equal_flat(mode, paths_setup):
    cfg, layer, x = paths_setup
    y0, _ = moe_apply(cfg, layer, x)
    y1, _ = moe_apply(dataclasses.replace(cfg, **MODES[mode]), layer, x)
    np.testing.assert_allclose(_f32(y1), _f32(y0), atol=PATHS_ATOL)


def test_capacity_drops_are_bounded():
    """At capacity factor 1.0, dropped tokens produce zero (not NaN)."""
    _jcfg, tcfg = _configs("bfloat16", capacity_factor=1.0)
    model = build_lm(tcfg, device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 32)).astype(np.int32))
    logits, aux = get_api(tcfg).apply(tcfg, model, x)
    assert not bool(torch.isnan(logits).any())
    assert np.isfinite(float(aux))


def test_moe_permutation_invariance():
    """tests/test_placement.py:59 on the port: relabelling experts with
    ``expert_perm`` and permuting their weights to match leaves the
    output unchanged; the JAX package agrees on the relabelled layer."""
    base = dict(name="m", family="moe", num_layers=1, d_model=32,
                num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                vocab_size=64, num_experts=4, top_k=2, moe_d_ff=32,
                capacity_factor=8.0)
    jcfg, tcfg = _configs(base=base)
    jl, tl = _layer(jcfg, tcfg)
    x = _x((2, 8, 32), seed=2)
    perm = [2, 0, 3, 1]
    y0, _ = moe_apply(tcfg, tl, torch.from_numpy(x))
    with torch.no_grad():
        for k in ("w1", "w3", "w2"):
            getattr(tl, k).copy_(getattr(tl, k)[perm].clone())
    y1, _ = moe_apply(tcfg, tl, torch.from_numpy(x), expert_perm=perm)
    np.testing.assert_allclose(_f32(y1), _f32(y0), atol=1e-6)
    jl = dict(jl, **{k: jl[k][jnp.asarray(perm)] for k in ("w1", "w3", "w2")})
    (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, jl, tl, x, perm=perm)
    np.testing.assert_allclose(ty, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(taux, jaux, atol=TOL, rtol=TOL)
