"""The port's LM serving path vs the JAX package, on the qwen3 smoke
config (2 layers, width 64, 4/2 heads, head_dim 16).

Weights are the JAX package's ``init_params`` draw, carried into the
port with ``convert.lm_params_from_numpy``; tokens come from seeded
numpy.  At sequence 256 the JAX ``ops.attention`` runs the Pallas flash
kernel (interpret mode), and the port's ``ops.attention`` its plain
version.  Tolerances: 1e-4 in float32; 0.25 in bf16, the JAX package's
own bf16 model tolerance (``tests/test_archs.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import qwen3_1_7b as jqwen3
from repro.launch import serve as jserve
from repro.models import get_api as j_get_api
from repro.models import init_params as j_init_params
from repro.models import param_count as j_param_count
from repro.models.common import is_def as j_is_def
from repro_torch import convert
from repro_torch.configs import qwen3_1_7b as tqwen3
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve as t_serve
from repro_torch.launch.steps import make_forward_step
from repro_torch.models import build_lm, get_api, param_count
from repro_torch.models.common import iter_defs
from repro_torch.models.lm import lm_defs

ARCH = "qwen3-1.7b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.25)}


def _configs(dtype, flash=True, **changes):
    jd, td, _tol = DTYPES[dtype]
    return (dataclasses.replace(jqwen3.SMOKE, dtype=jd,
                                use_flash_kernel=flash, **changes),
            dataclasses.replace(tqwen3.SMOKE, dtype=td,
                                use_flash_kernel=flash, **changes))


def _jax_params(jcfg, seed=0):
    return j_init_params(j_get_api(jcfg).defs(jcfg), jax.random.PRNGKey(seed))


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture
def no_launches():
    """Every wrapper on the path got CPU tensors: no kernel launched."""
    ops.reset_launches()
    yield
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


@pytest.mark.parametrize("cfg_name", ["config", "smoke"])
def test_param_tree_matches_jax(cfg_name):
    """Same leaves, shapes and init rules as the JAX ``lm_defs``; the
    full config has qwen3-1.7b's 2.03 G parameters."""
    jcfg = getattr(jqwen3.SPEC, cfg_name)
    tcfg = getattr(tqwen3.SPEC, cfg_name)
    jdefs = j_get_api(jcfg).defs(jcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(jdefs, is_leaf=j_is_def)[0]
    jmap = {".".join(k.key for k in path): d for path, d in jleaves}
    tmap = dict(iter_defs(lm_defs(tcfg)))
    assert sorted(jmap) == list(tmap)
    for path, d in tmap.items():
        assert (d.shape, d.axes, d.init, d.scale) == (
            jmap[path].shape, jmap[path].axes, jmap[path].init,
            jmap[path].scale), path
    assert param_count(lm_defs(tcfg)) == j_param_count(jdefs)
    if cfg_name == "config":
        assert param_count(lm_defs(tcfg)) == 2_031_739_904


def test_build_is_seeded():
    a = build_lm(tqwen3.SMOKE, device="cpu", seed=3)
    b = build_lm(tqwen3.SMOKE, device="cpu", seed=3)
    c = build_lm(tqwen3.SMOKE, device="cpu", seed=4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(("wq", "embed")):
            assert not torch.equal(pa, pc), name
    assert a.blocks[0].ln1.dtype == torch.float32
    assert a.blocks[0].attn.wq.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype,changes", [
    ("float32", {}), ("bfloat16", {}),
    # the reference's tied head and logit softcap (no shipped config
    # sets them)
    ("float32", {"tie_embeddings": True, "logit_softcap": 30.0})],
    ids=["float32", "bfloat16", "float32-tied-softcap"])
def test_forward_with_flash_matches_jax(dtype, changes, no_launches):
    jcfg, tcfg = _configs(dtype, **changes)
    params = _jax_params(jcfg)
    model = convert.lm_params_from_numpy(_numpy_tree(params), tcfg,
                                         device="cpu")
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 256)).astype(np.int32)
    want, _ = j_get_api(jcfg).apply(jcfg, params, jnp.asarray(toks))
    got = make_forward_step(tcfg)(model, torch.from_numpy(toks))
    assert got.shape == (2, 256, tcfg.vocab_size) and got.dtype == tcfg.dtype
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), _f32(want), atol=tol,
                               rtol=tol)


def test_decode_loop_matches_jax(no_launches):
    """Token-by-token prompt feed, then greedy decoding over the KV
    cache: identical tokens, logits within 1e-4 at every step."""
    jcfg, tcfg = _configs("float32", flash=False)
    params = _jax_params(jcfg)
    model = convert.lm_params_from_numpy(_numpy_tree(params), tcfg,
                                         device="cpu")
    japi, tapi = j_get_api(jcfg), get_api(tcfg)
    B, prompt_len, gen_len = 2, 8, 8
    prompts = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (B, prompt_len)).astype(np.int32)
    jdecode = jax.jit(functools.partial(japi.decode, jcfg))
    jcache = japi.init_cache(jcfg, B, prompt_len + gen_len)
    tcache = tapi.init_cache(tcfg, B, prompt_len + gen_len, "cpu")
    jtok = ttok = None
    for t in range(prompt_len + gen_len):
        jin = jnp.asarray(prompts[:, t]) if t < prompt_len else jtok
        tin = torch.from_numpy(prompts[:, t]) if t < prompt_len else ttok
        jlog, jcache = jdecode(params, jin, jcache, jnp.int32(t))
        tlog, tcache = tapi.decode(tcfg, model, tin, tcache, t)
        np.testing.assert_allclose(tlog.numpy(), _f32(jlog), atol=1e-4,
                                   rtol=1e-4)
        jtok = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tlog, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_serve_matches_jax(monkeypatch, no_launches):
    """``serve()`` of both packages on the same float32 weights: the same
    prompts and identical greedy tokens."""
    jcfg, tcfg = _configs("float32", flash=False)
    monkeypatch.setitem(jconfigs.ARCHS, ARCH, dataclasses.replace(
        jqwen3.SPEC, smoke=jcfg))
    want = jserve.serve(ARCH, batch=2, prompt_len=8, gen_len=6, seed=0)
    model = convert.lm_params_from_numpy(
        _numpy_tree(_jax_params(jcfg, seed=0)), tcfg, device="cpu")
    got = t_serve(ARCH, batch=2, prompt_len=8, gen_len=6, seed=0,
                  device="cpu", model=model)
    assert got.tokens.shape == (2, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.prefill_sec > 0 and got.tokens_per_sec > 0


def test_forward_matches_decode_in_the_port(no_launches):
    """The flash forward's last-position logits equal the decode loop's
    at the last prompt token (what the chip smoke checks at full
    width)."""
    _jcfg, tcfg = _configs("float32")
    model = build_lm(tcfg, device="cpu", seed=5)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (3, 20)).astype(np.int32))
    full = make_forward_step(tcfg)(model, toks)
    api = get_api(tcfg)
    cache = api.init_cache(tcfg, 3, 20, "cpu")
    for t in range(20):
        logits, cache = api.decode(tcfg, model, toks[:, t], cache, t)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("field", ["fsdp", "seq_shard_decode"])
def test_sharding_fields_reach_the_rules(field):
    """``fsdp`` and ``seq_shard_decode`` are accepted, as the reference's
    ``ModelConfig`` accepts them, and reach ``launch.steps._rules_for``
    as the reference's: FSDP shards the embed axis over "data" (then
    "pod"), and the decode rules shard the cache's sequence on
    "model"; a config without them gets neither."""
    from repro.launch.steps import _rules_for as j_rules_for
    from repro_torch.launch.steps import _rules_for
    cfg = dataclasses.replace(tqwen3.SMOKE, **{field: True})
    jcfg = dataclasses.replace(jqwen3.SMOKE, **{field: True})
    assert getattr(cfg, field) is True
    for decode in (False, True):
        assert _rules_for(cfg, decode) == j_rules_for(jcfg, decode)
        assert _rules_for(tqwen3.SMOKE, decode) == j_rules_for(
            jqwen3.SMOKE, decode)
    if field == "fsdp":
        assert _rules_for(cfg, False)["embed"] == [("data",), ("pod",)]
        assert _rules_for(tqwen3.SMOKE, False)["embed"] == []
    else:
        assert _rules_for(cfg, True)["cache_seq"] == [("model",)]
        assert _rules_for(cfg, False)["cache_seq"] == []
        assert _rules_for(tqwen3.SMOKE, True)["cache_seq"] == []


@pytest.mark.parametrize("change", [{"expert_affinity_placement": True},
                                    {"family": "ssm"},
                                    {"family": "rwkv"},
                                    {"family": "hybrid", "num_layers": 12}])
def test_unported_options_raise(change):
    """What the port still refuses: the reference field it has no
    counterpart for (a ``TypeError`` when the config is made), a family
    no package has (``KeyError``), the transformer ``LM`` built for
    another family (it names ``get_api``), and a jamba whose layers are
    not a multiple of ``attn_every`` (``ValueError``, as the
    reference's ``jamba.py:28-31``)."""
    if "family" not in change:
        with pytest.raises(TypeError, match=next(iter(change))):
            dataclasses.replace(tqwen3.SMOKE, **change)
        return
    cfg = dataclasses.replace(tqwen3.SMOKE, **change)
    if cfg.family == "ssm":
        with pytest.raises(KeyError, match="unknown model family"):
            get_api(cfg)
    elif cfg.family == "rwkv":
        with pytest.raises(NotImplementedError, match="get_api"):
            build_lm(cfg, device="cpu")
    else:
        with pytest.raises(ValueError, match="multiple of attn_every"):
            get_api(cfg).build(cfg, "cpu", 0)
