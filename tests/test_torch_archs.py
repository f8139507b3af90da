"""The port's archs against the JAX package, on their smoke configs:
for all ten, parameter trees and counts, config fields, ``input_specs``,
``all_cells`` and the published dimensions; for the eight transformer
archs (rwkv and jamba: ``test_torch_rwkv.py``, ``test_torch_jamba.py``)
the forward
with the flash path on in float32 and bf16, the decode loop (mixtral's
16-token window wrapped), ``serve()``, ``input_specs``, ``all_cells``,
the published dimensions, ``lm_loss`` with its MoE aux loss and its
gradients, and MoE checkpoints through ``convert``.

Weights are the JAX package's ``init_params`` draw, carried into the
port with ``convert.lm_params_from_numpy``; inputs come from seeded
numpy (token ids, or [B, S, D] embeddings for the ``embed_inputs``
archs).  At sequence 256 the JAX ``ops.attention`` runs the Pallas
flash kernel in interpret mode, the port's ``ops.attention`` its plain
version.  Tolerances: 1e-4 in float32; 0.25 in bf16, the JAX package's
own (``tests/test_archs.py:123``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.launch import serve as jserve
from repro.launch.train import train as j_train
from repro.models import ModelConfig as JModelConfig
from repro.models import get_api as j_get_api
from repro.models import init_params as j_init_params
from repro.models import param_count as j_param_count
from repro.models import lm as jlm
from repro.models.common import is_def as j_is_def
from repro.models.layers import moe_capacity as j_moe_capacity
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve as t_serve
from repro_torch.launch.steps import make_forward_step
from repro_torch.launch.train import train as t_train
from repro_torch.models import ModelConfig, get_api, param_count
from repro_torch.models.common import iter_defs
from repro_torch.models import lm as tlm
from repro_torch.models.layers import moe_routing
from repro_torch.optim import AdamWConfig, adamw_init

ARCHS = sorted(tconfigs.ARCHS)
LM_ARCHS = [a for a in ARCHS
            if tconfigs.get_arch(a).config.family in ("dense", "moe")]
NEW_ARCHS = [a for a in LM_ARCHS if a != "qwen3-1.7b"]  # qwen3: test_torch_lm
MOE_ARCHS = ["mixtral-8x7b", "qwen2-moe-a2.7b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.25)}
# the JAX package's config fields that the port leaves out (the
# docstring of the port's ModelConfig says why)
UNPORTED_FIELDS = {"expert_affinity_placement"}
FORWARD_SHAPE = (2, 256)
# bf16 routing: a near-tie is a K-th and (K+1)-th router probability
# within 2^-10 (about a quarter of bf16's 2^-8 relative step at the
# probabilities' size, 1/8 to 1/4); at most 5% of positions may route
# apart (read on the CPU: mixtral's smoke config 3 of 512 positions,
# qwen2-moe's, top-4 of 8, 11 with other experts and 7 more keeping
# others behind a full expert)
BF16_ROUTING_TIE, BF16_APART_SHARE = 2.0 ** -10, 0.05
DECODE_B, DECODE_T = 2, 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor operations: one intra-op thread keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_launches():
    """Every wrapper on the path got CPU tensors: no kernel launched."""
    ops.reset_launches()
    yield
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


def _configs(arch, dtype="float32", **changes):
    jd, td, _tol = DTYPES[dtype]
    return (dataclasses.replace(jconfigs.get_arch(arch).smoke, dtype=jd,
                                **changes),
            dataclasses.replace(tconfigs.get_arch(arch).smoke, dtype=td,
                                **changes))


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype):
    """The JAX draw for the arch's smoke config in ``dtype`` and the
    port's model holding it (flash off: tests replace the config)."""
    jcfg, tcfg = _configs(arch, dtype)
    params = j_init_params(j_get_api(jcfg).defs(jcfg), jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return params, model


def _inputs(cfg, shape, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _dtype_name(dt):
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


# ----------------------------------------------------------------------
# Structure: trees, counts, config fields, specs, cells
# ----------------------------------------------------------------------

PUBLISHED_COUNTS = {"qwen2-moe-a2.7b": 14_315_735_040,
                    "rwkv6-1.6b": 1_583_941_632,
                    "jamba-1.5-large-398b": 398_555_111_424}


@pytest.mark.parametrize("cfg_name", ["config", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch, cfg_name):
    """Same leaves, shapes, axes, init rules and dtypes as the JAX
    family's ``defs``, and the same ``param_count``."""
    jcfg = getattr(jconfigs.get_arch(arch), cfg_name)
    tcfg = getattr(tconfigs.get_arch(arch), cfg_name)
    jdefs = j_get_api(jcfg).defs(jcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(jdefs, is_leaf=j_is_def)[0]
    jmap = {".".join(k.key for k in path): d for path, d in jleaves}
    tdefs = get_api(tcfg).defs(tcfg)
    tmap = dict(iter_defs(tdefs))
    assert sorted(jmap) == list(tmap)
    for path, d in tmap.items():
        j = jmap[path]
        assert (d.shape, d.axes, d.init, d.scale, _dtype_name(d.dtype)) == (
            j.shape, j.axes, j.init, j.scale, _dtype_name(j.dtype)), path
    assert param_count(tdefs) == j_param_count(jdefs)
    if cfg_name == "config" and arch in PUBLISHED_COUNTS:
        assert param_count(tdefs) == PUBLISHED_COUNTS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_jax(arch):
    """Every field the two ``ModelConfig``s share is equal in the
    published and the smoke config (dtypes by name), the production
    profile's overrides and the shapes too; the reference fields the
    port lacks are exactly ``UNPORTED_FIELDS``."""
    jnames = {f.name for f in dataclasses.fields(JModelConfig)}
    tnames = {f.name for f in dataclasses.fields(ModelConfig)}
    assert tnames <= jnames and jnames - tnames == UNPORTED_FIELDS
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for jcfg, tcfg in ((jspec.config, tspec.config),
                       (jspec.smoke, tspec.smoke),
                       (jspec.optimized_config(), tspec.optimized_config())):
        for name in sorted(tnames):
            a, b = getattr(jcfg, name), getattr(tcfg, name)
            if name == "dtype":
                a, b = _dtype_name(a), _dtype_name(b)
            assert a == b, (arch, name, a, b)
    assert tspec.optimized == jspec.optimized
    assert (tspec.source, tspec.notes) == (jspec.source, jspec.notes)
    assert {k: dataclasses.astuple(v)[:5] for k, v in tspec.shapes.items()} \
        == {k: dataclasses.astuple(v)[:5] for k, v in jspec.shapes.items()}


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tuple(tree.shape), _dtype_name(tree.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    """Every live shape, full and smoke: the port's meta tensors have
    the reference's ``ShapeDtypeStruct`` shapes and dtypes (the decode
    cache capped by mixtral's window: [32, 1, 4096, 8, 128] at
    long_500k)."""
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for sname, sh in tspec.shapes.items():
        if sh.skip:
            assert sh.skip_reason
            continue
        for smoke in (False, True):
            got = tconfigs.input_specs(tspec, sname, smoke=smoke)
            want = jconfigs.input_specs(jspec, sname, smoke=smoke)
            assert all(t.device.type == "meta"
                       for t in jax.tree.leaves(got))
            assert list(_spec_leaves(got)) == list(_spec_leaves(want))
    if arch == "mixtral-8x7b":
        cache = tconfigs.input_specs(tspec, "long_500k")["cache"]
        assert tuple(cache["k"].shape) == (32, 1, 4096, 8, 128)


def test_all_cells_match_jax():
    for skipped in (False, True):
        want = [c for c in jconfigs.all_cells(include_skipped=skipped)
                if c[0] in tconfigs.ARCHS]
        assert tconfigs.all_cells(include_skipped=skipped) == want
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)


def test_exact_published_configs():
    """tests/test_archs.py's published dimensions."""
    c = tconfigs.get_arch("mixtral-8x7b").config
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size, c.num_experts, c.top_k) == \
        (32, 4096, 32, 8, 14336, 32000, 8, 2)
    assert c.window == 4096
    c = tconfigs.get_arch("llama3-405b").config
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (126, 16384, 128, 8, 53248, 128256)
    assert c.remat == "full"
    c = tconfigs.get_arch("jamba-1.5-large-398b").config
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.num_experts, c.top_k, c.attn_every) == \
        (72, 8192, 64, 8, 16, 2, 8)
    c = tconfigs.get_arch("qwen2-moe-a2.7b").config
    assert (c.num_experts, c.top_k, c.num_shared_experts, c.moe_d_ff) == \
        (60, 4, 4, 1408)
    c = tconfigs.get_arch("rwkv6-1.6b").config
    assert (c.num_layers, c.d_model, c.d_ff, c.vocab_size) == \
        (24, 2048, 7168, 65536)
    c = tconfigs.get_arch("nemotron-4-15b").config
    assert c.mlp_act == "sq_relu" and c.vocab_size == 256000
    c = tconfigs.get_arch("qwen2.5-3b").config
    assert c.qkv_bias and c.num_kv_heads == 2 and c.d_ff == 11008
    c = tconfigs.get_arch("qwen3-1.7b").config
    assert c.qk_norm and c.d_ff == 6144
    c = tconfigs.get_arch("musicgen-medium").config
    assert c.embed_inputs and c.vocab_size == 2048 and c.d_model == 1536
    c = tconfigs.get_arch("pixtral-12b").config
    assert c.embed_inputs and c.d_model == 5120 and c.num_layers == 40


# ----------------------------------------------------------------------
# Numerics: forward, decode, serve
# ----------------------------------------------------------------------

def _kept(idx, capacity):
    """The experts each token keeps [N, K] (sorted, -1 where dropped) in
    the reference's flat dispatch: an assignment keeps its expert when
    fewer than ``capacity`` earlier tokens went to that expert (its
    place in the stable sort by expert)."""
    e = idx.reshape(-1)
    order = np.argsort(e, kind="stable")
    start = np.searchsorted(e[order], np.arange(int(e.max()) + 1))
    pos = np.empty_like(e)
    pos[order] = np.arange(e.size) - start[e[order]]
    return np.sort(np.where(pos < capacity, e, -1).reshape(idx.shape), -1)


def _record_routing(monkeypatch, jcfg, tcfg, jmod=jlm, tmod=tlm):
    """Wrap both packages' ``moe_apply`` as their model modules call it
    (``jmod`` / ``tmod``: the ``lm`` modules, or jamba's):
    per MoE layer and token the expert set and the kept experts (the
    JAX side through ``jax.debug.callback``, from inside its jit and
    scan), and the reference's top-k margin, p_K - p_K+1 of the
    router's softmax.  For the flat dispatch of the smoke configs."""
    got, want = [], []
    j_inner, t_inner = jmod.moe_apply, tmod.moe_apply
    K = jcfg.top_k

    def j_route(h, router):
        probs = np.asarray(jax.nn.softmax(
            jnp.asarray(h, jnp.float32) @ jnp.asarray(router), -1))
        top = np.sort(probs, -1)[..., ::-1]
        idx = np.asarray(jax.lax.top_k(jnp.asarray(probs), K)[1]
                         ).reshape(-1, K)
        C = j_moe_capacity(jcfg, idx.shape[0])
        want.append((np.sort(idx, -1), _kept(idx, C),
                     (top[..., K - 1] - top[..., K]).reshape(-1)))

    def j_moe(cfg, p, h, *a, **kw):
        jax.debug.callback(j_route, h, p["router"], ordered=True)
        return j_inner(cfg, p, h, *a, **kw)

    def t_moe(cfg, p, h, *a, **kw):
        r = moe_routing(cfg, p, h)
        idx = r["idx"].reshape(-1, K).numpy()
        keep = r["keep"].reshape(-1, K).numpy()
        got.append((np.sort(idx, -1), np.sort(np.where(keep, idx, -1), -1)))
        return t_inner(cfg, p, h, *a, **kw)

    monkeypatch.setattr(jmod, "moe_apply", j_moe)
    monkeypatch.setattr(tmod, "moe_apply", t_moe)
    return got, want


def routed_alike(got_r, want_r, dtype, n):
    """The positions (of ``n``) that every MoE layer routed alike in
    both packages, from ``_record_routing``'s records: in float32 all
    of them; in bf16 a position that goes to other experts must be a
    near-tie there (or have gone apart in an earlier layer), one that
    keeps other experts behind a full expert must be in a layer where
    some token went apart, and at most ``BF16_APART_SHARE`` of them may
    differ."""
    alike = np.ones(n, bool)
    for (t_set, t_kept), (j_set, j_kept, margin) in zip(got_r, want_r):
        flipped = (t_set != j_set).any(-1)
        kept = (t_kept != j_kept).any(-1)
        if dtype == "float32":
            assert not flipped.any() and not kept.any()
        # a token routed apart in an earlier layer enters this one with
        # another hidden state; any other must be a near-tie here
        new = flipped & alike
        assert (margin[new] < BF16_ROUTING_TIE).all(), margin[new]
        assert flipped.any() or not kept.any()
        alike &= ~(flipped | kept)
    assert (~alike).mean() <= BF16_APART_SHARE, (~alike).sum()
    return alike


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_with_flash_matches_jax(arch, dtype, monkeypatch,
                                        no_launches):
    """Logits and the aux loss of the flash-path forward at 2 x 256.

    A MoE layer routes each token in both packages; in float32 every
    layer sends every token to the same experts and keeps the same.  In
    bf16 the hidden states entering the router differ in the last bits
    (the packages round in another order), so a token whose K-th and
    (K+1)-th router probabilities are within ``BF16_ROUTING_TIE`` may go
    to another expert; such a token must be a near-tie in the reference
    (or have gone apart in an earlier layer), and a token that keeps
    other experts while its own set agrees (an earlier token moved into
    or out of its expert, which was full) only in a layer where some
    token went apart.  Such positions are a share of at most
    ``BF16_APART_SHARE``, and every position routed alike in every layer
    is held to 0.25."""
    jcfg, tcfg = _configs(arch, dtype, use_flash_kernel=True)
    params, model = _weights(arch, dtype)
    x = _inputs(tcfg, FORWARD_SHAPE)
    got_r, want_r = _record_routing(monkeypatch, jcfg, tcfg)
    want, jaux = jax.jit(functools.partial(j_get_api(jcfg).apply, jcfg))(
        params, jnp.asarray(x))
    jax.effects_barrier()
    got, taux = get_api(tcfg).apply(tcfg, model, torch.from_numpy(x))
    assert got.shape == FORWARD_SHAPE + (tcfg.vocab_size,)
    assert got.dtype == tcfg.dtype
    assert torch.equal(make_forward_step(tcfg)(model, torch.from_numpy(x)),
                       got)
    tol = DTYPES[dtype][2]
    # the port's layers ran twice (apply, then the forward step)
    layers = tcfg.num_layers if tcfg.num_experts else 0
    assert len(got_r) == 2 * layers and len(want_r) == layers
    alike = routed_alike(got_r, want_r, dtype, np.prod(FORWARD_SHAPE)
                         ).reshape(FORWARD_SHAPE)
    np.testing.assert_allclose(_f32(got)[alike], _f32(want)[alike],
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), atol=tol, rtol=tol)
    if tcfg.num_experts:
        assert float(taux) > 0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_loop_matches_jax(arch, no_launches):
    """24 decode steps from an empty cache, logits within 1e-4 at every
    step; mixtral's cache is a 16-slot rolling buffer, so it wraps."""
    jcfg, tcfg = _configs(arch)
    params, model = _weights(arch, "float32")
    japi, tapi = j_get_api(jcfg), get_api(tcfg)
    x = _inputs(tcfg, (DECODE_B, DECODE_T), seed=2)
    jdecode = jax.jit(functools.partial(japi.decode, jcfg))
    jcache = japi.init_cache(jcfg, DECODE_B, DECODE_T)
    tcache = tapi.init_cache(tcfg, DECODE_B, DECODE_T, "cpu")
    assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape)
    for t in range(DECODE_T):
        jlog, jcache = jdecode(params, jnp.asarray(x[:, t]), jcache,
                               jnp.int32(t))
        tlog, tcache = tapi.decode(tcfg, model, torch.from_numpy(x[:, t]),
                                   tcache, t)
        np.testing.assert_allclose(tlog.numpy(), _f32(jlog), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
    np.testing.assert_allclose(tcache["k"].numpy(), _f32(jcache["k"]),
                               atol=1e-4, rtol=1e-4)
    if tcfg.window is not None:
        assert tcache["k"].shape[2] == tcfg.window < DECODE_T


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_matches_jax(arch, monkeypatch, no_launches):
    """``serve()`` of both packages on the same float32 weights: the same
    prompts (token ids or embeddings) and identical greedy tokens."""
    jcfg, tcfg = _configs(arch)
    monkeypatch.setitem(jconfigs.ARCHS, arch, dataclasses.replace(
        jconfigs.get_arch(arch), smoke=jcfg))
    want = jserve.serve(arch, batch=2, prompt_len=8, gen_len=6, seed=0)
    _params, model = _weights(arch, "float32")
    got = t_serve(arch, batch=2, prompt_len=8, gen_len=6, seed=0,
                  device="cpu", model=model)
    assert got.tokens.shape == (2, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)


# ----------------------------------------------------------------------
# Training loss and checkpoints of the MoE archs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_loss_and_gradients_match_jax(arch):
    """``lm_loss`` (cross-entropy plus 0.01 x the aux loss) and every
    parameter's gradient, float32, within 1e-4."""
    jcfg, tcfg = _configs(arch)
    params, model = _weights(arch, "float32")
    x = _inputs(tcfg, (2, 16), seed=3)
    y = _inputs(tcfg, (2, 16), seed=4)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_get_api(jcfg).loss(jcfg, p, jnp.asarray(x),
                                       jnp.asarray(y))))(params)
    named = dict(model.named_parameters())
    try:
        for p in named.values():
            p.requires_grad_(True)
        loss = get_api(tcfg).loss(tcfg, model, torch.from_numpy(x),
                                  torch.from_numpy(y))
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
    finally:
        for p in named.values():
            p.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-4)
    got = convert.adamw_state_to_numpy(
        {"m": grads, "v": grads, "step": 0}, tcfg)["m"]
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = jax.tree.leaves(got)
    assert len(jflat) == len(tflat)
    for (path, j), t in zip(jflat, tflat):
        np.testing.assert_allclose(_f32(t), _f32(j), atol=1e-4, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert float(np.abs(_f32(got["layers"]["moe"]["router"])).max()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS + ["musicgen-medium",
                                             "qwen2.5-3b"])
def test_checkpoint_round_trip(arch, tmp_path):
    """bf16 weights and float32 AdamW moments of a MoE (stacked [L, E, D,
    F] experts, the float32 router, shared experts), an embed-less or a
    dense tree (QKV biases): through ``convert``'s family-generic path
    bit for bit, and through checkpoints written by one package and
    read by the other."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    params, model = _weights(arch, "bfloat16")
    tree = convert.lm_params_to_numpy(model)
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(tree)[0]]
    for (path, j), t in zip(jflat, jax.tree.leaves(tree)):
        assert _dtype_name(t.dtype) == _dtype_name(j.dtype), path
        np.testing.assert_array_equal(_f32(t), _f32(j))
    again = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    for (name, a), b in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(a, b), name

    opt = adamw_init(dict(model.named_parameters()), AdamWConfig())
    for name, m in opt["m"].items():
        m.copy_(torch.randn(m.shape, generator=torch.Generator()
                            .manual_seed(len(name))))
    state = convert.adamw_state_to_numpy(opt, tcfg)
    back = convert.adamw_state_from_numpy(state, tcfg, device="cpu")
    for key in ("m", "v"):
        for name, a in opt[key].items():
            assert torch.equal(back[key][name], a), (key, name)

    save_checkpoint(tmp_path / "port", 1, {"params": tree, "opt": state})
    jstate = jax.tree.map(np.asarray, state)
    read = j_load_checkpoint(tmp_path / "port", 1,
                             {"params": params, "opt": jstate})
    for a, b in zip(jax.tree.leaves(read["params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(_f32(a), _f32(b))
    j_save_checkpoint(tmp_path / "jax", 1, {"params": params})
    read = load_checkpoint(tmp_path / "jax", 1, {"params": tree})
    model2 = convert.lm_params_from_numpy(read["params"], tcfg, device="cpu")
    for (name, a), b in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("arch", ["musicgen-medium", "pixtral-12b"])
def test_train_refuses_embed_input_archs(arch):
    """As the JAX package's ``train()``: a frontend-stub arch takes
    embeddings, not the token stream it would train on."""
    for fn, kw in ((j_train, {}), (t_train, {"device": "cpu"})):
        with pytest.raises(ValueError, match="frontend-stub"):
            fn(arch, steps=1, batch=2, seq=8, **kw)
