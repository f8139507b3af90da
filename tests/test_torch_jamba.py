"""The port's jamba hybrid against the JAX package, on the jamba smoke
config (8 layers: one super-block of attention + dense FFN, 4 mamba +
MoE and 3 mamba + dense sublayers; width 64, 4 experts top-2): the
mamba layer (prefill, a carried state, ``ssm_scan_unroll`` 1 and 8),
the forward through the flash path in float32 and bf16, decode steps,
``serve()``, the loss and its gradients, and bf16 checkpoints across
packages.

The port's decode state carries the causal convolution's inputs, the
context its prefill reads; the reference's carries the convolution's
outputs (``repro/models/ssm.py:69-72``), so the reference's decode
parts from its own forward from the second token on.  The port's decode
steps are therefore held to the JAX forward at every position (and to
the JAX decode where the two states agree: the first step and the
attention KV cache); ``test_reference_decode_carries_the_conv_output``
shows the difference.

Weights are the JAX package's ``init_params`` draw, carried into the
port with ``convert.lm_params_from_numpy``; other inputs come from
seeded numpy.  At sequence 256 the JAX ``ops.attention`` runs the
Pallas flash kernel in interpret mode, the port's ``ops.attention``
its plain version.  Tolerances: 1e-4 in float32; 0.25 in bf16, the JAX
package's own (``tests/test_archs.py:123``).
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
from repro.models import ModelConfig as JModelConfig
from repro.models import get_api as j_get_api
from repro.models import init_params as j_init_params
from repro.models import jamba as jjamba
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import save_checkpoint
from repro_torch.kernels import ops
from repro_torch.launch.serve import make_prompts
from repro_torch.launch.serve import serve as t_serve
from repro_torch.models import ModelConfig, get_api
from repro_torch.models import jamba as tjamba
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.common import init_params, param_count
from repro_torch.optim import AdamWConfig, adamw_init
from test_torch_archs import _record_routing, routed_alike

ARCH = "jamba-1.5-large-398b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.25)}
FORWARD_SHAPE = (2, 256)
DECODE_B, DECODE_T = 2, 10
# bf16 near-tie of the jamba router: one bf16 unit in the last place at
# the size of its probabilities (4 experts top-2: about 1/4, so 2^-9).
# The transformer archs' 2^-10 (test_torch_archs.py) is a quarter of
# that at 1/8 to 1/4; here 7 mamba layers round in another order ahead
# of the last router (read on the CPU with the routing replayed: 22 of
# 2,048 token-layers choose otherwise, at margins up to 1.03e-3)
JAMBA_ROUTING_TIE = 2.0 ** -9
# the mamba layer of tests/test_moe_paths.py:71
MAMBA = dict(name="m", family="hybrid", d_model=32, ssm_d_state=8,
             ssm_conv=4, ssm_expand=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_launches():
    ops.reset_launches()
    yield
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


def _configs(dtype="float32", **changes):
    jd, td, _tol = DTYPES[dtype]
    return (dataclasses.replace(jconfigs.get_arch(ARCH).smoke, dtype=jd,
                                **changes),
            dataclasses.replace(tconfigs.get_arch(ARCH).smoke, dtype=td,
                                **changes))


def _ample(cfg):
    """A capacity no expert can fill (factor E / K): the forward's flat
    dispatch drops nothing, as decode, one token a row, does not."""
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.num_experts / cfg.top_k)


@functools.lru_cache(maxsize=None)
def _weights(dtype):
    """The JAX draw of the smoke config in ``dtype`` and the port's
    model holding it."""
    jcfg, tcfg = _configs(dtype)
    params = j_init_params(j_get_api(jcfg).defs(jcfg), jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return params, model


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=what)


def _dtype_name(dt):
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


# ----------------------------------------------------------------------
# The mamba layer
# ----------------------------------------------------------------------

def _mamba(dtype, **changes):
    """The reference's mamba parameters for ``MAMBA`` in ``dtype`` (its
    ``A_log``, ``dt_bias`` and ``D_skip`` drawn, not their constant
    init, so the decay varies by channel), the port's module holding
    them, and both configs."""
    jd, td, _tol = DTYPES[dtype]
    jcfg = JModelConfig(dtype=jd, **MAMBA, **changes)
    tcfg = ModelConfig(dtype=td, **MAMBA, **changes)
    params = dict(j_init_params(jssm.mamba_defs(jcfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for name, lo, hi in (("A_log", -1.0, 1.0), ("dt_bias", -1.0, 0.5),
                         ("D_skip", 0.5, 1.5)):
        params[name] = jnp.asarray(rng.uniform(lo, hi, params[name].shape),
                                   jnp.float32)
    mod = tssm.Mamba(tcfg, torch.device("cpu"))
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(np.array(_f32(params[name]))))
    return jcfg, tcfg, params, mod


def _conv_inputs(jcfg, params, x):
    """The convolution's inputs of x (the first half of ``in_proj``)."""
    d_in = jcfg.ssm_expand * jcfg.d_model
    return (jnp.asarray(x) @ params["in_proj"])[..., :d_in]


@pytest.mark.parametrize("dtype,unroll", [("float32", 1), ("float32", 8),
                                          ("bfloat16", 1), ("bfloat16", 8)])
def test_mamba_prefill_matches_jax(dtype, unroll):
    """``mamba_apply`` on 2 x 16 tokens against the reference's at
    ``ssm_scan_unroll`` 1 and 8 (``tests/test_moe_paths.py:71``'s case,
    which the port reads nothing from): the output in x's dtype, the
    float32 scan state, and as conv state the last K - 1 conv inputs."""
    jcfg, tcfg, params, mod = _mamba(dtype, ssm_scan_unroll=unroll)
    x = np.random.default_rng(1).standard_normal((2, 16, 32)).astype(
        np.float32)
    jx = jnp.asarray(x, jcfg.dtype)
    want, (jh, _jconv) = jssm.mamba_apply(jcfg, params, jx)
    with torch.no_grad():
        got, (th, tconv) = tssm.mamba_apply(
            tcfg, mod, torch.from_numpy(x).to(tcfg.dtype))
    tol = DTYPES[dtype][2]
    assert got.dtype == tcfg.dtype and th.dtype == torch.float32
    assert tconv.dtype == tcfg.dtype and tuple(tconv.shape) == (2, 3, 64)
    _close(got, want, tol, "y")
    _close(th, jh, tol, "h")
    _close(tconv, _conv_inputs(jcfg, params, jx)[:, -3:], tol, "conv")


def test_mamba_carried_state_matches_jax():
    """A carried state: 16 tokens fed as 5, 1 and 10 through the port's
    decode state equal the reference's one prefill (output and final
    scan state); from the same given state the port's step equals the
    reference's (output and scan state), float32 within 1e-4."""
    jcfg, tcfg, params, mod = _mamba("float32")
    x = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(
        np.float32)
    want, (jh, _c) = jssm.mamba_apply(jcfg, params, jnp.asarray(x))
    state, outs = tssm.mamba_state(tcfg, 2, "cpu"), []
    with torch.no_grad():
        for a, b in ((0, 5), (5, 6), (6, 16)):
            y, state = tssm.mamba_apply(tcfg, mod, torch.from_numpy(x[:, a:b]),
                                        state=state)
            outs.append(y)
    _close(torch.cat(outs, 1), want, 1e-4, "y")
    _close(state[0], jh, 1e-4, "h")
    rng = np.random.default_rng(3)
    h0 = rng.standard_normal((2, 64, 8)).astype(np.float32)
    c0 = rng.standard_normal((2, 3, 64)).astype(np.float32)
    want, (jh, _c) = jssm.mamba_apply(jcfg, params, jnp.asarray(x[:, :1]),
                                      state=(jnp.asarray(h0),
                                             jnp.asarray(c0)))
    with torch.no_grad():
        got, (th, _c) = tssm.mamba_apply(tcfg, mod,
                                         torch.from_numpy(x[:, :1]),
                                         state=(torch.from_numpy(h0),
                                                torch.from_numpy(c0)))
    _close(got, want, 1e-4, "step y")
    _close(th, jh, 1e-4, "step h")


def test_reference_decode_carries_the_conv_output():
    """The fault the port leaves out: the reference's conv state is the
    last K - 1 conv *outputs*, so its one-token steps part from its own
    prefill; the port's (the conv inputs) give the prefill's output."""
    jcfg, tcfg, params, mod = _mamba("float32")
    x = np.random.default_rng(4).standard_normal((1, 6, 32)).astype(
        np.float32)
    full, _ = jssm.mamba_apply(jcfg, params, jnp.asarray(x))
    jstate = tuple(jnp.asarray(a.numpy())
                   for a in tssm.mamba_state(tcfg, 1, "cpu"))
    tstate = tssm.mamba_state(tcfg, 1, "cpu")
    jsteps, tsteps = [], []
    with torch.no_grad():
        for t in range(6):
            y, jstate = jssm.mamba_apply(jcfg, params,
                                         jnp.asarray(x[:, t:t + 1]),
                                         state=jstate)
            jsteps.append(np.asarray(y))
            y, tstate = tssm.mamba_apply(tcfg, mod,
                                         torch.from_numpy(x[:, t:t + 1]),
                                         state=tstate)
            tsteps.append(y.numpy())
    jsteps, tsteps = np.concatenate(jsteps, 1), np.concatenate(tsteps, 1)
    full = np.asarray(full)
    np.testing.assert_allclose(tsteps, full, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(jsteps[:, 0], full[:, 0], atol=1e-4, rtol=1e-4)
    assert np.abs(jsteps[:, 1:] - full[:, 1:]).max() > 1e-2


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------

def test_structure_and_cache():
    """Blocks, sublayers and the decode state's shapes and dtypes as the
    reference's (``input_specs`` of the published config at long_500k
    too); a layer count that is not a multiple of ``attn_every`` is
    refused by both packages."""
    for jspec_cfg, tspec_cfg in ((jconfigs.get_arch(ARCH).smoke,
                                  tconfigs.get_arch(ARCH).smoke),
                                 (jconfigs.get_arch(ARCH).config,
                                  tconfigs.get_arch(ARCH).config)):
        want = j_get_api(jspec_cfg).init_cache(jspec_cfg, 2, 24,
                                               as_shape=True)
        got = get_api(tspec_cfg).init_cache(tspec_cfg, 2, 24, "meta")
        assert [(tuple(a.shape), _dtype_name(a.dtype))
                for a in jax.tree.leaves(got)] == \
            [(tuple(a.shape), _dtype_name(a.dtype))
             for a in jax.tree.leaves(want)]
    model = get_api(tspec_cfg).module(
        dataclasses.replace(tspec_cfg, num_layers=8, moe_every=4),
        torch.device("meta"))
    blk = model.blocks[0]
    assert (len(model.blocks), len(blk.moe_layers), len(blk.dense_layers)) \
        == (1, 2, 5)
    assert param_count(tjamba.jamba_defs(model.cfg)) == 27_118_690_304
    bad = dataclasses.replace(tspec_cfg, num_layers=12)
    for fn, cfg in ((jjamba.jamba_defs, dataclasses.replace(
            jspec_cfg, num_layers=12)), (tjamba.jamba_defs, bad)):
        with pytest.raises(ValueError, match="multiple of attn_every"):
            fn(cfg)


def _replayed(monkeypatch, choices):
    """The port's routings (``layers._route``) take the next [N, K]
    expert ids of ``choices`` in place of their own top-k, weighted by
    their own router probabilities renormalised; returns the list that
    receives, per routing, the port's own top-k margins p_K - p_K+1 of
    the tokens whose own choice (as a set) differs."""
    inner = tlayers._route
    it = iter(choices)
    margins = []

    def replay(cfg, p, x, expert_perm):
        probs, own, _w = inner(cfg, p, x, expert_perm)
        idx = torch.from_numpy(next(it)).long().reshape(own.shape)
        K = cfg.top_k
        top = probs.topk(K + 1, dim=-1).values
        differ = (own.sort(-1).values != idx.sort(-1).values).any(-1)
        margins.append((top[..., K - 1] - top[..., K])[differ].numpy())
        vals = probs.gather(-1, idx)
        return probs, idx, vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)

    monkeypatch.setattr(tlayers, "_route", replay)
    return margins


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_with_flash_matches_jax(dtype, monkeypatch, no_launches):
    """Logits and the aux loss of the flash-path forward at 2 x 256.

    In float32 every MoE sublayer routes every token alike in both
    packages.  In bf16 the two round in another order, and a mamba
    layer carries a token's difference to every later position of its
    sequence, so one token routed apart at a near-tie changes the rest
    of its sequence (read on the CPU: 10 near-ties, at margins up to
    6.2e-4, leave 23 of 512 positions routed alike).  So the port
    replays the JAX forward's expert choices (recorded from inside its
    jit, as ``test_torch_archs.py`` does), every token whose own choice
    differs must be a near-tie (``JAMBA_ROUTING_TIE``), and every
    position is held to 0.25."""
    jcfg, tcfg = _configs(dtype, use_flash_kernel=True)
    params, model = _weights(dtype)
    x = _tokens(FORWARD_SHAPE)
    got_r, want_r = _record_routing(monkeypatch, jcfg, tcfg, jjamba, tjamba)
    want, jaux = jax.jit(functools.partial(j_get_api(jcfg).apply, jcfg))(
        params, jnp.asarray(x))
    jax.effects_barrier()
    assert len(want_r) == 4
    if dtype == "bfloat16":
        monkeypatch.setattr(tjamba, "moe_apply", tlayers.moe_apply)
        margins = _replayed(monkeypatch, [j_set for j_set, _k, _m in want_r])
    got, taux = get_api(tcfg).apply(tcfg, model, torch.from_numpy(x))
    assert got.shape == FORWARD_SHAPE + (tcfg.vocab_size,)
    assert got.dtype == tcfg.dtype
    if dtype == "bfloat16":
        assert len(margins) == 4
        margins = np.concatenate(margins)
        assert (margins < JAMBA_ROUTING_TIE).all(), margins
    else:
        assert routed_alike(got_r, want_r, dtype, np.prod(FORWARD_SHAPE)
                            ).all()
    tol = DTYPES[dtype][2]
    _close(got, want, tol)
    np.testing.assert_allclose(float(taux), float(jaux), atol=tol, rtol=tol)
    assert float(taux) > 0


def test_decode_steps_match_jax(no_launches):
    """10 decode steps from an empty state at an ample capacity: the
    logits within 1e-4 of the JAX forward's at every position, and of
    the JAX decode's at the first step; the attention KV cache equal to
    the JAX decode's.  The JAX decode itself parts from its forward
    (its conv state, ``test_reference_decode_carries_the_conv_output``)."""
    jcfg, tcfg = (_ample(c) for c in _configs())
    params, model = _weights("float32")
    japi, tapi = j_get_api(jcfg), get_api(tcfg)
    x = _tokens((DECODE_B, DECODE_T), seed=2)
    full, _ = jax.jit(functools.partial(japi.apply, jcfg))(params,
                                                           jnp.asarray(x))
    jdecode = jax.jit(functools.partial(japi.decode, jcfg))
    jcache = japi.init_cache(jcfg, DECODE_B, DECODE_T)
    tcache = tapi.init_cache(tcfg, DECODE_B, DECODE_T, "cpu")
    jlogs, tlogs = [], []
    for t in range(DECODE_T):
        jlog, jcache = jdecode(params, jnp.asarray(x[:, t]), jcache,
                               jnp.int32(t))
        tlog, tcache = tapi.decode(tcfg, model, torch.from_numpy(x[:, t]),
                                   tcache, t)
        jlogs.append(_f32(jlog))
        tlogs.append(_f32(tlog))
    tlogs, jlogs = np.stack(tlogs, 1), np.stack(jlogs, 1)
    np.testing.assert_allclose(tlogs, _f32(full), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tlogs[:, 0], jlogs[:, 0], atol=1e-4,
                               rtol=1e-4)
    assert np.abs(jlogs[:, 1:] - _f32(full)[:, 1:]).max() > 0.25
    for key in ("k", "v"):
        _close(tcache["kv"][key], jcache["kv"][key], 1e-4, key)
    for key in ("moe_h", "moe_conv", "dense_h", "dense_conv"):
        assert tuple(tcache[key].shape) == jcache[key].shape, key


def test_serve_is_greedy_over_the_forward(no_launches):
    """``serve()`` on the float32 weights: every generated token is the
    argmax of the port's forward over the prompt and the tokens before
    it (an ample capacity; decode at batch 2 drops nothing); the smoke
    config serves from its own draw too, and the default device is the
    card."""
    _jcfg, tcfg = _configs()
    _params, model = _weights("float32")
    r = t_serve(ARCH, batch=2, prompt_len=6, gen_len=5, seed=0, device="cpu",
                model=model)
    assert r.tokens.shape == (2, 5)
    # the serve loop feeds the last prompt step's argmax and emits the
    # steps after it
    apply = functools.partial(get_api(tcfg).apply, _ample(tcfg), model)
    prompts = torch.from_numpy(make_prompts(tcfg, 2, 6, 0))
    first = apply(prompts)[0][:, -1].argmax(-1, keepdim=True)
    seq = torch.cat([prompts, first.int(), torch.from_numpy(r.tokens)], 1)
    np.testing.assert_array_equal(apply(seq)[0][:, 6:-1].argmax(-1).numpy(),
                                  r.tokens)
    assert t_serve(ARCH, batch=1, prompt_len=3, gen_len=2,
                   device="cpu").tokens.shape == (1, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_serve(ARCH, batch=1, prompt_len=2, gen_len=1)


def test_loss_and_gradients_match_jax():
    """``jamba_loss`` (cross-entropy plus 0.01 x the aux loss) and every
    parameter's gradient, float32, within 1e-4."""
    jcfg, tcfg = _configs()
    params, model = _weights("float32")
    x, y = _tokens((2, 12), seed=3), _tokens((2, 12), seed=4)
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
    assert float(np.abs(_f32(
        got["blocks"]["moe_layers"]["moe"]["router"])).max()) > 0


def test_checkpoint_round_trip_across_packages(tmp_path):
    """bf16 weights ([nb, n_sub, ...] sublayer leaves among them) and
    float32 moments through ``convert`` bit for bit; a port checkpoint
    read by the JAX package; a model drawn by the port survives the
    round trip."""
    jcfg, tcfg = _configs("bfloat16")
    params, model = _weights("bfloat16")
    tree = convert.lm_params_to_numpy(model)
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [jax.tree_util.keystr(p) for p, _ in tflat]
    for (path, j), (_p, t) in zip(jflat, tflat):
        assert _dtype_name(t.dtype) == _dtype_name(j.dtype), path
        np.testing.assert_array_equal(_f32(t), _f32(j))
    drawn = init_params(get_api(tcfg).module(tcfg, torch.device("cpu")),
                        torch.Generator().manual_seed(3))
    again = convert.lm_params_from_numpy(convert.lm_params_to_numpy(drawn),
                                         tcfg, device="cpu")
    for (name, a), b in zip(drawn.named_parameters(), again.parameters()):
        assert torch.equal(a, b), name
    opt = adamw_init(dict(model.named_parameters()), AdamWConfig())
    for name, m in opt["m"].items():
        m.copy_(torch.randn(m.shape, generator=torch.Generator()
                            .manual_seed(len(name))))
    state = convert.adamw_state_to_numpy(opt, tcfg)
    back = convert.adamw_state_from_numpy(state, tcfg, device="cpu")
    for name, a in opt["m"].items():
        assert torch.equal(back["m"][name], a), name
    save_checkpoint(tmp_path, 1, {"params": tree, "opt": state})
    read = j_load_checkpoint(tmp_path, 1, {
        "params": params, "opt": jax.tree.map(np.asarray, state)})
    for a, b in zip(jax.tree.leaves(read["params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(_f32(a), _f32(b))
