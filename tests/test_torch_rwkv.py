"""The port's rwkv family against the JAX package, on the rwkv6 smoke
config (2 layers, width 64, head size 16, chunk 8): the WKV6 chunked
recurrence and its decode step, the dtypes of ``time_mix`` /
``channel_mix`` in bf16, the forward in float32 and bf16, decode steps,
``serve()``, the loss and its gradients, bf16 checkpoints across
packages, ``train()`` resumed from a checkpoint, and the O(1) decode
state.

Weights are the JAX package's ``init_params`` draw, carried into the
port with ``convert.lm_params_from_numpy``; other inputs come from
seeded numpy.  Tolerances: 1e-4 in float32 (absolute and relative);
0.25 in bf16, the JAX package's own (``tests/test_archs.py:123``).
"""
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.launch import serve as jserve
from repro.launch.train import train as j_train
from repro.models import get_api as j_get_api
from repro.models import init_params as j_init_params
from repro.models import rwkv as jrwkv
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import save_checkpoint
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve as t_serve
from repro_torch.launch.train import train as t_train
from repro_torch.models import get_api
from repro_torch.models import rwkv as trwkv
from repro_torch.optim import AdamWConfig, adamw_init

ARCH = "rwkv6-1.6b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.25)}
FORWARD_SHAPE = (2, 37)          # 4 chunks of 8, the last one padded
DECODE_B, DECODE_T = 2, 12


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


@functools.lru_cache(maxsize=None)
def _weights(dtype):
    """The JAX draw of the smoke config in ``dtype`` and the port's
    model holding it.  The draw is made again with nonzero ``mu_*``,
    ``w0`` and ``u`` (zeros by their init rule), so the token shifts
    and the bonus term are exercised."""
    jcfg, tcfg = _configs(dtype)
    params = j_init_params(j_get_api(jcfg).defs(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    layers = dict(params["layers"])
    for part, names in (("tm", ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
                                "w0", "u")), ("cm", ("mu_k", "mu_r"))):
        layers[part] = dict(layers[part])
        for n in names:
            a = layers[part][n]
            layers[part][n] = jnp.asarray(
                rng.uniform(-0.5, 1.0, a.shape).astype(np.float32), a.dtype)
    params = dict(params, layers=layers)
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


# ----------------------------------------------------------------------
# The recurrence
# ----------------------------------------------------------------------

@pytest.mark.parametrize("T,chunk", [(32, 8), (37, 8), (5, 8)],
                         ids=["divisible", "padded", "short"])
def test_wkv_chunked_matches_jax(T, chunk):
    """Output and final state within 1e-4: T a multiple of the chunk,
    T padded up to one, and T under one chunk (C = T)."""
    rng = np.random.default_rng(T)
    B, H, N = 2, 3, 16
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 0.999, (B, T, H, N)).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    want, want_S = jrwkv.wkv_chunked(*map(jnp.asarray, (r, k, v, w, u)),
                                     chunk)
    got, got_S = trwkv.wkv_chunked(*map(torch.from_numpy, (r, k, v, w, u)),
                                   chunk)
    assert got.shape == (B, T, H, N) and got_S.shape == (B, H, N, N)
    _close(got, want, 1e-4, "out")
    _close(got_S, want_S, 1e-4, "state")


def test_wkv_step_matches_jax_and_the_chunked_form():
    """``wkv_step`` against the reference's, and T steps from a zero
    state against ``wkv_chunked`` over the same T."""
    rng = np.random.default_rng(3)
    B, T, H, N = 2, 11, 2, 8
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 0.999, (B, T, H, N)).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    S0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    jS, jout = jrwkv.wkv_step(*map(jnp.asarray, (S0, r[:, 0], k[:, 0],
                                                  v[:, 0], w[:, 0], u)))
    tS, tout = trwkv.wkv_step(*map(torch.from_numpy, (S0, r[:, 0], k[:, 0],
                                                       v[:, 0], w[:, 0], u)))
    _close(tS, jS, 1e-5)
    _close(tout, jout, 1e-5)
    S = torch.zeros(B, H, N, N)
    outs = []
    for t in range(T):
        S, o = trwkv.wkv_step(S, *(torch.from_numpy(a[:, t])
                                   for a in (r, k, v, w)),
                              torch.from_numpy(u))
        outs.append(o)
    full, full_S = trwkv.wkv_chunked(*map(torch.from_numpy, (r, k, v, w, u)),
                                     4)
    _close(torch.stack(outs, 1), full, 1e-4)
    _close(S, full_S, 1e-4)


def _dtype_name(dt):
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


def test_mix_dtypes_follow_the_reference_in_bf16():
    """In a bf16 model the float32 ``mu_*`` promote the lerps, so
    ``time_mix`` and ``channel_mix`` return float32 outputs (the
    reference's, by ``jax.eval_shape``), a float32 state and the bf16
    last token; the outputs agree within 0.25."""
    jcfg, tcfg = _configs("bfloat16")
    params, model = _weights("bfloat16")
    x = np.random.default_rng(4).standard_normal((2, 9, 64)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jl = jax.tree.map(lambda a: a[0], params["layers"])
    blk = model.blocks[0]
    for jfn, tfn, jp, tp in ((jrwkv.time_mix, trwkv.time_mix, jl["tm"],
                              blk.tm),
                             (jrwkv.channel_mix, trwkv.channel_mix,
                              jl["cm"], blk.cm)):
        want = jax.eval_shape(functools.partial(jfn, jcfg), jp, jx)
        got = tfn(tcfg, tp, tx)
        want_leaves, got_leaves = jax.tree.leaves(want), jax.tree.leaves(got)
        assert [(_dtype_name(a.dtype), tuple(a.shape)) for a in got_leaves] \
            == [(_dtype_name(a.dtype), tuple(a.shape)) for a in want_leaves]
        _close(got[0], jfn(jcfg, jp, jx)[0], 0.25)
    assert _dtype_name(got_leaves[0].dtype) == "float32"


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_jax(dtype, no_launches):
    """Logits of the forward at 2 x 37 (four chunks, the last padded)."""
    jcfg, tcfg = _configs(dtype)
    params, model = _weights(dtype)
    x = _tokens(FORWARD_SHAPE)
    want, jaux = jax.jit(functools.partial(j_get_api(jcfg).apply, jcfg))(
        params, jnp.asarray(x))
    got, taux = get_api(tcfg).apply(tcfg, model, torch.from_numpy(x))
    assert got.shape == FORWARD_SHAPE + (tcfg.vocab_size,)
    assert got.dtype == tcfg.dtype
    _close(got, want, DTYPES[dtype][2])
    assert float(taux) == float(jaux) == 0.0


def test_decode_steps_match_jax(no_launches):
    """12 decode steps from an empty state: logits within 1e-4 at every
    step, the WKV state and the shift buffers at the end too."""
    jcfg, tcfg = _configs()
    params, model = _weights("float32")
    japi, tapi = j_get_api(jcfg), get_api(tcfg)
    x = _tokens((DECODE_B, DECODE_T), seed=2)
    jdecode = jax.jit(functools.partial(japi.decode, jcfg))
    jcache = japi.init_cache(jcfg, DECODE_B, DECODE_T)
    tcache = tapi.init_cache(tcfg, DECODE_B, DECODE_T, "cpu")
    for t in range(DECODE_T):
        jlog, jcache = jdecode(params, jnp.asarray(x[:, t]), jcache,
                               jnp.int32(t))
        tlog, tcache = tapi.decode(tcfg, model, torch.from_numpy(x[:, t]),
                                   tcache, t)
        _close(tlog, jlog, 1e-4, f"step {t}")
    for key in ("S", "tm_last", "cm_last"):
        assert tcache[key].dtype == getattr(torch, _dtype_name(
            jcache[key].dtype))
        _close(tcache[key], jcache[key], 1e-4, key)
    full, _ = tapi.apply(tcfg, model, torch.from_numpy(x))
    _close(full[:, -1], tlog, 1e-4, "forward vs decode")


def test_decode_state_is_o1_in_the_context():
    """The cache at ``max_len`` 160 and at 524,288 (long_500k) holds the
    same bytes; ``input_specs`` of long_500k gives those shapes."""
    cfg = tconfigs.get_arch(ARCH).config
    api = get_api(cfg)

    def nbytes(c):
        return sum(t.numel() * t.element_size() for t in c.values())
    short = api.init_cache(cfg, 1, 160, "meta")
    long = api.init_cache(cfg, 1, 524_288, "meta")
    assert nbytes(short) == nbytes(long) == 24 * (32 * 64 * 64 * 4
                                                  + 2 * 2048 * 2)
    spec = tconfigs.input_specs(tconfigs.get_arch(ARCH), "long_500k")
    assert {k: tuple(v.shape) for k, v in spec["cache"].items()} == \
        {k: tuple(v.shape) for k, v in long.items()}


def test_serve_matches_jax(monkeypatch, no_launches):
    """``serve()`` of both packages on the same float32 weights (the
    JAX serve's own draw replaced by ``_weights``'): the same greedy
    tokens."""
    jcfg, tcfg = _configs()
    params, model = _weights("float32")
    monkeypatch.setitem(jconfigs.ARCHS, ARCH, dataclasses.replace(
        jconfigs.get_arch(ARCH), smoke=jcfg))
    monkeypatch.setattr(jmodels, "init_params", lambda defs, key: params)
    want = jserve.serve(ARCH, batch=2, prompt_len=8, gen_len=6, seed=0)
    got = t_serve(ARCH, batch=2, prompt_len=8, gen_len=6, seed=0,
                  device="cpu", model=model)
    assert got.tokens.shape == (2, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    got = t_serve(ARCH, batch=2, prompt_len=4, gen_len=3, device="cpu")
    assert got.tokens.shape == (2, 3)


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve(ARCH, batch=1, prompt_len=2, gen_len=1)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_jax(remat):
    """``rwkv_loss`` and every parameter's gradient in float32 within
    1e-4, with and without rematerialisation."""
    jcfg, tcfg = _configs(remat=remat)
    params, model = _weights("float32")
    x, y = _tokens((2, 19), seed=3), _tokens((2, 19), seed=4)
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
    assert float(np.abs(_f32(got["layers"]["tm"]["u"])).max()) > 0


def test_checkpoint_round_trip_across_packages(tmp_path):
    """bf16 weights and float32 moments through ``convert`` bit for bit;
    a port checkpoint read by the JAX package."""
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
    again = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    for (name, a), b in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(a, b), name
    opt = adamw_init(dict(model.named_parameters()), AdamWConfig())
    state = convert.adamw_state_to_numpy(opt, tcfg)
    back = convert.adamw_state_from_numpy(state, tcfg, device="cpu")
    assert set(back["m"]) == set(opt["m"])
    save_checkpoint(tmp_path, 1, {"params": tree, "opt": state})
    read = j_load_checkpoint(tmp_path, 1, {
        "params": params, "opt": jax.tree.map(np.asarray, state)})
    for a, b in zip(jax.tree.leaves(read["params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(_f32(a), _f32(b))


def test_train_resumes_from_a_checkpoint(tmp_path):
    """``train()`` of the rwkv smoke config in float32: a JAX run
    checkpointed at step 2 resumes in the port with the JAX run's later
    losses, and the port's own bf16 run resumes exactly."""
    jcfg, tcfg = _configs()
    kw = dict(steps=4, batch=2, seq=16, seed=5, log_every=100)
    d = tmp_path / "jax"
    first = j_train(ARCH, config_override=jcfg, ckpt_dir=str(d),
                    ckpt_every=2, **kw)
    shutil.rmtree(d / "step_4")
    resumed = t_train(ARCH, config_override=tcfg, ckpt_dir=str(d),
                      device="cpu", **kw)
    assert resumed.resumed_from == 2 and resumed.steps == 2
    np.testing.assert_allclose(resumed.losses, first.losses[2:], atol=1e-5)

    kw["device"] = "cpu"
    whole = t_train(ARCH, **kw)
    d = tmp_path / "port"
    t_train(ARCH, ckpt_dir=str(d), ckpt_every=2, **kw)
    shutil.rmtree(d / "step_4")
    again = t_train(ARCH, ckpt_dir=str(d), **kw)
    assert again.resumed_from == 2 and again.losses == whole.losses[2:]
