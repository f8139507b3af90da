"""The port's LM training path against the JAX package, on the qwen3
smoke config (2 layers, width 64, 4/2 heads, head_dim 16): the data
pipeline, AdamW, gradient compression, the cosine schedule, ``lm_loss``,
``make_train_step``, rematerialisation, and ``train()`` checkpoints
resumed across packages.

Weights are the JAX package's ``init_params`` draw, carried into the
port with ``convert.lm_params_from_numpy``; tokens come from the seeded
``TokenStream``.  Tolerances, float32: the loss within 1e-5, the global
gradient norm within 1e-4 relative (per-leaf float32 sums are added in
another order), lr within 1e-6 relative, the moments within 1e-5 of
their leaf's largest entry, and the parameters within 1e-6 after
masking the elements whose gradient was under 1e-6 in magnitude, but
not 0, at some step (a first Adam step is nearly ``sign(g)``, so such
an element can move the other way; they are counted, and must be under
1% of the parameters).  bf16 (activations rounded to
bf16 in another order): the loss within 2e-2, the gradient norm within
5e-2 relative, the moments within 5e-2 of their leaf's largest entry;
after the same masking the float32 leaves within 2^-7 relative (plus
1e-6), and the bf16 leaves bit-equal to the reference's but for at most
3% of their elements, at most 1% outside 2^-7 relative (plus 1e-6).
Three steps move a bf16 element by about 9e-4, a few bf16 units in the
last place, so a parameter never written back or rounded the wrong way
breaks the bit-equal share.  Read on the CPU with jax 0.9.0 and torch
2.13: 1.45% of the bf16 elements differ, 0.36% outside 2^-7, all of
them elements whose update changed sign.
"""
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_substrate as reference_substrate_tests
from repro.configs import qwen3_1_7b as jqwen3
from repro.data import DataConfig, TokenStream
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.train import train as j_train
from repro.models import get_api as j_get_api
from repro.models import init_params as j_init_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import CompressionConfig as JCompressionConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import compress_gradients as j_compress
from repro.optim import cosine_schedule as j_cosine
from repro_torch import convert
from repro_torch.configs import qwen3_1_7b as tqwen3
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import get_api
from repro_torch.models.common import maybe_remat, remat_policy
from repro_torch.optim import (AdamWConfig, CompressionConfig, adamw_init,
                               adamw_update, compress_gradients,
                               cosine_schedule)
from repro_torch.tree import tree_leaves, tree_map
from torch_diff import run_reference_test

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
PACKAGES = ["repro", "repro_torch"]
BATCH, SEQ = 2, 16
# dtype -> (jax dtype, torch dtype, loss atol, grad-norm rtol, moment
# tolerance relative to the leaf's largest entry, parameter atol)
TOLS = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-4, 1e-5, 1e-6),
        "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 5e-2, 5e-2, 1e-6)}
NEAR_ZERO_GRAD = 1e-6
# bf16 parameters after three steps: relative tolerance, and the largest
# shares of bf16 elements that may differ at all / lie outside it
BF16_PARAM_RTOL, BF16_UNEQUAL, BF16_OUTSIDE = 2.0 ** -7, 0.03, 0.01


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor operations: one intra-op thread keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype, **changes):
    jd, td = TOLS[dtype][:2]
    return (dataclasses.replace(jqwen3.SMOKE, dtype=jd, **changes),
            dataclasses.replace(tqwen3.SMOKE, dtype=td, **changes))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batches(vocab, n, seed=3):
    stream = TokenStream(DataConfig(vocab, SEQ, BATCH, seed=seed))
    try:
        return [stream.batch_at(i) for i in range(n)]
    finally:
        stream.close()


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32))
                    .to(torch.bfloat16 if a.dtype == jnp.bfloat16
                        else torch.float32), tree)


# ----------------------------------------------------------------------
# The JAX package's data tests, on both packages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("name", ["test_data_deterministic_and_resumable",
                                  "test_data_host_sharding"])
def test_reference_data_tests(name, package, monkeypatch, tmp_path):
    run_reference_test(reference_substrate_tests, name, package,
                       monkeypatch, tmp_path)


# ----------------------------------------------------------------------
# Optimizer and compression
# ----------------------------------------------------------------------

def test_adamw_converges_quadratic():
    """``tests/test_substrate.py``'s quadratic, on tensors."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    for _ in range(200):
        params, state, _ = adamw_update(params, {"w": 2 * params["w"]},
                                        state, cfg)
    assert float(params["w"].abs().max()) < 0.05
    assert int(state["step"]) == 200 and state["step"].dtype == torch.int32


def test_compression_error_feedback():
    """``tests/test_substrate.py``'s error-feedback case, on tensors."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal(1000).astype(np.float32))}
    deq, resid = compress_gradients(g, None, CompressionConfig(enabled=True))
    err = (deq["w"] - g["w"]).abs()
    scale = float(g["w"].abs().max()) / 127
    assert float(err.max()) <= scale * 0.51 + 1e-6
    torch.testing.assert_close(resid["w"], g["w"] - deq["w"], atol=1e-6,
                               rtol=0)
    same, none = compress_gradients(g, None, CompressionConfig())
    assert same is g and none is None


def _seeded_tree(seed):
    """A tree of float32 and bf16 leaves (dicts and a list), as numpy."""
    rng = np.random.default_rng(seed)

    def leaf(shape, dtype, scale=1.0):
        return jnp.asarray(rng.standard_normal(shape) * scale, dtype)

    return {"a": leaf((3, 4), jnp.float32),
            "b": {"c": leaf((5,), jnp.bfloat16),
                  "d": leaf((2, 3, 2), jnp.float32, 0.1)},
            "e": [leaf((7,), jnp.bfloat16, 3.0)]}


@pytest.mark.parametrize("clip_norm", [None, 1.0])
@pytest.mark.parametrize("scheduled", [False, True])
def test_adamw_update_matches_reference(clip_norm, scheduled):
    """Three updates of a seeded tree: new parameters, moments, step and
    gradient norm equal the JAX package's (float32 leaves within 1e-6,
    bf16 leaves exact up to one bf16 rounding)."""
    jcfg = JAdamWConfig(clip_norm=clip_norm, weight_decay=0.1, lr=1e-2)
    tcfg = AdamWConfig(clip_norm=clip_norm, weight_decay=0.1, lr=1e-2)
    jp = _seeded_tree(1)
    jstate = j_adamw_init(jp, jcfg)
    tp = _torch_tree(jp)
    tstate = adamw_init(tp, tcfg)
    jsched, tsched = j_cosine(1e-2, 1, 3), cosine_schedule(1e-2, 1, 3)
    for i in range(3):
        jg = _seeded_tree(10 + i)
        tg = _torch_tree(jg)
        jlr = jsched(jstate["step"]) if scheduled else None
        tlr = tsched(tstate["step"]) if scheduled else None
        jp, jstate, jgn = j_adamw_update(jp, jg, jstate, jcfg, jlr)
        tp, tstate, tgn = adamw_update(tp, tg, tstate, tcfg, tlr)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16
                               else torch.float32)
            tol = 2 ** -8 if j.dtype == jnp.bfloat16 else 1e-6
            np.testing.assert_allclose(_f32(t), _f32(j), rtol=tol, atol=1e-6)
        for key in ("m", "v"):
            for t, j in zip(tree_leaves(tstate[key]),
                            jax.tree.leaves(jstate[key])):
                assert t.dtype == torch.float32
                np.testing.assert_allclose(_f32(t), _f32(j), rtol=1e-5,
                                           atol=1e-7)


def test_cosine_schedule_matches_reference():
    for warmup, total in ((0, 10), (3, 10), (1000, 50)):
        j, t = j_cosine(3e-4, warmup, total), cosine_schedule(3e-4, warmup,
                                                              total)
        for s in range(total + 3):
            np.testing.assert_allclose(
                float(t(torch.tensor(s, dtype=torch.int32))),
                float(j(jnp.asarray(s, jnp.int32))), rtol=1e-6, atol=1e-12)


def test_compress_gradients_matches_reference():
    """Quantization, dequantization and the error-feedback residual of a
    seeded tree over two rounds: exact (the same IEEE operations; both
    round half to even)."""
    cfg, jc = CompressionConfig(enabled=True), JCompressionConfig(enabled=True)
    jr = tr = None
    for i in range(2):
        jg = _seeded_tree(20 + i)
        jd, jr = j_compress(jg, jr, jc)
        td, tr = compress_gradients(_torch_tree(jg), tr, cfg)
        for t, j in zip(tree_leaves(td) + tree_leaves(tr),
                        jax.tree.leaves(jd) + jax.tree.leaves(jr)):
            np.testing.assert_array_equal(_f32(t), _f32(j))


# ----------------------------------------------------------------------
# Loss and train step
# ----------------------------------------------------------------------

def _models(dtype, seed=0, **changes):
    jcfg, tcfg = _configs(dtype, **changes)
    jparams = j_init_params(j_get_api(jcfg).defs(jcfg),
                            jax.random.PRNGKey(seed))
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         tcfg, device="cpu")
    return jcfg, tcfg, jparams, model


def test_lm_loss_matches_reference():
    jcfg, tcfg, jparams, model = _models("float32")
    x, y = _batches(tcfg.vocab_size, 1)[0]
    want = j_get_api(jcfg).loss(jcfg, jparams, jnp.asarray(x),
                                jnp.asarray(y))
    got = get_api(tcfg).loss(tcfg, model, torch.from_numpy(x),
                             torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_reference(dtype):
    """Three steps of ``make_train_step`` against the JAX package's on a
    one-device host mesh from the same weights and batches: loss, grad
    norm, lr, the AdamW moments and the masked parameters."""
    _jd, _td, loss_tol, gn_tol, mom_tol, p_tol = TOLS[dtype]
    jcfg, tcfg, jparams, model = _models(dtype, seed=1)
    total = 3
    bundle = j_make_train_step(jcfg, make_host_mesh(1, axis="data"),
                               batch=BATCH, seq=SEQ, total_steps=total)
    jstep = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                    out_shardings=bundle.out_shardings)
    jgrad = jax.jit(jax.grad(lambda p, x, y: j_get_api(jcfg).loss(
        jcfg, p, x, y)))
    tstep = make_train_step(tcfg, batch=BATCH, seq=SEQ, total_steps=total)
    jopt = j_adamw_init(jparams, JAdamWConfig())
    topt = adamw_init(dict(model.named_parameters()), AdamWConfig())
    near_zero = None
    for x, y in _batches(tcfg.vocab_size, total):
        g = jax.tree.map(lambda a: (np.abs(_f32(a)) < NEAR_ZERO_GRAD)
                         & (_f32(a) != 0),
                         jgrad(jparams, jnp.asarray(x), jnp.asarray(y)))
        near_zero = g if near_zero is None else jax.tree.map(
            np.logical_or, near_zero, g)
        jparams, jopt, jm = jstep(jparams, jopt, jnp.asarray(x),
                                  jnp.asarray(y))
        model, topt, tm = tstep(model, topt, torch.from_numpy(x),
                                torch.from_numpy(y))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=loss_tol)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=gn_tol)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(topt["step"]) == int(jopt["step"]) == total
    got_p = convert.lm_params_to_numpy(model)
    got_s = convert.adamw_state_to_numpy(topt, tcfg)
    masked = n_bf16 = unequal = outside = 0
    for (path, j), t, z in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0],
            jax.tree.leaves(got_p), jax.tree.leaves(near_zero)):
        keep = ~z
        masked += int(z.sum())
        t32, j32 = _f32(t)[keep], _f32(j)[keep]
        if dtype == "float32":
            np.testing.assert_allclose(t32, j32, atol=p_tol, rtol=0,
                                       err_msg=str(path))
        elif j.dtype != jnp.bfloat16:
            np.testing.assert_allclose(t32, j32, atol=p_tol,
                                       rtol=BF16_PARAM_RTOL,
                                       err_msg=str(path))
        else:
            n_bf16 += t32.size
            unequal += int((t32 != j32).sum())
            outside += int((np.abs(t32 - j32)
                            > BF16_PARAM_RTOL * np.abs(j32) + p_tol).sum())
    if dtype == "bfloat16":
        print(f"bf16 parameters: {unequal} of {n_bf16} differ, {outside} "
              f"outside {BF16_PARAM_RTOL} relative")
        assert n_bf16 and unequal <= BF16_UNEQUAL * n_bf16, (unequal, n_bf16)
        assert outside <= BF16_OUTSIDE * n_bf16, (outside, n_bf16)
    for key in ("m", "v"):
        for t, j in zip(jax.tree.leaves(got_s[key]),
                        jax.tree.leaves(jopt[key])):
            scale = float(np.abs(_f32(j)).max()) or 1.0
            np.testing.assert_allclose(_f32(t), _f32(j),
                                       atol=mom_tol * scale, rtol=0)
    n = sum(np.size(z) for z in jax.tree.leaves(near_zero))
    print(f"{dtype}: {masked} of {n} parameters masked")
    assert masked < n // 100, (masked, n)


def _loss_and_grads(cfg, model, x, y):
    loss = get_api(cfg).loss(cfg, model, torch.from_numpy(x),
                             torch.from_numpy(y))
    params = list(model.parameters())
    return loss, torch.autograd.grad(loss, params)


def test_remat_policies_give_the_same_loss_and_gradients():
    """``none``, ``full`` and ``dots`` compute the same loss and
    gradients; ``full`` recomputes the blocks' matmuls in the backward
    pass, ``dots`` keeps them (counted as ``aten.mm`` calls)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    _jcfg, tcfg, _jp, model = _models("float32", seed=2)
    for p in model.parameters():
        p.requires_grad_(True)
    x, y = _batches(tcfg.vocab_size, 1)[0]
    out, mms = {}, {}
    for name in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=name)
        loss = get_api(cfg).loss(cfg, model, torch.from_numpy(x),
                                 torch.from_numpy(y))
        with CountMM() as count:
            grads = torch.autograd.grad(loss, list(model.parameters()))
        out[name], mms[name] = (loss, grads), count.n
    for name in ("full", "dots"):
        assert torch.equal(out[name][0], out["none"][0])
        for a, b in zip(out[name][1], out["none"][1]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    # a block's 7 matmuls (q, k, v, o, w1, w3, w2) are recomputed but the
    # last: the non-reentrant checkpoint stops once the tensors the
    # backward needs are rebuilt, and no gradient needs w2's output
    assert mms["full"] == mms["none"] + 6 * tcfg.num_layers
    assert mms["dots"] == mms["none"]
    assert remat_policy("none") is None
    with pytest.raises(ValueError):
        remat_policy("most")
    f = lambda t: t * 2  # noqa: E731
    assert maybe_remat(f, "none") is f


# ----------------------------------------------------------------------
# train(): checkpoints across packages, the device rule, the CLI
# ----------------------------------------------------------------------

def _resume_case(writer, reader, tmp_path):
    """``writer`` trains 4 steps, checkpointing at steps 2 and 4; the
    step-4 checkpoint is removed (a run stopped after step 2) and
    ``reader`` resumes from step 2: its losses for steps 2 and 3 equal
    the writer's (float32 smoke config)."""
    d = tmp_path / "ckpt"
    kw = dict(steps=4, batch=BATCH, seq=SEQ, seed=5, log_every=100)
    first = writer(ckpt_dir=str(d), ckpt_every=2, **kw)
    assert sorted(p.name for p in d.glob("step_*")) == ["step_2", "step_4"]
    shutil.rmtree(d / "step_4")
    resumed = reader(ckpt_dir=str(d), **kw)
    assert resumed.resumed_from == 2 and resumed.steps == 2
    np.testing.assert_allclose(resumed.losses, first.losses[2:], atol=1e-5)
    return first, resumed


def _j_train(**kw):
    return j_train(ARCH, config_override=_configs("float32")[0], **kw)


def _t_train(**kw):
    return train(ARCH, config_override=_configs("float32")[1], device="cpu",
                 **kw)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    _resume_case(_j_train, _t_train, tmp_path)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    _resume_case(_t_train, _j_train, tmp_path)


def test_train_resume_is_exact_in_bf16(tmp_path):
    kw = dict(steps=4, batch=BATCH, seq=SEQ, seed=7, log_every=100,
              device="cpu")
    whole = train(ARCH, **kw)
    train(ARCH, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    shutil.rmtree(tmp_path / "step_4")
    resumed = train(ARCH, ckpt_dir=str(tmp_path), **kw)
    assert resumed.losses == whole.losses[2:]


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(ARCH, steps=1, batch=BATCH, seq=SEQ)


def test_train_cli_on_the_cpu(tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--steps", "3", "--batch", str(BATCH), "--seq", str(SEQ),
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-every", "3"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[train] done: 3 steps" in out.stdout
    assert (tmp_path / "ck" / "step_3" / "manifest.json").exists()
