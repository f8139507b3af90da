"""Plain versions of the port's flash attention and semijoin kernels vs
the JAX package.

The same seeded numpy inputs go through ``repro_torch.kernels.ops`` on
the CPU (where each wrapper runs its plain version, ``kernels/ref.py``)
and through the JAX package's Pallas kernels in interpret mode and its
jnp oracles.  Attention tolerances are those of the JAX package's own
kernel sweep (``tests/test_kernels.py``): 2e-5 in float32, 4e-2 in
bf16; semijoin masks are compared exactly.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import attention as j_attention
from repro.kernels import ref as jref
from repro.kernels import semijoin as j_semijoin
from repro_torch.kernels import ops

INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max

# the JAX package's attention sweep (tests/test_kernels.py ATTN_CASES),
# and one case more
ATTN_CASES = [
    # B, Hq, Hkv, Sq, Skv, D, causal, window
    (1, 4, 2, 256, 256, 64, True, None),
    (2, 8, 8, 128, 128, 32, True, None),
    (1, 4, 1, 256, 256, 64, True, 128),     # sliding window + GQA 4:1
    (1, 2, 2, 200, 200, 64, True, None),    # padded path
    (1, 4, 4, 128, 384, 64, True, None),    # cross (q at end of timeline)
    (1, 8, 2, 512, 512, 128, True, None),   # MXU-width head dim
    (1, 4, 4, 256, 256, 64, True, 64),      # window < block
    # beyond the JAX sweep: no causal mask
    (1, 4, 2, 128, 256, 64, False, None),
]
TOL = {"float32": 2e-5, "bfloat16": 4e-2}


@pytest.fixture
def no_launches():
    """Wrappers given CPU tensors run the plain version: no launch."""
    ops.reset_launches()
    yield
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D, dtype):
    rng = np.random.default_rng(seed)
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    return [rng.standard_normal(shape).astype(np_dtype)
            for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                          (B, Hkv, Skv, D))]


def _torch(a):
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _port(q, k, v, causal, window):
    got = ops.attention(_torch(q), _torch(k), _torch(v), causal=causal,
                        window=window)
    return got.float().numpy()


def _f32(x):
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_jax_kernel_and_oracle(case, dtype,
                                                     no_launches):
    B, Hq, Hkv, Sq, Skv, D, causal, window = case
    q, k, v = _inputs(sum(case[:6]), B, Hq, Hkv, Sq, Skv, D, dtype)
    got = _port(q, k, v, causal, window)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tol = TOL[dtype]
    for want in (j_attention(jq, jk, jv, causal=causal, window=window),
                 jref.attention_ref(jq, jk, jv, causal=causal,
                                    window=window)):
        np.testing.assert_allclose(got, _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_row_with_no_visible_key_is_zero(window, dtype,
                                                   no_launches):
    """Sq > Skv: the first Sq - Skv query rows sit before the first key
    (position < 0) and see nothing; they are 0, as in the JAX oracle."""
    B, Hq, Hkv, Sq, Skv, D = 1, 4, 2, 256, 128, 32
    q, k, v = _inputs(7, B, Hq, Hkv, Sq, Skv, D, dtype)
    got = _port(q, k, v, True, window)
    assert not got[:, :, :Sq - Skv].any()
    assert np.abs(got[:, :, Sq - Skv:]).sum(-1).min() > 0
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window)
    np.testing.assert_allclose(got, _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_attention_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 3, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        ops.attention(q, kv, kv)
    with pytest.raises(ValueError, match="window"):
        ops.attention(torch.zeros(1, 2, 8, 16), kv, kv, window=0)


def test_attention_inputs_the_kernel_cannot_read_in_place_are_copied():
    """Head-transposed views are read in place; a view whose base is not
    16-byte aligned goes to a fresh, aligned copy."""
    x = torch.zeros(2, 8, 3, 16, dtype=torch.bfloat16).transpose(1, 2)
    assert ops._rows(x) is x
    flat = torch.zeros(1 + 2 * 3 * 8 * 16, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 3, 8, 16)
    assert shifted.data_ptr() % 16 != 0
    got = ops._rows(shifted)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, shifted)


def _semijoin_cases():
    rng = np.random.default_rng(3)
    cases = {}
    for m, n, key_range in ((1, 1, 50), (513, 1025, 50), (5000, 5000, 5000),
                            (20000, 3000, 5000)):
        table = np.sort(rng.integers(0, key_range, n).astype(np.int32))
        queries = rng.integers(0, int(key_range * 1.3), m).astype(np.int32)
        cases[f"random-{m}-{n}-{key_range}"] = (queries, table)
    real = rng.integers(0, 300, 700).astype(np.int32)
    queries = rng.integers(0, 400, 500).astype(np.int32)
    for name, fill in (("min_pads", INT32_MIN), ("max_pads", INT32_MAX)):
        cases[name] = (queries, np.sort(np.concatenate(
            [real, np.full(345, fill, np.int32)])))
    cases["minus_one_pads"] = (
        np.concatenate([queries, np.full(77, -1, np.int32)]),
        np.sort(np.concatenate([real, np.full(345, -1, np.int32)])))
    cases["duplicates"] = (rng.integers(0, 8, 900).astype(np.int32),
                           np.sort(rng.integers(0, 4, 600).astype(np.int32)))
    cases["all_pad_table"] = (queries, np.full(1000, INT32_MIN, np.int32))
    # runs of up to 3000 equal keys (a Zipf hub's subject window), alone
    # and behind INT32_MIN pads; queries on, between and beyond the runs
    values = np.arange(0, 600, 3, dtype=np.int32)
    runs = np.minimum(rng.zipf(1.5, values.size), 3000)
    long_runs = np.repeat(values, runs)
    queries = rng.integers(-5, 610, 4000).astype(np.int32)
    cases["long_runs"] = (queries, long_runs)
    cases["long_runs_min_pads"] = (queries, np.concatenate(
        [np.full(500, INT32_MIN, np.int32), long_runs]))
    return cases


SEMIJOIN_CASES = _semijoin_cases()


@pytest.mark.parametrize("name", sorted(SEMIJOIN_CASES))
def test_semijoin_ref_matches_jax(name, no_launches):
    queries, table = SEMIJOIN_CASES[name]
    got = ops.semijoin(torch.from_numpy(queries), torch.from_numpy(table))
    assert got.dtype == torch.bool
    got = got.numpy()
    np.testing.assert_array_equal(got, np.isin(queries, table))
    jq, jt = jnp.asarray(queries), jnp.asarray(table)
    np.testing.assert_array_equal(got, np.asarray(j_semijoin(jq, jt)))
    np.testing.assert_array_equal(
        got, np.asarray(jref.semijoin_mask_ref(jq, jt)))


@pytest.mark.parametrize("m,n", [(0, 5), (5, 0), (0, 0)])
def test_semijoin_empty_sides(m, n, no_launches):
    queries = np.arange(m, dtype=np.int32)
    table = np.arange(n, dtype=np.int32)
    got = ops.semijoin(torch.from_numpy(queries), torch.from_numpy(table))
    assert got.shape == (m,) and not got.any()
    want = np.asarray(j_semijoin(jnp.asarray(queries), jnp.asarray(table)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_cpu_output_layout_and_head_merge(dtype, no_launches):
    """On the CPU the wrapper returns its plain version's [B, Hq, Sq, D]
    tensor, also for the head-transposed views the model passes; the
    model's merge of the heads gives the same [B, Sq, Hq * D] rows.
    (On the card the result is a [B, Sq, Hq, D] buffer viewed as [B,
    Hq, Sq, D], so the merge is a view; ``chip_smoke.py`` checks that.)"""
    from repro_torch.kernels import ref
    B, Hq, Hkv, S, D = 2, 4, 2, 40, 32
    rng = np.random.default_rng(5)
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q, k, v = (_torch(rng.standard_normal((B, S, H, D)).astype(np_dtype))
               .transpose(1, 2) for H in (Hq, Hkv, Hkv))
    got = ops.attention(q, k, v)
    want = ref.attention_ref(q, k, v)
    assert got.shape == (B, Hq, S, D) and got.dtype == q.dtype
    assert torch.equal(got, want)
    merged = got.transpose(1, 2).reshape(B, S, Hq * D)
    assert torch.equal(merged, want.transpose(1, 2).reshape(B, S, Hq * D))


@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_attention_refuses_autograd(needs_grad, no_launches):
    """The flash kernel has no backward (nor has the reference's: jax.grad
    through its Pallas kernel fails), so with grad mode on a q, k or v
    that requires grad is refused on both devices -- on the card its
    output would silently carry no gradient."""
    q, k, v = (_torch(a) for a in _inputs(3, 1, 4, 2, 32, 32, 16,
                                          "float32"))
    dict(q=q, k=k, v=v)[needs_grad].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q, k, v)


def test_attention_under_no_grad_is_unchanged(no_launches):
    """Serving runs under ``torch.no_grad()``: inputs that require grad
    give the plain version's output, with no graph."""
    from repro_torch.kernels import ref
    q, k, v = (_torch(a).requires_grad_(True)
               for a in _inputs(4, 1, 4, 2, 48, 48, 16, "float32"))
    with torch.no_grad():
        got = ops.attention(q, k, v)
        want = ref.attention_ref(q, k, v, True, None, None)
    assert got.grad_fn is None
    assert torch.equal(got, want)


def test_training_forward_through_the_flash_kernel_is_refused(no_launches):
    """A loss through ``use_flash_kernel=True`` raises; the same config
    on plain attention trains, and serving through the kernel (under
    ``lm_apply``'s ``no_grad``) gives the plain forward's logits."""
    import dataclasses

    from repro_torch.configs import qwen3_1_7b
    from repro_torch.models import build_lm, get_api
    cfg = dataclasses.replace(qwen3_1_7b.SMOKE, dtype=torch.float32)
    flash = dataclasses.replace(cfg, use_flash_kernel=True)
    model = build_lm(cfg, device="cpu", seed=1)
    for p in model.parameters():
        p.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    with pytest.raises(RuntimeError, match="no backward"):
        get_api(flash).loss(flash, model, toks, toks)
    loss = get_api(cfg).loss(cfg, model, toks, toks)
    assert torch.isfinite(loss) and loss.grad_fn is not None
    served, _ = get_api(flash).apply(flash, model, toks)
    plain, _ = get_api(cfg).apply(cfg, model, toks)
    torch.testing.assert_close(served, plain, atol=1e-5, rtol=1e-5)
