"""The LM substrate across a device mesh: the port's sharded forward,
train and serve steps (``launch.steps`` with ``mesh=``) on a gloo world
of 4 ranks, a (2, 2) ("data", "model") ``DeviceMesh``, against the JAX
package's steps jitted with their shardings on the 4 host devices that
``tests/conftest.py`` forces, from the same weights and batches.

Cases: the qwen3, qwen2-moe (``moe_shard_map`` off and on), rwkv6,
jamba and llama3 smoke configs in float32; jamba and llama3 with the
``fsdp`` and ``seq_shard_decode`` of their published configs.  The
port's qwen3 also runs its forward with ``use_flash_kernel`` (the
attention on each rank's local heads through ``local_map``; the kernel
has no backward, and the reference's Pallas kernel cannot be
partitioned by jit, so the other side runs plain attention).

- forward logits within the tolerance ``test_torch_lm.py``,
  ``test_torch_rwkv.py`` and ``test_torch_jamba.py`` hold the families'
  forwards to (1e-4);
- two train steps: loss, ``grad_norm`` and ``lr`` of each, the updated
  parameters (masked where a JAX gradient is near zero, as
  ``test_torch_train.py`` does) and the first moments;
- serve steps: the tokens and the whole cache.  Jamba's are held to
  the JAX package's on the first token only, and then to the port's
  unsharded serve step: the reference's decode carries the
  convolution's outputs, so it parts from its own forward (``ROADMAP.md``
  queue 3);
- every local shard shape (parameters, moments, logits, caches) equals
  the JAX ``addressable_shards`` shape at the rank's mesh coordinate.

The world starts once for the module (``torch_dist_ranks.
sharded_steps_rank``); the JAX steps run in this process meanwhile."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro import configs as jconfigs
from repro.launch.steps import make_forward_step as j_forward_step
from repro.launch.steps import make_serve_step as j_serve_step
from repro.launch.steps import make_train_step as j_train_step
from repro.models import get_api as j_get_api
from repro.models import init_params as j_init_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch.mesh import launch

# name -> (arch, config changes, steps run); "use_flash_kernel" is the
# port's side only
CASES = {
    "qwen3": ("qwen3-1.7b", {}, ("forward", "train", "serve")),
    "qwen3-flash": ("qwen3-1.7b", {"use_flash_kernel": True},
                    ("forward",)),
    "qwen2-moe": ("qwen2-moe-a2.7b", {}, ("forward", "train")),
    "qwen2-moe-shard-map": ("qwen2-moe-a2.7b", {"moe_shard_map": True},
                            ("forward", "train")),
    "rwkv6": ("rwkv6-1.6b", {}, ("forward", "train", "serve")),
    "jamba": ("jamba-1.5-large-398b",
              {"fsdp": True, "seq_shard_decode": True},
              ("forward", "train", "serve")),
    "llama3": ("llama3-405b", {"fsdp": True, "seq_shard_decode": True},
               ("forward", "train", "serve")),
}
BATCH, SEQ = 4, 16            # the batch splits over "data"
MAX_LEN, SERVE_STEPS = 8, 3
TRAIN_STEPS, TOTAL_STEPS = 2, 10   # the first step's lr is 0 (warmup)
LOGITS_TOL = 1e-4
# float32 train tolerances (test_torch_train.py's): loss atol,
# grad-norm rtol, moment atol relative to the leaf's largest entry,
# parameter atol where no JAX gradient was near zero
LOSS_TOL, GN_TOL, MOM_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-5, 1e-6
NEAR_ZERO_GRAD = 1e-6
# and a share of the last step's lr: a gradient summed across the ranks
# in another order than XLA's moves by about 1e-7, and AdamW's
# normalised step turns that into a relative error of the whole step
# where a gradient is small or cancels the step before (read: 1 of
# rwkv6's 16384 embedding entries 6.3e-6 off at lr 3e-4); a wrong
# gradient moves the step by the whole lr
STEP_RTOL = 0.05
# rwkv's moments: test_torch_rwkv.py holds its gradients to 1e-4 (the
# chunked recurrence's exp / log of the decays in float32; read here
# 9.1e-5 of the embedding moment's largest entry)
MOM_TOL_BY_CASE = {"rwkv6": 2e-4}
CACHE_TOL = 1e-4
DEADLINE_S = 900.0


def _jax_mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))


def _configs(name):
    arch, changes, _kinds = CASES[name]
    jchanges = {k: v for k, v in changes.items() if k != "use_flash_kernel"}
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).smoke,
                               dtype=jnp.float32, **jchanges)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).smoke,
                               dtype=torch.float32, **changes)
    return jcfg, tcfg


def _inputs(name, vocab):
    rng = np.random.default_rng(sum(map(ord, name)))
    toks = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    batches = [(rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
                rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32))
               for _ in range(TRAIN_STEPS)]
    return toks, batches


def _shard_shapes(arr, mesh):
    """Mesh coordinate (row-major rank) -> the shape of the shard that
    device holds."""
    where = {d: r for r, d in enumerate(mesh.devices.flat)}
    return {where[s.device]: tuple(s.data.shape)
            for s in arr.addressable_shards}


def _jax_case(name, jparams, toks, batches):
    """The JAX package's sharded steps of one case."""
    jcfg, _ = _configs(name)
    api = j_get_api(jcfg)
    mesh = _jax_mesh()
    kinds = CASES[name][2]
    out = {}
    with mesh:
        if "forward" in kinds:
            fb = j_forward_step(jcfg, mesh, BATCH, SEQ)
            f = jax.jit(fb.fn, in_shardings=fb.in_shardings,
                        out_shardings=fb.out_shardings)
            logits = f(jparams, jnp.asarray(toks))
            out["forward"] = {"logits": np.asarray(logits),
                              "local": _shard_shapes(logits, mesh)}
        if "train" in kinds:
            tb = j_train_step(jcfg, mesh, batch=BATCH, seq=SEQ,
                              total_steps=TOTAL_STEPS)
            step = jax.jit(tb.fn, in_shardings=tb.in_shardings,
                           out_shardings=tb.out_shardings)
            grad = jax.jit(jax.grad(lambda p, x, y: api.loss(jcfg, p, x, y)))
            params, state = jparams, j_adamw_init(jparams, JAdamWConfig())
            metrics, near_zero = [], None
            for x, y in batches:
                g = jax.tree.map(
                    lambda a: (np.abs(np.asarray(a)) < NEAR_ZERO_GRAD)
                    & (np.asarray(a) != 0),
                    grad(params, jnp.asarray(x), jnp.asarray(y)))
                near_zero = g if near_zero is None else jax.tree.map(
                    np.logical_or, near_zero, g)
                params, state, met = step(params, state, jnp.asarray(x),
                                          jnp.asarray(y))
                metrics.append({k: float(v) for k, v in met.items()})
            out["train"] = {
                "metrics": metrics, "near_zero": near_zero,
                "params": jax.tree.map(np.asarray, params),
                "m": jax.tree.map(np.asarray, state["m"]),
                "local": jax.tree.map(lambda a: _shard_shapes(a, mesh),
                                      params),
                "m_local": jax.tree.map(lambda a: _shard_shapes(a, mesh),
                                        state["m"])}
        if "serve" in kinds:
            sb = j_serve_step(jcfg, mesh, BATCH, MAX_LEN)
            step = jax.jit(sb.fn, in_shardings=sb.in_shardings,
                           out_shardings=sb.out_shardings)
            cache = api.init_cache(jcfg, BATCH, MAX_LEN)
            tok, tokens = jnp.asarray(toks[:, 0]), []
            for pos in range(SERVE_STEPS):
                tok, cache = step(jparams, tok, cache, jnp.int32(pos))
                tokens.append(np.asarray(tok))
            out["serve"] = {"tokens": tokens,
                            "cache": jax.tree.map(np.asarray, cache),
                            "local": [_shard_shapes(a, mesh)
                                      for a in jax.tree.leaves(cache)]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX records, every rank's records) of all cases."""
    inputs, jparams, rank_cases = {}, {}, {}
    for name, (arch, _changes, kinds) in CASES.items():
        jcfg, tcfg = _configs(name)
        jparams[name] = j_init_params(j_get_api(jcfg).defs(jcfg),
                                      jax.random.PRNGKey(len(name)))
        inputs[name] = _inputs(name, tcfg.vocab_size)
        rank_cases[name] = {
            "cfg": tcfg, "kinds": kinds,
            "params": jax.tree.map(np.asarray, jparams[name]),
            "toks": inputs[name][0], "batches": inputs[name][1],
            "total_steps": TOTAL_STEPS, "max_len": MAX_LEN,
            "serve_steps": SERVE_STEPS}
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(launch, ranks.sharded_steps_rank, 4,
                            tmp_path_factory.mktemp("sharded"),
                            backend="gloo", args=(rank_cases,),
                            deadline_s=DEADLINE_S)
        want = {name: _jax_case(name, jparams[name], *inputs[name])
                for name in CASES}
        got = world.result()
    return want, got


def _names(kind):
    return [n for n, c in CASES.items() if kind in c[2]]


def _coords(got):
    """Each rank's row-major mesh coordinate, which is its rank."""
    for r in got:
        assert r["coord"] == divmod(r["rank"], 2)
    return [r["rank"] for r in got]


@pytest.mark.parametrize("name", _names("forward"))
def test_sharded_forward_matches_jax(runs, name):
    want, got = runs
    w = want[name]["forward"]
    for r, rank in zip(got, _coords(got)):
        g = r["cases"][name]["forward"]
        np.testing.assert_allclose(g["logits"], w["logits"],
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)
        assert g["local"] == w["local"][rank]


def _stacked_local(tree_local, port_local, cfg):
    """Pairs (JAX shard shape, the port's local shape) of every
    parameter at each stacked index: the port's module holds one layer,
    the JAX leaf stacks them on its leading axes."""
    from repro_torch.models import get_api
    from repro_torch.models.common import iter_defs
    for path, d in iter_defs(get_api(cfg).defs(cfg)):
        leaf = tree_local
        for k in path.split("."):
            leaf = leaf[k]
        for idx, pname in convert._leaf_names(path.split("."), d):
            yield path, leaf, len(idx), port_local[pname]


@pytest.mark.parametrize("name", _names("train"))
def test_sharded_train_steps_match_jax(runs, name):
    want, got = runs
    w = want[name]["train"]
    _jcfg, tcfg = _configs(name)
    for r, rank in zip(got, _coords(got)):
        g = r["cases"][name]["train"]
        for gm, wm in zip(g["metrics"], w["metrics"]):
            np.testing.assert_allclose(gm["loss"], wm["loss"], atol=LOSS_TOL)
            np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"],
                                       rtol=GN_TOL)
            np.testing.assert_allclose(gm["lr"], wm["lr"], rtol=1e-6)
        masked = total = 0
        for (path, j), t, z in zip(
                jax.tree_util.tree_flatten_with_path(w["params"])[0],
                jax.tree.leaves(g["params"]), jax.tree.leaves(w["near_zero"])):
            keep = ~np.asarray(z)
            masked, total = masked + int((~keep).sum()), total + keep.size
            np.testing.assert_allclose(
                np.asarray(t, np.float32)[keep],
                np.asarray(j, np.float32)[keep],
                atol=PARAM_TOL + STEP_RTOL * w["metrics"][-1]["lr"], rtol=0,
                err_msg=str(path))
        assert masked < total // 100, (masked, total)
        for t, j in zip(jax.tree.leaves(g["m"]), jax.tree.leaves(w["m"])):
            scale = float(np.abs(j).max()) or 1.0
            np.testing.assert_allclose(
                np.asarray(t, np.float32), j, rtol=0,
                atol=MOM_TOL_BY_CASE.get(name, MOM_TOL) * scale)
        for key, local in (("local", "local"), ("m_local", "m_local")):
            for path, shapes, lead, port in _stacked_local(
                    w[key], g[local], tcfg):
                assert port == shapes[rank][lead:], (path, rank)


@pytest.mark.parametrize("name", _names("serve"))
def test_sharded_serve_steps_match_jax(runs, name):
    want, got = runs
    w = want[name]["serve"]
    for r, rank in zip(got, _coords(got)):
        g = r["cases"][name]["serve"]
        for (tok, plain), wtok in zip(g["tokens"], w["tokens"]):
            np.testing.assert_array_equal(tok, plain)
            if name != "jamba":
                np.testing.assert_array_equal(tok, wtok)
        # the first token does not read the conv context yet
        np.testing.assert_array_equal(g["tokens"][0][0], w["tokens"][0])
        # jamba's decode parts from the JAX package's after its first
        # token: it is held to the port's unsharded serve step
        ref = g["plain_cache"] if name == "jamba" else w["cache"]
        for key in g["cache"]:
            for t, j in zip(jax.tree.leaves(g["cache"][key]),
                            jax.tree.leaves(ref[key])):
                np.testing.assert_allclose(t, np.asarray(j, np.float32),
                                           atol=CACHE_TOL, rtol=CACHE_TOL,
                                           err_msg=key)
        assert g["local"] == [s[rank] for s in w["local"]]
