"""The dry run and its cost accounting (``launch/opcost.py``,
``launch/dryrun.py``) on the CPU.

- ``opcost.analyze`` on a plain matmul counts exactly 2*M*N*K and no
  collective; on a 12-layer stack within [want, 1.2 want], as
  ``tests/test_substrate.py:162-185`` asks of the reference's
  ``hlocost``;
- a model-sharded matmul on a fake world of 4: its collective bytes are
  the analytic ring count;
- one dry-run cell per family (and per step kind) at the smoke config on
  a fake world of 4, a (2, 2) ("data", "model") mesh: each device's
  argument bytes equal the exact sum of the local shard sizes that the
  reference's shardings imply (its step's ``in_shardings``), and its
  FLOPs per device lie within a stated band of the reference's
  ``hlocost.analyze`` of the same smoke cell compiled on the (2, 2)
  host mesh of ``tests/conftest.py``'s 4 devices."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.launch.hlocost import analyze as j_hlocost
from repro.launch.steps import make_forward_step as j_forward_step
from repro.launch.steps import make_serve_step as j_serve_step
from repro.launch.steps import make_train_step as j_train_step
from repro_torch.launch import dryrun
from repro_torch.launch.opcost import analyze

# (arch, shape): every family, every step kind
CELLS = [("qwen3-1.7b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
         ("rwkv6-1.6b", "decode_32k"), ("jamba-1.5-large-398b", "train_4k"),
         ("llama3-405b", "decode_32k"), ("mixtral-8x7b", "train_4k")]
# port FLOPs per device / the reference's hlocost FLOPs per device on
# the same smoke cell, by step kind.  Read on the CPU: qwen3 train
# 0.8663, qwen2-moe prefill 0.8743, jamba train 0.7754, mixtral train
# 0.8580 (the matmuls lead; XLA counts its converts and fused
# elementwise work the port's float32 casts count otherwise; jamba's
# scan is counted in chunks, dryrun._counting_scan), rwkv6
# decode 0.6653 and llama3 decode 0.4176 (a decode step's few matmuls
# leave the count to the elementwise and cache work, which the two
# count differently: XLA's dynamic-update-slice against the port's
# where over the cache)
FLOP_BAND = {"train": (0.75, 1.0), "prefill": (0.75, 1.0),
             "decode": (0.4, 0.8)}


@pytest.fixture(scope="module")
def fake_group():
    """The dry run's fake process groups live in this process; none is
    left behind."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_opcost_plain_matmul_is_exact():
    cost, _ = analyze(lambda a, b: a @ b, torch.zeros(256, 512),
                      torch.zeros(512, 128))
    assert cost.flops == 2 * 256 * 512 * 128
    assert cost.total_collective_bytes == 0 and not cost.collective_counts


def test_opcost_layer_stack():
    def fn(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x
    cost, _ = analyze(fn, torch.zeros(128, 256), torch.zeros(12, 256, 256))
    want = 2 * 12 * 128 * 256 * 256
    assert want <= cost.flops <= want * 1.2
    assert cost.transcendentals == 12 * 128 * 256


def test_opcost_sharded_matmul_collectives(fake_group):
    """x [8, 64] sharded on its contraction over a 4-rank "model" axis
    times w [64, 32] sharded on its rows: each rank multiplies its
    [8, 16] by [16, 32] (2*8*32*16 FLOPs) and the Partial result's
    all-reduce moves 2 * 3/4 of its 8*32*4 bytes; gathering a
    row-sharded [8, 32] moves 3/4 of the 8*32*4 bytes it outputs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_grid_mesh
    dryrun.fake_world(4)
    mesh = make_grid_mesh((4,), ("model",), device="cpu")
    x = distribute_tensor(torch.zeros(8, 64), mesh, [Shard(1)])
    w = distribute_tensor(torch.zeros(64, 32), mesh, [Shard(0)])
    cost, _ = analyze(lambda a, b: (a @ b).full_tensor(), x, w)
    assert cost.flops == 2 * 8 * 32 * 16
    assert cost.collective_bytes == {"all-reduce": 8 * 32 * 4 * 2 * 3 / 4}
    assert cost.collective_counts == {"all-reduce": 1}
    y = distribute_tensor(torch.zeros(8, 32), mesh, [Shard(0)])
    cost, _ = analyze(lambda a: a.redistribute(mesh, [Replicate()]), y)
    assert cost.collective_bytes == {"all-gather": 8 * 32 * 4 * 3 / 4}


def test_adamw_reduces_a_partial_gradient_once(fake_group):
    """A Partial gradient of a row-sharded [64, 32] parameter on a
    4-rank "data" axis is reduced once, to the parameter's placements:
    one reduce-scatter of its 64*32*4 bytes (3/4 of them move), as
    GSPMD reduce-scatters a gradient to its parameter's sharding; the
    global norm's all-reduce moves a scalar only."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import make_grid_mesh
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    dryrun.fake_world(4)
    mesh = make_grid_mesh((4,), ("data",), device="cpu")
    params = {"w": distribute_tensor(torch.zeros(64, 32), mesh, [Shard(0)])}
    grads = {"w": DTensor.from_local(torch.zeros(64, 32), mesh, [Partial()])}
    state = adamw_init(params, AdamWConfig())

    def update():
        with implicit_replication():
            return adamw_update(params, grads, state, AdamWConfig())

    cost, _ = analyze(update)
    assert cost.collective_counts["reduce-scatter"] == 1
    assert cost.collective_bytes["reduce-scatter"] == 64 * 32 * 4 * 3 / 4
    assert cost.collective_bytes.get("all-reduce", 0.0) <= 4 * 2 * 3 / 4


def _jax_cell(arch, shape):
    """The reference's smoke cell on the (2, 2) host mesh: (its
    hlocost, the bytes of every device's argument shards)."""
    spec = jconfigs.get_arch(arch)
    sh = spec.shape(shape)
    cfg = spec.smoke
    B, S = 2, min(sh.seq_len, 64)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    if sh.kind == "train":
        b = j_train_step(cfg, mesh, batch=B, seq=S)
        args = (b.input_shapes["params"], b.input_shapes["opt_state"],
                b.input_shapes["inputs"], b.input_shapes["targets"])
    elif sh.kind == "prefill":
        b = j_forward_step(cfg, mesh, B, S)
        args = (b.input_shapes["params"], b.input_shapes["inputs"])
    else:
        b = j_serve_step(cfg, mesh, B, S)
        args = (b.input_shapes["params"], b.input_shapes["token"],
                b.input_shapes["cache"], b.input_shapes["pos"])
    with mesh:
        compiled = jax.jit(b.fn, in_shardings=b.in_shardings,
                           out_shardings=b.out_shardings).lower(
                               *args).compile()
    nbytes = 0
    for struct, sharding in zip(jax.tree.leaves(args),
                                jax.tree.leaves(b.in_shardings)):
        nbytes += int(np.prod(sharding.shard_shape(struct.shape))) \
            * np.dtype(struct.dtype).itemsize
    return j_hlocost(compiled.as_text(), world=4), nbytes


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_smoke_cell_matches_reference(arch, shape, fake_group):
    """The cell's step at the smoke config, batch 2 and at most 64
    positions (as the reference's ``input_specs(smoke=True)`` cuts a
    cell), on a (2, 2) mesh over a fake group of 4."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_grid_mesh
    spec = get_arch(arch)
    sh = spec.shape(shape)
    sh = dataclasses.replace(sh, global_batch=2, seq_len=min(sh.seq_len, 64))
    cfg = dataclasses.replace(spec.smoke, use_flash_kernel=False)
    dryrun.fake_world(4)
    mesh = make_grid_mesh((2, 2), ("data", "model"), device="cpu")
    cost, nbytes = dryrun.step_cost(cfg, sh, mesh)
    rep = dryrun.cell_report(arch, shape, "2x2", cost, nbytes, 0.0,
                             dryrun._unit(cfg))
    assert json.loads(json.dumps(rep)) == rep
    assert set(rep["memory"]) == {"argument_bytes_per_device",
                                  "output_bytes_per_device",
                                  "temp_bytes_per_device"}
    assert set(rep["hlo_accounting"]) == {
        "flops_per_device", "transcendentals_per_device",
        "hbm_traffic_bytes_per_device", "collective_bytes",
        "collective_counts"}
    hc, nbytes = _jax_cell(arch, shape)
    assert rep["memory"]["argument_bytes_per_device"] == nbytes
    ratio = rep["hlo_accounting"]["flops_per_device"] / hc.flops
    print(f"{arch} {shape}: port/reference FLOPs per device {ratio:.4f}")
    lo, hi = FLOP_BAND[jconfigs.get_arch(arch).shape(shape).kind]
    assert lo <= ratio <= hi, ratio
