"""Multi-pod dry run: build every (architecture x input shape) cell's
step on the production meshes, prove the placements are coherent, and
record what the roofline analysis reads: per-device memory and the
per-device cost of one step.

Usage (CPU; no card, nothing allocated):

  PYTHONPATH=src python -m repro_torch.launch.dryrun             # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k --mesh both --out reports/dryrun_torch

Every cell runs its step (``launch.steps`` with ``mesh=``; the train
step for ``train`` shapes, the forward for ``prefill``, the serve step
for ``decode``) on the ``meta`` device over a **fake process group**
(``torch.testing._internal.distributed.fake_pg``: the "fake" backend,
whose collectives do nothing) of 256 ranks for 16x16 or 512 for
2x16x16, as its rank 0, with ``use_flash_kernel`` off as in the
reference.  Under ``opcost.analyze`` the step's local operations and
collectives are counted per device.  The stack of identical layers is
the reference's loop trip: the step runs at one and at two repeating
units (layers; jamba's 8-layer super-blocks) and the costs and the
temporaries are extrapolated linearly to the config's depth; the
mamba selective scan is counted SCAN_CHUNK steps to a call
(``_counting_scan``).

One JSON per cell, keyed as the reference's ``_cell_report``:

- ``memory.argument_bytes_per_device``: the local shards of the
  parameters, the optimizer state and the inputs (the decode cache
  too), exact from the placements;
- ``memory.output_bytes_per_device``: the local shards of the outputs;
- ``memory.temp_bytes_per_device``: the peak of the live local
  intermediates (``opcost.CostMode.peak_bytes``).  This is the port's
  own measure, not XLA's buffer assignment: nothing is fused, and it
  includes the outputs the step allocates;
- ``hlo_accounting``: ``flops_per_device``,
  ``transcendentals_per_device``, ``hbm_traffic_bytes_per_device``,
  ``collective_bytes`` and ``collective_counts`` from ``opcost``;
- ``trace_sec`` (building and running both depths on meta) in place of
  the reference's ``lower_sec`` and ``compile_sec``.

The fake backend and ``FakeStore`` are the API of torch 2.5 and later
(``init_process_group("fake", store=FakeStore(), ...)``).
"""
import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ..models import get_api
from ..models.common import ModelConfig
from ..tree import tree_leaves, tree_map
from .opcost import OpCost, analyze

_META = torch.device("meta")


def fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks as the default group (this
    process its rank 0); a group of another size is torn down first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def _unit(cfg: ModelConfig) -> Tuple[int, int]:
    """(layers of one repeating unit, units in the config)."""
    unit = cfg.attn_every if cfg.family == "hybrid" else 1
    return unit, cfg.num_layers // unit


def local_bytes(tensors: Any, placements: Any, mesh: Any) -> int:
    """Bytes of this rank's shards of a tree of (global) tensors at a
    tree of placements of the same structure (the rules engine only
    shards evenly)."""
    from torch.distributed.tensor import Shard
    total = 0
    for t, pl in zip(tree_leaves(tensors), _placement_leaves(placements)):
        shape = list(t.shape)
        for d, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] //= mesh.shape[d]
        total += math.prod(shape) * t.element_size()
    return total


def _placement_leaves(tree: Any):
    """Leaves of a tree whose leaves are placement tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _placement_leaves(tree[k])
    elif isinstance(tree, (list, tuple)) and tree \
            and not _is_placements(tree):
        for v in tree:
            yield from _placement_leaves(v)
    else:
        yield tree


def _is_placements(x: Any) -> bool:
    from torch.distributed.tensor import Placement
    return all(isinstance(p, Placement) for p in x)


SCAN_CHUNK = 64


def _counting_scan(dt, dx, Bf, Cf, A, h):
    """The selective scan's operations for counting on meta tensors:
    ``ssm._selective_scan``'s step (a decay, the state update, the
    read-out product) run on SCAN_CHUNK steps at a time, each operation
    on SCAN_CHUNK times the elements.  The FLOPs, transcendentals,
    bytes and saved tensors are the loop's; the number of calls, and so
    the dry run's time, is 1/SCAN_CHUNK of it (jamba's prefill_32k is
    32,768 steps a layer).  It computes no recurrence: meta tensors hold
    no values."""
    import torch
    Bn, T, d_in = dt.shape
    if h is None:
        h = dt.new_zeros((Bn, d_in, A.shape[-1]))
    ys = []
    for t0 in range(0, T, SCAN_CHUNK):
        s = slice(t0, min(t0 + SCAN_CHUNK, T))
        decay = torch.exp(dt[:, s, :, None] * A)
        hc = decay * h[:, None] + dx[:, s, :, None] * Bf[:, s, None, :]
        ys.append((hc @ Cf[:, s, :, None])[..., 0])
        h = hc[:, -1]
    return torch.cat(ys, dim=1), h


def _step_at(cfg: ModelConfig, sh: Any, mesh: Any) -> OpCost:
    """One step of ``cfg`` (at its own depth) on meta under
    ``opcost.analyze``, every argument placed first (so the placing is
    not counted)."""
    from .steps import (_place, make_forward_step, make_serve_step,
                        make_train_step, shard_params)
    from ..optim import AdamWConfig, adamw_init
    api = get_api(cfg)
    B, S = sh.global_batch, sh.seq_len
    if sh.kind == "train":
        b = make_train_step(cfg, batch=B, seq=S, mesh=mesh)
        _p, o_pl, in_pl, tgt_pl = b.in_placements
        model = shard_params(api.module(cfg, _META), mesh,
                             _rules(cfg, False))
        state = adamw_init(dict(model.named_parameters()), AdamWConfig())
        state["step"] = _place(state["step"], mesh, o_pl["step"])
        return analyze(b.fn, model, state,
                       _place(b.input_shapes["inputs"], mesh, in_pl),
                       _place(b.input_shapes["targets"], mesh, tgt_pl))[0]
    if sh.kind == "prefill":
        b = make_forward_step(cfg, mesh=mesh, batch=B, seq=S)
        model = shard_params(api.module(cfg, _META), mesh,
                             _rules(cfg, False))
        return analyze(b.fn, model, _place(b.input_shapes["inputs"], mesh,
                                           b.in_placements[1]))[0]
    b = make_serve_step(cfg, mesh=mesh, batch=B, max_len=S)
    _p, tok_pl, cache_pl, _pos = b.in_placements
    model = shard_params(api.module(cfg, _META), mesh, _rules(cfg, True))
    cache = tree_map(lambda t, pl: _place(t, mesh, pl),
                     b.input_shapes["cache"], cache_pl)
    return analyze(b.fn, model, _place(b.input_shapes["token"], mesh,
                                       tok_pl), cache, S - 1)[0]


def _rules(cfg: ModelConfig, decode: bool):
    from .steps import _rules_for
    return _rules_for(cfg, decode)


def step_cost(cfg: ModelConfig, sh: Any, mesh: Any
              ) -> Tuple[OpCost, Dict[str, int]]:
    """The cell's per-device cost at the config's full depth: the step
    counted at one and two repeating units, extrapolated
    (``c1 + (c2 - c1) * (units - 1)``), the peak too unless the
    two-unit step peaks lower than the one-unit step (then a
    three-unit step gives the repeating part's slope); the argument and
    output bytes of the full config, exact."""
    from unittest import mock
    from ..models import ssm
    unit, units = _unit(cfg)
    def at(k: int) -> OpCost:
        return _step_at(dataclasses.replace(cfg, num_layers=k * unit), sh,
                        mesh)

    with mock.patch.object(ssm, "_selective_scan", _counting_scan):
        c1 = at(1)
        total = OpCost()
        total.add(c1)
        if units > 1:
            c2 = at(2)
            total.add(c2, units - 1)
            total.add(c1, -(units - 1))
            if c2.peak_bytes < c1.peak_bytes and units > 2:
                # the one-unit step peaks in a part that does not repeat
                # (the head and the loss against the unit's buffers):
                # the repeating part grows by the slope from 2 to 3
                c3 = at(3)
                total.peak_bytes = max(
                    c1.peak_bytes, c2.peak_bytes + max(
                        0.0, c3.peak_bytes - c2.peak_bytes) * (units - 2))
    return total, _full_bytes(cfg, sh, mesh)


def _full_bytes(cfg: ModelConfig, sh: Any, mesh: Any) -> Dict[str, int]:
    """Argument and output bytes of the full config from its step's
    meta shapes and placements (nothing runs)."""
    from .steps import make_forward_step, make_serve_step, make_train_step
    B, S = sh.global_batch, sh.seq_len
    if sh.kind == "train":
        b = make_train_step(cfg, batch=B, seq=S, mesh=mesh)
        p_pl, o_pl, in_pl, tgt_pl = b.in_placements
        state = local_bytes((b.input_shapes["params"],
                             b.input_shapes["opt_state"]), (p_pl, o_pl), mesh)
        return {"args": state + local_bytes(
                    (b.input_shapes["inputs"], b.input_shapes["targets"]),
                    (in_pl, tgt_pl), mesh),
                "outs": state + 3 * 4}
    if sh.kind == "prefill":
        b = make_forward_step(cfg, mesh=mesh, batch=B, seq=S)
        p_pl, in_pl = b.in_placements
        logits = torch.empty((B, S, cfg.vocab_size), dtype=cfg.dtype,
                             device=_META)
        return {"args": local_bytes((b.input_shapes["params"],
                                     b.input_shapes["inputs"]),
                                    (p_pl, in_pl), mesh),
                "outs": local_bytes(logits, b.out_placements, mesh)}
    b = make_serve_step(cfg, mesh=mesh, batch=B, max_len=S)
    p_pl, tok_pl, cache_pl, _pos = b.in_placements
    cache = local_bytes(b.input_shapes["cache"], cache_pl, mesh)
    return {"args": local_bytes((b.input_shapes["params"],
                                 b.input_shapes["token"]),
                                (p_pl, tok_pl), mesh) + cache + 4,
            "outs": local_bytes(torch.empty((B,), dtype=torch.int32,
                                            device=_META),
                                b.out_placements[0], mesh) + cache}


def cell_report(arch_id: str, shape_name: str, mesh_name: str,
                cost: OpCost, nbytes: Dict[str, int], trace_s: float,
                units: Tuple[int, int]) -> dict:
    return {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "trace_sec": round(trace_s, 2),
        "depth": {"unit_layers": units[0], "units": units[1],
                  "counted_units": [1, 2] if units[1] > 1 else [1]},
        "memory": {
            "argument_bytes_per_device": nbytes["args"],
            "output_bytes_per_device": nbytes["outs"],
            "temp_bytes_per_device": cost.peak_bytes,
        },
        "hlo_accounting": {
            "flops_per_device": cost.flops,
            "transcendentals_per_device": cost.transcendentals,
            "hbm_traffic_bytes_per_device": cost.traffic_bytes,
            "collective_bytes": cost.collective_bytes,
            "collective_counts": cost.collective_counts,
        },
    }


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: Path, overrides: dict = None,
             profile: str = "baseline") -> dict:
    """One cell on the production mesh, over a fake group of its size;
    writes and returns its report."""
    from ..configs import get_arch
    from .mesh import make_production_mesh

    spec = get_arch(arch_id)
    sh = spec.shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if sh.skip:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "skipped": True, "reason": sh.skip_reason}
    cfg = spec.optimized_config() if profile == "optimized" else spec.config
    cfg = dataclasses.replace(cfg, use_flash_kernel=False,
                              **(overrides or {}))
    t0 = time.perf_counter()
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    cost, nbytes = step_cost(cfg, sh, mesh)
    rep = cell_report(arch_id, shape_name, mesh_name, cost, nbytes,
                      time.perf_counter() - t0, _unit(cfg))
    out_dir.mkdir(parents=True, exist_ok=True)
    fn = out_dir / f"{arch_id}__{shape_name}__{mesh_name}.json"
    fn.write_text(json.dumps(rep, indent=2))
    return rep


def main() -> int:
    import logging
    from ..configs import all_cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"],
                    help="optimized = per-arch production flags")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf experiments)")
    args = ap.parse_args()
    # DTensor logs every two-step Partial reduction it schedules
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    cells = all_cells(include_skipped=True)
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    out_dir = Path(args.out)
    failures = 0
    for arch_id, shape_name in cells:
        for mp in meshes:
            tag = (f"{arch_id:24s} {shape_name:12s} "
                   f"{'2x16x16' if mp else '16x16':8s}")
            try:
                rep = run_cell(arch_id, shape_name, mp, out_dir,
                               overrides or None, profile=args.profile)
                if rep.get("skipped"):
                    print(f"SKIP {tag} ({rep['reason'][:60]})", flush=True)
                    continue
                hc = rep["hlo_accounting"]
                mem = rep["memory"]
                per_dev_gb = (mem["argument_bytes_per_device"]
                              + mem["temp_bytes_per_device"]) / 1e9
                coll_gb = sum(hc["collective_bytes"].values()) / 1e9
                print(f"OK   {tag} trace={rep['trace_sec']:6.1f}s "
                      f"flops/dev={hc['flops_per_device']:.3e} "
                      f"mem/dev={per_dev_gb:6.2f}GB coll={coll_gb:8.3f}GB",
                      flush=True)
            except Exception as e:  # noqa: BLE001 -- report and continue
                failures += 1
                print(f"FAIL {tag} {type(e).__name__}: {e}", flush=True)
                traceback.print_exc(limit=3)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"\n{'ALL CELLS PASS' if failures == 0 else f'{failures} FAILURES'}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
