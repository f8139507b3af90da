"""End-to-end training loop: data pipeline -> train step -> async
checkpoints, with crash-resume, ported from the JAX package's
``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Runs on the card by default and raises without CUDA; ``--device cpu``
runs it on the CPU.  Checkpoints hold ``{"params", "opt"}`` in the JAX
package's layout and leaf names, so a run of either package resumes in
the other.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .. import convert
from ..checkpoint import CheckpointManager, latest_step, load_checkpoint
from ..configs import get_arch
from ..data import DataConfig, TokenStream
from ..device import resolve_device
from ..models import ModelConfig, get_api
from ..models.common import iter_defs
from ..optim import AdamWConfig, CompressionConfig, adamw_init
from .steps import make_train_step


@dataclasses.dataclass
class TrainResult:
    steps: int
    final_loss: float
    first_loss: float
    losses: list
    steps_per_sec: float
    resumed_from: Optional[int]


def _checkpoint_like(cfg: ModelConfig) -> Dict[str, Any]:
    """The ``{params, opt}`` tree's structure and shapes (the family's
    ``defs``), for ``load_checkpoint``: zero-size numpy stand-ins, so
    nothing is copied off the device to restore."""
    tree: Dict[str, Any] = {}
    for path, d in iter_defs(get_api(cfg).defs(cfg)):
        keys = path.split(".")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.broadcast_to(np.float32(0), d.shape)
    return {"params": tree, "opt": {"m": tree, "v": tree,
                                    "step": np.zeros((), np.int32)}}


def train(arch: str, steps: int = 50, batch: int = 8, seq: int = 128,
          smoke: bool = True, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, lr: float = 3e-4, seed: int = 0,
          log_every: int = 10, compression: bool = False,
          config_override: Optional[ModelConfig] = None,
          device: Union[str, torch.device] = "cuda") -> TrainResult:
    """Train ``arch`` (its smoke or full config, or ``config_override``)
    for ``steps`` steps of ``batch`` x ``seq`` tokens of the synthetic
    corpus from weights drawn from ``seed``, resuming from the latest
    checkpoint under ``ckpt_dir`` and writing one every ``ckpt_every``
    steps."""
    dev = resolve_device(device)
    spec = get_arch(arch)
    cfg = config_override or (spec.smoke if smoke else spec.config)
    if cfg.embed_inputs:
        raise ValueError(f"{arch} is a frontend-stub arch; train the token "
                         f"archs")
    api = get_api(cfg)

    opt_cfg = AdamWConfig(lr=lr)
    step_fn = make_train_step(
        cfg, opt=opt_cfg, compression=CompressionConfig(enabled=compression),
        batch=batch, seq=seq, total_steps=steps)

    # --- init or resume ------------------------------------------------
    resumed_from = None
    params = api.build(cfg, dev, seed)
    opt_state = adamw_init(dict(params.named_parameters()), opt_cfg)
    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=2)
        last = latest_step(ckpt_dir)
        if last is not None:
            state = load_checkpoint(ckpt_dir, last, _checkpoint_like(cfg))
            params = convert.lm_params_from_numpy(state["params"], cfg, dev)
            opt_state = convert.adamw_state_from_numpy(state["opt"], cfg, dev)
            start_step = last
            resumed_from = last
            print(f"[train] resumed from step {last}")

    data = TokenStream(DataConfig(cfg.vocab_size, seq, batch, seed=seed),
                       start_step=start_step)

    losses = []
    t0 = time.perf_counter()
    try:
        for step, (inputs, targets) in data:
            if step >= steps:
                break
            params, opt_state, metrics = step_fn(
                params, opt_state, torch.from_numpy(inputs).to(dev),
                torch.from_numpy(targets).to(dev))
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"lr {float(metrics['lr']):.2e}")
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, {
                    "params": convert.lm_params_to_numpy(params),
                    "opt": convert.adamw_state_to_numpy(opt_state, cfg)})
    finally:
        data.close()
        if mgr:
            mgr.close()
    dt = time.perf_counter() - t0
    return TrainResult(len(losses), losses[-1] if losses else float("nan"),
                       losses[0] if losses else float("nan"), losses,
                       len(losses) / max(dt, 1e-9), resumed_from)


def main() -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.train",
        description="LM training loop (synthetic corpus, AdamW, "
                    "resumable checkpoints).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    r = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
              smoke=args.smoke, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, lr=args.lr,
              compression=args.compression, device=args.device)
    print(f"[train] done: {r.steps} steps, loss {r.first_loss:.4f} -> "
          f"{r.final_loss:.4f}, {r.steps_per_sec:.2f} steps/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
