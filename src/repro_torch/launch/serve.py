"""LM decode loop of the serving substrate (prefill through decode
steps, then greedy decoding over the KV cache), ported from the JAX
package's ``launch/serve.py``.  It is not the RDF query serving layer.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --full --batch 4 --prompt-len 128 --gen-len 32

Runs on the card by default and raises without CUDA; ``--device cpu``
runs it on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..configs import get_arch
from ..device import resolve_device
from ..models import ModelConfig, get_api
from .steps import make_serve_step


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray            # [B, gen_len]
    prefill_sec: float
    decode_sec: float
    tokens_per_sec: float


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int,
                 seed: int) -> np.ndarray:
    """The prompts ``serve`` feeds, from ``numpy.random.default_rng(seed)``
    as the reference draws them: uniform token ids [batch, prompt_len]
    int32, or for an ``embed_inputs`` arch (a stub frontend) standard
    normal embeddings [batch, prompt_len, d_model] float32."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.standard_normal(
            (batch, prompt_len, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size,
                        size=(batch, prompt_len)).astype(np.int32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, batch: int = 4, prompt_len: int = 16,
          gen_len: int = 32, smoke: bool = True, seed: int = 0,
          device: Union[str, torch.device] = "cuda",
          model: Optional[nn.Module] = None) -> ServeResult:
    """Feed ``batch`` seeded prompts token by token through the serve
    step (the cache warm-up the reference calls prefill), then decode
    ``gen_len`` tokens greedily.  An ``embed_inputs`` arch decodes from
    zero embeddings, as the reference's stub frontend does.  ``model``
    serves given weights (it must lie on ``device``); without it the
    arch's smoke or full config is built from ``seed``."""
    dev = resolve_device(device)
    spec = get_arch(arch)
    if model is None:
        cfg = spec.smoke if smoke else spec.config
        model = get_api(cfg).build(cfg, dev, seed)
    else:
        where = next(model.parameters()).device
        if where.type != dev.type:
            raise ValueError(f"serve: the model lies on {where}, not on "
                             f"{dev}")
    cfg = model.cfg
    api = get_api(cfg)
    max_len = prompt_len + gen_len
    prompts = torch.from_numpy(
        make_prompts(cfg, batch, prompt_len, seed)).to(dev)
    step_fn = make_serve_step(cfg)

    # --- prefill: feed the prompt through decode steps (cache warmup) ---
    cache = api.init_cache(cfg, batch, max_len, dev)
    _sync(dev)
    t0 = time.perf_counter()
    tok = None
    for t in range(prompt_len):
        tok, cache = step_fn(model, prompts[:, t], cache, t)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    # --- decode loop (greedy) -------------------------------------------
    out: List[torch.Tensor] = []
    t0 = time.perf_counter()
    for t in range(prompt_len, max_len):
        if cfg.embed_inputs:
            cur = torch.zeros((batch, cfg.d_model), dtype=cfg.dtype,
                              device=dev)
        else:
            cur = tok
        tok, cache = step_fn(model, cur, cache, t)
        out.append(tok)
    tokens = torch.stack(out, dim=1).cpu().numpy()
    t_decode = time.perf_counter() - t0
    return ServeResult(tokens, t_prefill, t_decode,
                       batch * gen_len / max(t_decode, 1e-9))


def main() -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="LM decode-loop demo (prefill + greedy decode).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    r = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
              gen_len=args.gen_len, smoke=args.smoke, device=args.device)
    print(f"[launch.serve/lm] generated {r.tokens.shape} tokens; "
          f"prefill {r.prefill_sec:.2f}s decode {r.decode_sec:.2f}s "
          f"({r.tokens_per_sec:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
