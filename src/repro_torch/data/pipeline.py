"""Token data pipeline: deterministic, seekable, shard-aware.

Design points for scale:
  * **Deterministic addressing** -- batch ``i`` is a pure function of
    (seed, i), so restart-after-failure resumes exactly (no replayed or
    skipped batches) and any host can compute any shard (elastic
    re-sharding just changes the host->shard map).
  * **Host sharding** -- each host materializes only its
    ``(host_id, num_hosts)`` slice of the global batch.
  * **Prefetch** -- a double-buffered background thread hides host->device
    transfer behind the step.

The corpus here is synthetic; swapping in a real tokenized corpus only
changes ``_tokens_for_doc``.  This module is numpy and a thread, the
JAX package's as it is.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1


def synthetic_corpus(vocab: int, seed: int = 0):
    """A Zipf-token synthetic corpus with local n-gram structure, so the
    loss actually decreases during the example training runs."""
    rng = np.random.default_rng(seed)
    bigram_shift = rng.integers(1, vocab, size=64)

    def tokens(doc_id: int, length: int) -> np.ndarray:
        r = np.random.default_rng((seed * 1_000_003 + doc_id) & 0x7FFFFFFF)
        out = ((r.zipf(1.3, size=length) - 1) % vocab).astype(np.int64)
        # deterministic bigram structure: every odd token is a function of
        # the preceding even token -> the LM has something to learn
        n_odd = len(out[1::2])
        prev_even = out[0::2][:n_odd]
        out[1::2] = (prev_even + bigram_shift[prev_even % 64]) % vocab
        return out.astype(np.int32)

    return tokens


class TokenStream:
    """Deterministic batch stream with background prefetch."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self._tokens_for_doc = synthetic_corpus(cfg.vocab_size, cfg.seed)
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- deterministic batch addressing --------------------------------
    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.num_hosts
        rows = []
        for r in range(per_host):
            doc_id = step * cfg.global_batch + cfg.host_id * per_host + r
            rows.append(self._tokens_for_doc(doc_id, cfg.seq_len + 1))
        arr = np.stack(rows)
        return arr[:, :-1], arr[:, 1:]

    def _producer(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Tuple[int, Tuple[np.ndarray, np.ndarray]]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
