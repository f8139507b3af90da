"""On-disk checkpoints in the JAX package's layout (npy-per-leaf), so a
checkpoint written by either package loads in the other.

Layout:   <dir>/step_<N>/
            manifest.json          -- step, and per leaf its name, file,
                                      shape and logical dtype
            <leaf_idx>.npy         -- one file per pytree leaf

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
torch tensors or Python scalars; ``None`` holds no leaf.  Leaves are
ordered and named as ``jax.tree_util.tree_flatten_with_path`` orders
and names them: dict keys sorted (as strings sort, so ``frag_10``
comes before ``frag_2``), sequence items by index, the path's keys
joined by ``/``.  numpy has no bfloat16, so bf16 leaves are stored as
their ``uint16`` bit pattern with ``"bfloat16"`` as the manifest's
dtype, and come back as ``torch.bfloat16`` tensors.  Writes go to a
temporary directory renamed into place (an atomic commit), and
``CheckpointManager`` writes in a background thread.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_map


def _walk(tree: Any, path: Tuple, out: List[Tuple[Tuple, Any]]) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (k,), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, path + (i,), out)
    else:
        out.append((path, tree))


def _flatten_with_names(tree: Any) -> List[Tuple[str, Any]]:
    flat: List[Tuple[Tuple, Any]] = []
    _walk(tree, (), flat)
    return [("/".join(str(p) for p in path), leaf) for path, leaf in flat]


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to write, logical dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str | Path, step: int, tree: Any) -> Path:
    """Synchronous save with atomic commit."""
    directory = Path(directory)
    tmp = directory / f".tmp_step_{step}"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
        arr, logical_dtype = _host_array(leaf)
        np.save(tmp / f"{i}.npy", arr)
        manifest["leaves"].append(
            {"name": name, "file": f"{i}.npy", "shape": list(arr.shape),
             "dtype": logical_dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def load_checkpoint(directory: str | Path, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes validated).  A
    leaf comes back as a torch tensor where ``like`` holds one (on that
    leaf's device) or where it is bfloat16, otherwise as a numpy
    array."""
    directory = Path(directory) / f"step_{step}"
    manifest = json.loads((directory / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}
    names = iter(name for name, _ in _flatten_with_names(like))

    def restore(leaf: Any) -> Any:
        name = next(names)
        e = by_name.get(name)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(directory / e["file"])
        want_shape = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"target {want_shape}")
        if e["dtype"] == "bfloat16":
            out = torch.from_numpy(
                np.ascontiguousarray(arr.view(np.int16))).view(
                    torch.bfloat16)
        elif isinstance(leaf, torch.Tensor):
            out = torch.from_numpy(arr)
        else:
            return arr
        if isinstance(leaf, torch.Tensor):
            out = out.to(leaf.device)
        return out

    return tree_map(restore, like)


class CheckpointManager:
    """Async checkpointing with bounded queue + keep-last-k retention."""

    def __init__(self, directory: str | Path, keep: int = 3):
        if keep < 1:
            # keep=0 would slice steps[:-0] -- the empty slice -- in
            # _gc and silently retain everything instead of nothing
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = Path(directory)
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save_checkpoint(self.directory, step, tree)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)

    def _take_err(self) -> Optional[BaseException]:
        # deliver a stored failure exactly once: re-raising the same
        # exception object on every later call would poison the manager
        # permanently after the caller already handled it
        err, self._err = self._err, None
        return err

    def save_async(self, step: int, tree: Any) -> None:
        err = self._take_err()
        if err is not None:
            raise err
        # copy to the host NOW (so the caller can mutate its buffers)
        # but write later
        def snapshot(leaf: Any) -> Any:
            if isinstance(leaf, torch.Tensor):
                return leaf.detach().to("cpu", copy=True)
            return np.array(leaf)
        self._q.put((step, tree_map(snapshot, tree)))

    def wait(self) -> None:
        self._q.join()
        err = self._take_err()
        if err is not None:
            raise err

    def close(self) -> None:
        # always stop and join the worker, even when a pending async
        # failure surfaces -- raising before the sentinel is enqueued
        # would leak the thread
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join(timeout=10)
