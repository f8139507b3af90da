"""Checkpoints: save/restore + async writer, in the JAX package's
on-disk layout."""
from .ckpt import (CheckpointManager, latest_step, load_checkpoint,
                   save_checkpoint)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint",
           "latest_step"]
