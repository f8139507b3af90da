"""Optimizer substrate: AdamW with float32 (or bf16) moments, gradient
clipping, the cosine LR schedule and error-feedback gradient
compression, written as the JAX package writes them."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, cosine_schedule)
from .compress import CompressionConfig, compress_gradients

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm", "CompressionConfig", "compress_gradients"]
