"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783; unverified]

The production sharding for this arch turns on FSDP (params sharded over
data as well as model) + full remat: bf16 params alone are 810 GB.
"""
from ..models import ModelConfig
from .base import ArchSpec, lm_shapes

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    head_dim=128, d_ff=53248, vocab_size=128256, rope_theta=5e5,
    fsdp=True, remat="full", seq_shard_decode=True,
)

SMOKE = ModelConfig(
    name="llama3-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=256,
)

SPEC = ArchSpec(
    arch_id="llama3-405b", config=CONFIG, smoke=SMOKE,
    shapes=lm_shapes(long_ok=False),
    optimized={},  # fsdp+remat already in config
    source="arXiv:2407.21783; unverified",
    notes="GQA, 128k vocab; FSDP+remat required at this scale.",
)
