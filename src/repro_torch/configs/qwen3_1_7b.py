"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B; hf]
"""
from ..models import ModelConfig
from .base import ArchSpec, lm_shapes

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936, qk_norm=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, qk_norm=True,
)

SPEC = ArchSpec(
    arch_id="qwen3-1.7b", config=CONFIG, smoke=SMOKE,
    shapes=lm_shapes(long_ok=False),
    optimized={"remat": "full"},
    source="hf:Qwen/Qwen3-8B; hf",
    notes="qk_norm, GQA.",
)
