"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]
"""
from ..models import ModelConfig
from .base import ArchSpec, lm_shapes

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, qkv_bias=True,
)

SPEC = ArchSpec(
    arch_id="qwen2.5-3b", config=CONFIG, smoke=SMOKE,
    shapes=lm_shapes(long_ok=False),
    optimized={"remat": "full"},
    source="hf:Qwen/Qwen2.5-0.5B; hf",
    notes="GQA kv=2 (replicated under TP=16), QKV bias.",
)
