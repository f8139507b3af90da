"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
(per routed expert) vocab=151936, 60 routed experts top-4 + 4 shared.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from ..models import ModelConfig
from .base import ArchSpec, lm_shapes

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151936,
    num_experts=60, top_k=4, moe_d_ff=1408, num_shared_experts=4,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=256, num_experts=8, top_k=4, moe_d_ff=32,
    num_shared_experts=2, qkv_bias=True,
)

SPEC = ArchSpec(
    arch_id="qwen2-moe-a2.7b", config=CONFIG, smoke=SMOKE,
    shapes=lm_shapes(long_ok=False),
    optimized={"moe_shard_map": True, "remat": "full"},
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
    notes="4 shared + 60 routed top-4; QKV bias; MHA-equivalent kv=16.",
)
