"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 -- Finch, data-dependent decay. [arXiv:2404.05892; unverified]

long_500k runs: the decode state is O(1) in the context length.
"""
from ..models import ModelConfig
from .base import ArchSpec, lm_shapes

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="rwkv",
    num_layers=24, d_model=2048, d_ff=7168, vocab_size=65536,
    rwkv_head_dim=64, chunk_size=256,
    num_heads=32, num_kv_heads=32, head_dim=64,  # informational (H=D/64)
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="rwkv",
    num_layers=2, d_model=64, d_ff=128, vocab_size=256,
    rwkv_head_dim=16, chunk_size=8,
)

SPEC = ArchSpec(
    arch_id="rwkv6-1.6b", config=CONFIG, smoke=SMOKE,
    shapes=lm_shapes(long_ok=True),
    optimized={"remat": "full"},
    source="arXiv:2404.05892; unverified",
    notes="attention-free; chunked WKV6 (chunk=256); O(1) decode state.",
)
