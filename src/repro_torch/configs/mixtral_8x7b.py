"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]

long_500k RUNS: SWA bounds the decode KV cache to the window, so
500k-context decode is O(window) state.
"""
from ..models import ModelConfig
from .base import ArchSpec, lm_shapes

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    num_experts=8, top_k=2, moe_d_ff=14336,
    window=4096, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, num_experts=4, top_k=2, moe_d_ff=96,
    window=16,
)

SPEC = ArchSpec(
    arch_id="mixtral-8x7b", config=CONFIG, smoke=SMOKE,
    shapes=lm_shapes(long_ok=True),
    optimized={"moe_shard_map": True, "remat": "full"},
    source="arXiv:2401.04088; hf",
    notes="8 experts top-2, SWA window 4096; rolling KV cache at decode.",
)
