"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16 experts top-2, Mamba:attention 7:1 interleave.
[arXiv:2403.19887; hf]

long_500k runs: 63 of the 72 layers are mamba with an O(1) state; the
9 attention layers hold the long KV cache.  FSDP and sequence-sharded
decode caches (``fsdp``, ``seq_shard_decode``) with full remat: bf16
parameters alone are 797 GB.
"""
from ..models import ModelConfig
from .base import ArchSpec, lm_shapes

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    num_experts=16, top_k=2, moe_d_ff=24576,
    attn_every=8, moe_every=2, ssm_d_state=16, ssm_conv=4, ssm_expand=2,
    fsdp=True, remat="full", seq_shard_decode=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, num_experts=4, top_k=2, moe_d_ff=96,
    attn_every=8, moe_every=2, ssm_d_state=8,
)

SPEC = ArchSpec(
    arch_id="jamba-1.5-large-398b", config=CONFIG, smoke=SMOKE,
    shapes=lm_shapes(long_ok=True),
    optimized={"moe_shard_map": True, "ssm_scan_unroll": 32},
    source="arXiv:2403.19887; hf",
    notes="1 attn per 8 layers; MoE every other layer; FSDP+remat at 398B.",
)
