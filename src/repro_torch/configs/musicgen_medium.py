"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 -- decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a stub; ``input_specs`` provides
precomputed frame embeddings [B, S, d_model] (brief requirement).
"""
from ..models import ModelConfig
from .base import ArchSpec, lm_shapes

CONFIG = ModelConfig(
    name="musicgen-medium", family="dense",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048, embed_inputs=True, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64, embed_inputs=True,
)

SPEC = ArchSpec(
    arch_id="musicgen-medium", config=CONFIG, smoke=SMOKE,
    shapes=lm_shapes(long_ok=False),
    optimized={"remat": "full"},
    source="arXiv:2306.05284; hf",
    notes="EnCodec-token decoder backbone; frame-embedding stub frontend.",
)
