"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 -- pixtral-ViT frontend + mistral-nemo decoder.
[hf:mistralai/Pixtral-12B-2409; unverified]

Backbone only: the ViT patch encoder is a stub; ``input_specs`` provides
precomputed patch embeddings [B, S, d_model] (brief requirement).
"""
from ..models import ModelConfig
from .base import ArchSpec, lm_shapes

CONFIG = ModelConfig(
    name="pixtral-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, embed_inputs=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="pixtral-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, embed_inputs=True,
)

SPEC = ArchSpec(
    arch_id="pixtral-12b", config=CONFIG, smoke=SMOKE,
    shapes=lm_shapes(long_ok=False),
    optimized={"remat": "full"},
    source="hf:mistralai/Pixtral-12B-2409; unverified",
    notes="ViT-patch-embedding stub frontend + mistral-nemo-style decoder.",
)
