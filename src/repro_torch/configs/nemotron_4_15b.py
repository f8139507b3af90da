"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU MLP (no gate). [arXiv:2402.16819; unverified]
"""
from ..models import ModelConfig
from .base import ArchSpec, lm_shapes

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000, mlp_act="sq_relu", rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="nemotron-smoke", family="dense",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512, mlp_act="sq_relu",
)

SPEC = ArchSpec(
    arch_id="nemotron-4-15b", config=CONFIG, smoke=SMOKE,
    shapes=lm_shapes(long_ok=False),
    optimized={"remat": "full"},
    source="arXiv:2402.16819; unverified",
    notes="GQA, squared-ReLU, 256k vocab.",
)
