"""StarCoder2-15B  [arXiv:2402.19173; hf] — GQA + RoPE, LayerNorm + GELU.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
The port's own copy of ``src/repro/configs/starcoder2_15b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2_15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152,
    norm_type="layernorm", activation="gelu",
)

REDUCED = ModelConfig(
    arch_id="starcoder2_15b", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    norm_type="layernorm", activation="gelu",
    dtype="float32", remat="none",
)
