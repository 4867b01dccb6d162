"""Qwen2.5-14B (dense)  [hf:Qwen/Qwen2.5 family] — GQA with QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
The port's own copy of ``src/repro/configs/qwen2_5_14b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2_5_14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
)

REDUCED = ModelConfig(
    arch_id="qwen2_5_14b", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    qkv_bias=True,
    dtype="float32", remat="none",
)
