"""Qwen3-14B (dense)  [hf:Qwen/Qwen3-8B family] — qk-norm GQA.

40L d_model=5120 40H (GQA kv=8, head_dim=128) d_ff=17408 vocab=151936.
The port's own copy of ``src/repro/configs/qwen3_14b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=17408, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
)

REDUCED = ModelConfig(
    arch_id="qwen3_14b", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=512,
    qk_norm=True,
    dtype="float32", remat="none",
)
