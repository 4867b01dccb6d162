"""Qwen3-MoE 30B-A3B  [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4, head_dim=128), 128 experts top-8
(d_ff=768/expert), qk-norm, vocab 151936.
The port's own copy of ``src/repro/configs/qwen3_moe_30b_a3b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_moe_30b_a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=768, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
    num_experts=128, num_shared_experts=0, top_k=8, moe_d_ff=768,
    norm_topk_prob=True,
)

REDUCED = ModelConfig(
    arch_id="qwen3_moe_30b_a3b", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=64, vocab_size=512,
    qk_norm=True,
    num_experts=8, num_shared_experts=0, top_k=2, moe_d_ff=64,
    norm_topk_prob=True,
    dtype="float32", remat="none",
)
