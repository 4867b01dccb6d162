"""DeepSeek-V2-Lite 16B (MoE, MLA)  [arXiv:2405.04434; hf].

27L d_model=2048 16H, MLA kv_lora=512, MoE: 2 shared + 64 routed top-6,
expert d_ff=1408, first layer dense (d_ff=10944), vocab 102400.
The port's own copy of ``src/repro/configs/deepseek_v2_lite_16b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek_v2_lite_16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    use_mla=True, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=64, num_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_k_dense=1, dense_d_ff=10944,
    router_softmax_then_topk=True, norm_topk_prob=False,
)

REDUCED = ModelConfig(
    arch_id="deepseek_v2_lite_16b", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=512,
    use_mla=True, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    num_experts=8, num_shared_experts=2, top_k=2, moe_d_ff=96,
    first_k_dense=1, dense_d_ff=128,
    router_softmax_then_topk=True, norm_topk_prob=False,
    dtype="float32", remat="none",
)
