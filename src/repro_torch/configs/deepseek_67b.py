"""DeepSeek-67B (dense, llama-arch)  [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
The port's own copy of ``src/repro/configs/deepseek_67b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek_67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=102400,
)

REDUCED = ModelConfig(
    arch_id="deepseek_67b", family="dense",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    dtype="float32", remat="none",
)
