"""HuBERT-XLarge  [arXiv:2106.07447] — encoder-only audio transformer.

48L d_model=1280 16H d_ff=5120 vocab=504 (masked-unit prediction head).
Conv waveform frontend is a STUB (input_specs gives frame embeddings,
dim 512). Encoder-only ⇒ no decode shapes.
The port's own copy of ``src/repro/configs/hubert_xlarge.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert_xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    encoder_only=True, frontend="audio", frontend_dim=512,
    norm_type="layernorm", activation="gelu",
)

REDUCED = ModelConfig(
    arch_id="hubert_xlarge", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=64,
    encoder_only=True, frontend="audio", frontend_dim=32,
    norm_type="layernorm", activation="gelu",
    dtype="float32", remat="none",
)
