"""InternVL2-2B  [arXiv:2404.16821; hf] — InternLM2 backbone + ViT stub.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. The InternViT
frontend is a STUB per the assignment: input_specs provides precomputed
patch embeddings (frontend_dim=1024 = InternViT-300M width).
The port's own copy of ``src/repro/configs/internvl2_2b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2_2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    frontend="vision", frontend_dim=1024, num_patches=256,
)

REDUCED = ModelConfig(
    arch_id="internvl2_2b", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    frontend="vision", frontend_dim=32, num_patches=8,
    dtype="float32", remat="none",
)
