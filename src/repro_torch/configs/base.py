"""Architecture config schema and registry (the port's own copy).

``ModelConfig`` has the fields of ``src/repro/configs/base.py`` so that a
reference config and its port differ in nothing but the package, and
``dataclasses.replace`` takes the same names.  The port runs the GQA and
MLA attention models with dense, Tucker-compressed or MoE FFNs, the
vision and audio frontends (stubs in the reference too: a projection of
precomputed patch or frame embeddings) and ``encoder_only`` (non-causal,
no decode): ``get_config`` of an architecture that is not ported yet, and
``require_ported`` of a config that asks for a part that is not ported,
raise ``NotImplementedError`` (see ROADMAP.md).  Every ported config
trains on one device; the configs without a frontend also sharded over a
mesh (``distributed.sharded_lm.ShardedLM``), where ``moe_sharded`` takes
the expert-parallel MoE island, and is ``moe_ffn`` on one device.
``ShapeCell`` and ``SHAPES`` are the reference's shape cells, which
``launch.steps.input_specs`` turns into a batch's shapes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense|moe|vlm|ssm|hybrid|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # MLA (deepseek-v2)
    use_mla: bool = False
    mla_absorb: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_softmax_then_topk: bool = False
    norm_topk_prob: bool = True

    # mixer pattern
    mixer: str = "gqa"               # gqa|mla|mamba2|xlstm
    slstm_every: int = 0
    shared_attn_every: int = 0

    # ssm (mamba2)
    ssm_state_size: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # xlstm
    mlstm_inner: int = 0             # 0 → 2·d_model
    xlstm_conv: int = 4
    mlstm_chunk: int = 256

    # structure
    encoder_only: bool = False
    frontend: Optional[str] = None   # None|"audio"|"vision"
    frontend_dim: int = 0
    num_patches: int = 256
    norm_type: str = "rmsnorm"
    activation: str = "silu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # numerics / memory
    dtype: str = "bfloat16"          # activation (residual stream) dtype
    remat: str = "block"             # JAX-only: the port does not remat
    mixed_precision: bool = False
    moe_sharded: bool = False
    repeat_kv: bool = False

    # paper-technique integration: Tucker-compress MLP weights
    tucker_rank: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.mixer == "xlstm" and self.mlstm_inner == 0:
            object.__setattr__(self, "mlstm_inner", 2 * self.d_model)

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "deepseek_v2_lite_16b",
    "qwen3_moe_30b_a3b",
    "internvl2_2b",
    "xlstm_125m",
    "zamba2_1p2b",
    "hubert_xlarge",
    "qwen3_14b",
    "deepseek_67b",
    "qwen2_5_14b",
    "starcoder2_15b",
]
PORTED_ARCHS = ("qwen3_14b", "deepseek_v2_lite_16b", "qwen3_moe_30b_a3b",
                "qwen2_5_14b", "deepseek_67b", "starcoder2_15b",
                "internvl2_2b", "hubert_xlarge")


def require_ported(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` if the port runs every part it asks for, else raise."""
    parts = {
        f"the {cfg.mixer} mixer": cfg.mixer not in ("gqa", "mla"),
        "the zamba2 shared block (shared_attn_every)":
            cfg.shared_attn_every > 0,
        f"dtype={cfg.dtype!r}": cfg.dtype not in ("float32", "bfloat16"),
    }
    missing = [name for name, asked in parts.items() if asked]
    if missing:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(missing)} not ported to repro_torch "
            "yet (see ROADMAP.md, Queue 1)")
    return cfg


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    """``repro_torch/configs/<arch_id>.py`` → CONFIG (or REDUCED)."""
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    if arch_id not in PORTED_ARCHS:
        known = arch_id in ARCH_IDS
        raise NotImplementedError(
            f"architecture {arch_id!r} is "
            + ("not ported to repro_torch yet" if known else "unknown")
            + f"; ported: {PORTED_ARCHS} (see ROADMAP.md, Queue 1)")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return require_ported(mod.REDUCED if reduced else mod.CONFIG)


def list_archs() -> list[str]:
    return list(PORTED_ARCHS)
