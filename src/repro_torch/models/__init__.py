"""The LM stack: GQA and MLA attention with dense, Tucker-compressed or
MoE FFNs, and the vision and audio stub frontends.

Counterpart of ``repro.models`` (the SSM/xLSTM mixers are not ported yet;
see ROADMAP.md).
"""
from .model import (
    Model,
    cross_entropy_loss,
    decode_step,
    forward,
    init_cache,
    init_model,
    loss_fn,
    param_axes,
)

__all__ = [
    "Model", "cross_entropy_loss", "decode_step", "forward", "init_cache",
    "init_model", "loss_fn", "param_axes",
]
