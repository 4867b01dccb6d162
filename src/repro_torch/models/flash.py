"""Flash attention, forward only, through the kernel registry.

Counterpart of ``repro.models.flash``, whose custom-VJP flash attention
(an FA2 forward and a recompute backward in jnp) is what the reference's
no-cache attention runs.  The port's LM path is serving, so only the
forward is here: it goes to the backend's ``flash_attention`` — the
hand-written CUDA kernel on ``"cuda"`` (the counterpart of the Pallas
``flash_attention_fwd``, which the reference calls "the TPU lowering of
its forward pass" but never calls from the model), the dense-softmax
plain version on ``"torch"``.  The backward waits for LM training.

The reference scans (q_chunk × kv_chunk) blocks; the kernel has its own
64 × 64 tiles, so there are no chunk arguments: they change the order of
the sums only.
"""
from __future__ import annotations

import torch


def flash_attention(
    q: torch.Tensor,   # (B, Sq, Kv, G, D) or (B, Sq, H, D)
    k: torch.Tensor,   # (B, Sk, Kv, D)
    v: torch.Tensor,   # (B, Sk, Kv, Dv)
    causal: bool = True,
    *,
    q_offset: int = 0,
    kv_len: int | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """Softmax attention of grouped heads → q's shape.

    Query head (kv, g) reads key/value head kv; query i sits at position
    ``q_offset + i``; keys at or past ``kv_len`` (default Sk) are masked.
    """
    from repro_torch.kernels import dispatch

    shape = q.shape
    q4 = q.reshape(*shape[:2], -1, shape[-1]) if q.dim() == 5 else q
    out = dispatch.get_backend(backend).flash_attention(
        q4, k, v, causal=causal, kv_len=kv_len, q_offset=q_offset)
    return out.reshape(*shape[:-1], v.shape[-1])
