"""Flash attention with a recompute backward, through the kernel registry.

Counterpart of ``repro.models.flash``, whose custom-VJP flash attention
(an FA2 forward and a recompute backward in jnp) is what the reference's
no-cache attention runs.  Here it is ``FlashAttention``, an autograd
Function over the backend's two kernels:

* forward: the backend's ``flash_attention`` — the hand-written CUDA kernel
  on ``"cuda"`` (the counterpart of the Pallas ``flash_attention_fwd``,
  which the reference calls "the TPU lowering of its forward pass" but
  never calls from the model), the dense-softmax plain version on
  ``"torch"``.  When the result is to be differentiated it also returns
  each row's log-sum-exp, and saves q, k, v, the output and that lse:
  O(S·D) memory, never the (S × S) probabilities;
* backward: the backend's ``flash_attention_bwd`` — the hand-written CUDA
  kernel (``csrc/flash_attention_bwd.cu``, the counterpart of the
  reference's jnp ``_flash_bwd``) on ``"cuda"``, a dense recompute on
  ``"torch"``.

Serving (no gradient) goes through the same Function without asking for
the lse, so the forward kernel runs exactly as it did before training was
ported.  The reference scans (q_chunk × kv_chunk) blocks; the kernels have
their own tiles, so there are no chunk arguments: they change the order of
the sums only.
"""
from __future__ import annotations

import torch


class FlashAttention(torch.autograd.Function):
    """(q, k, v) → softmax attention; the model's (B, S, H, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int,
                kv_len: int | None, backend: str | None, want_grad: bool):
        from repro_torch.kernels import dispatch

        be = dispatch.get_backend(backend)
        kw = dict(causal=causal, kv_len=kv_len, q_offset=q_offset)
        if not want_grad:
            return be.flash_attention(q, k, v, **kw)
        out, lse = be.flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        ctx.backend = backend
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import dispatch

        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = dispatch.get_backend(ctx.backend).flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


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
    Differentiable in q, k and v (``FlashAttention``).
    """
    shape = q.shape
    q4 = q.reshape(*shape[:2], -1, shape[-1]) if q.dim() == 5 else q
    want_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q4, k, v))
    out = FlashAttention.apply(q4, k, v, causal, q_offset, kv_len, backend,
                               want_grad)
    return out.reshape(*shape[:-1], v.shape[-1])
