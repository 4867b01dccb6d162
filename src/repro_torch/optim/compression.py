"""Gradient compression: int8 quantization with error feedback.

Counterpart of ``repro.optim.compression``.  Used around the reduction of
the dense STD factor gradients (they are (I_n, J) dense after the row
scatter, the shape a data-parallel all-reduce moves).  Error feedback keeps
the quantization residual and adds it back on the next step, which keeps
SGD converging (Karimireddy et al., 2019).

The operations run in the reference's order, each in the gradient's dtype,
so on the CPU an f32 gradient gives the reference's bits: ``torch.round``
rounds half to even, as ``jnp.round`` does.  The row maximum is divided
by 127 held in a tensor on the gradient's device: PyTorch's CUDA division
by a Python number multiplies by its reciprocal, which can be one ulp off
the quotient, and the card must give the CPU's bits for the same input.
"""
from __future__ import annotations

import torch


def compress_ef(
    grad: torch.Tensor, error: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad + carried error) → (int8 q, per-row scale, new error)."""
    g = grad + error
    amax = torch.amax(torch.abs(g), dim=-1, keepdim=True)
    scale = amax / amax.new_full((), 127.0) + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(grad.dtype) * scale
    new_error = g - deq
    return q, scale, new_error


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(scale.dtype) * scale


def compression_ratio(shape, dtype_bytes: int = 4) -> float:
    """int8 payload + per-row f32 scale against the raw bytes."""
    rows, cols = shape[-2], shape[-1]
    raw = rows * cols * dtype_bytes
    comp = rows * cols * 1 + rows * 4
    return raw / comp
