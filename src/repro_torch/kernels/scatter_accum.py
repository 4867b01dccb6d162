"""Factor-row scatter of unsorted row grads: CUDA kernel wrapper, count, plain.

Replaces ``src/repro/kernels/scatter_accum.py::scatter_accum`` (a Pallas
TPU kernel, a one-hot O(rows×B) MXU sweep).  The kernel is
``csrc/scatter_accum.cu``: O(B·J) atomic adds into a zeroed output; its
source note gives its bound on the card.  Ids outside ``[0, num_rows)``
are dropped, as ``jax.ops.segment_sum`` drops them.  The atomics sum the
duplicates of a row in an order that changes from run to run, so the
result equals the plain version within f32 tolerance, not bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import scatter_accum_ref


def _check(grads: torch.Tensor, idx: torch.Tensor, num_rows: int) -> None:
    if grads.device.type != "cuda" or idx.device != grads.device:
        raise ValueError(
            "scatter_accum: the CUDA kernel takes CUDA tensors on one "
            f"device, got {grads.device} and {idx.device}")
    if grads.dtype != torch.float32:
        raise TypeError(f"scatter_accum: grads must be float32, got "
                        f"{grads.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"scatter_accum: idx must be int32, got {idx.dtype}")
    if not (grads.is_contiguous() and idx.is_contiguous()):
        raise ValueError("scatter_accum: grads and idx must be contiguous")
    if grads.dim() != 2 or idx.shape != (grads.shape[0],):
        raise ValueError(f"scatter_accum: grads (B, J) and idx (B,) expected, "
                         f"got {tuple(grads.shape)} and {tuple(idx.shape)}")
    if num_rows < 1:
        raise ValueError(f"scatter_accum: num_rows must be >= 1, got "
                         f"{num_rows}")


def scatter_accum(
    grads: torch.Tensor,  # (B, J) per-sample row gradients
    idx: torch.Tensor,    # (B,) int32 target rows
    num_rows: int,
) -> torch.Tensor:
    """Segment-sum scatter -> (num_rows, J); duplicates summed."""
    if grads.device.type == "cpu":
        return scatter_accum_ref(grads, idx, num_rows)
    _check(grads, idx, num_rows)
    B, J = grads.shape
    out = torch.zeros((num_rows, J), dtype=torch.float32,
                      device=grads.device)
    fn = build.function(
        "scatter_accum", "scatter_accum_f32",
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("scatter_accum", fn(
            grads.data_ptr(), idx.data_ptr(), out.data_ptr(), B, J,
            num_rows, stream))
    scatter_accum.launches += 1
    return out


scatter_accum.launches = 0
