"""Sorted-batch row scatter: CUDA kernel wrapper, launch count, plain path.

Replaces ``src/repro/kernels/segment_reduce.py::segment_reduce`` (a Pallas
TPU kernel).  The kernel is ``csrc/segment_reduce.cu``: one lane group per
run of equal ids folds the run in sorted order, with no atomics; its
source note gives its bound on the card.  The result is bitwise equal to
the plain version (``ref.segment_reduce_ref``), and so to the reference's
``jax.ops.segment_sum`` of the unsorted batch, on every run.  Ids outside
``[0, num_rows)`` are dropped.  The ids must be sorted ascending
(``layout.sorted_rows[n]``), which the wrapper does not check: that would
cost a host round trip.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import segment_reduce_ref

MAX_WIDTH = 32  # J <= one warp


def _check(grads: torch.Tensor, idx: torch.Tensor, num_rows: int) -> None:
    if grads.device.type != "cuda" or idx.device != grads.device:
        raise ValueError(
            "segment_reduce: the CUDA kernel takes CUDA tensors on one "
            f"device, got {grads.device} and {idx.device}")
    if grads.dtype != torch.float32:
        raise TypeError(f"segment_reduce: grads must be float32, got "
                        f"{grads.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"segment_reduce: idx must be int32, got "
                        f"{idx.dtype}")
    if not (grads.is_contiguous() and idx.is_contiguous()):
        raise ValueError("segment_reduce: grads and idx must be contiguous")
    if grads.dim() != 2 or idx.shape != (grads.shape[0],):
        raise ValueError(f"segment_reduce: grads (B, J) and idx (B,) "
                         f"expected, got {tuple(grads.shape)} and "
                         f"{tuple(idx.shape)}")
    if not 1 <= grads.shape[1] <= MAX_WIDTH:
        raise ValueError(f"segment_reduce: the kernel takes J <= "
                         f"{MAX_WIDTH}, got {grads.shape[1]}")
    if num_rows < 1:
        raise ValueError(f"segment_reduce: num_rows must be >= 1, got "
                         f"{num_rows}")


def segment_reduce(
    grads: torch.Tensor,  # (B, J) row grads permuted to mode-sorted order
    idx: torch.Tensor,    # (B,) int32 sorted row ids
    num_rows: int,
) -> torch.Tensor:
    """Sorted segment-sum scatter -> (num_rows, J), f32."""
    if grads.device.type == "cpu":
        return segment_reduce_ref(grads, idx, num_rows)
    _check(grads, idx, num_rows)
    B, J = grads.shape
    out = torch.zeros((num_rows, J), dtype=torch.float32,
                      device=grads.device)
    fn = build.function(
        "segment_reduce", "segment_reduce_f32",
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("segment_reduce", fn(
            grads.data_ptr(), idx.data_ptr(), out.data_ptr(), B, J,
            num_rows, stream))
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
