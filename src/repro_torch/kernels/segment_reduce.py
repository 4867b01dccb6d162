"""Sorted-batch row scatter: CUDA kernel wrapper, launch count, plain path.

Replaces ``src/repro/kernels/segment_reduce.py::segment_reduce`` (a Pallas
TPU kernel).  The kernel is ``csrc/segment_reduce.cu``: one launch in which
each block owns a contiguous range of output rows (``plan``), zeroes it,
finds the sorted positions that fall in it and folds each run of equal ids
in sorted order, with no atomics; its source note gives its bound on the
card.  It writes every output row exactly once, so the wrapper allocates
the output with ``torch.empty`` and launches no fill.  The result is
bitwise equal to the plain version (``ref.segment_reduce_ref``), and so to
the reference's ``jax.ops.segment_sum`` of the unsorted batch, on every
run.  Ids outside ``[0, num_rows)`` are dropped.  The ids must be sorted
ascending (``layout.sorted_rows[n]``), which the wrapper does not check:
that would cost a host round trip.

``plan`` picks one of two routes.  The staged route (above) serves the
training batches.  Calls whose runs are long on average (B at least
``WALK_MIN_RUN`` × rows: the ALS and CCD sums over a whole tensor) take
the walk route, one group of lanes per output row folding its run from
global memory, so the rows' runs fold side by side rather than one after
another in a block; the same bits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .ref import segment_reduce_ref

MAX_WIDTH = 64        # J <= two entries a lane
TARGET_BLOCKS = 256   # row ranges a call aims for, so small modes fill the
                      # card too
TILE_FLOATS = 4096    # a block's rows in shared memory (16 kB)
STAGE_FLOATS = 8192   # staged sorted ids and gradient rows (32 kB)
WALK_MIN_RUN = 4      # mean entries a row from which a call walks the runs
THREADS = 256         # a block's threads, on both routes


class Plan(NamedTuple):
    """The kernel's partition for one shape (see ``plan``)."""
    rows_per_block: int  # block k owns rows [k·rows_per_block, …)
    blocks: int
    chunk: int           # sorted positions staged in shared memory at once
    smem_bytes: int
    route: str = "staged"  # "staged" | "walk" (one lane group a row)


def group_width(J: int) -> int:
    """Lanes a row takes: the next power of two from J, at most 32
    (``group_width`` in csrc/common.cuh)."""
    w = 1
    while w < J and w < 32:
        w <<= 1
    return w


def plan(num_rows: int, J: int, B: int = 0) -> Plan:
    """Route, row ranges and staging for ``num_rows`` output rows of
    width J over ``B`` sorted ids.  On the staged route
    ``rows_per_block`` is a multiple of 4, so each range starts on a
    16-byte boundary of an aligned output for any J; on the walk route
    each group of ``group_width(J)`` lanes owns one row."""
    if num_rows < 1 or not 1 <= J <= MAX_WIDTH:
        raise ValueError(f"segment_reduce: the kernel takes num_rows >= 1 "
                         f"and J <= {MAX_WIDTH}, got {num_rows} and {J}")
    if B >= WALK_MIN_RUN * num_rows:
        groups = THREADS // group_width(J)
        return Plan(groups, -(-num_rows // groups), 0, 0, "walk")
    per = -(-num_rows // TARGET_BLOCKS)
    rows_per_block = min(-(-per // 4) * 4, TILE_FLOATS // J // 4 * 4)
    chunk = 1 << (STAGE_FLOATS // (J + 1)).bit_length() - 1
    return Plan(rows_per_block, -(-num_rows // rows_per_block), chunk,
                4 * (rows_per_block * J + chunk * (J + 1)))


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
    pl = plan(num_rows, J, B)
    out = torch.empty((num_rows, J), dtype=torch.float32,
                      device=grads.device)
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        if pl.route == "walk":
            fn = build.function(
                "segment_reduce", "segment_walk_f32",
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_longlong,
                                         ctypes.c_longlong,
                                         ctypes.c_void_p])
            code = fn(grads.data_ptr(), idx.data_ptr(), out.data_ptr(), B,
                      J, num_rows, pl.blocks, stream)
        else:
            fn = build.function(
                "segment_reduce", "segment_reduce_f32",
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_void_p])
            code = fn(grads.data_ptr(), idx.data_ptr(), out.data_ptr(), B,
                      J, num_rows, pl.rows_per_block, pl.chunk, pl.blocks,
                      stream)
        build.check("segment_reduce", code)
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
