"""Factor-row scatter of unsorted row grads: CUDA kernel wrapper, count, plain.

Replaces ``src/repro/kernels/scatter_accum.py::scatter_accum`` (a Pallas
TPU kernel, a one-hot O(rows×B) MXU sweep).  The kernel is
``csrc/scatter_accum.cu``: one launch in which each block owns a contiguous
range of output rows (``plan``), reads the batch's ids, keeps the hits
that fall in its range in batch order and folds each row's hits from 0 in
ascending batch position, with no atomics, one sub-tile of its range at a
time; its source note gives its bound on the card (memory: the dense
output).  It writes every output row
exactly once, so the wrapper allocates the output with ``torch.empty`` and
launches no fill.  The result is bitwise equal to the plain version
(``ref.scatter_accum_ref``, the same ordered fold), to the reference's
``jax.ops.segment_sum`` and to ``segment_reduce`` of the stable-sorted
batch, on every run and for any plan.  Ids outside ``[0, num_rows)`` are
dropped, as ``jax.ops.segment_sum`` drops them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .ref import scatter_accum_ref

MAX_WIDTH = 64        # J <= two entries a lane
TARGET_BLOCKS = 128   # row ranges a call aims for, a block of 512 threads
                      # each: every block reads every id (16 kB at the
                      # training batch), and a block's time grows with its
                      # hits and rows; one block a SM balanced the two
MAX_RANGE = 65_532    # rows a block owns: a hit packs its row in 16 bits
TILE_FLOATS = 16_384  # a sub-tile of a block's rows in shared memory (64 kB)
CHUNK = 4096          # ids a block reads a round (8 a thread, 512 threads);
                      # their hits are listed in shared memory (16 kB)
STAGE_FLOATS = 2048   # hits' gradient rows staged for the fold (8 kB)


class Plan(NamedTuple):
    """The kernel's partition for one shape (see ``plan``)."""
    rows_per_block: int  # block k owns rows [k·rows_per_block, …)
    blocks: int
    tile_rows: int       # rows of a sub-tile, folded and written at once
    rounds: int          # passes over the ids, CHUNK at a time
    smem_bytes: int


def plan(num_rows: int, J: int, B: int) -> Plan:
    """Row ranges for ``num_rows`` output rows of width J and B ids.  It
    reads the shapes only, never the card or the data, and the bits of the
    result do not depend on it.  ``rows_per_block`` is a multiple of 4, so
    each range and sub-tile starts on a 16-byte boundary of an aligned
    output for any J.  Above 48 kB of shared memory the kernel opts in (at
    most 88 kB)."""
    if num_rows < 1 or not 1 <= J <= MAX_WIDTH or B < 1:
        raise ValueError(f"scatter_accum: the kernel takes num_rows >= 1, "
                         f"J <= {MAX_WIDTH} and B >= 1, got {num_rows}, {J} "
                         f"and {B}")
    per = -(-num_rows // TARGET_BLOCKS)
    rows_per_block = min(-(-per // 4) * 4, MAX_RANGE)
    tile_rows = min(rows_per_block, TILE_FLOATS // J // 4 * 4)
    return Plan(rows_per_block, -(-num_rows // rows_per_block), tile_rows,
                -(-B // CHUNK),
                4 * (CHUNK + STAGE_FLOATS + tile_rows * J))


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


def scatter_accum(
    grads: torch.Tensor,  # (B, J) per-sample row gradients
    idx: torch.Tensor,    # (B,) int32 target rows
    num_rows: int,
) -> torch.Tensor:
    """Segment-sum scatter -> (num_rows, J); duplicates summed in batch
    order."""
    if grads.device.type == "cpu":
        return scatter_accum_ref(grads, idx, num_rows)
    _check(grads, idx, num_rows)
    B, J = grads.shape
    pl = plan(num_rows, J, B)
    out = torch.empty((num_rows, J), dtype=torch.float32,
                      device=grads.device)
    fn = build.function(
        "scatter_accum", "scatter_accum_f32",
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_void_p])
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("scatter_accum", fn(
            grads.data_ptr(), idx.data_ptr(), out.data_ptr(), B, J,
            num_rows, pl.rows_per_block, pl.tile_rows, pl.blocks, stream))
    scatter_accum.launches += 1
    return out


scatter_accum.launches = 0
