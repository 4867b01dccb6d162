"""Serving-table rows C = A B: CUDA kernel wrappers, launch counts, plain paths.

Replaces the reference's jnp mode products of the serving tables
(``src/repro/core/kruskal.py::mode_products`` and the jitted
``_patch_impl`` of ``src/repro/serve/engine.py``); neither is a Pallas
kernel.  The kernels are ``csrc/mode_product_rows.cu``:

``mode_product_rows(rows, core)``
    (M, J) against (J, R) → (M, R) f32 in one launch.  Every element is the
    plain version's sequence (``core.kruskal.mode_product_rows``: one
    product, then a multiply and an add per further j, each rounded, in
    ascending j), so the result is bitwise the plain version whatever M is
    — which a matmul is not.

``patch_table_rows(table, colsum, mirror, core, ids, rows)``
    The row patch of ``TuckerServer.update_rows`` in one C call: the ids
    copied from the caller's host array, the live table copied into a new
    one, then one kernel that gathers the old rows of ``mirror``, writes
    the new ``rows`` into it, forms both products and writes the new one
    into the new table, and one block that adds the colsum delta.  The
    patched rows are bitwise what ``mode_product_rows`` gives for them;
    the live ``table`` and ``colsum`` are never written.  The colsum delta
    is summed in a fixed order (rows within a block, then blocks), so it
    repeats its bits; it is not the plain version's order (``torch.sum``).

On CPU tensors each wrapper computes its plain version (``ref``); on CUDA
tensors it launches its kernel or raises.  Storage may be f32 or bf16 for
the rows, the factors and the table.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .ref import mode_product_rows_ref, patch_table_rows_ref

MAX_WIDTH = 64           # J, R
THREADS = 256
TILE_OUT = 1024          # outputs a tile: four a thread
BUILD_STAGE = 8192       # floats of staged rows a build's tile (32 kB)
PATCH_STAGE = 3072       # floats a patch tile's old and new rows take each
MAX_BLOCKS = 512         # a call's blocks at most (~4 a SM on an H100): a
                         # constant, so a patch's colsum order depends on
                         # the row count alone
STORAGE = (torch.float32, torch.bfloat16)


class Plan(NamedTuple):
    rows_per_tile: int
    tiles: int
    blocks: int


def plan(M: int, J: int, R: int, patch: bool = False) -> Plan:
    """Rows a tile, tiles and blocks for M rows of width J against R."""
    if not (1 <= J <= MAX_WIDTH and 1 <= R <= MAX_WIDTH) or M < 1:
        raise ValueError(f"mode_product_rows: the kernel takes M >= 1 and "
                         f"J, R <= {MAX_WIDTH}, got M={M}, J={J}, R={R}")
    stage = PATCH_STAGE if patch else BUILD_STAGE
    tr = max(1, min(TILE_OUT // R, stage // (J + 1)))
    tiles = -(-M // tr)
    return Plan(tr, tiles, min(tiles, MAX_BLOCKS))


def _check(what: str, **tensors: torch.Tensor) -> torch.device:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors on "
                             f"one device, got {name} on {t.device}")
        if t.dtype not in STORAGE:
            raise TypeError(f"{what}: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return dev


def mode_product_rows(rows: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """(M, J) rows against (J, R) → (M, R) f32, bitwise the plain version."""
    if rows.device.type == "cpu":
        return mode_product_rows_ref(rows, core)
    dev = _check("mode_product_rows", rows=rows, core=core)
    if rows.dim() != 2 or core.dim() != 2 or rows.shape[1] != core.shape[0]:
        raise ValueError(f"mode_product_rows: rows (M, J) and core (J, R) "
                         f"expected, got {tuple(rows.shape)} and "
                         f"{tuple(core.shape)}")
    M, J = rows.shape
    R = core.shape[1]
    out = torch.empty((M, R), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    pl = plan(M, J, R)
    fn = build.function(
        "mode_product_rows", "mode_product_rows",
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("mode_product_rows", fn(
            rows.data_ptr(), core.data_ptr(), out.data_ptr(), M, J, R,
            pl.rows_per_tile, pl.blocks, int(rows.dtype == torch.bfloat16),
            int(core.dtype == torch.bfloat16), stream))
    mode_product_rows.launches += 1
    return out


mode_product_rows.launches = 0


def patch_table_rows(
    table: torch.Tensor,    # (I, R) the live table, never written
    colsum: torch.Tensor,   # (R,) f32 its column sums, never written
    mirror: torch.Tensor,   # (I, J) factor rows: the dirty ones rewritten
    core: torch.Tensor,     # (J, R) the mode's Kruskal core factor
    ids: np.ndarray,        # (K,) int32 unique row ids in range, host
    rows: torch.Tensor,     # (K, J) the new factor rows, mirror's dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """The row patch: (new table, new colsum); ``mirror`` updated in place.
    The caller checks that the ids are unique and in range."""
    if table.device.type == "cpu":
        return patch_table_rows_ref(table, colsum, mirror, core, ids, rows)
    dev = _check("patch_table_rows", table=table, mirror=mirror, core=core,
                 rows=rows)
    if colsum.device != dev or colsum.dtype != torch.float32:
        raise TypeError("patch_table_rows: colsum must be float32 on the "
                        f"table's device, got {colsum.dtype} on "
                        f"{colsum.device}")
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    I, J = mirror.shape
    R = core.shape[1]
    K = len(ids)
    if (table.shape != (I, R) or core.shape[0] != J or colsum.shape != (R,)
            or rows.shape != (K, J) or rows.dtype != mirror.dtype):
        raise ValueError(
            f"patch_table_rows: table {tuple(table.shape)}, mirror "
            f"{tuple(mirror.shape)}, core {tuple(core.shape)}, colsum "
            f"{tuple(colsum.shape)} and rows {tuple(rows.shape)} "
            f"({rows.dtype}, mirror {mirror.dtype}) do not match")
    if K == 0:
        return table, colsum
    pl = plan(K, J, R, patch=True)
    ids_dev = torch.empty((K,), dtype=torch.int32, device=dev)
    new_table = torch.empty_like(table)
    new_colsum = torch.empty_like(colsum)
    partials = torch.empty((pl.blocks, R), dtype=torch.float32, device=dev)
    fn = build.function(
        "mode_product_rows", "patch_table_rows",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
        + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("mode_product_rows", fn(
            ids.ctypes.data, ids_dev.data_ptr(), K, rows.data_ptr(),
            mirror.data_ptr(), core.data_ptr(), table.data_ptr(),
            new_table.data_ptr(), I, colsum.data_ptr(),
            new_colsum.data_ptr(), partials.data_ptr(), J, R,
            pl.rows_per_tile, pl.blocks, int(mirror.dtype == torch.bfloat16),
            int(core.dtype == torch.bfloat16),
            int(table.dtype == torch.bfloat16), stream))
    patch_table_rows.launches += 1
    return new_table, new_colsum


patch_table_rows.launches = 0
