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
    — which a matmul is not.  ``plan`` picks the route from the shapes:
    "narrow" (J, R <= 8, byte-bound: a row a thread, B in registers) or
    "wide" (a register micro-tile of 8 rows × 4 columns a thread, tiles of
    128 rows double-buffered through ``cp.async``).

``patch_table_rows(table, colsum, mirror, core, ids, rows)``
    The row patch of ``TuckerServer.update_rows`` in one C call: the ids
    and a bit map of the dirty rows copied from the host into the call's
    workspace in one ``cudaMemcpyAsync``, then one launch whose copy blocks
    copy the live table's clean rows into a new one while its patch blocks
    walk tiles of dirty rows (32 on the wide route, 128 on the narrow one):
    they gather the old rows of ``mirror``, write the new ``rows`` into
    it, form both products on the build's micro-tile and write the new one
    into the new table, and the last of them to finish adds the colsum
    delta.  The patched rows are bitwise what
    ``mode_product_rows`` gives for them; the live ``table`` and ``colsum``
    are never written.  The colsum delta is summed in a fixed order that,
    on a route, depends on the row count alone (each thread's rows, the
    threads of a block, then the blocks in order, in segments), so it
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
THREADS = 256            # a build block, a wide patch block
NARROW = 8               # J, R at most this: the narrow route
ROW_GROUPS = 16          # wide route: row groups a tile, 4 columns a thread
BUILD_ROWS = 128         # wide build tile: 16 row groups of 8 rows
NARROW_ROWS = THREADS    # narrow build: a row a thread
PATCH_ROWS = 32          # wide patch tile: 16 row groups of 2
PATCH_NARROW = 128       # narrow patch tile: a row a thread
BUILD_BLOCKS = 264       # wide build grid: two blocks an SM of an H100's 132
NARROW_BLOCKS = 2 * 132  # narrow build grid: fewer blocks stage B fewer
                         # times (grid stride past it; 264 measured fastest
                         # on an H100)
MAX_BLOCKS = 512         # a patch's blocks at most: a constant, so on a
                         # route the colsum's order depends on K alone
SMEM_DEFAULT = 48 * 1024   # a block's shared memory without an opt-in
SMEM_MAX = 227 * 1024      # with one (Hopper)
STORAGE = (torch.float32, torch.bfloat16)


# the C entries' argument types
_BUILD_ARGS = ([ctypes.c_void_p] * 3
               + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p])
_PATCH_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
               + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
               + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
               + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


class Plan(NamedTuple):
    route: str           # "narrow" (J, R <= 8) or "wide"
    threads: int         # a block
    rows_per_tile: int
    tiles: int
    blocks: int
    rows_per_block: int  # wide build: a block's contiguous rows (a multiple
                         # of 8); 0 where the blocks stride over the tiles
    smem: int            # shared bytes a block
    workspace: int       # patch: int32 words (ids, block counter, dirty
                         # rows' bits, partials)


def plan(M: int, J: int, R: int, patch: bool = False, itemsize: int = 4,
         table_rows: int = 0) -> Plan:
    """The launch of M rows of width J against R, from the shapes alone
    (``itemsize``: the rows' storage bytes, 4 or 2; ``table_rows``: a
    patch's table rows I, which size the dirty-row bit map).  Must match
    ``csrc/mode_product_rows.cu``'s constants."""
    if not (1 <= J <= MAX_WIDTH and 1 <= R <= MAX_WIDTH) or M < 1:
        raise ValueError(f"mode_product_rows: the kernel takes M >= 1 and "
                         f"J, R <= {MAX_WIDTH}, got M={M}, J={J}, R={R}")
    narrow = J <= NARROW and R <= NARROW
    S = -(-R // 4) * 4                      # B's row stride, wide route
    if patch:
        threads = PATCH_NARROW if narrow else THREADS
        rows, cap = (PATCH_NARROW if narrow else PATCH_ROWS), MAX_BLOCKS
        smem = 4 * threads + (  # + the last block's segment sums
            4 * NARROW * NARROW + 4 * PATCH_NARROW * (NARROW + 1) if narrow
            else 4 * (J + ROW_GROUPS) * S + 2 * itemsize * PATCH_ROWS * J)
    elif narrow:
        threads, rows, cap = THREADS, NARROW_ROWS, NARROW_BLOCKS
        smem = 4 * NARROW * NARROW
    else:
        threads, rows, cap = THREADS, BUILD_ROWS, BUILD_BLOCKS
        smem = 4 * J * S + 2 * itemsize * BUILD_ROWS * J
    tiles = -(-M // rows)
    blocks = min(tiles, cap)
    per_block = 0
    if not (patch or narrow):
        # the same rows for every block (a multiple of the 8 rows a thread
        # takes), so no block is left a tile behind; a block's last tile
        # may be short
        per_block = (-(-M // min(-(-M // 8), cap)) + 7) // 8 * 8
        blocks = -(-M // per_block)
        last = M - (blocks - 1) * per_block
        tiles = (blocks - 1) * -(-per_block // rows) + -(-last // rows)
    # a patch's workspace: the ids and the block counter, the bit map of
    # the dirty rows, each rounded up to 16 bytes, then the partials
    work = (((M + 4) & ~3) + ((-(-table_rows // 32) + 3) & ~3) + blocks * R
            if patch else 0)
    return Plan("narrow" if narrow else "wide", threads, rows, tiles, blocks,
                per_block, smem, work)


def _on_device(dev: torch.device, launch) -> int:
    """``launch(stream)`` on ``dev``'s current stream; ``dev`` is made the
    current device only when it is not already (the kernels launch on the
    current one)."""
    if torch.cuda.current_device() == dev.index:
        return launch(torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return launch(torch.cuda.current_stream(dev).cuda_stream)


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
    pl = plan(M, J, R, itemsize=rows.element_size())
    fn = build.function("mode_product_rows", "mode_product_rows",
                        _BUILD_ARGS)
    build.check("mode_product_rows", _on_device(dev, lambda stream: fn(
        rows.data_ptr(), core.data_ptr(), out.data_ptr(), M, J, R,
        pl.blocks, pl.rows_per_block, int(rows.dtype == torch.bfloat16),
        int(core.dtype == torch.bfloat16), stream)))
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
    pl = plan(K, J, R, patch=True, itemsize=mirror.element_size(),
              table_rows=I)
    new_table = torch.empty_like(table)
    new_colsum = torch.empty_like(colsum)
    work = torch.empty((pl.workspace,), dtype=torch.int32, device=dev)
    fn = build.function("mode_product_rows", "patch_table_rows",
                        _PATCH_ARGS)
    build.check("mode_product_rows", _on_device(dev, lambda stream: fn(
        ids.ctypes.data, work.data_ptr(), K, rows.data_ptr(),
        mirror.data_ptr(), core.data_ptr(), table.data_ptr(),
        new_table.data_ptr(), I, colsum.data_ptr(), new_colsum.data_ptr(),
        J, R, pl.blocks, int(mirror.dtype == torch.bfloat16),
        int(core.dtype == torch.bfloat16),
        int(table.dtype == torch.bfloat16), stream)))
    patch_table_rows.launches += 1
    return new_table, new_colsum


patch_table_rows.launches = 0
