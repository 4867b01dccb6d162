"""Fused forward + Eq. 13/17 gradients: CUDA kernel wrapper, count, plain path.

Replaces ``src/repro/kernels/kruskal_grad.py::kruskal_grad`` (a Pallas TPU
kernel).  The kernel is ``csrc/kruskal_grad.cu``; its source note gives its
bound on the card (memory, and at the training batch the launch itself)
and how the core gradient is reduced across blocks without atomics.

The CUDA kernel computes the joint pass of the training step: every row
mode, core gradients on, no cached mode products.  The phase flags of the
reference (``c=``, ``emit_c``, a partial ``row_modes``,
``want_core=False``) are off this slice's path: on CPU tensors the plain
version (``ref.kruskal_grad_ref``) implements them all, and on any other
device the wrapper raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import build
from .ref import NUM_SCALARS, kruskal_grad_ref

MAX_MODES = 10
MAX_WIDTH = 32          # J, R <= one warp
MAX_BLOCKS = 256        # core partials; a constant, so results do not
                        # depend on the card's SM count
SMEM_LIMIT = 232_448    # bytes of shared memory a Hopper block may use
TILES = (64, 32, 16)    # samples per shared-memory tile, largest that fits


class KernelOuts(NamedTuple):
    """Outputs of the fused pass (absent stages are None)."""
    pred: torch.Tensor                        # (B,)
    err: torch.Tensor                         # (B,)
    row_grads: Optional[torch.Tensor] = None  # (len(row_modes), B, J)
    core_grads: Optional[torch.Tensor] = None  # (N, J, R)
    c: Optional[torch.Tensor] = None          # (N, B, R) mode products


def tile_size(N: int, J: int, R: int) -> int:
    """Samples per tile: the largest of ``TILES`` whose shared memory fits."""
    for bt in TILES:
        floats = N * J * (R + 1) + N * bt * (J + R) + N * J * R
        if 4 * floats <= SMEM_LIMIT:
            return bt
    raise ValueError(f"kruskal_grad: N={N}, J={J}, R={R} does not fit in "
                     "shared memory")


def _check_flags(N, c, row_modes, want_core, emit_c) -> None:
    if c is not None or emit_c:
        raise NotImplementedError(
            "kruskal_grad: the CUDA kernel does not take cached mode "
            "products (c=) or emit them (emit_c)")
    if row_modes is not None and tuple(row_modes) != tuple(range(N)):
        raise NotImplementedError(
            "kruskal_grad: the CUDA kernel emits every row mode; got "
            f"row_modes={row_modes}")
    if not want_core:
        raise NotImplementedError(
            "kruskal_grad: the CUDA kernel always computes core gradients "
            "(want_core=False is not taken)")


def _check(a_rows, b_fac, val, mask, scal) -> tuple[int, ...]:
    dev = a_rows.device
    named = (("a_rows", a_rows), ("b_fac", b_fac), ("val", val),
             ("mask", mask), ("scal", scal))
    for name, t in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kruskal_grad: the CUDA kernel takes CUDA "
                             f"tensors on one device; {name} is on "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"kruskal_grad: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"kruskal_grad: {name} must be contiguous")
    if a_rows.dim() != 3 or b_fac.dim() != 3:
        raise ValueError("kruskal_grad: a_rows (N, B, J) and b_fac (N, J, R) "
                         "must be 3-D")
    N, B, J = a_rows.shape
    R = b_fac.shape[2]
    if b_fac.shape[:2] != (N, J):
        raise ValueError(f"kruskal_grad: b_fac {tuple(b_fac.shape)} does not "
                         f"match a_rows {tuple(a_rows.shape)}")
    if val.shape != (B,) or mask.shape != (B,):
        raise ValueError(f"kruskal_grad: val and mask must be ({B},)")
    if scal.shape != (NUM_SCALARS,):
        raise ValueError(f"kruskal_grad: scal must be ({NUM_SCALARS},)")
    if not (1 <= N <= MAX_MODES and 1 <= J <= MAX_WIDTH
            and 1 <= R <= MAX_WIDTH):
        raise ValueError(
            f"kruskal_grad: the kernel takes N <= {MAX_MODES} and "
            f"J, R <= {MAX_WIDTH}, got N={N}, J={J}, R={R}")
    return N, B, J, R


def kruskal_grad(
    a_rows: torch.Tensor,  # (N, B, J)  gathered factor rows (J zero-padded)
    b_fac: torch.Tensor,   # (N, J, R)  Kruskal core factors (zero-padded)
    val: torch.Tensor,     # (B,)       sampled tensor values
    mask: torch.Tensor,    # (B,)       1.0 valid / 0.0 padding
    scal: torch.Tensor,    # (5,)  [1/ρ_row, 1/δ_core, λ_a, λ_b, pred_coef]
    c: torch.Tensor | None = None,  # (N, B, R) cached mode products
    *,
    row_modes: tuple[int, ...] | None = None,  # None = all; () = none
    want_core: bool = True,
    emit_c: bool = False,
) -> KernelOuts:
    """Fused contraction + Eq. 13/17 gradients; ``core_grads`` includes
    the λ_b·B regularizer.  All outputs f32."""
    if a_rows.device.type == "cpu":
        return KernelOuts(*kruskal_grad_ref(
            a_rows, b_fac, val, mask, scal, c, row_modes=row_modes,
            want_core=want_core, emit_c=emit_c))
    _check_flags(a_rows.shape[0], c, row_modes, want_core, emit_c)
    N, B, J, R = _check(a_rows, b_fac, val, mask, scal)
    dev = a_rows.device
    pred = torch.empty((B,), dtype=torch.float32, device=dev)
    err = torch.empty((B,), dtype=torch.float32, device=dev)
    rg = torch.empty((N, B, J), dtype=torch.float32, device=dev)
    cg = torch.empty((N, J, R), dtype=torch.float32, device=dev)
    bt = tile_size(N, J, R)
    blocks = min(-(-B // bt), MAX_BLOCKS)
    partial = torch.empty((blocks, N * J * R), dtype=torch.float32,
                          device=dev)
    fn = build.function(
        "kruskal_grad", "kruskal_grad_f32",
        [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("kruskal_grad", fn(
            a_rows.data_ptr(), b_fac.data_ptr(), val.data_ptr(),
            mask.data_ptr(), scal.data_ptr(), pred.data_ptr(),
            err.data_ptr(), rg.data_ptr(), cg.data_ptr(), partial.data_ptr(),
            N, B, J, R, bt, blocks, stream))
    kruskal_grad.launches += 1
    return KernelOuts(pred, err, rg, cg)


kruskal_grad.launches = 0
