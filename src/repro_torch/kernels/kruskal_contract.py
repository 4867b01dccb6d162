"""Theorem-1 forward contraction: CUDA kernel wrapper, launch count, plain path.

Replaces ``src/repro/kernels/kruskal_contract.py::kruskal_contract`` (a
Pallas TPU kernel).  The kernel is ``csrc/kruskal_contract.cu``; its
source note gives its bound on the card (memory) and its two routes (one
thread a sample up to width 8; a lane group a sample above).
On CPU tensors the wrapper computes the plain version
(``ref.kruskal_contract_ref``); on CUDA tensors it launches the kernel or
raises — it never falls back.  Storage may be f32 or bf16 (``a_rows`` and
``b_fac`` alike); the outputs are f32.  ``want_pexc=False`` returns
``(pred, None)``: the same function restricted to the output a caller
reads, and the kernel then writes ``pred`` alone (about half the bytes at
the paper's widths).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import kruskal_contract_ref

MAX_MODES = 10
MAX_WIDTH = 64  # J, R <= two entries a lane
STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16"}  # C entry suffix


def _check(a_rows: torch.Tensor, b_fac: torch.Tensor) -> tuple[int, ...]:
    if a_rows.device.type != "cuda" or b_fac.device != a_rows.device:
        raise ValueError(
            "kruskal_contract: the CUDA kernel takes CUDA tensors on one "
            f"device, got {a_rows.device} and {b_fac.device}")
    if a_rows.dtype not in STORAGE or b_fac.dtype != a_rows.dtype:
        raise TypeError("kruskal_contract: a_rows and b_fac must both be "
                        f"float32 or both bfloat16, got {a_rows.dtype} and "
                        f"{b_fac.dtype}")
    for name, t in (("a_rows", a_rows), ("b_fac", b_fac)):
        if not t.is_contiguous():
            raise ValueError(f"kruskal_contract: {name} must be contiguous")
    if a_rows.dim() != 3 or b_fac.dim() != 3:
        raise ValueError("kruskal_contract: a_rows (N, B, J) and b_fac "
                         "(N, J, R) must be 3-D")
    N, B, J = a_rows.shape
    R = b_fac.shape[2]
    if b_fac.shape[:2] != (N, J):
        raise ValueError(f"kruskal_contract: b_fac {tuple(b_fac.shape)} does "
                         f"not match a_rows {tuple(a_rows.shape)}")
    check_widths(N, J, R)
    return N, B, J, R


def check_widths(N: int, J: int, R: int) -> None:
    """Raise the kernel's ``ValueError`` for a shape it does not take."""
    if not (1 <= N <= MAX_MODES and 1 <= J <= MAX_WIDTH
            and 1 <= R <= MAX_WIDTH):
        raise ValueError(
            f"kruskal_contract: the kernel takes N <= {MAX_MODES} and "
            f"J, R <= {MAX_WIDTH}, got N={N}, J={J}, R={R}")


def kruskal_contract(
    a_rows: torch.Tensor,  # (N, B, J) gathered rows, J zero-padded
    b_fac: torch.Tensor,   # (N, J, R) Kruskal core factors, zero-padded
    want_pexc: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Returns (pred (B,), pexc (N, B, R) or None), f32."""
    if a_rows.device.type == "cpu":
        pred, pexc = kruskal_contract_ref(a_rows, b_fac)
        return pred, (pexc if want_pexc else None)
    N, B, J, R = _check(a_rows, b_fac)
    pred = torch.empty((B,), dtype=torch.float32, device=a_rows.device)
    pexc = (torch.empty((N, B, R), dtype=torch.float32,
                        device=a_rows.device) if want_pexc else None)
    fn = build.function(
        "kruskal_contract", f"kruskal_contract_{STORAGE[a_rows.dtype]}",
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(a_rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("kruskal_contract", fn(
            a_rows.data_ptr(), b_fac.data_ptr(), pred.data_ptr(),
            None if pexc is None else pexc.data_ptr(), N, B, J, R, stream))
    kruskal_contract.launches += 1
    return pred, pexc


kruskal_contract.launches = 0
