"""Theorem-1 forward contraction: CUDA kernel wrapper, launch count, plain path.

Replaces ``src/repro/kernels/kruskal_contract.py::kruskal_contract`` (a
Pallas TPU kernel).  The kernel is ``csrc/kruskal_contract.cu``; its
source note gives its bound on the card (memory) and what the design does
about it.  On CPU tensors the wrapper computes the plain version
(``ref.kruskal_contract_ref``); on CUDA tensors it launches the kernel or
raises — it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import kruskal_contract_ref

MAX_MODES = 10
MAX_WIDTH = 32  # J, R <= one warp


def _check(a_rows: torch.Tensor, b_fac: torch.Tensor) -> tuple[int, ...]:
    if a_rows.device.type != "cuda" or b_fac.device != a_rows.device:
        raise ValueError(
            "kruskal_contract: the CUDA kernel takes CUDA tensors on one "
            f"device, got {a_rows.device} and {b_fac.device}")
    for name, t in (("a_rows", a_rows), ("b_fac", b_fac)):
        if t.dtype != torch.float32:
            raise TypeError(f"kruskal_contract: {name} must be float32, "
                            f"got {t.dtype}")
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
    if not (1 <= N <= MAX_MODES and 1 <= J <= MAX_WIDTH
            and 1 <= R <= MAX_WIDTH):
        raise ValueError(
            f"kruskal_contract: the kernel takes N <= {MAX_MODES} and "
            f"J, R <= {MAX_WIDTH}, got N={N}, J={J}, R={R}")
    return N, B, J, R


def kruskal_contract(
    a_rows: torch.Tensor,  # (N, B, J) gathered rows, J zero-padded
    b_fac: torch.Tensor,   # (N, J, R) Kruskal core factors, zero-padded
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (pred (B,), pexc (N, B, R)), f32."""
    if a_rows.device.type == "cpu":
        return kruskal_contract_ref(a_rows, b_fac)
    N, B, J, R = _check(a_rows, b_fac)
    pred = torch.empty((B,), dtype=torch.float32, device=a_rows.device)
    pexc = torch.empty((N, B, R), dtype=torch.float32, device=a_rows.device)
    fn = build.function(
        "kruskal_contract", "kruskal_contract_f32",
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(a_rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("kruskal_contract", fn(
            a_rows.data_ptr(), b_fac.data_ptr(), pred.data_ptr(),
            pexc.data_ptr(), N, B, J, R, stream))
    kruskal_contract.launches += 1
    return pred, pexc


kruskal_contract.launches = 0
