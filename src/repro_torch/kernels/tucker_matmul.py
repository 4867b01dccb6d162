"""Tucker-2 factorized linear: CUDA kernel wrapper, launch count, plain path.

Replaces ``src/repro/kernels/tucker_matmul.py::tucker_matmul`` (a Pallas TPU
kernel).  The kernel is ``csrc/tucker_matmul.cu``: y = ((x U1) G) U2ᵀ with
f32 accumulation, through two (M, R) f32 intermediates that are each
computed once (the Pallas grid recomputes x U1 for every N tile); its
source note gives its bound on the card.  On CPU tensors the wrapper
computes the plain version (``ref.tucker_matmul_ref``); on CUDA tensors it
launches the kernel or raises — it never falls back.  The factors are f32
with x in f32 or bf16 (the LM's mix), or all four are bf16 (the Pallas
kernel's case); y has the promoted dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import tucker_matmul_ref

STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16"}  # C entry suffixes
# (x dtype, factor dtype) pairs with a C entry: the LM path's two and the
# Pallas kernel's all-bf16 case
DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.bfloat16))
SMS = 132            # streaming multiprocessors of the H100 SXM
TILE_N = 128         # output tile width of the kernel's GEMM
MIN_SPLIT_K = 128    # fewest k values one K-split takes
MAX_SPLITS = 128


def split_k(M: int, N: int, K: int) -> int:
    """How many K-splits one (M, N, K) product takes.

    For M > 16 the kernel's output tiles are 128 x 128 (two resident
    blocks per SM): one split once the tiles cover every SM — every product
    at prefill — else enough splits for two blocks per SM.  For M <= 16
    (decode) the tiles are 16 x 128, blocks of little arithmetic that wait
    on memory: enough splits for eight per SM.  Each split takes at least
    ``MIN_SPLIT_K`` values of k.
    """
    if M > 16:
        tiles = -(-M // 128) * -(-N // TILE_N)
        if tiles >= SMS:
            return 1
        want = 2 * SMS
    else:
        tiles = -(-N // TILE_N)
        want = 8 * SMS
    return max(1, min(-(-want // tiles), K // MIN_SPLIT_K, MAX_SPLITS))


def _check(x, u1, g, u2) -> tuple[int, int, int, int, int]:
    if any(t.device.type != "cuda" or t.device != x.device
           for t in (x, u1, g, u2)):
        raise ValueError(
            "tucker_matmul: the CUDA kernel takes CUDA tensors on one "
            f"device, got {[str(t.device) for t in (x, u1, g, u2)]}")
    if (x.dtype, u1.dtype) not in DTYPES \
            or not (g.dtype == u2.dtype == u1.dtype):
        raise TypeError("tucker_matmul: the kernel takes f32 factors with "
                        "an f32 or bf16 x, or all four in bf16; got "
                        f"{x.dtype}, {u1.dtype}, {g.dtype}, {u2.dtype}")
    for name, t in (("x", x), ("u1", u1), ("g", g), ("u2", u2)):
        if t.dim() != 2:
            raise ValueError(f"tucker_matmul: {name} must be 2-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"tucker_matmul: {name} must be contiguous")
    M, K = x.shape
    R1, R2, N = u1.shape[1], g.shape[1], u2.shape[0]
    if u1.shape[0] != K or g.shape[0] != R1 or u2.shape[1] != R2:
        raise ValueError(
            f"tucker_matmul: shapes x {tuple(x.shape)}, u1 "
            f"{tuple(u1.shape)}, g {tuple(g.shape)}, u2 {tuple(u2.shape)} "
            "do not chain")
    if min(M, K, R1, R2, N) < 1 or max(M, K, R1, R2, N) >= 2 ** 31:
        raise ValueError(f"tucker_matmul: sizes out of range: M={M} K={K} "
                         f"R1={R1} R2={R2} N={N}")
    return M, K, R1, R2, N


def tucker_matmul(
    x: torch.Tensor,   # (M, K)
    u1: torch.Tensor,  # (K, R1)
    g: torch.Tensor,   # (R1, R2)
    u2: torch.Tensor,  # (N, R2)
) -> torch.Tensor:
    """y = ((x U1) G) U2ᵀ -> (M, N) in the promoted dtype."""
    if x.device.type == "cpu":
        return tucker_matmul_ref(x, u1, g, u2)
    M, K, R1, R2, N = _check(x, u1, g, u2)
    out_dtype = torch.promote_types(x.dtype, u1.dtype)
    dev = x.device
    splits = (split_k(M, R1, K), split_k(M, R2, R1), split_k(M, N, R2))
    ws_floats = max([s * M * n for s, n in zip(splits, (R1, R2, N))
                     if s > 1], default=0)
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    t1 = torch.empty((M, R1), dtype=torch.float32, device=dev)
    t = torch.empty((M, R2), dtype=torch.float32, device=dev)
    ws = (torch.empty((ws_floats,), dtype=torch.float32, device=dev)
          if ws_floats else None)
    fn = build.function(
        "tucker_matmul",
        f"tucker_matmul_{STORAGE[x.dtype]}_{STORAGE[u1.dtype]}",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("tucker_matmul", fn(
            x.data_ptr(), u1.data_ptr(), g.data_ptr(), u2.data_ptr(),
            y.data_ptr(), t1.data_ptr(), t.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            M, K, R1, R2, N, *splits, stream))
    tucker_matmul.launches += 1
    return y


tucker_matmul.launches = 0
