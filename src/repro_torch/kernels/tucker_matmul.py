"""Tucker-2 factorized linear: CUDA kernel wrapper, launch count, plain path.

Replaces ``src/repro/kernels/tucker_matmul.py::tucker_matmul`` (a Pallas TPU
kernel).  The kernel is ``csrc/tucker_matmul.cu``: y = ((x U1) G) U2ᵀ with
f32 accuracy (3xTF32 tensor-core tiles at prefill, f32 streams of the
factors at decode), each product computed once (the Pallas grid recomputes
x U1 for every N tile), three launches per call as ``plan()`` lays them
out; its source note gives its bound on the card.  On CPU tensors the wrapper
computes the plain version (``ref.tucker_matmul_ref``); on CUDA tensors it
launches the kernel or raises — it never falls back.  The factors are f32
with x in f32 or bf16 (the LM's mix), or all four are bf16 (the Pallas
kernel's case); y has the promoted dtype.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import build
from .ref import tucker_matmul_ref

STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16"}  # C entry suffixes
# (x dtype, factor dtype) pairs with a C entry: the LM path's two and the
# Pallas kernel's all-bf16 case
DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.bfloat16))
SMS = 132             # streaming multiprocessors of the H100 SXM
STREAM_MAX_M = 16     # the streaming route's largest M (decode batches)
STRIP = 32            # columns per streaming block (one 128-byte f32 line)
STREAM_BLOCKS = 2 * SMS   # blocks of the last product's stream: two per SM
MAX_CLUSTER = 8       # row splits of one streaming product: one cluster
MIN_ROWS = 16         # fewest factor rows one streaming split takes
ROWS_SMEM = 192 * 1024    # shared bytes for a split's rows of x (or t1)
T_SMEM = 48 * 1024        # shared bytes for t (M x R2) in the last product
WIDE = 16             # bytes of a wide load; narrow loads are 4 bytes


@dataclasses.dataclass(frozen=True)
class Plan:
    """What the wrapper hands the kernel for one call: three launches, one
    per product, in order ``x U1``, ``t1 G``, ``t U2ᵀ``, through t1 (M, R1)
    and t (M, R2) in an f32 workspace.  The kernel computes its grids
    itself, checks ``passes`` against the passes it was compiled with, and
    refuses an unaligned t.

    ``routes``: ``"mma"`` (tensor-core GEMM tiles) for every product when
    M > 16; the streaming route for M <= 16: ``"rows"`` (stream factor
    rows in 32-column strips) twice, then ``"cols"`` (one warp per output
    column).  ``splits``: the K-splits of each product — on the streaming
    route a cluster of that many blocks per strip, summed in rank order
    inside the cluster; the last product never splits.  ``load_bytes``: 16
    when the product's rows are 16-byte multiples on 16-byte aligned bases,
    else 4.  ``passes``: tensor-core passes per k-step (3xTF32; 2 when one
    side is bf16; 0 on the streaming route, which is f32 fmaf).
    ``workspace``: f32 scratch elements, t1 first and t at ``t_offset``
    (16-byte aligned).  ``col_blocks``: the blocks of the streaming route's
    last product (0 on the tensor-core route).
    """
    routes: tuple[str, str, str]
    splits: tuple[int, int, int]
    load_bytes: tuple[int, int, int]
    passes: tuple[int, int, int]
    workspace: int
    t_offset: int
    col_blocks: int

    @property
    def stream(self) -> bool:
        return self.routes[0] == "rows"

    @property
    def launches(self) -> int:
        return len(self.routes)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _wide(ok_rows: bool, *aligns: int) -> int:
    return WIDE if ok_rows and all(a % WIDE == 0 for a in aligns) else 4


def _splits(K: int) -> int:
    """Row splits of a streamed (K, ·) factor: a full cluster, each split
    at least MIN_ROWS rows, none empty."""
    return _cdiv(K, _cdiv(K, min(MAX_CLUSTER, _cdiv(K, MIN_ROWS))))


def plan(M: int, K: int, R1: int, R2: int, N: int, x_dtype: torch.dtype,
         w_dtype: torch.dtype = torch.float32, *, x_align: int = WIDE,
         w_align: int = WIDE) -> Plan:
    """The launch plan of ``tucker_matmul`` for these sizes and dtypes.

    ``x_align`` / ``w_align``: the largest power of two (capped at 16)
    dividing x's base address / every factor's.  M <= 16 (decode) takes
    the streaming route when a split's rows of x and t1 (M padded to 4 or
    16) fit in ROWS_SMEM and t in T_SMEM; every other call takes the
    tensor-core route in one pass over K (its output tiles fill the card at
    prefill).
    """
    xe, we = x_dtype.itemsize, w_dtype.itemsize
    t_off = _cdiv(M * R1, 4) * 4      # t on a 16-byte boundary
    mb = 4 if M <= 4 else 16
    s1, s2 = _splits(K), _splits(R1)
    if (M <= STREAM_MAX_M and mb * R2 * 4 <= T_SMEM
            and 4 * mb * max(_cdiv(K, s1), _cdiv(R1, s2)) <= ROWS_SMEM):
        return Plan(
            routes=("rows", "rows", "cols"), splits=(s1, s2, 1),
            load_bytes=(_wide(R1 * we % WIDE == 0, w_align),
                        _wide(R2 * we % WIDE == 0, w_align),
                        _wide(R2 * we % WIDE == 0, w_align)),
            passes=(0, 0, 0), workspace=t_off + M * R2, t_offset=t_off,
            col_blocks=min(_cdiv(N, 8), STREAM_BLOCKS))
    fp = 2 if we == 2 else 3      # f32 t1 / t against the factors
    return Plan(
        routes=("mma", "mma", "mma"), splits=(1, 1, 1),
        load_bytes=(_wide(K * xe % WIDE == 0 and R1 * we % WIDE == 0,
                          x_align, w_align),
                    _wide(R1 % 4 == 0 and R2 * we % WIDE == 0, w_align),
                    _wide(R2 % 4 == 0 and R2 * we % WIDE == 0, w_align)),
        passes=(1 if xe == we == 2 else 2 if 2 in (xe, we) else 3, fp, fp),
        workspace=t_off + M * R2, t_offset=t_off, col_blocks=0)


def _align(t: torch.Tensor) -> int:
    a = t.data_ptr() & -t.data_ptr() if t.data_ptr() else WIDE
    return min(a, WIDE)


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
    p = plan(M, K, R1, R2, N, x.dtype, u1.dtype, x_align=_align(x),
             w_align=min(_align(t) for t in (u1, g, u2)))
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    ws = torch.empty((p.workspace,), dtype=torch.float32, device=dev)
    wide = sum(1 << i for i, b in enumerate(p.load_bytes) if b == WIDE)
    passes = sum(n << 2 * i for i, n in enumerate(p.passes))
    fn = build.function(
        "tucker_matmul",
        f"tucker_matmul_{STORAGE[x.dtype]}_{STORAGE[u1.dtype]}",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("tucker_matmul", fn(
            x.data_ptr(), u1.data_ptr(), g.data_ptr(), u2.data_ptr(),
            y.data_ptr(), ws.data_ptr(), ws[p.t_offset:].data_ptr(),
            M, K, R1, R2, N, int(p.stream), p.splits[0], p.splits[1],
            p.col_blocks, wide, passes, stream))
    tucker_matmul.launches += 1
    return y


tucker_matmul.launches = 0
