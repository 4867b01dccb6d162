"""Fused forward + Eq. 13/17 gradients: CUDA kernel wrapper, count, plain path.

Replaces ``src/repro/kernels/kruskal_grad.py::kruskal_grad`` (a Pallas TPU
kernel).  The kernel is ``csrc/kruskal_grad.cu``; its source note gives its
bound on the card (at the training batch, the launch and chains of
latency) and how the core gradient is reduced across blocks in the same
launch, without float atomics.

The CUDA kernel takes every phase flag of the reference: ``emit_c``
(write the mode products it used), ``c=`` (consume cached ones instead of
the N dots), an ordered ``row_modes`` list and ``want_core``.  Its tiling,
``plan(N, J, R, B)``, does not depend on the flags, so a core pass fed
with emitted ``c`` gives the joint pass's core gradient bit for bit.
Storage may be f32 or bf16 (``a_rows`` and ``b_fac`` alike); every output
is f32.  On CPU tensors the wrapper computes the plain version
(``ref.kruskal_grad_ref``); on CUDA tensors it launches the kernel (one
device kernel per call, whatever the flags) or raises — it never falls
back.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import build
from .ref import NUM_SCALARS, kruskal_grad_ref

MAX_MODES = 10
MAX_WIDTH = 64          # J, R <= two entries a lane
MAX_BLOCKS = 256        # core partials; a constant, so results do not
                        # depend on the card's SM count
MAX_THREADS = 256       # threads of a block: BT lane groups of W lanes
MAX_TILE = 32           # samples per tile; <= 32 gives >= 128 blocks at
                        # the training batch B = 4096
LANE_ENTRIES = 2        # core entries a lane of the last block sums at
                        # once (the cross-block sum's shared memory)
SMEM_LIMIT = 232_448    # bytes of shared memory a Hopper block may use
STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16"}  # C entry suffix


class KernelOuts(NamedTuple):
    """Outputs of the fused pass (absent stages are None)."""
    pred: torch.Tensor                        # (B,)
    err: torch.Tensor                         # (B,)
    row_grads: Optional[torch.Tensor] = None  # (len(row_modes), B, J)
    core_grads: Optional[torch.Tensor] = None  # (N, J, R)
    c: Optional[torch.Tensor] = None          # (N, B, R) mode products


class Plan(NamedTuple):
    """The kernel's tiling for one shape (see ``plan``)."""
    bt: int          # samples per tile, one lane group each
    blocks: int      # blocks launched (= core partials)
    threads: int     # threads per block: bt lane groups of width W
    slices: int      # Eq. 17 fold: each (n, j, r) entry in this many slices
    smem_bytes: int  # dynamic shared memory with the core stages on


def group_width(J: int, R: int) -> int:
    """Lanes per sample: the next power of two >= max(J, R), at most a
    warp (above 32 each lane holds two columns)."""
    return min(1 << (max(J, R) - 1).bit_length(), 32)


def _smem_bytes(N: int, J: int, R: int, bt: int, W: int) -> int:
    """The factors (N, J, R+1), the tiles (N, bt, J + R) and the partial
    (N, J, R), or the last block's per-lane sums, whichever is larger."""
    tile_floats = N * J * (R + 1) + N * bt * (J + R) + N * J * R
    return 4 * max(tile_floats, bt * W * LANE_ENTRIES)


def plan(N: int, J: int, R: int, B: int) -> Plan:
    """Tile, blocks, threads, fold slices and shared memory for N modes of
    width J, core rank R and B samples.  It reads the shapes only, never
    the phase flags or the card, so every flag combination folds the same
    terms in the same order on any card.  The tile is the largest that
    fits 256 threads, halved while its shared memory does not fit a block;
    where even one sample a tile does not fit (N >= 7 at J = R = 64), it
    raises."""
    if not (1 <= N <= MAX_MODES and 1 <= J <= MAX_WIDTH
            and 1 <= R <= MAX_WIDTH and B >= 1):
        raise ValueError(
            f"kruskal_grad: the kernel takes N <= {MAX_MODES}, "
            f"J, R <= {MAX_WIDTH} and B >= 1, got N={N}, J={J}, R={R}, "
            f"B={B}")
    W = group_width(J, R)
    bt = min(MAX_TILE, MAX_THREADS // W)
    # threads stay a whole number of warps: bt >= 32 / W
    while (_smem_bytes(N, J, R, bt, W) > SMEM_LIMIT
           and (bt // 2) * W % 32 == 0 and bt > 1):
        bt //= 2
    smem = _smem_bytes(N, J, R, bt, W)
    if smem > SMEM_LIMIT:
        raise ValueError(f"kruskal_grad: N={N}, J={J}, R={R} needs {smem} "
                         f"bytes of shared memory at {bt} samples a tile, "
                         f"more than a block's {SMEM_LIMIT}")
    blocks = min(-(-B // bt), MAX_BLOCKS)
    njr = N * J * R
    slices = 1          # the most that keep the fold to one pass
    while 2 * slices * njr <= bt * W and 2 * slices <= min(bt, 32):
        slices *= 2
    return Plan(bt, blocks, bt * W, slices, smem)


def row_mode_code(N: int, row_modes: tuple[int, ...] | None) -> int:
    """The kernel's by-value row-mode list: bits 0-3 hold the count, bits
    4 + 4j the j-th mode.  ``None`` means every mode in order."""
    modes = tuple(range(N)) if row_modes is None else tuple(row_modes)
    if len(modes) > MAX_MODES or any(not 0 <= m < N for m in modes):
        raise ValueError(f"kruskal_grad: row_modes must list at most "
                         f"{MAX_MODES} modes in [0, {N}), got {row_modes}")
    code = len(modes)
    for j, m in enumerate(modes):
        code |= m << (4 + 4 * j)
    return code


def _check(a_rows, b_fac, val, mask, scal, c) -> tuple[int, ...]:
    dev = a_rows.device
    if a_rows.dtype not in STORAGE:
        raise TypeError(f"kruskal_grad: a_rows must be float32 or bfloat16, "
                        f"got {a_rows.dtype}")
    named = (("a_rows", a_rows), ("b_fac", b_fac), ("val", val),
             ("mask", mask), ("scal", scal), ("c", c))
    for name, t in named:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kruskal_grad: the CUDA kernel takes CUDA "
                             f"tensors on one device; {name} is on "
                             f"{t.device}")
        want = a_rows.dtype if name in ("a_rows", "b_fac") else torch.float32
        if t.dtype != want:
            raise TypeError(f"kruskal_grad: {name} must be {want}, got "
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
    if c is not None and c.shape != (N, B, R):
        raise ValueError(f"kruskal_grad: c must be ({N}, {B}, {R}), got "
                         f"{tuple(c.shape)}")
    return N, B, J, R


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# One 4-byte ticket per (device, stream): the blocks of a call count
# themselves on it and the last one puts it back to 0, so it is zeroed only
# here, when it is made, and calls queued on one stream reuse it in turn.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = torch.zeros(1, dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


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
    the λ_b·B regularizer.  All outputs f32; absent stages are None."""
    if a_rows.device.type == "cpu":
        return KernelOuts(*kruskal_grad_ref(
            a_rows, b_fac, val, mask, scal, c, row_modes=row_modes,
            want_core=want_core, emit_c=emit_c))
    N, B, J, R = _check(a_rows, b_fac, val, mask, scal, c)
    code = row_mode_code(N, row_modes)
    nrow = code & 15
    dev = a_rows.device

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    pl = plan(N, J, R, B)
    pred, err = out(B), out(B)
    rg = out(nrow, B, J) if nrow else None
    cg = out(N, J, R) if want_core else None
    c_out = out(N, B, R) if emit_c else None
    fn = build.function(
        "kruskal_grad", f"kruskal_grad_{STORAGE[a_rows.dtype]}",
        [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        partial = ticket = None
        if want_core:
            partial = out(pl.blocks, N * J * R)
            ticket = _ticket(dev, stream)
        build.check("kruskal_grad", fn(
            a_rows.data_ptr(), b_fac.data_ptr(), val.data_ptr(),
            mask.data_ptr(), scal.data_ptr(), _ptr(c), pred.data_ptr(),
            err.data_ptr(), _ptr(rg), _ptr(cg), _ptr(c_out), _ptr(partial),
            _ptr(ticket), N, B, J, R, pl.bt, pl.slices, pl.blocks, code,
            int(want_core), stream))
    kruskal_grad.launches += 1
    return KernelOuts(pred, err, rg, cg, c_out)


kruskal_grad.launches = 0
