"""Flash-attention backward: CUDA kernel wrapper, launch count, plain path.

Counterpart of ``src/repro/models/flash.py::_flash_bwd``, the reference's
FA2 recompute backward (a jnp custom VJP; the reference has no Pallas
kernel for it).  The kernel is ``csrc/flash_attention_bwd.cu``: dQ, dK and
dV from q, k, v, the forward's output o and log-sum-exp lse, and dO, with
the probabilities recomputed tile by tile from lse; each output element is
written once by one block (no atomics), so two calls give the same bits.
Same layouts, masks, head grouping and widths as the forward
(``flash_attention``): q (B, Sq, H, D) or (BH, Sq, D), k with H/G heads,
v, o and dO at v's width Dv, lse (B, H, Sq) or (BH, Sq); (D, Dv) one of
``WIDTHS`` (D = Dv, 80 included, or MLA's (192, 128), whose ring tiles
are 16 rows high: ``plan()``).  Any strides with the last dimension
contiguous are read as they are; dq, dk and dv are new f32 tensors,
contiguous in the (B, S, H, width) layout.  q, k, v, o and dO are all f32 or
all bf16 (the ``mixed_precision`` step's), read in place; lse is f32.  A
bf16 call gives the f32 kernel's bits on the inputs widened to f32.  The
kernel's 16-byte ``cp.async`` copies need q, k, v, o and dO on 16-byte
boundaries with (batch, sequence, head) strides in 16-byte units;
``plan()`` lays out its three launches, and the C entry refuses a plan it
was not built for.  On CPU tensors the wrapper computes the plain version
(``ref.flash_attention_bwd_ref``); on CUDA tensors it launches the kernel
or raises — it never falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import build
from .flash_attention import ALIGN, HEAD_DIMS, STORAGE, WIDTHS, _as_4d
from .ref import flash_attention_bwd_ref

WARPS = 8             # a block of both passes: 16 rows a warp
ROWS = 128            # keys of a dK/dV block, queries of a dQ block
# rows of a ring tile (queries in the dK/dV pass, keys in the dQ pass): 16
# at (192, 128), where 32 would need 289,792 shared bytes
RING_ROWS = {w: 16 if w == (192, 128) else 32 for w in WIDTHS}
PASSES = 3            # 3xTF32: tensor-core passes per f32 product
PRODUCTS = ("S", "dP", "dV", "dK", "dQ")
# bf16 inputs: a bf16 value is exact in TF32 (its small part is 0), so
# S = q·kᵀ and dP = dO·vᵀ (bf16 × bf16) take one pass, and dV, dK, dQ (the
# f32 P or dS times bf16 dO, q or k) two
BF16_PASSES = (1, 1, 2, 2, 2)
DOT_THREADS = 256     # the Di kernel: one warp a row


@dataclasses.dataclass(frozen=True)
class Plan:
    """The three launches of one call, as the wrapper hands them to the C
    entry, which refuses any value it was not built with.

    ``kv_tile``: keys of a dK/dV block (16 a warp) and queries of each
    tile its ring brings; ``q_tile``: queries of a dQ block and keys of
    each ring tile.  ``smem``: dynamic shared bytes of the dK/dV and the
    dQ kernel (resident tiles of 128 rows at D and Dv, two ring stages and
    the small parts of the landed one; the same for bf16 inputs, whose
    landing zones take the second stage's space).  ``grids``: (x, y, z) of the Di, dK/dV and dQ
    launches; the dK/dV block x is (key tile x // (Hk B), KV head x % Hk,
    batch x // Hk % B) and the dQ block (the last query tile first) is
    likewise over (query tile, head, batch), so the blocks with the most
    causal work are issued first.  ``passes``: tensor-core passes of each
    of ``PRODUCTS`` (3 on f32 inputs, ``BF16_PASSES`` on bf16).
    ``workspace``: scratch bytes, Di only (dQ is a second pass, no
    partials).
    """
    warps: int
    kv_tile: tuple[int, int]
    q_tile: tuple[int, int]
    smem: tuple[int, int]
    grids: tuple[tuple[int, int, int], ...]
    passes: tuple[int, ...]
    workspace: int

    def to_c(self):
        """The ints of the C entry's ``plan`` argument, in its order."""
        vals = (self.warps, *self.kv_tile, *self.q_tile,
                sum(p << 2 * i for i, p in enumerate(self.passes)),
                *self.smem, *(g[0] for g in self.grids))
        return (ctypes.c_int * len(vals))(*vals)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _widths_message(D: int, Dv: int) -> str:
    return (f"flash_attention_bwd: the kernel takes D in {HEAD_DIMS} with "
            f"Dv = D, or (D, Dv) = (192, 128); got {(D, Dv)}")


def _smem_bytes(D: int, Dv: int, rows: int, tile: int) -> int:
    # resident rows: permuted in place where the width is a multiple of
    # 32 floats, else padded by 4 (16 and 80)
    res = sum(w + 4 if w % 32 else w for w in (D, Dv))
    ring = D + 4 + Dv + 4            # ring rows, read along both axes
    return 4 * (rows * res + 3 * tile * ring)


def plan(B: int, Sq: int, Sk: int, H: int, Hk: int, D: int,
         Dv: int | None = None, dtype: torch.dtype = torch.float32) -> Plan:
    """The launch plan of ``flash_attention_bwd`` for these sizes (Dv:
    v's width, default D) and inputs of ``dtype``."""
    Dv = D if Dv is None else Dv
    if (D, Dv) not in WIDTHS:
        raise ValueError(_widths_message(D, Dv))
    nt = RING_ROWS[D, Dv]
    smem = _smem_bytes(D, Dv, ROWS, nt)
    return Plan(
        warps=WARPS, kv_tile=(ROWS, nt), q_tile=(ROWS, nt),
        smem=(smem, smem),
        grids=((_cdiv(B * H * Sq * 32, DOT_THREADS), 1, 1),
               (_cdiv(Sk, ROWS) * Hk * B, 1, 1),
               (_cdiv(Sq, ROWS) * H * B, 1, 1)),
        passes=(BF16_PASSES if dtype == torch.bfloat16
                else (PASSES,) * len(PRODUCTS)),
        workspace=4 * B * H * Sq)


def _check(q, k, v, o, lse, dout, kv_len, q_offset) -> None:
    ts = (q, k, v, o, lse, dout)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError(
            "flash_attention_bwd: the CUDA kernel takes CUDA tensors on one "
            f"device, got {[str(t.device) for t in ts]}")
    if lse.dtype != torch.float32 or q.dtype not in STORAGE or any(
            t.dtype != q.dtype for t in (k, v, o, dout)):
        raise TypeError("flash_attention_bwd: the kernel takes q, k, v, o "
                        "and dO all float32 or all bfloat16 and a float32 "
                        f"lse, got {[t.dtype for t in ts]}")
    if not (q.dim() == k.dim() == v.dim() and q.dim() in (3, 4)):
        raise ValueError("flash_attention_bwd: q, k, v must all be "
                         "(BH, S, D) or all (B, S, H, D)")
    q4, k4, v4 = _as_4d(q), _as_4d(k), _as_4d(v)
    B, Sq, H, D = q4.shape
    Sk, Hk, Dv = k4.shape[1], k4.shape[2], v4.shape[3]
    if k4.shape[:3] != v4.shape[:3] or k4.shape[0] != B \
            or k4.shape[3] != D:
        raise ValueError(f"flash_attention_bwd: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    want_o = (*q.shape[:-1], Dv)
    if o.shape != want_o or dout.shape != want_o:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and dO "
                         f"{tuple(dout.shape)} must have q's shape with v's "
                         f"width, {want_o}")
    want = (B, H, Sq) if q.dim() == 4 else (H, Sq)
    if tuple(lse.shape) != want or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"{want}, got {tuple(lse.shape)}")
    if (D, Dv) not in WIDTHS:
        raise ValueError(_widths_message(D, Dv))
    if H % Hk:
        raise ValueError(f"flash_attention_bwd: {H} query heads are not a "
                         f"multiple of {Hk} key/value heads")
    if not 1 <= kv_len <= Sk or q_offset < 0:
        raise ValueError(f"flash_attention_bwd: kv_len {kv_len} outside "
                         f"[1, {Sk}] or q_offset {q_offset} < 0")
    if any(_as_4d(t).stride(3) != 1 for t in (q, k, v, o, dout)):
        raise ValueError("flash_attention_bwd: the head dimension must be "
                         "contiguous")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("dO", dout)):
        t4 = _as_4d(t)
        if t4.data_ptr() % ALIGN or any(
                st * t4.element_size() % ALIGN
                for st, n in zip(t4.stride()[:3], t4.shape[:3]) if n > 1):
            raise ValueError(
                f"flash_attention_bwd: {name} must start on a {ALIGN}-byte "
                f"boundary with (batch, seq, head) strides in {ALIGN}-byte "
                f"units, got address {t4.data_ptr()} and strides "
                f"{t4.stride()[:3]}")
    if max(B, H) > 65535 or max(Sq, Sk) >= 2 ** 31:
        raise ValueError("flash_attention_bwd: sizes out of range")


def flash_attention_bwd(
    q: torch.Tensor,     # (BH, Sq, D) or (B, Sq, H, D)
    k: torch.Tensor,     # (BH/G, Sk, D) or (B, Sk, H/G, D)
    v: torch.Tensor,     # like k, of width Dv
    o: torch.Tensor,     # like q, of width Dv
    lse: torch.Tensor,   # (BH, Sq) or (B, H, Sq), f32
    dout: torch.Tensor,  # like o
    *,
    causal: bool = True,
    kv_len: int | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax attention, f32, in q's, k's and v's
    shapes."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, dout, causal,
                                       kv_len=kv_len, q_offset=q_offset)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    _check(q, k, v, o, lse, dout, kv_len, q_offset)
    dev = q.device
    q4, k4, v4, o4, d4 = (_as_4d(t) for t in (q, k, v, o, dout))
    B, Sq, H, D = q4.shape
    Sk, Hk, Dv = k4.shape[1], k4.shape[2], v4.shape[3]
    # written contiguous in the (B, S, H, width) layout
    dq = torch.empty(q4.shape, dtype=torch.float32, device=dev)
    dk = torch.empty(k4.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(v4.shape, dtype=torch.float32, device=dev)
    p = plan(B, Sq, Sk, H, Hk, D, Dv, q.dtype)
    di = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(*(
        s for t in (q4, k4, v4, o4, d4) for s in t.stride()[:3]))
    fn = build.function(
        "flash_attention_bwd", f"flash_attention_bwd_{STORAGE[q.dtype]}",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int),
           ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("flash_attention_bwd", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, Hk, D, Dv, strides,
            kv_len, int(q_offset), int(causal), 1.0 / math.sqrt(D),
            p.to_c(), stream))
    flash_attention_bwd.launches += 1
    if q.dim() == 3:   # views in the (BH, S, D) layout
        return tuple(t[0].transpose(0, 1) for t in (dq, dk, dv))
    return dq, dk, dv


flash_attention_bwd.launches = 0
