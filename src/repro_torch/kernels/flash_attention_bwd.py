"""Flash-attention backward: CUDA kernel wrapper, launch count, plain path.

Counterpart of ``src/repro/models/flash.py::_flash_bwd``, the reference's
FA2 recompute backward (a jnp custom VJP; the reference has no Pallas
kernel for it).  The kernel is ``csrc/flash_attention_bwd.cu``: dQ, dK and
dV from q, k, v, the forward's output o and log-sum-exp lse, and dO, with
the probabilities recomputed tile by tile from lse; each output element is
written once by one block (no atomics), so two calls give the same bits.
Same layouts, masks and head grouping as the forward (``flash_attention``):
q, o, dO (B, Sq, H, D) or (BH, Sq, D), k and v with H/G heads, lse (B, H,
Sq) or (BH, Sq).  Any strides with D contiguous are read as they are;
dq, dk and dv are new tensors, contiguous in the (B, S, H, D) layout.
The kernel's 16-byte ``cp.async`` copies need q, k, v, o and dO on
16-byte boundaries with (batch, sequence, head) strides in 16-byte units;
``plan()`` lays out its three launches, and the C entry refuses a plan it
was not built for.  On CPU tensors the wrapper computes the plain version
(``ref.flash_attention_bwd_ref``); on CUDA tensors it launches the kernel
or raises — it never falls back.  f32 only; D in {16, 32, 64, 128}
(q, k and v of one width: MLA's (192, 128), which the forward takes, is
refused by name until its backward is ported).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import build
from .flash_attention import ALIGN, HEAD_DIMS, WIDTHS, _as_4d
from .ref import flash_attention_bwd_ref

WARPS = 8             # a block of both passes: 16 rows a warp
KV_TILE = (128, 32)   # dK/dV pass: keys a block, queries a ring tile
Q_TILE = (128, 32)    # dQ pass: queries a block, keys a ring tile
PASSES = 3            # 3xTF32: tensor-core passes per f32 product
PRODUCTS = ("S", "dP", "dV", "dK", "dQ")
DOT_THREADS = 256     # the Di kernel: one warp a row


@dataclasses.dataclass(frozen=True)
class Plan:
    """The three launches of one call, as the wrapper hands them to the C
    entry, which refuses any value it was not built with.

    ``kv_tile``: keys of a dK/dV block (16 a warp) and queries of each
    tile its ring brings; ``q_tile``: queries of a dQ block and keys of
    each ring tile.  ``smem``: dynamic shared bytes of the dK/dV and the
    dQ kernel (resident tiles of 128 rows, two ring stages and the small
    parts of the landed one).  ``grids``: (x, y, z) of the Di, dK/dV and dQ
    launches; the dK/dV block x is (key tile x // (Hk B), KV head x % Hk,
    batch x // Hk % B) and the dQ block (the last query tile first) is
    likewise over (query tile, head, batch), so the blocks with the most
    causal work are issued first.  ``passes``: tensor-core passes of each
    of ``PRODUCTS``.
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


def _smem_bytes(D: int, rows: int, tile: int) -> int:
    res = D + 4 if D == 16 else D    # resident rows (chunk-permuted)
    ring = D + 4                     # ring rows, read along both axes
    return 4 * (2 * rows * res + 3 * 2 * tile * ring)


def plan(B: int, Sq: int, Sk: int, H: int, Hk: int, D: int) -> Plan:
    """The launch plan of ``flash_attention_bwd`` for these sizes."""
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: the kernel takes D in "
                         f"{HEAD_DIMS}, got {D}")
    smem = (_smem_bytes(D, *KV_TILE), _smem_bytes(D, *Q_TILE))
    return Plan(
        warps=WARPS, kv_tile=KV_TILE, q_tile=Q_TILE, smem=smem,
        grids=((_cdiv(B * H * Sq * 32, DOT_THREADS), 1, 1),
               (_cdiv(Sk, KV_TILE[0]) * Hk * B, 1, 1),
               (_cdiv(Sq, Q_TILE[0]) * H * B, 1, 1)),
        passes=(PASSES,) * len(PRODUCTS), workspace=4 * B * H * Sq)


def _check(q, k, v, o, lse, dout, kv_len, q_offset) -> None:
    ts = (q, k, v, o, lse, dout)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError(
            "flash_attention_bwd: the CUDA kernel takes CUDA tensors on one "
            f"device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("flash_attention_bwd: the kernel takes float32 "
                        f"tensors, got {[t.dtype for t in ts]}")
    if not (q.dim() == k.dim() == v.dim() and q.dim() in (3, 4)):
        raise ValueError("flash_attention_bwd: q, k, v must all be "
                         "(BH, S, D) or all (B, S, H, D)")
    q4, k4 = _as_4d(q), _as_4d(k)
    B, Sq, H, D = q4.shape
    Sk, Hk = k4.shape[1], k4.shape[2]
    if v.shape[-1] != D and (D, v.shape[-1]) in WIDTHS:
        raise NotImplementedError(
            f"flash_attention_bwd: (D, Dv) = {(D, v.shape[-1])} (MLA's "
            "widths) is not ported yet; the forward takes it (see "
            "ROADMAP.md, Queue 1)")
    if v.shape != k.shape or k4.shape[0] != B or k4.shape[3] != D:
        raise ValueError(f"flash_attention_bwd: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and dO "
                         f"{tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    want = (B, H, Sq) if q.dim() == 4 else (H, Sq)
    if tuple(lse.shape) != want or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"{want}, got {tuple(lse.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: the kernel takes D in "
                         f"{HEAD_DIMS}, got {D}")
    if H % Hk:
        raise ValueError(f"flash_attention_bwd: {H} query heads are not a "
                         f"multiple of {Hk} key/value heads")
    if not 1 <= kv_len <= Sk or q_offset < 0:
        raise ValueError(f"flash_attention_bwd: kv_len {kv_len} outside "
                         f"[1, {Sk}] or q_offset {q_offset} < 0")
    if any(_as_4d(t).stride(3) != 1 for t in (q, k, v, o, dout)):
        raise ValueError("flash_attention_bwd: the head dimension D must "
                         "be contiguous")
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
    v: torch.Tensor,     # like k
    o: torch.Tensor,     # like q
    lse: torch.Tensor,   # (BH, Sq) or (B, H, Sq)
    dout: torch.Tensor,  # like q
    *,
    causal: bool = True,
    kv_len: int | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax attention, f32, in q's and k's shapes."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, dout, causal,
                                       kv_len=kv_len, q_offset=q_offset)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    _check(q, k, v, o, lse, dout, kv_len, q_offset)
    dev = q.device
    q4, k4, v4, o4, d4 = (_as_4d(t) for t in (q, k, v, o, dout))
    B, Sq, H, D = q4.shape
    Sk, Hk = k4.shape[1], k4.shape[2]
    # written contiguous in the (B, S, H, D) layout
    dq = torch.empty(q4.shape, dtype=torch.float32, device=dev)
    dk = torch.empty(k4.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(k4.shape, dtype=torch.float32, device=dev)
    p = plan(B, Sq, Sk, H, Hk, D)
    di = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(*(
        s for t in (q4, k4, v4, o4, d4) for s in t.stride()[:3]))
    fn = build.function(
        "flash_attention_bwd", "flash_attention_bwd_f32",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int),
           ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("flash_attention_bwd", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, Hk, D, strides,
            kv_len, int(q_offset), int(causal), 1.0 / math.sqrt(D),
            p.to_c(), stream))
    flash_attention_bwd.launches += 1
    if q.dim() == 3:   # views in the (BH, S, D) layout
        return tuple(t[0].transpose(0, 1) for t in (dq, dk, dv))
    return dq, dk, dv


flash_attention_bwd.launches = 0
