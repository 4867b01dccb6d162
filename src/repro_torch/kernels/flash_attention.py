"""Flash-attention forward: CUDA kernel wrapper, launch count, plain path.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_fwd`` (a
Pallas TPU kernel).  The kernel is ``csrc/flash_attention.cu``: the online
softmax over 32-key tiles with an f32 accumulator, causal or not, keys at or
past ``kv_len`` masked, scale 1/sqrt(D), both products in 3xTF32 on the
tensor cores (``wgmma`` at D = 128 and (192, 128), ``mma.sync`` below);
its source note gives its design and its bound on the card.  It takes the Pallas layout (BH, S, D) and the model's layout
(B, S, H, D), with grouped key/value heads read in place (query head h
reads head h // G) and a ``q_offset`` for prefill into a cache.  Any
strides with D contiguous are read as they are: a KV cache slice is not
copied, but the kernel's 16-byte ``cp.async`` copies need every base
pointer and every (batch, sequence, head) stride in 16-byte units (a
stride of a dimension of size 1 is never stepped and is not checked).  On
CPU tensors the wrapper computes the plain version
(``ref.flash_attention_ref``); on CUDA tensors it launches the kernel or
raises — it never falls back.  q, k and v are all f32 or all bf16 (the
``mixed_precision`` forward's), read in place either way; the output
comes in their dtype, the arithmetic is f32 (a bf16 call gives the f32
kernel's bits on the inputs widened to f32, the output then rounded to
bf16).  The widths (D of q and k, Dv of v and the output) are one of
``WIDTHS``: D = Dv in {16, 32, 64, 80, 128} (80: HuBERT-XLarge's 1280 / 16),
or (192, 128), MLA's (DeepSeek-V2: q·k over 128 + 64 rope dims, v at 128;
the scale is 1/sqrt(D)).
``return_lse`` adds each row's log-sum-exp (f32), which the backward
(``flash_attention_bwd``) recomputes the probabilities from.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 80, 128)   # D = Dv
WIDTHS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)   # (D, Dv)
ALIGN = 16    # bytes: the kernel's cp.async copies (4 f32 or 8 bf16 values)
STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16"}  # C entry suffixes


def _as_4d(t: torch.Tensor) -> torch.Tensor:
    """(BH, S, D) -> the (1, S, BH, D) view; (B, S, H, D) as it is."""
    return t.transpose(0, 1).unsqueeze(0) if t.dim() == 3 else t


def _check(q, k, v, kv_len, q_offset) -> None:
    if any(t.device.type != "cuda" or t.device != q.device
           for t in (q, k, v)):
        raise ValueError(
            "flash_attention: the CUDA kernel takes CUDA tensors on one "
            f"device, got {[str(t.device) for t in (q, k, v)]}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in STORAGE):
        raise TypeError("flash_attention: the kernel takes q, k, v all "
                        f"float32 or all bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.dim() == k.dim() == v.dim() and q.dim() in (3, 4)):
        raise ValueError("flash_attention: q, k, v must all be (BH, S, D) "
                         "or all (B, S, H, D)")
    q4, k4, v4 = _as_4d(q), _as_4d(k), _as_4d(v)
    B, Sq, H, D = q4.shape
    Sk, Hk = k4.shape[1], k4.shape[2]
    if k4.shape[:3] != v4.shape[:3] or k4.shape[0] != B \
            or k4.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if (D, v4.shape[3]) not in WIDTHS:
        raise ValueError(f"flash_attention: the kernel takes (D, Dv) in "
                         f"{WIDTHS}, got {(D, v4.shape[3])}")
    if H % Hk:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {Hk} key/value heads")
    if not 1 <= kv_len <= Sk or q_offset < 0:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside "
                         f"[1, {Sk}] or q_offset {q_offset} < 0")
    if any(t.stride(3) != 1 for t in (q4, k4, v4)):
        raise ValueError("flash_attention: the head dimension D must be "
                         "contiguous")
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        if t.data_ptr() % ALIGN or any(
                st * t.element_size() % ALIGN
                for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(
                f"flash_attention: {name} must start on a {ALIGN}-byte "
                f"boundary with (batch, seq, head) strides in {ALIGN}-byte "
                f"units, got address {t.data_ptr()} and strides "
                f"{t.stride()[:3]}")
    if max(B, H) > 65535 or max(Sq, Sk) >= 2 ** 31:
        raise ValueError("flash_attention: sizes out of range")


def flash_attention(
    q: torch.Tensor,   # (BH, Sq, D) or (B, Sq, H, D)
    k: torch.Tensor,   # (BH/G, Sk, D) or (B, Sk, H/G, D)
    v: torch.Tensor,   # like k, of width Dv
    *,
    causal: bool = True,
    kv_len: int | None = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Softmax attention with an online softmax -> q's shape with v's
    width, in q's dtype.

    ``return_lse``: also return each row's log-sum-exp of the scaled
    logits, f32, (B, H, Sq) — (BH, Sq) in the 3-D layout — for the
    backward; without it the kernel is given no lse pointer.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, kv_len=kv_len,
                                   q_offset=q_offset, return_lse=return_lse)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len, q_offset)
    out = torch.empty((*q.shape[:-1], v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    lse = None
    q4, k4, v4, o4 = _as_4d(q), _as_4d(k), _as_4d(v), _as_4d(out)
    B, Sq, H, D = q4.shape
    Dv = v4.shape[3]
    Sk, Hk = k4.shape[1], k4.shape[2]
    if return_lse:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q4, k4, v4, o4) for s in t.stride()[:3]))
    fn = build.function(
        "flash_attention", f"flash_attention_{STORAGE[q.dtype]}",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check("flash_attention", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, Hk, D, Dv, strides, kv_len, int(q_offset),
            int(causal), 1.0 / math.sqrt(D),
            None if lse is None else lse.data_ptr(), stream))
    flash_attention.launches += 1
    if not return_lse:
        return out
    return out, (lse[0] if q.dim() == 3 else lse)


flash_attention.launches = 0
