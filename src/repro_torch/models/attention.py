"""Grouped-query attention (qk-norm / qkv-bias options) with a KV cache.

Counterpart of the GQA half of ``repro.models.attention``; MLA is not
ported yet (ROADMAP.md).  ``chunked_attention`` keeps the reference's
three branches and its branch condition:

* ``Sq·Sk ≤ q_chunk·kv_chunk``: one dense masked softmax, plain PyTorch
  (plain jnp in the reference, not a kernel).  Every decode step lands
  here.
* otherwise the online-softmax region — the reference's custom-VJP flash
  attention (no cache, ``q_offset`` 0) and its ``lax.scan`` over KV chunks
  (a cache, or a traced ``q_offset``) — goes to one kernel,
  ``models.flash.flash_attention``, with ``q_offset`` and
  ``kv_len = kv_valid_len``.  The port's cache index is a Python int, so
  the reference's test "is ``q_offset`` a traced array" becomes "is there
  a ``kv_valid_len``": prefill from index 0 into a cache still masks the
  keys past ``idx + S``.

The KV cache is updated in place (the reference's ``dynamic_update_slice``
returns a new array): at Qwen3-14B's width a functional copy would move
the whole 2.7 GB f32 cache every step.  ``gqa_attention`` returns the same
dict it was given.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import flash
from .layers import RMSNorm, apply_rope, const_param, dense_param, promote, \
    rmsnorm

NEG_INF = -1e30


def _attend_dense(q, k, v, mask, scale):
    """Reference einsum attention. q:(B,Sq,K,G,D) k/v:(B,Sk,K,D)."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)


def chunked_attention(
    q: torch.Tensor,        # (B, Sq, H, D)
    k: torch.Tensor,        # (B, Sk, Kv, D)
    v: torch.Tensor,        # (B, Sk, Kv, D)
    *,
    causal: bool,
    q_offset: int = 0,                  # absolute position of q[0]
    kv_valid_len: int | None = None,    # mask the cache tail
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    backend: str | None = None,
) -> torch.Tensor:
    """Softmax attention; never materializes (Sq, Sk) above one block."""
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    B, Sq, H, D = q.shape
    Dv = v.shape[-1]
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv

    if Sq * Sk <= q_chunk * kv_chunk:  # small: one dense block
        scale = 1.0 / math.sqrt(D)
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Sk, device=q.device)
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if kv_valid_len is not None:
            mask &= k_pos[None, :] < kv_valid_len
        out = _attend_dense(q.reshape(B, Sq, Kv, G, D), k, v, mask, scale)
        return out.reshape(B, Sq, H, Dv)

    # the online-softmax region: the reference's flash and scan branches
    return flash.flash_attention(q, k, v, causal, q_offset=q_offset,
                                 kv_len=kv_valid_len, backend=backend)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, H, Kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
        self.wq = dense_param((d, H, hd), generator, device,
                              ("embed", "heads", "head_dim"))
        self.wk = dense_param((d, Kv, hd), generator, device,
                              ("embed", "kv_heads", "head_dim"))
        self.wv = dense_param((d, Kv, hd), generator, device,
                              ("embed", "kv_heads", "head_dim"))
        self.wo = dense_param((H, hd, d), generator, device,
                              ("heads", "head_dim", "embed"))
        if cfg.qkv_bias:
            self.bq = const_param((H, hd), 0.0, device, ("heads", "head_dim"))
            self.bk = const_param((Kv, hd), 0.0, device,
                                  ("kv_heads", "head_dim"))
            self.bv = const_param((Kv, hd), 0.0, device,
                                  ("kv_heads", "head_dim"))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device, "head_dim")
            self.k_norm = RMSNorm(hd, device, "head_dim")


def init_gqa(cfg, generator: torch.Generator, device=None) -> GQA:
    return GQA(cfg, generator, device)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) under JAX's promotion."""
    B, S, d = x.shape
    x, w = promote(x, w)
    return (x.reshape(B * S, d) @ w.reshape(d, -1)).reshape(
        B, S, *w.shape[1:])


def gqa_attention(
    params: GQA,
    cfg,
    x: torch.Tensor,                 # (B, S, d)
    positions: torch.Tensor,         # (S,) absolute positions
    *,
    causal: bool = True,
    cache: dict | None = None,
    cache_index: int | None = None,
    backend: str | None = None,
) -> tuple[torch.Tensor, dict | None]:
    B, S, _ = x.shape
    q = _project(x, params.wq)
    k = _project(x, params.wk)
    v = _project(x, params.wv)
    if cfg.qkv_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    if cfg.qk_norm:
        q = rmsnorm(params.q_norm, q)
        k = rmsnorm(params.k_norm, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        # the reference's repeat_kv (a sharding layout: the same math) has
        # no counterpart: the kernel reads the grouped KV heads in place
        out = chunked_attention(q, k, v, causal=causal, backend=backend)
        new_cache = None
    else:
        idx = int(cache_index)
        if not 0 <= idx <= cache["k"].shape[1] - S:
            raise ValueError(f"cache index {idx} + {S} new positions do not "
                             f"fit a cache of {cache['k'].shape[1]}")
        cache["k"][:, idx:idx + S] = k.to(cache["k"].dtype)
        cache["v"][:, idx:idx + S] = v.to(cache["v"].dtype)
        # causal with q_offset handles both decode (S=1) and prefill (S>1)
        out = chunked_attention(
            q, cache["k"], cache["v"], causal=causal, q_offset=idx,
            kv_valid_len=idx + S, backend=backend)
        new_cache = cache
    H, hd, d = params.wo.shape
    out, wo = promote(out, params.wo)
    y = (out.reshape(B * S, H * hd) @ wo.reshape(H * hd, d)).reshape(B, S, d)
    return y, new_cache


def init_gqa_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
