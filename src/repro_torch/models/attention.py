"""Attention: GQA (qk-norm / qkv-bias options) and MLA, with KV caches.

Counterpart of ``repro.models.attention``.  ``chunked_attention`` keeps
the reference's three branches and its branch condition, with v's width
Dv carried through (MLA's q·k width is 192, its v width 128):

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
the whole 2.7 GB f32 cache every step.  ``gqa_attention`` and
``mla_attention`` return the same dict they were given.  MLA's cache is the
compressed one, ``c_kv`` (B, S_max, kv_lora) and ``k_pe`` (B, S_max,
rope_dim): MLA's reason to exist.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import flash
from .layers import (RMSNorm, apply_rope, const_param, dense_param, matmul,
                     promote, rmsnorm)

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
    v: torch.Tensor,        # (B, Sk, Kv, Dv)
    *,
    causal: bool,
    q_offset: int = 0,                  # absolute position of q[0]
    kv_valid_len: int | None = None,    # mask the cache tail
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    backend: str | None = None,
) -> torch.Tensor:
    """Softmax attention → (B, Sq, H, Dv); never materializes (Sq, Sk)
    above one block."""
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
        _cache_slot(cache["k"].shape[1], idx, S)
        cache["k"][:, idx:idx + S] = k.to(cache["k"].dtype)
        cache["v"][:, idx:idx + S] = v.to(cache["v"].dtype)
        # causal with q_offset handles both decode (S=1) and prefill (S>1)
        out = chunked_attention(
            q, cache["k"], cache["v"], causal=causal, q_offset=idx,
            kv_valid_len=idx + S, backend=backend)
        new_cache = cache
    return _out_project(out, params.wo), new_cache


def _out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, wo) under JAX's promotion."""
    B, S = out.shape[:2]
    H, hd, d = wo.shape
    out, wo = promote(out, wo)
    return (out.reshape(B * S, H * hd) @ wo.reshape(H * hd, d)).reshape(
        B, S, d)


def _cache_slot(cache_len: int, idx: int, S: int) -> None:
    if not 0 <= idx <= cache_len - S:
        raise ValueError(f"cache index {idx} + {S} new positions do not "
                         f"fit a cache of {cache_len}")


def init_gqa_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        dv, L = cfg.v_head_dim, cfg.kv_lora_rank
        self.wq = dense_param((d, H, dn + dr), generator, device,
                              ("embed", "heads", "head_dim"))
        self.w_dkv = dense_param((d, L), generator, device,
                                 ("embed", "kv_lora"))
        self.kv_norm = RMSNorm(L, device)   # the reference's init_rmsnorm
        self.w_uk = dense_param((L, H, dn), generator, device,
                                ("kv_lora", "heads", "head_dim"))
        self.w_uv = dense_param((L, H, dv), generator, device,
                                ("kv_lora", "heads", "head_dim"))
        self.w_kpe = dense_param((d, dr), generator, device,
                                 ("embed", "head_dim"))
        self.wo = dense_param((H, dv, d), generator, device,
                              ("heads", "head_dim", "embed"))


def init_mla(cfg, generator: torch.Generator, device=None) -> MLA:
    return MLA(cfg, generator, device)


def mla_attention(
    params: MLA,
    cfg,
    x: torch.Tensor,                 # (B, S, d)
    positions: torch.Tensor,         # (S,) absolute positions
    *,
    causal: bool = True,
    cache: dict | None = None,
    cache_index: int | None = None,
    backend: str | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """MLA with the compressed cache.  Two routes, as in the reference:

    * decompress (the default, and every call without a cache): k =
      [c_kv·W_uk, k_pe] (dn + dr wide, k_pe shared by the heads) and v =
      c_kv·W_uv (dv wide) over the whole cache, through
      ``chunked_attention``: prefill lands in the flash kernel at
      (D, Dv) = (dn + dr, dv), decode in the dense block;
    * absorbed decode, plain einsums, when ``cfg.mla_absorb`` and S ≤ 16:
      scores = (q_nope·W_uk)·c_kvᵀ + q_pe·k_peᵀ and out = (P·c_kv)·W_uv,
      so the cache is never decompressed.  The reference reads
      ``getattr(cfg, "mla_absorb", True)``, and the field defaults to
      False, so its default decode decompresses too.

    Training differentiates the decompress route: k_pe is expanded over
    the heads, so its gradient is autograd's sum over them, and the flash
    region's backward is ``flash_attention_bwd`` at (dn + dr, dv).
    """
    B, S, _ = x.shape
    H = params.wq.shape[1]       # a sharded worker's heads, as in _out_project
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim

    q = _project(x, params.wq)                               # (B,S,H,dn+dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    c_kv = rmsnorm(params.kv_norm, matmul(x, params.w_dkv))  # (B,S,L)
    k_pe = apply_rope(matmul(x, params.w_kpe)[:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0]               # (B,S,dr)

    if cache is not None:
        idx = int(cache_index)
        _cache_slot(cache["c_kv"].shape[1], idx, S)
        cache["c_kv"][:, idx:idx + S] = c_kv.to(cache["c_kv"].dtype)
        cache["k_pe"][:, idx:idx + S] = k_pe.to(cache["k_pe"].dtype)
        c_kv_full, k_pe_full = cache["c_kv"], cache["k_pe"]
        valid, q_offset = idx + S, idx
        if cfg.mla_absorb and S <= 16:
            return _absorbed(params, cfg, x, q_nope, q_pe, c_kv_full,
                             k_pe_full, idx), cache
    else:
        c_kv_full, k_pe_full = c_kv, k_pe
        valid, q_offset = None, 0

    k_nope = _project(c_kv_full, params.w_uk)                # (B,T,H,dn)
    v = _project(c_kv_full, params.w_uv)                     # (B,T,H,dv)
    k_pe_full = k_pe_full.to(k_nope.dtype)
    k_full = torch.cat([k_nope, k_pe_full[:, :, None, :].expand(
        *k_pe_full.shape[:2], H, dr)], dim=-1)
    del k_nope
    out = chunked_attention(
        torch.cat([q_nope, q_pe], dim=-1), k_full, v, causal=causal,
        q_offset=q_offset, kv_valid_len=valid, backend=backend)
    return _out_project(out, params.wo), cache


def _absorbed(params: MLA, cfg, x, q_nope, q_pe, c_kv_full, k_pe_full,
              idx: int) -> torch.Tensor:
    """The absorbed decode: the compressed cache is never decompressed
    (the same multiplication-order insight as the paper's Theorem 1)."""
    S = x.shape[1]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, w_uk = promote(q_nope, params.w_uk)
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope, w_uk)
    s_nope = torch.einsum("bshl,btl->bhst", q_lat,
                          c_kv_full.to(q_lat.dtype))
    s_pe = torch.einsum("bshr,btr->bhst", q_pe, k_pe_full.to(q_pe.dtype))
    logits = (s_nope + s_pe).float() * (1.0 / math.sqrt(dn + dr))
    t_pos = torch.arange(c_kv_full.shape[1], device=x.device)
    q_pos = idx + torch.arange(S, device=x.device)
    bias = torch.where((t_pos[None, :] < idx + S)
                       & (q_pos[:, None] >= t_pos[None, :]), 0.0, NEG_INF)
    probs = torch.softmax(logits + bias, dim=-1)
    o_lat = torch.einsum("bhst,btl->bshl", probs.to(c_kv_full.dtype),
                         c_kv_full)
    out = torch.einsum("bshl,lhv->bshv", o_lat.float(), params.w_uv.float())
    return _out_project(out.to(x.dtype), params.wo)


def init_mla_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                dtype=dtype, device=device)}
