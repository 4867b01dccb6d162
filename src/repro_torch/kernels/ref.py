"""Plain PyTorch versions of every ported kernel (the oracles).

Counterpart of ``repro.kernels.ref``.  The kernel wrappers take these only
for tensors that lie on the CPU; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  ``pred`` is summed as Σ_r pexc[0]·c[0], the
order of ``repro.kernels.ref`` and ``repro.core.kruskal`` (the Pallas
kernels take the prefix chain ((c0·c1)·c2)… instead, so the two reference
backends differ in the last bits; every comparison states its tolerance).

bf16 storage: rows and factors may come in as bf16.  They are upcast to f32
before any product, so every dot, residual and gradient is f32, as the
reference's ``preferred_element_type=float32`` keeps them (``torch.bmm`` of
two bf16 tensors would round its result to bf16).
"""
from __future__ import annotations

import math

import torch

import numpy as np

from repro_torch.core.kruskal import exclusive_products
from repro_torch.core.kruskal import mode_product_rows as mode_product_rows_ref

# layout of the (5,) scalar vector of kruskal_grad; PRED_COEF generalizes
# the residual to err = (pred_coef·pred − val)·mask — 1 for training, 0 for
# the autograd backward, which passes val = −ḡ so err = ḡ exactly
(SCAL_INV_ROW, SCAL_INV_CORE, SCAL_LAM_A, SCAL_LAM_B,
 SCAL_PRED_COEF) = range(5)
NUM_SCALARS = 5


def kruskal_contract_ref(
    a_rows: torch.Tensor,  # (N, B, J)  gathered factor rows (J zero-padded)
    b_fac: torch.Tensor,   # (N, J, R)  Kruskal core factors (zero-padded)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Theorem-1 contraction: pred (B,), exclusive products (N, B, R), f32."""
    c = torch.bmm(a_rows.float(), b_fac.float())
    full, pexc = exclusive_products(c)
    return full.sum(dim=-1), pexc


def kruskal_grad_ref(
    a_rows: torch.Tensor,  # (N, B, J)  gathered factor rows (J zero-padded)
    b_fac: torch.Tensor,   # (N, J, R)  Kruskal core factors (zero-padded)
    val: torch.Tensor,     # (B,)
    mask: torch.Tensor,    # (B,)  1.0 valid / 0.0 padding
    scal: torch.Tensor,    # (5,)  [1/ρ_row, 1/δ_core, λ_a, λ_b, pred_coef]
    c: torch.Tensor | None = None,  # (N, B, R) cached mode products
    *,
    row_modes: tuple[int, ...] | None = None,  # None = all; () = none
    want_core: bool = True,
    emit_c: bool = False,
) -> tuple:
    """Fused forward + Eq. 13/17 gradients, every phase flag.

    Returns ``(pred (B,), err (B,), row_grads (len(row_modes), B, J),
    core_grads (N, J, R), c (N, B, R))``; absent stages are ``None``:
    ``c=`` replaces the mode dots with cached products, ``row_modes``
    selects which modes' Eq.-13 gradients to emit, ``want_core`` gates
    Eq. 17 and ``emit_c`` returns the (possibly recomputed) products.
    """
    N = a_rows.shape[0]
    a_rows, b_fac = a_rows.float(), b_fac.float()
    if c is None:
        c = torch.bmm(a_rows, b_fac)
    full, pexc = exclusive_products(c)
    pred = full.sum(dim=-1)
    inv_row, inv_core, lam_a, lam_b, pred_coef = (scal[i] for i in range(5))
    err = (pred_coef * pred - val) * mask
    w_row = err * inv_row
    w_core = err * inv_core
    if row_modes is None:
        row_modes = tuple(range(N))
    row_grads = None
    if row_modes:
        sel = list(row_modes)
        row_grads = (
            w_row[None, :, None]
            * torch.bmm(pexc[sel], b_fac[sel].transpose(1, 2))
            + (lam_a * inv_row) * mask[None, :, None] * a_rows[sel]
        )
    core_grads = None
    if want_core:
        core_grads = (
            torch.bmm(a_rows.transpose(1, 2), w_core[None, :, None] * pexc)
            + lam_b * b_fac
        )
    return pred, err, row_grads, core_grads, (c if emit_c else None)


def scatter_accum_ref(
    grads: torch.Tensor,  # (B, J) per-sample row gradients
    idx: torch.Tensor,    # (B,)  target rows
    num_rows: int,
) -> torch.Tensor:
    """Segment-sum scatter into (num_rows, J); ids < 0 or ≥ num_rows dropped.

    An ordered fold on any device: every row gets ((0 + g_b0) + g_b1) + …
    over its hits in ascending batch position — what
    ``jax.ops.segment_sum`` computes, and bitwise equal to it.  A stable
    sort of the ids puts each row's hits side by side in batch order, and
    ``segment_reduce_ref``'s passes fold them; ``index_add_`` alone would
    add a row's duplicates in no fixed order on CUDA.
    """
    sorted_idx, perm = torch.sort(idx, stable=True)
    return segment_reduce_ref(grads.index_select(0, perm), sorted_idx,
                              num_rows)


def segment_reduce_ref(
    grads: torch.Tensor,  # (B, J) row grads permuted to mode-sorted order
    idx: torch.Tensor,    # (B,)  SORTED target rows (duplicates adjacent)
    num_rows: int,
) -> torch.Tensor:
    """Sorted segment-sum into (num_rows, J); ids < 0 or ≥ num_rows dropped.

    An ordered fold: every row gets ((0 + g_0) + g_1) + … over its run, in
    sorted position order, on any device — what ``jax.ops.segment_sum``
    computes, and bitwise equal to it.  On the CPU one ``index_add_`` is
    that fold: it adds the source rows one position at a time, in
    ascending position.  On CUDA it would add the duplicates of a row in no
    fixed order, so there the k-th element of every run is added in pass
    k, where the rows of one pass are distinct; the number of passes (the
    longest run) is read on the host.
    """
    out = torch.zeros((num_rows + 1, grads.shape[1]), dtype=grads.dtype,
                      device=grads.device)
    keep = (idx >= 0) & (idx < num_rows)
    target = torch.where(keep, idx.long(), num_rows)  # spare row: dropped
    if grads.device.type == "cpu":
        return out.index_add_(0, target, grads)[:num_rows]
    return fold_in_passes(out, grads, idx, target)[:num_rows]


def fold_in_passes(out: torch.Tensor, grads: torch.Tensor, idx: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """``segment_reduce_ref``'s fold on CUDA: ``out`` += grads at
    ``target``, the k-th entry of every run of equal sorted ``idx`` added
    in pass k (one ``index_add_`` over distinct rows a pass)."""
    B = idx.shape[0]
    pos = torch.arange(B, device=idx.device)
    head = torch.ones((B,), dtype=torch.bool, device=idx.device)
    head[1:] = idx[1:] != idx[:-1]
    run_start = torch.cummax(torch.where(head, pos, 0), 0).values
    offset = pos - run_start                    # place inside its run
    order = torch.sort(offset, stable=True).indices
    counts = torch.bincount(offset).tolist()
    for sel in torch.split(order, counts):
        out.index_add_(0, target[sel], grads[sel])
    return out


def patch_table_rows_ref(
    table: torch.Tensor,    # (I, R) the live table, never written
    colsum: torch.Tensor,   # (R,) f32 its column sums, never written
    mirror: torch.Tensor,   # (I, J) factor rows: the dirty ones rewritten
    core: torch.Tensor,     # (J, R) the mode's Kruskal core factor
    ids: np.ndarray,        # (K,) int32 unique row ids, on the host
    rows: torch.Tensor,     # (K, J) the new factor rows, mirror's dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """The serving table's row patch: (new table, new colsum).

    The dirty rows of C = A B recomputed by ``mode_product_rows_ref`` (so
    a patched row is bitwise the rebuilt one) into a copy of ``table``,
    the colsum moved by the sum of new − old over the dirty rows, and the
    new rows written into ``mirror`` in place.
    """
    idx = torch.tensor(ids, dtype=torch.int64, device=mirror.device)
    old32 = mode_product_rows_ref(mirror.index_select(0, idx), core)
    new32 = mode_product_rows_ref(rows, core)
    colsum = colsum + (new32 - old32).sum(0)
    table = table.clone()
    table.index_copy_(0, idx, new32.to(table.dtype))
    mirror.index_copy_(0, idx, rows)
    return table, colsum


def tucker_matmul_ref(
    x: torch.Tensor,   # (M, K)
    u1: torch.Tensor,  # (K, R1)
    g: torch.Tensor,   # (R1, R2)
    u2: torch.Tensor,  # (N, R2)
) -> torch.Tensor:
    """y = ((x U1) G) U2ᵀ — Tucker-2 factorized linear layer.

    Every product runs in f32 and the result is cast to the promoted dtype
    of the four inputs, as the kernel (and the Pallas kernel, whose
    intermediates live in f32 scratch) computes it.  When that dtype is f32
    — the LM's mix of bf16 or f32 activations with f32 factors — this is
    the reference's ``((x @ u1) @ g) @ u2.T`` under JAX's promotion.
    """
    out = torch.promote_types(torch.promote_types(x.dtype, u1.dtype),
                              torch.promote_types(g.dtype, u2.dtype))
    y = ((x.float() @ u1.float()) @ g.float()) @ u2.float().T
    return y.to(out)


def _attention_logits(q, k, causal, kv_len, q_offset):
    """(B, Hk, G, Sq, Sk) scaled logits of (B, Sq, H, D) q against
    (B, Sk, Hk, D) k, and the mask of the keys each query sees."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hk, H // Hk, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = (k_pos < (Sk if kv_len is None else kv_len))[None, :]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    return logits, mask


def flash_attention_ref(
    q: torch.Tensor,   # (BH, Sq, D) or (B, Sq, H, D)
    k: torch.Tensor,   # (BH/G, Sk, D) or (B, Sk, H/G, D)
    v: torch.Tensor,   # like k, of width Dv (the output's)
    causal: bool = True,
    *,
    kv_len: int | None = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Dense-softmax oracle of the flash-attention kernel.

    The reference's ``flash_attention_ref`` (logits / sqrt(D), masked to
    −1e30, softmax in f32) with the kernel's arithmetic: bf16 inputs are
    widened to f32 and the output is rounded to their dtype at the end;
    and with the kernel's two extensions: query head h reads key/value head h // G
    (G = H / H_kv, no copies), query i sits at position ``q_offset + i``,
    and keys at or past ``kv_len`` (default Sk) are masked.  3-D inputs
    are the Pallas layout (batch·heads flattened), the case B = 1.
    ``return_lse`` also returns each row's log-sum-exp of the scaled
    logits, f32, (B, H, Sq) — (BH, Sq) in the 3-D layout — as the kernel
    writes it for the backward.
    """
    if q.dim() == 3:
        res = flash_attention_ref(
            *(t.transpose(0, 1).unsqueeze(0) for t in (q, k, v)), causal,
            kv_len=kv_len, q_offset=q_offset, return_lse=return_lse)
        if return_lse:
            return res[0][0].transpose(0, 1), res[1][0]
        return res[0].transpose(0, 1)
    B, Sq, H, D = q.shape
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    logits, mask = _attention_logits(q, k, causal, kv_len, q_offset)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    out = out.reshape(B, Sq, H, v.shape[-1]).to(dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_ref(
    q: torch.Tensor,     # (BH, Sq, D) or (B, Sq, H, D)
    k: torch.Tensor,     # (BH/G, Sk, D) or (B, Sk, H/G, D)
    v: torch.Tensor,     # like k
    o: torch.Tensor,     # like q: the forward's output
    lse: torch.Tensor,   # (BH, Sq) or (B, H, Sq): the forward's
    dout: torch.Tensor,  # like q
    causal: bool = True,
    *,
    kv_len: int | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense recompute oracle of the flash-attention backward, in f32.

    What the reference's ``_flash_bwd`` computes, with P recomputed from
    the saved log-sum-exp: P = exp(scale·q·kᵀ − lse) (0 where masked),
    Di = Σ dO·o, dV = Pᵀ·dO, dS = P ∘ (dO·vᵀ − Di), dQ = scale·dS·k and
    dK = scale·dSᵀ·q, each key/value head summing its G query heads.
    Returns (dq, dk, dv) in q's and k's shapes, f32.
    """
    if q.dim() == 3:
        dq, dk, dv = flash_attention_bwd_ref(
            *(t.transpose(0, 1).unsqueeze(0) for t in (q, k, v, o)),
            lse.unsqueeze(0), dout.transpose(0, 1).unsqueeze(0), causal,
            kv_len=kv_len, q_offset=q_offset)
        return tuple(t[0].transpose(0, 1) for t in (dq, dk, dv))
    q, k, v, o, lse, dout = (t.float() for t in (q, k, v, o, lse, dout))
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    scale = 1.0 / math.sqrt(D)
    logits, mask = _attention_logits(q, k, causal, kv_len, q_offset)
    p = torch.where(mask, torch.exp(
        logits - lse.reshape(B, Hk, G, Sq)[..., None]), 0.0)
    dog = dout.reshape(B, Sq, Hk, G, -1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v)
    di = (dout * o).sum(-1).reshape(B, Sq, Hk, G).permute(0, 2, 3, 1)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k).reshape(B, Sq, H, D) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.reshape(B, Sq, Hk, G, D)) * scale
    return dq, dk, dv
