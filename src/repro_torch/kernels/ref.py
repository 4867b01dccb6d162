"""Plain PyTorch versions of every ported kernel (the oracles).

Counterpart of ``repro.kernels.ref``.  The kernel wrappers take these only
for tensors that lie on the CPU; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  ``pred`` is summed as Σ_r pexc[0]·c[0], the
order of ``repro.kernels.ref`` and ``repro.core.kruskal`` (the Pallas
kernels take the prefix chain ((c0·c1)·c2)… instead, so the two reference
backends differ in the last bits; every comparison states its tolerance).
"""
from __future__ import annotations

import torch

from repro_torch.core.kruskal import exclusive_products

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
    """Theorem-1 contraction: pred (B,), exclusive products (N, B, R)."""
    c = torch.bmm(a_rows, b_fac)
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

    ``index_add_`` rejects such ids rather than dropping them (as
    ``jax.ops.segment_sum`` does), so they are sent to a spare row that is
    cut off afterwards.
    """
    keep = (idx >= 0) & (idx < num_rows)
    target = torch.where(keep, idx.long(), num_rows)
    out = torch.zeros((num_rows + 1, grads.shape[1]), dtype=grads.dtype,
                      device=grads.device)
    out.index_add_(0, target, grads)
    return out[:num_rows]
