"""Kruskal-core Theorem-1 contractions, counterpart of ``repro.core.kruskal``.

All functions take ``core_factors`` as a tuple of ``(J_n, R)`` tensors and
per-sample gathered factor rows as a tuple of ``(B, J_n)`` tensors (modes
may have different J_n; the kernels use a padded stacked layout instead).
Rows and factors stored in bf16 are upcast to f32 before each product, so
the products are f32, as the reference's ``preferred_element_type`` keeps
them.
"""
from __future__ import annotations

from typing import Sequence

import torch


def mode_dots(
    rows: Sequence[torch.Tensor], core_factors: Sequence[torch.Tensor]
) -> torch.Tensor:
    """c_r^(n) = ⟨a_{i_n}, b_{:,r}^(n)⟩ for a batch.  -> (N, B, R), f32."""
    return torch.stack(
        [torch.matmul(r.float(), b.float())
         for r, b in zip(rows, core_factors)], dim=0)


def exclusive_products(
    c: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Given c: (N, B, R), return (full_prod (B,R), excl (N,B,R)).

    excl[n] = Π_{k≠n} c[k], computed division-free with prefix/suffix
    products (stable when some c ≈ 0); full = excl[0]·c[0], the
    reference's multiplication order.
    """
    ones = torch.ones_like(c[0])
    # prefix[n] = Π_{k<n} c[k]; suffix[n] = Π_{k>n} c[k]
    prefix = torch.cat([ones[None], torch.cumprod(c[:-1], dim=0)], dim=0)
    suffix = torch.cat(
        [torch.cumprod(c.flip(0)[:-1], dim=0).flip(0), ones[None]], dim=0)
    excl = prefix * suffix
    full = excl[0] * c[0]
    return full, excl


def predict_from_rows(
    rows: Sequence[torch.Tensor], core_factors: Sequence[torch.Tensor]
) -> torch.Tensor:
    """x̂ = Σ_r Π_n c_r^(n)   (Theorem-1 factored prediction).  -> (B,)"""
    full, _ = exclusive_products(mode_dots(rows, core_factors))
    return full.sum(dim=-1)


def mode_products(
    factors: Sequence[torch.Tensor], core_factors: Sequence[torch.Tensor]
) -> tuple[torch.Tensor, ...]:
    """C^(n) = A^(n) B^(n) ∈ R^{I_n × R} — all mode dots, precomputed, f32."""
    return tuple(torch.matmul(a.float(), b.float())
                 for a, b in zip(factors, core_factors))
