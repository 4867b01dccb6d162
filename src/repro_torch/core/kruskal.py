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


def mode_product_rows(
    rows: torch.Tensor, core_factor: torch.Tensor
) -> torch.Tensor:
    """Rows of C^(n) = A^(n) B^(n): ``rows`` (M, J) against B^(n) (J, R)
    → (M, R), f32.

    The serving tables are built and patched through this one function,
    and a patched row must equal the rebuilt one bit for bit.  A matmul
    does not give that: cuBLAS (and MKL on the CPU) choose the algorithm
    and the split of the J sum by the row count M.  Here every element is
    the same sequence of f32 operations whatever M is — a product for
    j = 0, then one multiply and one add per further j, each rounded, in
    ascending j — on the CPU and on the card alike (two kernels per j,
    never fused into an FMA).
    """
    a, b = rows.float(), core_factor.float()
    acc = a[:, 0:1] * b[0]
    for j in range(1, a.shape[1]):
        acc = acc + a[:, j:j + 1] * b[j]
    return acc


def mode_products(
    factors: Sequence[torch.Tensor], core_factors: Sequence[torch.Tensor]
) -> tuple[torch.Tensor, ...]:
    """C^(n) = A^(n) B^(n) ∈ R^{I_n × R} — all mode dots, precomputed, f32
    (``mode_product_rows`` of every row)."""
    return tuple(mode_product_rows(a, b)
                 for a, b in zip(factors, core_factors))


def kruskal_to_core(core_factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Materialize Ĝ = Σ_r b_r^(1) ∘ … ∘ b_r^(N)  (tests / tiny shapes)."""
    letters = "abcdefghijklmnop"[:len(core_factors)]
    expr = ",".join(f"{c}r" for c in letters) + "->" + letters
    return torch.einsum(expr, *(b.float() for b in core_factors))


def dense_reconstruct(
    factors: Sequence[torch.Tensor], core_factors: Sequence[torch.Tensor]
) -> torch.Tensor:
    """X̂ = Ĝ ×_1 A^(1) … ×_N A^(N) materialized, f32 (tiny tensors, tests,
    or slices: pass the rows of one mode in place of its factor).

    The oracle the factored serving path is checked against, routed
    through the materialized core ``kruskal_to_core`` (not
    ``mode_products``) so it shares no code with the serving tables.
    """
    G = kruskal_to_core(core_factors)                # (J_1, …, J_N)
    N = len(factors)
    core_l = "abcdefghijklmnop"[:N]
    out_l = "ABCDEFGHIJKLMNOP"[:N]
    expr = (core_l + ","
            + ",".join(f"{out_l[n]}{core_l[n]}" for n in range(N))
            + "->" + out_l)
    return torch.einsum(expr, G, *(f.float() for f in factors))
