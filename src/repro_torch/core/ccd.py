"""Vest-style CCD baseline: column-wise coordinate descent for STD.

Counterpart of ``repro.core.ccd``.  Vest (Park et al.) sweeps the columns
of each factor matrix with closed-form one-dimensional updates against the
current residual:

    a_{i,j} ← ( Σ_{t∈Ω_i} r_t^{(+j)} d_{t,j} ) / ( λ + Σ_{t∈Ω_i} d_{t,j}² )

where d_{t,j} is the j-th coefficient of the core-contracted design vector
and r^{(+j)} the residual with coordinate j's contribution added back
(``1e-12`` guards the division; rows with no observation keep their
value).  Factor updates only (the paper's §6.3 protocol).

The nonzeros are taken in the stable sort of the mode's ids, as in
``als``, and each segment sum is one ordered fold through the registry's
``segment_reduce`` (1 wide): 2·J calls a mode, and an epoch repeats its
bits on the card.  The design vectors are built ``chunk`` nonzeros at a
time, which bounds the contraction's intermediates; d, the residual and
the gathered rows (nnz × (2J + 1) floats) are held whole, as the column
sweep reads them J times.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import dispatch
from .als import mode_order, ordered_fold
from .cutucker import CuTuckerParams, _contract_except
from .cutucker import predict  # noqa: F401  — the shared dense-core predict
from .fasttucker import gather_rows
from .sampling import SortedBatchOrder
from .sptensor import SparseTensor

DEFAULT_CHUNK = 1 << 22   # nonzeros per contraction pass


@dataclasses.dataclass(frozen=True)
class CCDConfig:
    dims: tuple[int, ...]
    ranks: tuple[int, ...]
    lambda_a: float = 0.01

    @property
    def order(self) -> int:
        return len(self.dims)


@torch.no_grad()
def ccd_update_mode(
    params: CuTuckerParams,
    indices: torch.Tensor,
    values: torch.Tensor,
    mode: int,
    num_rows: int,
    lambda_a: float,
    chunk: int = DEFAULT_CHUNK,
    backend: str | None = None,
    order: SortedBatchOrder | None = None,
) -> torch.Tensor:
    """One CCD sweep over all J_n columns of A^(mode)."""
    bk = dispatch.get_backend(backend)
    perm, seg = mode_order(indices, mode, order)
    d = torch.cat([
        _contract_except(params.core,
                         gather_rows(params.factors, indices.index_select(
                             0, perm[s:s + chunk])), mode)
        for s in range(0, values.shape[0], chunk)])   # (nnz, J), sorted
    A = params.factors[mode].clone()
    a_rows = A.index_select(0, seg)                     # (nnz, J)
    resid = (values.index_select(0, perm)
             - torch.sum(a_rows * d, dim=-1))           # (nnz,)
    seen = torch.bincount(seg, minlength=num_rows) > 0

    def segment_sum(x):
        out = torch.zeros((num_rows, 1), dtype=x.dtype, device=x.device)
        ordered_fold(bk, x[:, None], seg, num_rows, out)
        return out[:, 0]

    for j in range(d.shape[1]):
        dj = d[:, j]
        rj = resid + a_rows[:, j] * dj                  # add back coord j
        num = segment_sum(rj * dj)
        den = segment_sum(dj * dj)
        new_col = num / (lambda_a + den + 1e-12)
        new_col = torch.where(seen, new_col, A[:, j])
        A[:, j] = new_col
        new_aj = new_col.index_select(0, seg)
        resid = rj - new_aj * dj
        a_rows[:, j] = new_aj
    return A


def ccd_epoch(
    params: CuTuckerParams,
    tensor: SparseTensor,
    cfg: CCDConfig,
    chunk: int = DEFAULT_CHUNK,
    backend: str | None = None,
    order: SortedBatchOrder | None = None,
) -> CuTuckerParams:
    factors = list(params.factors)
    for n in range(cfg.order):
        p = CuTuckerParams(tuple(factors), params.core)
        factors[n] = ccd_update_mode(p, tensor.indices, tensor.values, n,
                                     cfg.dims[n], cfg.lambda_a, chunk,
                                     backend, order)
    return CuTuckerParams(tuple(factors), params.core)
