"""P-Tucker-style ALS baseline: exact per-row least-squares solves.

Counterpart of ``repro.core.als``.  P-Tucker (Oh et al., ICDE'18) updates
each factor row by solving the normal equations over the nonzeros observed
in that row:

    (Σ_{j∈Ω_i} d_j d_jᵀ + λI) a_i = Σ_{j∈Ω_i} x_j d_j,
    d_j = G ×_{k≠n} a^(k)_{i_k}.

Per-nonzero ``d`` vectors (nnz, J_n) through the dense core contraction,
a segment sum of their outer products into per-row Gram matrices
(I_n, J, J), then one batched ``torch.linalg.solve``; rows with no
observation keep their value.  Factor updates only (the published
comparison fixes the core, paper §6.3).

The segment sums are ``index_add_`` (the reference's ``segment_sum`` is
no Pallas kernel): on the card it adds with float atomics, in no fixed
order, so an epoch need not repeat its bits there.  The port's
``scatter_accum`` kernel is not used: each of its blocks reads every id,
fine at a batch of 4096 and O(blocks × nnz) over a whole tensor.  The
nonzeros are taken ``chunk`` at a time, so the outer products never
exceed chunk × J² floats (5.7 GB for one pass over the Netflix tensor's
89 M training nonzeros at J = 4).
"""
from __future__ import annotations

import dataclasses

import torch

from .cutucker import CuTuckerParams, _contract_except
from .cutucker import predict  # noqa: F401  — the shared dense-core predict
from .fasttucker import gather_rows
from .sptensor import SparseTensor

DEFAULT_CHUNK = 1 << 22   # nonzeros a pass: 256 MiB of outer products at J=4


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    dims: tuple[int, ...]
    ranks: tuple[int, ...]
    lambda_a: float = 0.01

    @property
    def order(self) -> int:
        return len(self.dims)


@torch.no_grad()
def als_update_mode(
    params: CuTuckerParams,
    indices: torch.Tensor,
    values: torch.Tensor,
    mode: int,
    num_rows: int,
    lambda_a: float,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Return the updated A^(mode) (I_n, J_n)."""
    J = params.factors[mode].shape[1]
    dev = values.device
    gram = torch.zeros((num_rows, J, J), dtype=torch.float32, device=dev)
    rhs = torch.zeros((num_rows, J), dtype=torch.float32, device=dev)
    for s in range(0, values.shape[0], chunk):
        idx = indices[s:s + chunk]
        d = _contract_except(params.core, gather_rows(params.factors, idx),
                             mode)                           # (nnz, J)
        seg = idx[:, mode]
        gram.index_add_(0, seg, d[:, :, None] * d[:, None, :])
        rhs.index_add_(0, seg, values[s:s + chunk, None] * d)
    gram += lambda_a * torch.eye(J, dtype=torch.float32, device=dev)
    # rows with no observations keep their previous value
    seen = torch.bincount(indices[:, mode], minlength=num_rows) > 0
    sol = torch.linalg.solve(gram, rhs[..., None])[..., 0]
    return torch.where(seen[:, None], sol, params.factors[mode])


def als_epoch(
    params: CuTuckerParams,
    tensor: SparseTensor,
    cfg: ALSConfig,
    chunk: int = DEFAULT_CHUNK,
) -> CuTuckerParams:
    """One full alternating sweep over all modes (Gauss–Seidel)."""
    factors = list(params.factors)
    for n in range(cfg.order):
        p = CuTuckerParams(tuple(factors), params.core)
        factors[n] = als_update_mode(p, tensor.indices, tensor.values, n,
                                     cfg.dims[n], cfg.lambda_a, chunk)
    return CuTuckerParams(tuple(factors), params.core)
