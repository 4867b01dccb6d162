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

The segment sums are ordered folds, so an epoch repeats its bits on the
card too: the nonzeros are taken in the stable sort of the mode's ids
(``core.sampling.sorted_batch_order``; pass ``order=`` to reuse one sort
over several calls), ``chunk`` sorted positions at a time, and each
chunk's sum goes through the registry's ``segment_reduce`` (the kernel on
``"cuda"``, the plain ordered fold on ``"torch"``), added into the running
sum in chunk order.  The kernel takes rows up to 64 wide, so the J²-wide
Gram rows are folded in column slices of at most ``FOLD_WIDTH``: one call
a slice at J > 8.  Per mode and chunk that is ⌈J²/64⌉ + 1 calls (the +1 is
the right-hand side).  The port's ``scatter_accum`` kernel is not used:
each of its blocks reads every id, fine at a batch of 4096 and
O(blocks × nnz) over a whole tensor.  The chunks bound the outer products
at chunk × J² floats (5.7 GB for one pass over the Netflix tensor's 89 M
training nonzeros at J = 4).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import dispatch
from .cutucker import CuTuckerParams, _contract_except
from .cutucker import predict  # noqa: F401  — the shared dense-core predict
from .fasttucker import gather_rows
from .sampling import SortedBatchOrder
from .sptensor import SparseTensor

DEFAULT_CHUNK = 1 << 22   # nonzeros a pass: 256 MiB of outer products at J=4
FOLD_WIDTH = 64           # the widest row segment_reduce's kernel takes


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    dims: tuple[int, ...]
    ranks: tuple[int, ...]
    lambda_a: float = 0.01

    @property
    def order(self) -> int:
        return len(self.dims)


def mode_order(
    indices: torch.Tensor, mode: int, order: SortedBatchOrder | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, sorted int32 ids) of one mode: from ``order`` when given,
    else one stable sort of ``indices[:, mode]``."""
    if order is not None:
        return order.perm[mode], order.sorted_rows[mode]
    srows, perm = torch.sort(indices[:, mode].to(torch.int32), stable=True)
    return perm, srows


def ordered_fold(bk, x: torch.Tensor, seg: torch.Tensor, num_rows: int,
                 out: torch.Tensor) -> None:
    """``out += `` the segment sum of ``x`` (B, W) over the sorted ids
    ``seg``, each row folded in sorted order by the backend's
    ``segment_reduce``, in column slices of at most ``FOLD_WIDTH``."""
    for a in range(0, x.shape[1], FOLD_WIDTH):
        out[:, a:a + FOLD_WIDTH] += bk.segment_reduce(
            x[:, a:a + FOLD_WIDTH].contiguous(), seg, num_rows)


def normal_equations(
    params: CuTuckerParams,
    indices: torch.Tensor,
    values: torch.Tensor,
    mode: int,
    num_rows: int,
    chunk: int = DEFAULT_CHUNK,
    backend: str | None = None,
    order: SortedBatchOrder | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row Σ d dᵀ (I_n, J, J) and Σ x d (I_n, J), ordered folds."""
    bk = dispatch.get_backend(backend)
    perm, seg_all = mode_order(indices, mode, order)
    J = params.factors[mode].shape[1]
    dev = values.device
    gram = torch.zeros((num_rows, J * J), dtype=torch.float32, device=dev)
    rhs = torch.zeros((num_rows, J), dtype=torch.float32, device=dev)
    for s in range(0, values.shape[0], chunk):
        p = perm[s:s + chunk]
        seg = seg_all[s:s + chunk]
        d = _contract_except(
            params.core, gather_rows(params.factors, indices.index_select(
                0, p)), mode)                                  # (c, J)
        ordered_fold(bk, (d[:, :, None] * d[:, None, :]).reshape(-1, J * J),
                     seg, num_rows, gram)
        ordered_fold(bk, values.index_select(0, p)[:, None] * d, seg,
                     num_rows, rhs)
    return gram.reshape(num_rows, J, J), rhs


@torch.no_grad()
def als_update_mode(
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
    """Return the updated A^(mode) (I_n, J_n)."""
    gram, rhs = normal_equations(params, indices, values, mode, num_rows,
                                 chunk, backend, order)
    J = rhs.shape[1]
    gram += lambda_a * torch.eye(J, dtype=torch.float32, device=rhs.device)
    # rows with no observations keep their previous value
    seen = torch.bincount(indices[:, mode], minlength=num_rows) > 0
    sol = torch.linalg.solve(gram, rhs[..., None])[..., 0]
    return torch.where(seen[:, None], sol, params.factors[mode])


def als_epoch(
    params: CuTuckerParams,
    tensor: SparseTensor,
    cfg: ALSConfig,
    chunk: int = DEFAULT_CHUNK,
    backend: str | None = None,
    order: SortedBatchOrder | None = None,
) -> CuTuckerParams:
    """One full alternating sweep over all modes (Gauss–Seidel).
    ``order``: ``sorted_batch_order(tensor.indices)``, to sort once for
    several epochs."""
    factors = list(params.factors)
    for n in range(cfg.order):
        p = CuTuckerParams(tuple(factors), params.core)
        factors[n] = als_update_mode(p, tensor.indices, tensor.values, n,
                                     cfg.dims[n], cfg.lambda_a, chunk,
                                     backend, order)
    return CuTuckerParams(tuple(factors), params.core)
