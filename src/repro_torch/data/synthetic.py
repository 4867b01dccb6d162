"""Synthetic HOHDST generators, counterpart of ``repro.data.synthetic``.

The draws are the reference's numpy draws, in the same order from the same
``default_rng(seed)``, so the port's data is bitwise the reference's.  Only
the last step differs: the arrays become a ``SparseTensor`` of torch
tensors on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sptensor import SparseTensor


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` — the sorted distinct values — by a sort and an
    adjacent-difference mask.  numpy 2.3 finds unique integers through a
    hash table, which is far slower than this sort for the ~10^8 random
    int64 keys of a Netflix-sized tensor; the result is the same array."""
    s = np.sort(a)
    keep = np.empty(s.shape, dtype=bool)
    keep[:1] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def _unique_indices(rng, dims, nnz):
    """nnz distinct random index tuples (rejection-free for sparse regime)."""
    dims = np.asarray(dims, dtype=np.int64)
    total = np.prod(dims.astype(object))
    flat = rng.integers(0, int(total), size=int(nnz * 1.2), dtype=np.int64)
    flat = _sorted_unique(flat)[:nnz]
    while len(flat) < nnz:
        extra = rng.integers(0, int(total), size=nnz, dtype=np.int64)
        flat = _sorted_unique(np.concatenate([flat, extra]))[:nnz]
    idx = np.zeros((nnz, len(dims)), dtype=np.int32)
    rem = flat
    for n in range(len(dims)):
        idx[:, n] = rem % dims[n]
        rem = rem // dims[n]
    return idx


def planted_arrays(
    dims: tuple[int, ...],
    nnz: int,
    rank: int = 4,
    core_rank: int = 4,
    noise: float = 0.05,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """(indices (nnz, N) int32, values (nnz,) f32) of ``planted_tensor``."""
    rng = np.random.default_rng(seed)
    N = len(dims)
    idx = _unique_indices(rng, dims, nnz)
    scale = (1.0 / core_rank) ** (0.5 / N) / np.sqrt(rank)
    A = [rng.uniform(0, 2 * scale, (dims[n], rank)).astype(np.float32)
         for n in range(N)]
    B = [rng.uniform(0, 2 * scale, (rank, core_rank)).astype(np.float32)
         for n in range(N)]
    # x̂ = Σ_r Π_n ⟨a_{i_n}, b_r^(n)⟩ — evaluate in chunks
    vals = np.zeros(nnz, dtype=np.float32)
    chunk = 1 << 18
    for s in range(0, nnz, chunk):
        sl = slice(s, min(s + chunk, nnz))
        c = None
        for n in range(N):
            cn = A[n][idx[sl, n]] @ B[n]  # (b, R)
            c = cn if c is None else c * cn
        vals[sl] = c.sum(-1)
    vals += rng.normal(0, noise, nnz).astype(np.float32)
    return idx, vals


def planted_tensor(
    dims: tuple[int, ...],
    nnz: int,
    rank: int = 4,
    core_rank: int = 4,
    noise: float = 0.05,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> SparseTensor:
    """Observations of a planted Kruskal-core Tucker model + Gaussian noise."""
    idx, vals = planted_arrays(dims, nnz, rank, core_rank, noise, seed)
    return SparseTensor.from_numpy(idx, vals, tuple(dims), device)


def ratings_tensor(
    dims: tuple[int, ...],
    nnz: int,
    min_value: float = 1.0,
    max_value: float = 5.0,
    rank: int = 8,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> SparseTensor:
    """Recommender-style tensor: planted low-rank signal squashed to range."""
    idx, v = planted_arrays(dims, nnz, rank=rank, core_rank=rank, noise=0.1,
                            seed=seed)
    lo, hi = np.quantile(v, [0.01, 0.99])
    v = (v - lo) / max(hi - lo, 1e-6)
    v = np.clip(v, 0, 1) * (max_value - min_value) + min_value
    return SparseTensor.from_numpy(idx, v.astype(np.float32), tuple(dims),
                                   device)
