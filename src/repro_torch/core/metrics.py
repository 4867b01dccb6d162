"""RMSE / MAE over a held-out set Γ, counterpart of ``repro.core.metrics``.

The same 262,144-nonzero chunks as the reference, each chunk's squared and
absolute errors summed in f32 and the chunk sums added in f32.
"""
from __future__ import annotations

from typing import Callable

import torch

from .sptensor import SparseTensor


@torch.no_grad()
def rmse_mae(
    params,
    test: SparseTensor,
    predict_fn: Callable,
    chunk: int = 262144,
) -> tuple[torch.Tensor, torch.Tensor]:
    """√(Σ(v−ṽ)²/|Γ|),  Σ|v−ṽ|/|Γ| — streamed in chunks, 0-dim f32."""
    nnz = test.nnz
    se = torch.zeros((), dtype=torch.float32, device=test.device)
    ae = torch.zeros((), dtype=torch.float32, device=test.device)
    for start in range(0, nnz, chunk):
        idx = test.indices[start: start + chunk]
        val = test.values[start: start + chunk]
        err = predict_fn(params, idx) - val
        se = se + torch.sum(err ** 2)
        ae = ae + torch.sum(torch.abs(err))
    return torch.sqrt(se / nnz), ae / nnz
