"""COO container for High-Order High-Dimension Sparse Tensors (HOHDST).

Counterpart of ``repro.core.sptensor``:

    indices : (nnz, N) int32 tensor  -- one column per mode
    values  : (nnz,)   float32 tensor

plus the dense mode sizes ``dims = (I_1, ..., I_N)``.  Both tensors live on
one device.  ``split`` draws the same numpy permutation as the reference,
so the train/test split is identical for the same data and seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class SparseTensor:
    """COO sparse tensor on one device."""

    indices: torch.Tensor  # (nnz, N) int32
    values: torch.Tensor   # (nnz,) float32
    dims: tuple[int, ...]

    @classmethod
    def from_numpy(
        cls,
        indices: np.ndarray,
        values: np.ndarray,
        dims: tuple[int, ...],
        device: str | torch.device | None = None,
    ) -> "SparseTensor":
        device = resolve_device(device)
        # C-contiguous and writable (torch wraps the buffer, no copy when
        # it already is)
        idx = torch.from_numpy(np.require(indices, np.int32, ["C", "W"]))
        val = torch.from_numpy(np.require(values, np.float32, ["C", "W"]))
        return cls(idx.to(device), val.to(device),
                   tuple(int(d) for d in dims))

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def split(self, test_fraction: float, seed: int = 0):
        """Random split into (train, test=Γ), the reference's permutation."""
        rng = np.random.default_rng(seed)
        nnz = self.nnz
        perm = torch.from_numpy(rng.permutation(nnz)).to(self.device)
        n_test = int(nnz * test_fraction)
        test_ids, train_ids = perm[:n_test], perm[n_test:]

        def take(ids: torch.Tensor) -> SparseTensor:
            return SparseTensor(self.indices.index_select(0, ids),
                                self.values.index_select(0, ids), self.dims)

        return take(train_ids), take(test_ids)
