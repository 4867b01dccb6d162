"""COO container for High-Order High-Dimension Sparse Tensors (HOHDST).

Counterpart of ``repro.core.sptensor``:

    indices : (nnz, N) int32 tensor  -- one column per mode
    values  : (nnz,)   float32 tensor

plus the dense mode sizes ``dims = (I_1, ..., I_N)``.  Both tensors live on
one device.  ``split`` draws the same numpy permutation as the reference,
so the train/test split is identical for the same data and seed.

Also the paper's Section 5.3 workload partition: each mode is cut into
``M`` ranges, giving ``M**N`` blocks; a *stratum* is a set of M blocks
whose per-mode block digits are pairwise distinct, so the M workers of a
stratum touch disjoint factor-row ranges.  ``BlockPartition`` (host numpy,
as in the reference) gives the reference's digits, strata and assignment
bit for bit, and ``partition_for_workers`` its padded ``(S, M, L, ·)``
buckets (the layout ``data.pipeline.NonzeroStore`` stores), computed with
integer torch operations and a stable sort on the tensor's own device: on
the card the Netflix tensor's 89 M nonzeros take no host sort.  The
Latin-hypercube ``epoch_schedule`` is a ``torch.randperm`` of the strata
(``sampling.latin_hypercube_schedule``), in the reference's digit
convention but from PyTorch's random stream, not its threefry one.
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
    def order(self) -> int:
        return len(self.dims)

    @property
    def density(self) -> float:
        total = float(np.prod([float(d) for d in self.dims]))
        return self.nnz / total

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to_dense(self) -> torch.Tensor:
        """Materialize (tiny tensors only — tests); duplicates add."""
        dense = torch.zeros(self.dims, dtype=self.values.dtype,
                            device=self.device)
        return dense.index_put_(
            tuple(self.indices[:, n].long() for n in range(self.order)),
            self.values, accumulate=True)

    @classmethod
    def from_dense(cls, dense, threshold: float = 0.0,
                   device: str | torch.device | None = None
                   ) -> "SparseTensor":
        """The entries of ``dense`` (numpy or a tensor) with |x| above
        ``threshold``, in C order."""
        if isinstance(dense, torch.Tensor):
            dense = dense.detach().cpu().numpy()
        dense = np.asarray(dense)
        idx = np.argwhere(np.abs(dense) > threshold).astype(np.int32)
        vals = dense[tuple(idx.T)].astype(np.float32)
        return cls.from_numpy(idx, vals, tuple(dense.shape), device)

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


# ---------------------------------------------------------------------------
# Section 5.3: M**N block partition + conflict-free strata schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockPartition:
    """The paper's M-way per-mode cut of an N-order tensor (host numpy).

    ``block_of(indices)`` maps each nonzero to its N-digit block coordinate;
    ``strata()`` enumerates the conflict-free schedule: stratum ``s``
    assigns worker ``m`` the block whose mode-n digit is ``(m + s_n) mod M``
    for the base-M digits ``s_n`` of ``s``.  Workers within a stratum then
    own pairwise-distinct digits in every mode, hence disjoint factor-row
    ranges.
    """

    dims: tuple[int, ...]
    num_workers: int  # M

    @property
    def order(self) -> int:
        return len(self.dims)

    def mode_boundaries(self, n: int) -> np.ndarray:
        """M+1 boundaries of mode n ranges (balanced)."""
        return np.linspace(0, self.dims[n], self.num_workers + 1
                           ).astype(np.int64)

    def block_digit(self, n: int, coords: np.ndarray) -> np.ndarray:
        """Digit (0..M-1) of each coordinate along mode n."""
        bounds = self.mode_boundaries(n)[1:-1]
        return np.searchsorted(bounds, coords, side="right")

    def block_of(self, indices: np.ndarray) -> np.ndarray:
        """(nnz, N) -> (nnz, N) block digits."""
        indices = np.asarray(indices)
        return np.stack([self.block_digit(n, indices[:, n])
                         for n in range(self.order)], axis=1)

    def strata(self) -> np.ndarray:
        """All strata: shape (M**(N-1), M, N).

        ``strata()[s, m]`` is the N-digit block coordinate worker ``m``
        handles in stratum ``s``: mode 0's digit is ``m``, the others are
        shifted by the base-M digits of ``s``.
        """
        M, N = self.num_workers, self.order
        S = M ** (N - 1)
        s = np.arange(S, dtype=np.int64)
        m = np.arange(M, dtype=np.int64)
        out = np.empty((S, M, N), dtype=np.int64)
        out[:, :, 0] = m[None, :]
        for n in range(1, N):
            digit = (s // M ** (n - 1)) % M
            out[:, :, n] = (m[None, :] + digit[:, None]) % M
        return out

    def epoch_schedule(self, seed_or_generator) -> np.ndarray:
        """Pre-sampled Latin-hypercube epoch cover: (S,) int64 stratum ids,
        every stratum once.

        Host numpy, because the strategies pick each stratum's rotations on
        the host.  Takes an int seed (a CPU generator seeded with it, so
        the schedule is the same on every device) or a ``torch.Generator``;
        digits via ``sampling.stratum_digits``.
        """
        from .sampling import latin_hypercube_schedule

        gen = (torch.Generator().manual_seed(seed_or_generator)
               if isinstance(seed_or_generator, int) else seed_or_generator)
        return latin_hypercube_schedule(gen, self.num_workers,
                                        self.order).cpu().numpy()

    def assign(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Map nonzeros to (stratum, worker), both int64: the inverse of
        ``strata``, worker = digit_0 and stratum digits
        s_n = (digit_n − digit_0) mod M."""
        digits = self.block_of(indices)  # (nnz, N)
        M, N = self.num_workers, self.order
        worker = digits[:, 0]
        stratum = np.zeros(len(digits), dtype=np.int64)
        mult = 1
        for n in range(1, N):
            stratum += ((digits[:, n] - worker) % M) * mult
            mult *= M
        return stratum, worker


def bucket_positions(key: np.ndarray, offsets: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The stable bucket scatter of one chunk of nonzeros.

    ``key`` holds each entry's flat bucket id (stratum·M + worker) and
    ``offsets`` each bucket's current fill.  Returns ``(order, bucket,
    pos)``: entry ``order[i]`` goes to slot ``pos[i]`` of bucket
    ``bucket[i]``, in order of appearance within each bucket.  ``offsets``
    is advanced in place by the chunk's counts.
    """
    # a stable sort is one permutation whatever the key's dtype; uint16
    # keys take numpy's radix sort
    narrow = key.astype(np.uint16) if len(offsets) <= 1 << 16 else key
    order = np.argsort(narrow, kind="stable")
    ksort = key[order]
    first = np.searchsorted(ksort, np.arange(len(offsets)))
    pos = offsets[ksort] + (np.arange(len(ksort)) - first[ksort])
    offsets += np.bincount(key, minlength=len(offsets))
    return order, ksort, pos


def partition_for_workers(tensor: SparseTensor, num_workers: int,
                          pad_multiple: int = 8) -> dict:
    """Bucket nonzeros by (stratum, worker) with equal padded sizes.

    Returns a dict with, on the tensor's device:
      indices : (S, M, L, N) int32  -- padded per-bucket COO indices
      values  : (S, M, L)    float32
      mask    : (S, M, L)    bool   -- valid entries
    and ``partition``, the ``BlockPartition``.  S = M**(N-1) strata, L the
    longest bucket rounded up to ``pad_multiple``; entries keep their order
    of appearance within a bucket, and padding points at row 0 of each
    mode with value 0 and mask False (a no-op update).

    The digits are ``BlockPartition``'s (a ``searchsorted`` into the same
    boundaries), the entry order a stable sort of the bucket keys, every
    step exact integer arithmetic: the buckets are the reference's host
    computation bit for bit, on whatever device the tensor is.
    """
    part = BlockPartition(tensor.dims, num_workers)
    M, N = num_workers, tensor.order
    S = M ** (N - 1)
    dev, nnz = tensor.device, tensor.nnz
    idx = tensor.indices
    key = None
    for n in range(N):
        bounds = torch.from_numpy(part.mode_boundaries(n)[1:-1]).to(dev)
        digit = torch.searchsorted(bounds, idx[:, n].long(), right=True)
        if n == 0:
            worker = key = digit
        else:  # stratum digit s_n = (digit_n − digit_0) mod M, base M
            key = key + ((digit - worker) % M) * M ** n
    counts = torch.bincount(key, minlength=S * M)
    L = max(1, int(counts.max()))
    L = ((L + pad_multiple - 1) // pad_multiple) * pad_multiple
    ksort, order = torch.sort(key, stable=True)
    first = torch.searchsorted(ksort, torch.arange(S * M, device=dev))
    slot = ksort * L + (torch.arange(nnz, device=dev) - first[ksort])
    out_idx = torch.zeros((S * M * L, N), dtype=torch.int32, device=dev)
    out_val = torch.zeros((S * M * L,), dtype=torch.float32, device=dev)
    out_mask = torch.zeros((S * M * L,), dtype=torch.bool, device=dev)
    out_idx[slot] = idx.index_select(0, order)
    out_val[slot] = tensor.values.index_select(0, order)
    out_mask[slot] = True
    return {
        "indices": out_idx.reshape(S, M, L, N),
        "values": out_val.reshape(S, M, L),
        "mask": out_mask.reshape(S, M, L),
        "partition": part,
    }
