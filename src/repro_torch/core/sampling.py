"""One-step stochastic sampling sets Ψ, counterpart of ``repro.core.sampling``.

Every update step draws ``|Ψ|`` nonzeros uniformly, with replacement, from
Ω on the tensor's own device.  The draw comes from an explicit
``torch.Generator``, which gives other numbers than JAX's threefry keys:
parity with the reference therefore goes through fed batches
(``fasttucker.sgd_step_batch``), never through this sampler.

Mode-sorted batches (cuFasterTucker / P-Tucker style): the sorted step
reads only ``sorted_batch_order`` — per mode, the stable sort permutation
and the sorted row ids, which the ``segment_reduce`` scatter of
``FastTuckerConfig(sorted_batches=True)`` consumes.  ``sorted_batch_layout``
adds the rest of the reference's layout (unique ids, inverse index, CSR
segment offsets, unique counts) for code and tests that want the whole
of it.  Both run on the batch's device with no host round trip.
Stability is load-bearing: it keeps the duplicates of a row in batch
order, which makes the sorted segment sum bitwise equal to the unsorted
one in f32.

The stratified schedule (§5.3): ``latin_hypercube_schedule`` is one
``torch.randperm`` of the S = M^(N-1) strata (the reference's permutation
comes from threefry, so the two differ; the parity tests feed the
reference's), and ``stratum_digits`` gives the reference's base-M digits
bit for bit, on numpy arrays or tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def sample_batch_arrays(
    generator: torch.Generator,
    indices: torch.Tensor,
    values: torch.Tensor,
    batch_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw Ψ: returns (indices (B, N), values (B,)) on the tensor's device."""
    pick = torch.randint(0, values.shape[0], (batch_size,),
                         generator=generator, device=values.device)
    return indices.index_select(0, pick), values.index_select(0, pick)


class SortedBatchOrder(NamedTuple):
    """Per-mode stable sort of one sampled batch: all the sorted step reads.

      * ``perm[n]``        (B,) int64  position p of the sorted view holds
                                       batch entry ``perm[n][p]``
      * ``sorted_rows[n]`` (B,) int32  ``idx[perm[n], n]``: row ids
                                       ascending, duplicates adjacent and
                                       in batch order
    """
    perm: tuple[torch.Tensor, ...]
    sorted_rows: tuple[torch.Tensor, ...]


def sorted_batch_order(idx: torch.Tensor) -> SortedBatchOrder:
    """One stable sort per mode of a sampled batch ``idx`` (B, N).

    Negative ids are kept as they are (they sort first).
    """
    perm, srows = [], []
    for n in range(idx.shape[1]):
        sr, p = torch.sort(idx[:, n].to(torch.int32), stable=True)
        perm.append(p)
        srows.append(sr)
    return SortedBatchOrder(tuple(perm), tuple(srows))


class SortedBatchLayout(NamedTuple):
    """The reference's whole per-mode sorted view (all int32, leading axis N).

      * ``perm[n]``        (B,)   stable sort permutation
      * ``sorted_rows[n]`` (B,)   ``idx[perm[n], n]``
      * ``uniq[n]``        (B,)   unique row ids compacted left; slots past
                                  ``num_uniq[n]`` hold row 0 and are never
                                  referenced by ``inv``
      * ``inv[n]``         (B,)   batch position → slot in ``uniq[n]``, so
                                  ``uniq[n][inv[n]] == idx[:, n]`` exactly
      * ``seg_starts[n]``  (B+1,) offsets into the sorted view: unique row
                                  u's entries are sorted positions
                                  [seg_starts[u], seg_starts[u+1]); slots
                                  past ``num_uniq[n]`` hold B
      * ``num_uniq``       (N,)   unique row count per mode (on the device)
    """
    perm: torch.Tensor         # (N, B) int32
    sorted_rows: torch.Tensor  # (N, B) int32
    uniq: torch.Tensor         # (N, B) int32
    inv: torch.Tensor          # (N, B) int32
    seg_starts: torch.Tensor   # (N, B+1) int32
    num_uniq: torch.Tensor     # (N,) int32


def sorted_batch_layout(idx: torch.Tensor) -> SortedBatchLayout:
    """The whole mode-sorted layout of ``idx`` (B, N), bitwise the
    reference's: ``sorted_batch_order`` plus O(B) index arithmetic per
    mode.  Gathering through ``uniq``/``inv`` reads what the unsorted
    path reads."""
    B, N = idx.shape
    dev = idx.device
    i32 = torch.int32
    order = sorted_batch_order(idx)
    pos = torch.arange(B, dtype=i32, device=dev)
    uniq, inv, starts, nu = [], [], [], []
    for p, sr in zip(order.perm, order.sorted_rows):
        first = torch.ones((B,), dtype=i32, device=dev)
        first[1:] = (sr[1:] != sr[:-1]).to(i32)
        seg = torch.cumsum(first, 0, dtype=i32) - 1     # (B,) segment ids
        seg_l = seg.long()
        # duplicate segment slots all write the same row id: exact
        uniq.append(torch.zeros((B,), dtype=i32, device=dev)
                    .scatter_(0, seg_l, sr))
        inv.append(torch.zeros((B,), dtype=i32, device=dev)
                   .scatter_(0, p, seg))
        starts.append(torch.full((B + 1,), B, dtype=i32, device=dev)
                      .scatter_reduce_(0, seg_l, pos, "amin",
                                       include_self=True))
        nu.append(seg[-1:] + 1)
    return SortedBatchLayout(
        torch.stack(order.perm).to(i32), torch.stack(order.sorted_rows),
        torch.stack(uniq), torch.stack(inv), torch.stack(starts),
        torch.cat(nu))


def epoch_permutation_batches(
    generator: torch.Generator, nnz: int, batch_size: int
) -> torch.Tensor:
    """Permutation of 0..nnz-1 on the generator's device, padded with its
    own head and reshaped to (num_batches, B), int32."""
    perm = torch.randperm(nnz, generator=generator, dtype=torch.int32,
                          device=generator.device)
    num_batches = -(-nnz // batch_size)
    pad = num_batches * batch_size - nnz
    perm = torch.cat([perm, perm[:pad]])
    return perm.reshape(num_batches, batch_size)


def stratum_digits(strata, num_workers: int, order: int):
    """Base-M digits of stratum ids → (S, N) mode shifts.

    Mode 0 is the anchor (digit 0: its factor shards never rotate); mode
    n ∈ 1..N-1 gets ``(s // M^(n-1)) % M``, matching
    ``BlockPartition.strata`` / ``assign``.  A numpy array (or a list) in
    gives a numpy array of its integer dtype, a tensor a tensor.
    """
    if isinstance(strata, torch.Tensor):
        cols, rem = [torch.zeros_like(strata)], strata
        for _ in range(1, order):
            cols.append(rem % num_workers)
            rem = rem // num_workers
        return torch.stack(cols, dim=1)
    strata = np.asarray(strata)
    cols, rem = [np.zeros_like(strata)], strata
    for _ in range(1, order):
        cols.append(rem % num_workers)
        rem = rem // num_workers
    return np.stack(cols, axis=1)


def latin_hypercube_schedule(generator: torch.Generator, num_workers: int,
                             order: int) -> torch.Tensor:
    """One epoch of the stratified schedule: a random permutation of all
    ``S = M^(N-1)`` strata (each an M-block generalized diagonal), drawn
    from ``generator`` on its device, int64.

    Visiting every stratum once an epoch touches each of the M^N blocks
    exactly once, a Latin-hypercube cover of the block grid.  Digits via
    ``stratum_digits``.
    """
    return torch.randperm(num_workers ** (order - 1), generator=generator,
                          device=generator.device)
