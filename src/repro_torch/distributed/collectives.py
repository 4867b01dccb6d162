"""Collectives over an in-process worker mesh, as explicit copies.

The port's stand-in for the two ``jax.lax`` collectives the multi-device
strategies use (``launch.mesh`` says why the mesh is in-process):

``rotate`` (``ppermute``)
    worker m receives the shard worker (m + shift) mod M holds, copied into
    a new buffer on m's device.  It copies even when both workers are on
    one device, so the bytes really move and the stream ordering is the one
    a multi-card mesh runs; between cards it is a peer copy.  A shift of 0
    mod M moves nothing, as the reference skips that ``ppermute``.
``psum``
    the sum of every worker's part in fixed worker order, 0 … M−1, on
    worker 0's device, copied back to every other worker: the same bits
    whatever the placement, and no float atomics.

Sharded serving (``serve.engine``) adds three, each returning the bytes it
copied between workers by ``shard_bytes``' rule (elements × item size of
every tensor that leaves its worker; what stays on a worker is free):

``gather_rows`` (the reference's masked ``psum`` row gather)
    global row ids of a row-sharded table → their rows, in request order,
    on one worker: each row copied from the worker that owns it,
    ``id // block_rows``.
``all_gather``
    the workers' parts, concatenated in worker order 0 … M−1 on one
    worker.
``broadcast``
    one worker's tensor, copied to every other worker.

``SideStreams`` issues a rotation's copies on one side CUDA stream per
device (``strata_overlap``): each copy waits on an event of the compute
stream recorded after its source was written and its destination
allocated, records its own event, and the consumer's compute stream waits
on that (``Pending.wait``).  The source is marked as used by the side
stream, so the allocator does not hand its memory to a compute kernel
before the copy has read it.  On the CPU the copies are synchronous.

``Traffic`` is a step function's account of its collectives (``rotate``,
``psum`` and ``SideStreams.rotate`` add to the one they are given), by the
reference's rules for the collectives its compiled step holds
(``repro.launch.hlo_analysis``), per worker: a ``psum`` of b bytes a
worker is a ring all-reduce, 2·b·(M − 1)/M wire bytes; a rotation is one
collective-permute of the worker's shard.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Traffic:
    """What a step function's collectives moved, summed over its calls
    until ``reset`` (divide by the steps taken for a figure a step).

    ``psum_bytes``     per worker: 2·b·(M − 1)/M for every ``psum`` of b
                       bytes a worker (ring all-reduce); 0 on one worker
    ``permute_bytes``  per worker: the bytes of the shard each non-zero
                       rotation moves off it (``shard_bytes`` ÷ M)
    ``rotated_bytes``  all workers' together: ``shard_bytes`` of every
                       rotation (M × ``permute_bytes`` for equal shards)
    ``permutes``       non-zero rotations a worker issued
    ``async_starts``   of those, the ones a side CUDA stream carried
                       (``SideStreams`` on the card; 0 on the CPU, where
                       the copies are synchronous)
    ``hidden_flops``   per worker: FLOPs of the compute-stream work issued
                       between a side rotation's issue and its
                       ``Pending.wait`` (the caller adds them)
    """

    FIELDS = ("psum_bytes", "permute_bytes", "rotated_bytes", "permutes",
              "async_starts", "hidden_flops")
    __slots__ = FIELDS

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)

    def add_psum(self, part: Sequence[torch.Tensor], workers: int) -> None:
        """One ``psum`` of ``part`` (one worker's tensors) over
        ``workers``."""
        if workers > 1:
            b = sum(nbytes(t) for t in part)
            self.psum_bytes += 2.0 * b * (workers - 1) / workers

    def add_rotation(self, shards: Sequence[torch.Tensor], shift: int,
                     side: bool = False) -> None:
        """One rotation of ``shards`` by ``shift`` (nothing at shift 0 mod
        M); ``side`` when a side stream carries its copies."""
        moved = shard_bytes(shards, shift)
        if moved:
            self.rotated_bytes += moved
            self.permute_bytes += moved / len(shards)
            self.permutes += 1
            self.async_starts += int(side)


def copy_to(src: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A new tensor on ``device`` holding ``src`` (always a copy)."""
    return torch.empty(src.shape, dtype=src.dtype, device=device).copy_(src)


def shard_bytes(shards: Sequence[torch.Tensor], shift: int) -> int:
    """Bytes ``rotate(shards, shift)`` moves."""
    if shift % len(shards) == 0:
        return 0
    return sum(t.numel() * t.element_size() for t in shards)


def rotate(shards: Sequence[torch.Tensor], shift: int, mesh,
           traffic: Traffic | None = None) -> list[torch.Tensor]:
    """``ppermute`` by ``shift``: worker m gets a copy of worker
    (m + shift) mod M's shard, on its own device.  Shifts compose
    additively: from shift d to d' is a rotation by (d' − d) mod M."""
    if traffic is not None:
        traffic.add_rotation(shards, shift)
    M = len(shards)
    if shift % M == 0:
        return list(shards)
    return [copy_to(shards[(m + shift) % M], mesh.devices[m])
            for m in range(M)]


def psum(parts: Sequence[tuple[torch.Tensor, ...]], mesh,
         traffic: Traffic | None = None) -> list[tuple[torch.Tensor, ...]]:
    """``parts[m]`` a tuple of tensors on worker m's device → the leafwise
    sum, added in worker order on worker 0's device, one copy a worker.
    With one worker its part comes back unchanged."""
    M = len(parts)
    if traffic is not None:
        traffic.add_psum(parts[0], M)
    if M == 1:
        return [tuple(parts[0])]
    dev0 = mesh.devices[0]
    sums = []
    for leaf in zip(*parts):
        acc = leaf[0]
        for t in leaf[1:]:
            acc = acc + t.to(dev0)
        sums.append(acc)
    return [tuple(sums)] + [tuple(copy_to(s, mesh.devices[m]) for s in sums)
                            for m in range(1, M)]


def nbytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements (``shard_bytes``' rule for one tensor)."""
    return t.numel() * t.element_size()


def gather_rows(shards: Sequence[torch.Tensor], ids: np.ndarray,
                block_rows: int, mesh, dst: int = 0
                ) -> tuple[torch.Tensor, int]:
    """Rows ``ids`` (global, host ints) of a table whose rows
    [m·block_rows, (m+1)·block_rows) worker m holds as ``shards[m]`` →
    (len(ids), R) on worker ``dst``'s device in request order, and the
    bytes copied from the other workers.

    Exact: every row is copied, never summed.  The reference zero-masks
    the rows a device does not own and adds the M blocks with one
    ``psum``, which is exact too, but for one bit: a −0.0 entry comes
    back as +0.0 there (−0.0 + 0.0) and as −0.0 here.  No prediction can
    tell the two apart: the two zeros compare equal, and so do the
    products and sums made from them.
    """
    dev = mesh.devices[dst]
    ids = np.asarray(ids, dtype=np.int64)
    if len(shards) == 1:
        return shards[0].index_select(0, torch.from_numpy(ids).to(dev)), 0
    owner = ids // block_rows
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=len(shards))
    local = (ids - owner * block_rows)[order]
    parts, moved, start = [], 0, 0
    for m, c in enumerate(counts.tolist()):
        if not c:
            continue
        lid = torch.from_numpy(local[start:start + c]).to(mesh.devices[m])
        part = shards[m].index_select(0, lid)
        if m != dst:
            part = copy_to(part, dev)
            moved += nbytes(part)
        parts.append(part)
        start += c
    rows = parts[0] if len(parts) == 1 else torch.cat(parts)
    if (order[1:] < order[:-1]).any():      # back to request order
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        rows = rows.index_select(0, torch.from_numpy(inv).to(dev))
    return rows, moved


def all_gather(parts: Sequence[torch.Tensor], mesh, dim: int = 0,
               dst: int = 0) -> tuple[torch.Tensor, int]:
    """``parts[m]`` on worker m → their concatenation along ``dim`` in
    worker order on worker ``dst``, and the bytes copied to it."""
    dev = mesh.devices[dst]
    moved = [p if m == dst else copy_to(p, dev) for m, p in enumerate(parts)]
    return (torch.cat(moved, dim=dim),
            sum(nbytes(p) for m, p in enumerate(parts) if m != dst))


def broadcast(t: torch.Tensor, mesh, workers: int,
              src: int = 0) -> tuple[list[torch.Tensor], int]:
    """``t`` (on worker ``src``) for each of the first ``workers``
    workers: ``t`` itself on ``src``, a copy on every other one; and the
    bytes copied."""
    out = [t if m == src else copy_to(t, mesh.devices[m])
           for m in range(workers)]
    return out, (workers - 1) * nbytes(t)


class Pending:
    """A rotation's destination shards and the events of their copies."""

    __slots__ = ("tensors", "events")

    def __init__(self, tensors: list[torch.Tensor], events: list):
        self.tensors, self.events = tensors, events

    def wait(self) -> list[torch.Tensor]:
        """The shards, once each consumer's current stream waits on its
        copy."""
        for t, ev in zip(self.tensors, self.events):
            if ev is not None:
                torch.cuda.current_stream(t.device).wait_event(ev)
        return self.tensors


class SideStreams:
    """One side CUDA stream per device for rotation copies, made on first
    use.  Kernels stay on the compute (current) streams: the side streams
    carry copies only."""

    def __init__(self):
        self._streams: dict[torch.device, torch.cuda.Stream] = {}

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device=device)
        return s

    def rotate(self, shards: Sequence[torch.Tensor], shift: int, mesh,
               traffic: Traffic | None = None) -> Pending:
        """``rotate`` issued on the side streams; ``Pending.wait`` before
        the shards are read."""
        M = len(shards)
        if shift % M == 0:
            return Pending(list(shards), [None] * M)
        if mesh.devices[0].type != "cuda":
            return Pending(rotate(shards, shift, mesh, traffic), [None] * M)
        if traffic is not None:
            traffic.add_rotation(shards, shift, side=True)
        out, events = [], []
        for m in range(M):
            src, dev = shards[(m + shift) % M], mesh.devices[m]
            s_src, s_dst = self._stream(src.device), self._stream(dev)
            with torch.cuda.device(dev):
                dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
            # the source's writer and the destination's last reader are
            # on the compute streams, queued before these events
            for d, s in {src.device: s_src, dev: s_dst}.items():
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                s.wait_event(ev)
            with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
                dst.copy_(src)
            done = torch.cuda.Event()
            done.record(s_dst)
            src.record_stream(s_src)
            out.append(dst)
            events.append(done)
        return Pending(out, events)
