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

Sharded LM training (``distributed.sharded_lm``) differentiates through
its collectives: ``GatherLeaf`` all-gathers a parameter's parts over the
mesh axes it is gathered on, cast first where it is asked to move another
dtype (backward: the reduce-scatter, and the sum over the workers holding
the same part, in the parts' dtype), ``Psum`` sums each group's parts
(backward: the sum of the group's cotangents, to every member) and
``GatherRows`` concatenates each group's rows (backward: the sum of the
members' cotangents, each member its own rows).  Every backward adds in
worker order, 0 … k − 1, with no float atomics.  ``prefix_counts`` hands
each worker the sum of the integer counts of the batch slices before its
own (the MoE dispatch over the global batch; no gradient).

``Traffic`` is a step function's account of its collectives (``rotate``,
``psum`` and ``SideStreams.rotate`` add to the one they are given), by the
reference's rules for the collectives its compiled step holds
(``repro.launch.hlo_analysis``), per worker: a ``psum`` of b bytes a
worker is a ring all-reduce, 2·b·(M − 1)/M wire bytes; a rotation is one
collective-permute of the worker's shard; over a group of g workers an
all-gather of a b-byte result costs b·(g − 1)/g, a reduce-scatter of an
r-byte result shard r·(g − 1), an all-reduce of b bytes 2·b·(g − 1)/g.
"""
from __future__ import annotations

import math
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
    ``all_gather_bytes``, ``reduce_scatter_bytes``, ``all_reduce_bytes``
                       per worker, the sharded LM step's collectives
    ``count_bytes``    per worker, the all-gathers of the MoE dispatch's
                       per-expert counts (``prefix_counts``)
    """

    FIELDS = ("psum_bytes", "permute_bytes", "rotated_bytes", "permutes",
              "async_starts", "hidden_flops", "all_gather_bytes",
              "reduce_scatter_bytes", "all_reduce_bytes", "count_bytes")
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

    def add_all_gather(self, result_bytes: float, group: int) -> None:
        self.all_gather_bytes += result_bytes * (group - 1) / group

    def add_reduce_scatter(self, shard_bytes: float, group: int) -> None:
        self.reduce_scatter_bytes += shard_bytes * (group - 1)

    def add_all_reduce(self, nbytes: float, group: int) -> None:
        self.all_reduce_bytes += 2.0 * nbytes * (group - 1) / group

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}

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


# ---------------------------------------------------------------------------
# differentiable collectives of sharded LM training
# ---------------------------------------------------------------------------

class GatherPlan:
    """Where each worker's gathered region of a leaf comes from.

    ``layout`` is the leaf's ``sharding.Layout``; ``keep`` the dimensions
    left as the worker's own slice (tensor parallelism).  ``gather`` and
    ``gather_one`` take a ``dtype`` to cast the parts to as they are
    copied.  Every other
    dimension a mesh axis binds is gathered whole.  ``region[m]`` is worker
    m's region of the full leaf; ``sources[m]`` the distinct blocks it is
    assembled from, ``(w, slices in the region)``, each taken from worker m
    itself where it holds the block, else from the first worker that does;
    ``sinks[w]`` every worker whose region holds worker w's block, in
    worker order.  ``group`` is the size of the gather; ``replicas`` the
    workers holding each block.
    """

    def __init__(self, layout, keep: Sequence[int] = ()):
        from .sharding import entry_axes

        self.layout = layout
        mesh = layout.mesh
        M = mesh.size
        idx = [layout.index(m) for m in range(M)]
        spec = tuple(layout.spec) + (None,) * (len(layout.shape)
                                               - len(layout.spec))
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        keep = set(keep)
        self.group = math.prod(sizes[a] for d, e in enumerate(spec)
                               if d not in keep for a in entry_axes(e))
        self.region = [tuple(idx[m][d] if d in keep else slice(0, n)
                             for d, n in enumerate(layout.shape))
                       for m in range(M)]
        blocks = {idx[w] for w in range(M)}
        self.replicas = M // len(blocks)

        def rel(w, m):
            return tuple(slice(b.start - r.start, b.stop - r.start)
                         for b, r in zip(idx[w], self.region[m]))

        def inside(w, m):
            return all(r.start <= b.start and b.stop <= r.stop
                       for b, r in zip(idx[w], self.region[m]))

        self.sources, self.sinks = [], []
        for m in range(M):
            seen, src = set(), []
            for w in [m] + [w for w in range(M) if w != m]:
                if inside(w, m) and idx[w] not in seen:
                    seen.add(idx[w])
                    src.append((w, rel(w, m)))
            self.sources.append(src)
        for w in range(M):
            self.sinks.append([(m, rel(w, m)) for m in range(M)
                               if inside(w, m)])
        self.own = [self.region[m] == idx[m] for m in range(M)]

    def gather(self, parts: Sequence[torch.Tensor], dtype=None
               ) -> list[torch.Tensor]:
        return [(parts[m] if dtype is None else parts[m].to(dtype))
                if self.own[m] else self.gather_one(parts, m, dtype)
                for m in range(len(parts))]

    def gather_one(self, parts: Sequence[torch.Tensor], m: int, dtype=None
                   ) -> torch.Tensor:
        """Worker m's region, a new buffer on its device."""
        part = parts[m]
        shape = tuple(s.stop - s.start for s in self.region[m])
        buf = torch.empty(shape, dtype=dtype or part.dtype,
                          device=part.device)
        for w, rel in self.sources[m]:
            buf[rel] = parts[w]
        return buf

    def reduce(self, grads: Sequence[torch.Tensor],
               devices: Sequence[torch.device], dtype=None
               ) -> list[torch.Tensor]:
        """The adjoint: worker w's part receives the sum over every worker
        whose region holds its block, in worker order, added in ``dtype``
        (default: the gradients')."""
        out = []
        for w, dev in enumerate(devices):
            acc = None
            for m, rel in self.sinks[w]:
                g = grads[m][rel].to(dev, dtype)
                acc = g if acc is None else acc + g
            out.append(acc)
        return out


class GatherLeaf(torch.autograd.Function):
    """parts (one a worker) → each worker's gathered region
    (``GatherPlan``), cast to ``dtype`` before it moves (None: as it is);
    backward: ``GatherPlan.reduce``, summed in the parts' dtype."""

    @staticmethod
    def forward(ctx, plan: GatherPlan, traffic, dtype, *parts):
        ctx.plan, ctx.traffic = plan, traffic
        ctx.devices = [p.device for p in parts]
        ctx.dtype = parts[0].dtype
        out = plan.gather(parts, dtype)
        if traffic is not None and plan.group > 1:
            traffic.add_all_gather(nbytes(out[0]), plan.group)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        plan, traffic = ctx.plan, ctx.traffic
        out = plan.reduce(grads, ctx.devices, ctx.dtype)
        if traffic is not None:
            part = nbytes(out[0])
            if plan.group > 1:
                traffic.add_reduce_scatter(part, plan.group)
            if plan.replicas > 1:
                traffic.add_all_reduce(part, plan.replicas)
        return (None, None, None, *out)


def gather_leaf(plan: GatherPlan, parts: Sequence[torch.Tensor],
                traffic: Traffic | None = None, dtype=None
                ) -> list[torch.Tensor]:
    """``GatherLeaf`` on a mesh of more than one worker; one worker's part
    as it is (cast to ``dtype``)."""
    if len(parts) == 1:
        return [parts[0] if dtype is None else parts[0].to(dtype)]
    return list(GatherLeaf.apply(plan, traffic, dtype, *parts))


def _group_sum(ts: Sequence[torch.Tensor], group: Sequence[int],
               devices: Sequence[torch.device]) -> dict[int, torch.Tensor]:
    dev0 = devices[group[0]]
    acc = ts[group[0]]
    for m in group[1:]:
        acc = acc + ts[m].to(dev0)
    return {m: acc if i == 0 else copy_to(acc, devices[m])
            for i, m in enumerate(group)}


class Psum(torch.autograd.Function):
    """Each group's parts summed in worker order, the sum to every member
    (``groups``: lists of worker indices, every worker in one); backward:
    the same sum of the members' cotangents."""

    @staticmethod
    def forward(ctx, groups, traffic, *parts):
        ctx.groups, ctx.traffic = groups, traffic
        ctx.devices = [p.device for p in parts]
        out: dict[int, torch.Tensor] = {}
        for g in groups:
            out.update(_group_sum(parts, g, ctx.devices))
        _count_all_reduce(traffic, parts, groups)
        return tuple(out[m] for m in range(len(parts)))

    @staticmethod
    def backward(ctx, *grads):
        out: dict[int, torch.Tensor] = {}
        for g in ctx.groups:
            out.update(_group_sum(grads, g, ctx.devices))
        _count_all_reduce(ctx.traffic, grads, ctx.groups)
        return (None, None, *(out[m] for m in range(len(grads))))


def psum_groups(parts: Sequence[torch.Tensor], groups,
                traffic: Traffic | None = None) -> list[torch.Tensor]:
    """``Psum`` where a group has more than one worker; the parts as they
    are otherwise."""
    if all(len(g) == 1 for g in groups):
        return list(parts)
    return list(Psum.apply(groups, traffic, *parts))


@torch.no_grad()
def pmax_groups(parts: Sequence[torch.Tensor], groups,
                traffic: Traffic | None = None) -> list[torch.Tensor]:
    """Each group's elementwise maximum, to every member (no gradient)."""
    devices = [p.device for p in parts]
    out: dict[int, torch.Tensor] = {}
    for g in groups:
        acc = parts[g[0]]
        for m in g[1:]:
            acc = torch.maximum(acc, parts[m].to(devices[g[0]]))
        out.update({m: acc if i == 0 else copy_to(acc, devices[m])
                    for i, m in enumerate(g)})
    _count_all_reduce(traffic, parts, groups)
    return [out[m] for m in range(len(parts))]


class GatherRows(torch.autograd.Function):
    """Each group's parts concatenated along dimension 0 in worker order,
    the result to every member; backward: the sum of the members'
    cotangents in worker order, each member its own rows."""

    @staticmethod
    def forward(ctx, groups, traffic, *parts):
        ctx.groups, ctx.traffic = groups, traffic
        ctx.devices = [p.device for p in parts]
        ctx.rows = [p.shape[0] for p in parts]
        out: dict[int, torch.Tensor] = {}
        for g in groups:
            dev0 = ctx.devices[g[0]]
            full = torch.cat([parts[m].to(dev0) for m in g])
            out.update({m: full if i == 0 else copy_to(full, ctx.devices[m])
                        for i, m in enumerate(g)})
        g0 = next(g for g in groups if 0 in g)
        if traffic is not None:
            traffic.add_all_gather(nbytes(out[0]), len(g0))
        return tuple(out[m] for m in range(len(parts)))

    @staticmethod
    def backward(ctx, *grads):
        out: dict[int, torch.Tensor] = {}
        for g in ctx.groups:
            summed = _group_sum(grads, g, ctx.devices)
            start = 0
            for m in g:
                out[m] = summed[m][start:start + ctx.rows[m]]
                start += ctx.rows[m]
        g0 = next(g for g in ctx.groups if 0 in g)
        if ctx.traffic is not None:
            ctx.traffic.add_reduce_scatter(nbytes(out[0]), len(g0))
        return (None, None, *(out[m] for m in range(len(grads))))


def gather_rows_groups(parts: Sequence[torch.Tensor], groups,
                       traffic: Traffic | None = None) -> list[torch.Tensor]:
    """``GatherRows`` where a group has more than one worker; the parts as
    they are otherwise."""
    if all(len(g) == 1 for g in groups):
        return list(parts)
    return list(GatherRows.apply(groups, traffic, *parts))


@torch.no_grad()
def prefix_counts(counts: Sequence[torch.Tensor], slices: Sequence[int],
                  traffic: Traffic | None = None) -> list[torch.Tensor]:
    """``counts[m]`` (integer counts on worker m's device) of batch slice
    ``slices[m]`` (the workers holding one slice hold equal counts) → each
    worker's sum of the counts of the slices before its own, in slice
    order: an all-gather of the slices' counts, then an exclusive prefix.
    ``Traffic.count_bytes`` takes the all-gather, a worker receiving the
    other slices' counts."""
    first: dict[int, int] = {}
    for m, s in enumerate(slices):
        first.setdefault(s, m)
    dev0 = counts[0].device
    run = torch.zeros_like(counts[0])
    before = {}
    for s in sorted(first):
        before[s] = run
        run = run + counts[first[s]].to(dev0)
    if traffic is not None:
        traffic.count_bytes += nbytes(counts[0]) * (len(first) - 1)
    return [copy_to(before[s], counts[m].device)
            for m, s in enumerate(slices)]


def _count_all_reduce(traffic: Traffic | None, parts, groups) -> None:
    """One all-reduce of worker 0's part over its group: a figure a
    worker (the groups are alike)."""
    g = next(g for g in groups if 0 in g)
    if traffic is not None and len(g) > 1:
        traffic.add_all_reduce(nbytes(parts[0]), len(g))
