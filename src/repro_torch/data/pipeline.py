"""Deterministic data pipelines and the out-of-core nonzero store.

Counterpart of ``repro.data.pipeline``, host numpy wherever the reference
is host numpy, so every array below is the reference's bit for bit:

``TokenPipeline`` — synthetic-corpus LM batches, a pure function of (seed,
step, shard), so a restarted run replays the same data whatever the number
of shards.

``TensorStream`` — the STD engine's Ψ picks into a fixed Ω, with the same
replay property.

``NonzeroStore`` — COO nonzeros bucketed per (stratum, worker) exactly as
``core.sptensor.partition_for_workers`` buckets them (same entry order,
same padded length), held in host memory or spilled to memory-mapped
``.npy`` files with the reference's names, dtypes and ``meta.json``: a
directory written by either package opens in the other.  ``append`` folds
arrivals in and equals a rebuild on the concatenation; growth stages
``{f}.npy.tmp`` and publishes by ``os.replace``, so a crash leaves the
pre-append store.

``StratumPrefetcher`` — a background thread that loads and places blocks
``depth`` positions ahead of use (bounded queue, in-order ``take``).  On
the card the default placement stages each block in one of ``depth + 1``
pinned host buffers, copies it with ``non_blocking=True`` on a side CUDA
stream and records an event; ``take`` makes the consumer's stream wait on
it.  On the CPU, where the caller asked for it, a plain ``.to(device)``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.core.sptensor import BlockPartition, bucket_positions
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic corpus: Zipf-ish unigram + bigram mixture so losses move
    zipf_a: float = 1.2


class TokenPipeline:
    """Deterministic synthetic LM token stream (host-side numpy)."""

    def __init__(self, cfg: TokenPipelineConfig,
                 shard: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {num_shards} shards")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        # fixed unigram distribution (vocab-sized)
        rng = np.random.default_rng(cfg.seed)
        w = rng.zipf(cfg.zipf_a, size=cfg.vocab_size * 4) % cfg.vocab_size
        hist = np.bincount(w, minlength=cfg.vocab_size).astype(np.float64)
        self.probs = hist / hist.sum()

    def batch(self, step: int) -> dict:
        """Batch for ``step`` — identical across runs / topologies."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.shard, 0xBEEF))
        toks = rng.choice(
            cfg.vocab_size, p=self.probs,
            size=(self.local_batch, cfg.seq_len + 1),
        ).astype(np.int32)
        # light bigram structure: every even position correlates w/ previous
        toks[:, 2::2] = (toks[:, 1:-1:2] * 31 + 7) % cfg.vocab_size
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }

    def global_batch(self, step: int) -> dict:
        """All shards concatenated (single-host testing)."""
        parts = [
            TokenPipeline(self.cfg, s, self.num_shards).batch(step)
            for s in range(self.num_shards)
        ]
        return {
            k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]
        }


class TensorStream:
    """Deterministic Ψ-batch stream for STD (indices into a fixed Ω)."""

    def __init__(self, nnz: int, batch_size: int, seed: int = 0,
                 shard: int = 0, num_shards: int = 1):
        self.nnz = nnz
        self.batch_size = batch_size
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards

    def picks(self, step: int) -> np.ndarray:
        """The (batch_size,) int64 picks of ``step``: a pure function of
        (seed, step, shard)."""
        rng = np.random.default_rng(
            (self.seed, step, self.shard, 0xFA57))
        return rng.integers(0, self.nnz, size=self.batch_size,
                            dtype=np.int64)


# ---------------------------------------------------------------------------
# out-of-core nonzero store (per-stratum chunks, optional mmap spill)
# ---------------------------------------------------------------------------

_STORE_META_FILE = "meta.json"
_STORE_FIELDS = ("indices", "values", "mask")
_STORE_DTYPES = {"indices": np.int32, "values": np.float32, "mask": bool}


def _source(tensor) -> tuple:
    """(indices, values, dims) of a port ``SparseTensor`` or of a host
    ``(indices, values, dims)`` triple; tensors are left where they are."""
    if isinstance(tensor, tuple):
        idx, val, dims = tensor
        idx = np.asarray(idx)
        val = np.asarray(val)
    else:
        idx, val, dims = tensor.indices, tensor.values, tensor.dims
    if idx.ndim != 2 or tuple(val.shape) != (idx.shape[0],):
        raise ValueError(f"need indices (nnz, N) and values (nnz,), got "
                         f"{tuple(idx.shape)} and {tuple(val.shape)}")
    return idx, val, tuple(int(d) for d in dims)


def _host_chunk(a, sl: slice) -> np.ndarray:
    """Rows ``sl`` of a numpy array or tensor as a host numpy array (a
    tensor on the card is copied chunk by chunk, never whole)."""
    if isinstance(a, torch.Tensor):
        return a[sl].cpu().numpy()
    return np.asarray(a[sl])


def _bucket_keys(part: BlockPartition, idx: np.ndarray) -> np.ndarray:
    s_, w_ = part.assign(idx)
    return s_ * part.num_workers + w_


def _tensor_bucket_counts(part: BlockPartition, idx: torch.Tensor,
                          chunk_nnz: int) -> np.ndarray:
    """``BlockPartition.assign``'s bucket counts of an index tensor,
    computed on its device (integer searches: the same digits as numpy's),
    so a tensor on the card is not copied to the host for them."""
    M, N = part.num_workers, part.order
    bounds = [torch.from_numpy(part.mode_boundaries(n)[1:-1]).to(idx.device)
              for n in range(N)]
    counts = torch.zeros(M ** N, dtype=torch.int64, device=idx.device)
    for lo in range(0, idx.shape[0], chunk_nnz):
        chunk = idx[lo:lo + chunk_nnz].long()
        worker = torch.searchsorted(bounds[0], chunk[:, 0].contiguous(),
                                    right=True)
        key = worker.clone()
        mult = M
        for n in range(1, N):
            digit = torch.searchsorted(bounds[n], chunk[:, n].contiguous(),
                                       right=True)
            key += ((digit - worker) % M) * mult
            mult *= M
        # key = stratum·M + worker, stratum = Σ_n s_n·M^(n−1)
        counts += torch.bincount(key, minlength=M ** N)
    return counts.cpu().numpy()


class NonzeroStore:
    """COO nonzeros sharded into per-stratum chunks.

    The layout is exactly ``core.sptensor.partition_for_workers`` of the
    M-padded tensor: ``indices (S, M, L, N)`` int32, ``values (S, M, L)``
    f32, ``mask (S, M, L)`` bool, S = M**(N-1) strata, entries in order of
    appearance within each bucket, L the padded longest bucket.
    ``stratum(s)`` hands back host arrays of one chunk; for a spilled store
    a copy read from the memmap then, so only that stratum is paged in.

    ``build`` streams the source in chunks of ``chunk_nnz``: one counting
    pass (on the tensor's device for a tensor) to size L, one scatter pass
    into the arrays, so host memory above the arrays it writes is O(chunk);
    the scatter's host digits must give the counting pass's counts.
    Each bucket's fill is kept beside the arrays, so an ``append`` reads no
    mask for it.
    """

    def __init__(self, indices, values, mask, meta: dict,
                 path: str | None = None, fill: np.ndarray | None = None):
        self.indices = indices
        self.values = values
        self.mask = mask
        self.meta = dict(meta)
        self.path = path
        self._fill = fill

    # -- properties ----------------------------------------------------------
    @property
    def num_strata(self) -> int:
        return self.indices.shape[0]

    @property
    def num_workers(self) -> int:
        return self.indices.shape[1]

    @property
    def order(self) -> int:
        return self.indices.shape[3]

    @property
    def chunk_len(self) -> int:
        return self.indices.shape[2]

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(self.meta["dims"])

    @property
    def padded_dims(self) -> tuple[int, ...]:
        return tuple(self.meta["padded_dims"])

    @property
    def nnz(self) -> int:
        return int(self.meta["nnz"])

    @property
    def spilled(self) -> bool:
        return self.path is not None

    @property
    def nbytes(self) -> int:
        """Total store size (bytes) across all chunks."""
        return sum(getattr(self, f).nbytes for f in _STORE_FIELDS)

    @property
    def stratum_nbytes(self) -> int:
        """Host bytes of ONE stratum chunk (= per-step transfer size)."""
        return self.nbytes // self.num_strata

    def fill(self) -> np.ndarray:
        """Valid entries per bucket, (S·M,) int64 (read from the mask once
        for a store that was opened, then kept)."""
        if self._fill is None:
            S, M, L = self.mask.shape
            self._fill = self.mask.reshape(S * M, L).sum(axis=1).astype(
                np.int64)
        return self._fill

    # -- access --------------------------------------------------------------
    def stratum(self, s: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host arrays (idx (M, L, N), val (M, L), msk (M, L)) of chunk s.

        A spilled store returns fresh in-memory copies, read now on the
        calling thread (the prefetcher calls this from its worker, so the
        disk read is hidden too).
        """
        idx, val, msk = self.indices[s], self.values[s], self.mask[s]
        if self.spilled:
            idx, val, msk = (np.array(idx), np.array(val), np.array(msk))
        return idx, val, msk

    def strata_block(self, ids) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Device-major block of several chunks: (M, K, L, ·) for K ids,
        assembled chunk by chunk."""
        ids = list(ids)
        K, (S, M, L, N) = len(ids), self.indices.shape
        idx = np.empty((M, K, L, N), np.int32)
        val = np.empty((M, K, L), np.float32)
        msk = np.empty((M, K, L), bool)
        for k, s in enumerate(ids):
            i, v, m = self.stratum(int(s))
            idx[:, k], val[:, k], msk[:, k] = i, v, m
        return idx, val, msk

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, tensor, num_workers: int, *, spill_dir: str | None = None,
              pad_multiple: int = 8, chunk_nnz: int = 1 << 20,
              ) -> "NonzeroStore":
        """Shard a COO tensor into per-stratum chunks.

        ``tensor`` is a port ``SparseTensor`` (on any device) or a host
        ``(indices, values, dims)`` triple.  ``spill_dir=None`` keeps the
        chunks in host memory; a directory spills them to memory-mapped
        ``.npy`` files (+ ``meta.json``) reopenable with ``open``.
        """
        M = int(num_workers)
        idx, val, dims = _source(tensor)
        padded_dims = tuple(-(-d // M) * M for d in dims)
        part = BlockPartition(padded_dims, M)
        nnz, N = int(idx.shape[0]), int(idx.shape[1])
        S = M ** (N - 1)

        # pass 1: bucket counts → global padded length L
        if isinstance(idx, torch.Tensor):
            counts = _tensor_bucket_counts(part, idx, chunk_nnz)
        else:
            counts = np.zeros(S * M, np.int64)
            for lo in range(0, nnz, chunk_nnz):
                key = _bucket_keys(part, _host_chunk(
                    idx, slice(lo, lo + chunk_nnz)))
                counts += np.bincount(key, minlength=S * M)
        L = max(1, int(counts.max()))
        L = ((L + pad_multiple - 1) // pad_multiple) * pad_multiple

        meta = {
            "dims": list(dims), "padded_dims": list(padded_dims),
            "num_workers": M, "pad_multiple": pad_multiple,
            "nnz": nnz, "chunk_len": L, "num_strata": S,
        }
        shapes = _shapes(S, M, L, N)
        if spill_dir is None:
            arrays = {f: np.zeros(shapes[f], _STORE_DTYPES[f])
                      for f in _STORE_FIELDS}
        else:
            os.makedirs(spill_dir, exist_ok=True)
            # fresh memmaps are zero-filled: padding needs no extra pass
            arrays = {f: np.lib.format.open_memmap(
                os.path.join(spill_dir, f"{f}.npy"), mode="w+",
                dtype=_STORE_DTYPES[f], shape=shapes[f])
                for f in _STORE_FIELDS}

        # pass 2: scatter entries at their running per-bucket offsets, in
        # order of appearance (== partition_for_workers)
        offsets = np.zeros(S * M, np.int64)
        for lo in range(0, nnz, chunk_nnz):
            sl = slice(lo, lo + chunk_nnz)
            _scatter(arrays, _host_chunk(idx, sl), _host_chunk(val, sl),
                     part, offsets)
        if not np.array_equal(offsets, counts):
            raise RuntimeError("NonzeroStore.build: the counting pass and "
                               "the scatter pass disagree on bucket sizes")

        if spill_dir is not None:
            for a in arrays.values():
                a.flush()
            _write_meta(spill_dir, meta)
            out = cls.open(spill_dir)
            out._fill = offsets
            return out
        return cls(arrays["indices"], arrays["values"], arrays["mask"],
                   meta, fill=offsets)

    @classmethod
    def open(cls, path: str) -> "NonzeroStore":
        """Reopen a spilled store read-only (memmapped chunks)."""
        with open(os.path.join(path, _STORE_META_FILE)) as f:
            meta = json.load(f)
        arrays = {f: np.load(os.path.join(path, f"{f}.npy"), mmap_mode="r")
                  for f in _STORE_FIELDS}
        return cls(arrays["indices"], arrays["values"], arrays["mask"],
                   meta, path=path)

    def save(self, path: str) -> "NonzeroStore":
        """Spill an in-memory store to ``path`` and reopen it memmapped."""
        os.makedirs(path, exist_ok=True)
        for f in _STORE_FIELDS:
            np.save(os.path.join(path, f"{f}.npy"), getattr(self, f))
        _write_meta(path, self.meta)
        out = NonzeroStore.open(path)
        out._fill = self._fill
        return out

    # -- online ingestion ----------------------------------------------------
    def append(self, indices, values, *, chunk_nnz: int = 1 << 20
               ) -> "NonzeroStore":
        """Fold new nonzeros into the per-(stratum, worker) buckets.

        The writer's two passes, with the offsets starting at the current
        fills, so appended entries land after the existing ones in order of
        arrival: the result is the store ``build`` gives on the
        concatenated nonzeros (the chunk length regrows, in
        ``pad_multiple`` steps, only when a bucket overflows).

        Without growth an in-memory store is patched in place and returned,
        and a spilled one rewrites its memmaps in place.  With growth an
        in-memory store reallocates; a spilled one copies stratum by
        stratum into ``{f}.npy.tmp`` files, publishes them by
        ``os.replace`` and then rewrites ``meta.json``, so the published
        files are never mutated in place on this path.  A spilled store
        returns a reopened handle; the old one keeps reading its snapshot.
        """
        if isinstance(indices, torch.Tensor):
            indices = indices.cpu().numpy()
        if isinstance(values, torch.Tensor):
            values = values.cpu().numpy()
        idx = np.ascontiguousarray(np.asarray(indices, np.int32))
        val = np.ascontiguousarray(np.asarray(values, np.float32))
        S, M, L, N = self.indices.shape
        if idx.ndim != 2 or idx.shape[1] != N:
            raise ValueError(f"indices must be (nnz, {N}), got {idx.shape}")
        if val.shape != (idx.shape[0],):
            raise ValueError(
                f"values shape {val.shape} != ({idx.shape[0]},)")
        if idx.size and ((idx < 0).any()
                         or (idx >= np.asarray(self.dims)).any()):
            raise ValueError(f"indices out of range for dims {self.dims}")
        if idx.shape[0] == 0:
            return self

        part = BlockPartition(self.padded_dims, M)
        pad = int(self.meta["pad_multiple"])
        nnz = idx.shape[0]

        # pass 1: current fills + new-entry counts → (possibly grown) L
        fill = self.fill()
        counts = np.zeros(S * M, np.int64)
        for lo in range(0, nnz, chunk_nnz):
            counts += np.bincount(_bucket_keys(part, idx[lo:lo + chunk_nnz]),
                                  minlength=S * M)
        need = int((fill + counts).max())
        L_new = L if need <= L else ((need + pad - 1) // pad) * pad

        meta = dict(self.meta)
        meta["nnz"] = self.nnz + nnz
        meta["chunk_len"] = L_new
        shapes = _shapes(S, M, L_new, N)

        if not self.spilled:
            if L_new == L:
                arrays = {f: getattr(self, f) for f in _STORE_FIELDS}
            else:
                arrays = {f: np.zeros(shapes[f], _STORE_DTYPES[f])
                          for f in _STORE_FIELDS}
                for f in _STORE_FIELDS:
                    arrays[f][:, :, :L] = getattr(self, f)
        elif L_new == L:
            arrays = {f: np.load(os.path.join(self.path, f"{f}.npy"),
                                 mmap_mode="r+")
                      for f in _STORE_FIELDS}
        else:
            arrays = {f: np.lib.format.open_memmap(
                os.path.join(self.path, f"{f}.npy.tmp"), mode="w+",
                dtype=_STORE_DTYPES[f], shape=shapes[f])
                for f in _STORE_FIELDS}
            for s in range(S):  # stratum by stratum: host memory O(chunk)
                for f in _STORE_FIELDS:
                    arrays[f][s, :, :L] = getattr(self, f)[s]

        # pass 2: the writer's stable scatter, offsets at the current fills
        offsets = fill.copy()
        for lo in range(0, nnz, chunk_nnz):
            sl = slice(lo, lo + chunk_nnz)
            _scatter(arrays, idx[sl], val[sl], part, offsets)

        if self.spilled:
            for a in arrays.values():
                a.flush()
            if L_new != L:
                for f in _STORE_FIELDS:
                    os.replace(os.path.join(self.path, f"{f}.npy.tmp"),
                               os.path.join(self.path, f"{f}.npy"))
            _write_meta(self.path, meta)
            out = NonzeroStore.open(self.path)
            out._fill = offsets
            return out
        if L_new == L:
            self.meta = meta
            self._fill = offsets
            return self
        return NonzeroStore(arrays["indices"], arrays["values"],
                            arrays["mask"], meta, fill=offsets)


def _shapes(S: int, M: int, L: int, N: int) -> dict:
    return {"indices": (S, M, L, N), "values": (S, M, L), "mask": (S, M, L)}


def _write_meta(path: str, meta: dict) -> None:
    with open(os.path.join(path, _STORE_META_FILE), "w") as f:
        json.dump(meta, f, indent=1)


def _scatter(arrays: dict, idx: np.ndarray, val: np.ndarray,
             part: BlockPartition, offsets: np.ndarray) -> None:
    """Place one host chunk at its buckets' running offsets (advanced in
    place), in order of appearance."""
    S, M, L, N = arrays["indices"].shape
    order, bucket, pos = bucket_positions(_bucket_keys(part, idx), offsets)
    arrays["indices"].reshape(S * M, L, N)[bucket, pos] = idx[order]
    arrays["values"].reshape(S * M, L)[bucket, pos] = val[order]
    arrays["mask"].reshape(S * M, L)[bucket, pos] = True


# ---------------------------------------------------------------------------
# host→device stratum prefetcher
# ---------------------------------------------------------------------------

class _PrefetchFailure:
    """Queue sentinel carrying a worker-thread exception to ``take()``."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _InFlight:
    """Device tensors whose copies were queued on a side stream, and the
    event recorded after them."""

    __slots__ = ("tensors", "event", "single")

    def __init__(self, tensors: tuple, event, single: bool):
        self.tensors, self.event, self.single = tensors, event, single

    def ready(self):
        """The tensors, once the current stream waits on the copies (and
        the allocator knows that stream uses them)."""
        stream = torch.cuda.current_stream(self.tensors[0].device)
        stream.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(stream)
        return self.tensors[0] if self.single else self.tensors


class _StagedPlacer:
    """The default ``place_fn``: a block of host arrays onto ``device``.

    On the card each array goes into one of ``slots`` reused pinned
    buffers (a slot is refilled only after the event of its last copy),
    then into a fresh device tensor by a ``non_blocking`` copy on a side
    stream; returns an ``_InFlight``.  On the CPU a plain ``.to(device)``.
    ``pinned_sets`` counts the sets of pinned buffers allocated.
    """

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.pinned_sets = 0
        self._slots: list = [None] * max(1, slots)
        self._next = 0
        self._stream = None
        self._lock = threading.Lock()

    def __call__(self, block):
        single = not isinstance(block, (tuple, list))
        arrays = [np.asarray(a) for a in ((block,) if single else block)]
        if self.device.type != "cuda":
            out = tuple(torch.tensor(a).to(self.device) for a in arrays)
            return out[0] if single else out
        with self._lock, torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            k = self._next
            self._next = (k + 1) % len(self._slots)
            slot = self._slots[k]
            if slot is not None:
                slot[1].synchronize()    # its last copy has left the buffers
            bufs = slot[0] if slot is not None else ()
            if [(b.shape, b.dtype) for b in bufs] != [
                    (torch.Size(a.shape), _torch_dtype(a.dtype))
                    for a in arrays]:
                bufs = tuple(torch.empty(a.shape, dtype=_torch_dtype(a.dtype),
                                         pin_memory=True) for a in arrays)
                self.pinned_sets += 1
            for b, a in zip(bufs, arrays):
                np.copyto(b.numpy(), a)
            with torch.cuda.stream(self._stream):
                out = tuple(torch.empty(b.shape, dtype=b.dtype,
                                        device=self.device) for b in bufs)
                for o, b in zip(out, bufs):
                    o.copy_(b, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            self._slots[k] = (bufs, event)
        return _InFlight(out, event, single)

    def release(self) -> None:
        """Drop the pinned buffers once their copies are done."""
        with self._lock:
            for slot in self._slots:
                if slot is not None:
                    slot[1].synchronize()
            self._slots = [None] * len(self._slots)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty((0,), dtype)).dtype


class StratumPrefetcher:
    """Places schedule blocks on the device ``depth`` positions ahead of use.

    ``load_fn(pos)`` returns the host arrays of schedule position ``pos``;
    ``next_pos(pos)`` gives the position consumed after ``pos``.  A
    background thread walks that sequence, calls ``place_fn`` on each block
    and parks the result in a bounded queue of ``depth``, so the host read
    (a memmap page-in) and the host→device copy of p and up to ``depth``−1
    successors happen off the critical path.  ``depth=0`` loads on demand,
    synchronously.  The default ``place_fn`` stages through ``depth + 1``
    reused pinned buffers and a side CUDA stream on ``device`` (the
    current card when None), or copies with ``.to(device)`` where
    ``device`` names the CPU.  A ``place_fn`` may return an object with a
    ``ready()`` (called by ``take``) and have a ``release()`` (called by
    ``close``), as the default's do.

    ``take(pos)`` enforces in-order consumption; a jump (a resume) re-seeds
    the walk (``reset``).  A transient load/place failure retries in place
    up to ``retries`` times on the ``runtime.fault.backoff`` schedule
    before it becomes fatal (the attempt count resets on every success);
    a fatal one is re-raised by the ``take`` that reaches its position and
    by every ``take`` after it, until ``reset``.  ``fault_plan`` injects
    failures at site ``"transfer"``, before the placement.
    """

    def __init__(self, load_fn, next_pos, *, depth: int = 2,
                 place_fn=None, start: int = 0, retries: int = 2,
                 retry_base_s: float = 0.01, retry_cap_s: float = 0.25,
                 seed: int = 0, fault_plan=None, device=None):
        self._load = load_fn
        self._next = next_pos
        self.depth = max(0, int(depth))
        self._placer = None
        if place_fn is None:
            self._placer = _StagedPlacer(resolve_device(device),
                                         self.depth + 1)
            place_fn = self._placer
        self._place = place_fn
        self.retries = max(0, int(retries))
        self._retry_base_s = float(retry_base_s)
        self._retry_cap_s = float(retry_cap_s)
        self._seed = int(seed)
        self._fault_plan = fault_plan
        self.retried = 0  # total transient failures absorbed by retries
        self._thread: threading.Thread | None = None
        self._stop: threading.Event | None = None
        self._queue: queue.Queue | None = None
        self._failure: BaseException | None = None
        self._head = start
        if self.depth:
            self._spawn(start)

    def _load_place(self, pos: int, stop: threading.Event | None = None):
        """Load + place position ``pos``, retrying transient failures.

        Shared by the background worker (``stop``-aware backoff sleeps) and
        the synchronous ``depth=0`` path.  Raises the last failure once the
        retry budget is spent or the walk is being shut down.
        """
        from repro_torch.runtime.fault import backoff

        attempt = 0
        while True:
            try:
                block = self._load(pos)
                if self._fault_plan is not None:
                    self._fault_plan.check("transfer")
                return self._place(block)
            except BaseException as e:  # noqa: BLE001 — bounded re-raise
                if attempt >= self.retries:
                    raise
                attempt += 1
                self.retried += 1
                delay = backoff(attempt - 1, base=self._retry_base_s,
                                cap=self._retry_cap_s, seed=self._seed)
                if stop is not None:
                    if stop.wait(delay):
                        raise e from None
                else:
                    time.sleep(delay)

    def _spawn(self, start: int) -> None:
        stop = threading.Event()
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        nxt = self._next

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(pos: int) -> None:
            # a failure must not just end this thread (take() would wait on
            # an empty queue for ever): _load_place retries transients, and
            # a spent budget is parked in the queue at its position
            try:
                while not stop.is_set():
                    blocks = self._load_place(pos, stop)
                    if not put((pos, blocks)):
                        return
                    pos = nxt(pos)
            except BaseException as e:  # noqa: BLE001 — forwarded, not eaten
                put((pos, _PrefetchFailure(e)))

        t = threading.Thread(target=worker, args=(start,),
                             name="stratum-prefetch", daemon=True)
        self._stop, self._queue, self._thread, self._head = stop, q, t, start
        self._failure = None
        t.start()

    @staticmethod
    def _ready(blocks):
        # an _InFlight, or a placement of its own with the same ``ready``
        ready = getattr(blocks, "ready", None)
        return ready() if ready is not None else blocks

    def take(self, pos: int, timeout: float | None = None):
        """Device blocks for schedule position ``pos`` (in-order walk).

        Re-raises any exception the background load/place hit: at the
        first take() that reaches the failed position, and at every take()
        after it (the walk is dead until ``reset``).  ``timeout`` bounds
        the wait for the worker (``TimeoutError`` past it).
        """
        if self.depth == 0:
            return self._ready(self._load_place(pos))
        if self._failure is not None:
            raise self._failure
        if pos != self._head:
            self.reset(pos)
        try:
            got, blocks = self._queue.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"stratum prefetch: position {pos} not "
                               f"placed within {timeout}s") from None
        if isinstance(blocks, _PrefetchFailure):
            self._failure = RuntimeError(
                f"stratum prefetch worker failed loading position {got}")
            self._failure.__cause__ = blocks.exc
            raise self._failure
        if got != pos:
            raise RuntimeError(f"prefetch walk desync: got {got}, want {pos}")
        self._head = self._next(pos)
        return self._ready(blocks)

    def reset(self, pos: int) -> None:
        """Re-seed the walk at ``pos`` (after a resume/restore jump)."""
        self._halt()
        self._failure = None
        if self.depth:
            self._spawn(pos)
        else:
            self._head = pos

    def _halt(self) -> None:
        if self._thread is not None:
            self._stop.set()
            # unblock a worker stuck in put()
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None

    def close(self) -> None:
        """Stop the worker and drop the pinned buffers; idempotent."""
        self._halt()
        release = getattr(self._place, "release", None)
        if release is not None:
            release()

    def __del__(self):  # best-effort; the thread is a daemon anyway
        try:
            self.close()
        except Exception:
            pass
