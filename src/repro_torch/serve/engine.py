"""Batched FastTucker inference engine over trained (factors, core_factors).

Counterpart of ``repro.serve.engine`` on one device.  The engine caches the
per-mode Kruskal products

    C^(n) = A^(n) B^(n) ∈ R^{I_n × R}          (all mode dots, precomputed)

and serves every query class from them without materializing the dense
tensor:

    predict            x̂(i_1..i_N) = Σ_r Π_n C^(n)[i_n, r]
    reconstruct_rows   one factored einsum over the C^(n) → requested slices
    top_k              scores = (C^(m)[ids] ⊙ Π_other σ^(k)) C^(t)ᵀ, σ^(k)
                       the column sums marginalizing unpinned modes

``predict`` goes through ``core.fasttucker.predict`` on the synthetic
parameters ``(factors=C^(n), core_factors=I_R)`` — mode dots of rows of C
against the identity ARE the cached coefficients — so on the ``"cuda"``
backend every bucket chunk is one launch of the ``kruskal_contract`` kernel
(``pred`` alone) at J = R = the table rank, under ``torch.inference_mode``.
The kernel takes R ≤ 64: a wider table is refused at construction with the
kernel's ``ValueError``.  ``top_k``'s scores are one ``torch.matmul`` (the
reference's ``jnp.matmul``, outside any Pallas kernel) and its ties break
by ascending id, as ``lax.top_k``'s do (a stable descending sort);
``reconstruct_rows`` is ``torch.einsum``.

Requests are padded onto the bucket ladder (``serve.bucketing``) and
chunked above its top, so an answer does not depend on the request's size
within a bucket.  The serving state is one ``_TableSet`` generation,
swapped by a single attribute assignment: every query snapshots it once,
and ``update_rows`` / ``refresh_tables`` build the next generation in
fresh tensors (a patch clones the table and writes the clone), so a query
in flight finishes on the generation it started with.

The tables are built and patched by ``core.kruskal.mode_product_rows``,
whose per-element arithmetic does not depend on the row count, so a
patched table equals a rebuilt one bit for bit on the CPU and on the
card.  The reference pads a patch to a power of two to bound its jit
cache; the port has none and patches the dirty rows as they are.

Not ported: sharded serving (``mesh=``, ``shard_mode``, ``expected_qps``,
``policy``) waits for the multi-device strategies (ROADMAP.md, Queue 1
item 4); ``mesh=`` raises ``NotImplementedError``.  ``donate=`` and
``predict_cache_size`` have no PyTorch meaning.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, from_host
from repro_torch.core.fasttucker import DTYPES, FastTuckerParams
from repro_torch.core.fasttucker import predict as ft_predict
from repro_torch.core.kruskal import mode_product_rows, mode_products
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.kernels.kruskal_contract import check_widths

from .bucketing import (
    DEFAULT_MAX_BUCKET, DEFAULT_MIN_BUCKET, bucket_ladder, split_batch,
)

_LETTERS = "abcdefghijklmnop"
# leaf names of factor matrices in a checkpoint tree: ``params.factors.0``
# (DistState, TrainState) or ``factors.0`` (bare params), likewise
# ``core_factors``
_FACTOR_LEAF = re.compile(r"(?:^|\.)(core_factors|factors)\.(\d+)$")


class _TableSet(NamedTuple):
    """One immutable generation of serving state, swapped atomically."""

    version: int       # monotone generation counter
    tables: tuple      # C^(n), table_dtype storage
    colsums: tuple     # f32 column sums of the rows, per mode


# ---------------------------------------------------------------------------
# checkpoint → params
# ---------------------------------------------------------------------------

def load_params_from_checkpoint(
    directory, step: int | None = None,
    dims: Sequence[int] | None = None,
    device: str | torch.device | None = None,
) -> tuple[FastTuckerParams, int]:
    """Recover (factors, core_factors) from a ``checkpoint.manager`` dir.

    Works for every tree the port's trainers write (``DistState`` with its
    ``rng`` and ``ef`` leaves, ``TrainState``, bare params): the leaves
    named ``…factors.<n>`` and ``…core_factors.<n>`` are the parameters, in
    their stored dtype (f32 or bf16), placed on ``device`` (default: the
    current card).  Shapes are cross-checked (``B^(n)`` rows must equal
    ``A^(n)`` cols, one shared R).  ``dims`` trims factor rows to the true
    mode sizes.
    """
    manifest, leaves = CheckpointManager(directory).load_leaves(step)
    found: dict[str, dict[int, torch.Tensor]] = {"factors": {},
                                                 "core_factors": {}}
    for spec, a in zip(manifest["leaves"], leaves):
        m = _FACTOR_LEAF.search(spec["name"])
        if m and a.ndim == 2:
            found[m.group(1)][int(m.group(2))] = from_host(a, spec["dtype"])
    N = len(found["factors"])
    if (N < 2 or sorted(found["factors"]) != list(range(N))
            or sorted(found["core_factors"]) != list(range(N))):
        raise ValueError(
            f"checkpoint in {directory} does not look like FastTucker "
            f"state: factor leaves {sorted(found['factors'])}, core factor "
            f"leaves {sorted(found['core_factors'])} (want 0..N-1, N ≥ 2)")
    factors = [found["factors"][n] for n in range(N)]
    core_factors = [found["core_factors"][n] for n in range(N)]
    R = core_factors[0].shape[1]
    for n in range(N):
        if (core_factors[n].shape[0] != factors[n].shape[1]
                or core_factors[n].shape[1] != R):
            raise ValueError(
                f"checkpoint leaf shapes inconsistent at mode {n}: "
                f"A{tuple(factors[n].shape)} vs B{tuple(core_factors[n].shape)}"
                f" (R={R})")
    if dims is not None:
        if len(dims) != N:
            raise ValueError(f"dims has {len(dims)} modes, checkpoint {N}")
        for n, d in enumerate(dims):
            if d > factors[n].shape[0]:
                raise ValueError(
                    f"dims[{n}]={d} exceeds checkpointed rows "
                    f"{factors[n].shape[0]}")
        factors = [f[:d] for f, d in zip(factors, dims)]
    device = resolve_device(device)
    return (
        FastTuckerParams(tuple(f.contiguous().to(device) for f in factors),
                         tuple(b.to(device) for b in core_factors)),
        int(manifest["step"]),
    )


# ---------------------------------------------------------------------------
# query bodies
# ---------------------------------------------------------------------------

def _reconstruct_impl(tables, ids: torch.Tensor, mode: int) -> torch.Tensor:
    """Factored slice reconstruction: (B, *dims except mode), f32."""
    operands, subs = [tables[mode].index_select(0, ids).float()], ["zr"]
    out = "z"
    for n, t in enumerate(tables):
        if n == mode:
            continue
        operands.append(t.float())
        subs.append(f"{_LETTERS[n]}r")
        out += _LETTERS[n]
    return torch.einsum(",".join(subs) + "->" + out, *operands)


def _top_k_impl(tables, colsums, ids: torch.Tensor, mode: int, target: int,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores, item ids): rank ``target``-mode entries for each ``ids`` row,
    the other modes marginalized by their f32 column sums.  Ties break by
    ascending id (a stable descending sort), as ``lax.top_k``'s do."""
    w = tables[mode].index_select(0, ids).float()
    for n in range(len(tables)):
        if n not in (mode, target):
            w = w * colsums[n]
    scores = torch.matmul(w, tables[target].float().T)   # (B, I_target)
    values, items = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], items[:, :k].to(torch.int32)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class TuckerServer:
    """Batched query engine over one trained FastTucker model.

    Parameters
    ----------
    params : FastTuckerParams
        Trained ``(A^(n), B^(n))`` in the global layout, e.g.
        ``strategy.eval_params(...)`` or ``load_params_from_checkpoint``.
        The server serves on their device and never writes into them.
    backend : str | None
        Kernel backend for ``predict`` (``"cuda"`` | ``"torch"``; default
        ``$REPRO_TORCH_KERNEL_BACKEND`` then ``"cuda"``).
    mesh
        Not ported: raises ``NotImplementedError``.
    max_bucket / min_bucket : int
        Request bucket ladder bounds (``serve.bucketing``).
    table_dtype : str | None
        Storage dtype of the cached C^(n) tables (and the identity core
        factors): ``None`` keeps the params' dtype, or ``"float32"`` /
        ``"bfloat16"``.  The tables are computed in f32 and only stored
        rounded; every query accumulates in f32.
    """

    def __init__(
        self,
        params: FastTuckerParams,
        *,
        backend: str | None = None,
        mesh=None,
        max_bucket: int = DEFAULT_MAX_BUCKET,
        min_bucket: int = DEFAULT_MIN_BUCKET,
        table_dtype: str | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "sharded serving (mesh=) is not ported yet (ROADMAP.md, "
                "Queue 1 item 4)")
        self.backend = dispatch.resolve_backend_name(backend)
        dispatch.get_backend(self.backend)        # fail fast on typos
        N = len(params.factors)
        if N < 2 or len(params.core_factors) != N:
            raise ValueError(f"need ≥2 modes with matching core factors, "
                             f"got {N}/{len(params.core_factors)}")
        R = params.core_factors[0].shape[1]
        for n in range(N):
            if (params.factors[n].shape[1] != params.core_factors[n].shape[0]
                    or params.core_factors[n].shape[1] != R):
                raise ValueError(
                    f"mode {n}: A{tuple(params.factors[n].shape)} "
                    f"incompatible with B{tuple(params.core_factors[n].shape)}")
        if self.backend == "cuda":
            # the tables are served as rows of width R against I_R
            check_widths(N, R, R)
        if table_dtype is not None and table_dtype not in DTYPES:
            raise ValueError(f"table_dtype must be one of {tuple(DTYPES)}, "
                             f"got {table_dtype!r}")
        self.device = params.factors[0].device
        self.dims = tuple(int(f.shape[0]) for f in params.factors)
        self.order = N
        self.core_rank = int(R)
        self.ladder = bucket_ladder(max_bucket, min_bucket)
        self.table_dtype = (DTYPES[table_dtype] if table_dtype is not None
                            else params.factors[0].dtype)
        self._core = tuple(params.core_factors)
        self._params = FastTuckerParams(tuple(params.factors), self._core)
        # writable mirror of the factor matrices: ``update_rows`` writes
        # the dirty rows in place (O(dirty) a call), and ``params``
        # re-materializes a copy only when read after an update
        self._factors = [f.detach().clone() for f in params.factors]
        self._params_stale = False
        self._eyes = tuple(torch.eye(R, dtype=self.table_dtype,
                                     device=self.device) for _ in range(N))
        # generation 0: queries snapshot self._live, swaps replace it whole
        self._live = self._build(self._params, 0)

    @classmethod
    def from_checkpoint(cls, directory, step: int | None = None,
                        dims: Sequence[int] | None = None,
                        device: str | torch.device | None = None, **kw
                        ) -> "TuckerServer":
        """Load the latest (or ``step``) committed checkpoint and serve it."""
        params, _ = load_params_from_checkpoint(directory, step, dims, device)
        return cls(params, **kw)

    # -- queries --------------------------------------------------------------

    def predict(self, indices) -> torch.Tensor:
        """Batched x̂ for (i_1..i_N) tuples: (B, N) ints on the host (numpy,
        a list or a CPU tensor) → (B,) f32 on the server's device.  One
        ``kruskal_contract`` launch per bucket chunk on the ``"cuda"``
        backend."""
        indices = np.asarray(indices, np.int32)
        if indices.ndim != 2 or indices.shape[1] != self.order:
            raise ValueError(
                f"indices must be (B, {self.order}), got {indices.shape}")
        if len(indices) and ((indices < 0).any()
                             or (indices >= np.asarray(self.dims)).any()):
            raise ValueError(f"indices out of range for dims {self.dims}")
        return self._predict_from(self._live, indices)

    def _predict_from(self, live: _TableSet, indices: np.ndarray
                      ) -> torch.Tensor:
        """``predict`` of checked indices against one generation."""
        if len(indices) == 0:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        params = FastTuckerParams(live.tables, self._eyes)
        outs = []
        with torch.inference_mode():
            for chunk, n in self._bucketed_chunks(indices):
                idx = torch.tensor(chunk, device=self.device)
                pred = ft_predict(params, idx, self.backend)
                outs.append(pred if n == len(chunk) else pred[:n])
            return outs[0] if len(outs) == 1 else torch.cat(outs)

    def reconstruct_rows(self, mode: int, ids) -> torch.Tensor:
        """Factored reconstruction of whole mode-``mode`` slices:
        (len(ids), *dims without ``mode``), f32.  For small slice counts;
        the dense tensor itself is never formed."""
        mode = self._check_mode(mode)
        ids = self._check_ids(ids, mode)
        if len(ids) == 0:
            other = tuple(d for n, d in enumerate(self.dims) if n != mode)
            return torch.zeros((0,) + other, dtype=torch.float32,
                               device=self.device)
        live = self._live         # one snapshot: all chunks, one generation
        with torch.inference_mode():
            outs = [_reconstruct_impl(live.tables, self._ids(chunk),
                                      mode)[:n]
                    for chunk, n in self._bucketed_chunks(ids)]
            return outs[0] if len(outs) == 1 else torch.cat(outs)

    def top_k(self, mode: int, ids, k: int, target_mode: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k recommendation: for each entity ``ids`` of ``mode``, the
        ``k`` highest-scoring entries of ``target_mode`` (default: the next
        mode), the remaining modes marginalized (summed) through the cached
        column sums.  Returns (scores (B, k) f32, item ids (B, k) int32);
        equal scores come in ascending id."""
        mode = self._check_mode(mode)
        target = ((mode + 1) % self.order if target_mode is None
                  else self._check_mode(target_mode))
        if target == mode:
            raise ValueError(f"target_mode must differ from mode {mode}")
        if not 1 <= k <= self.dims[target]:
            raise ValueError(f"k={k} outside 1..{self.dims[target]}")
        ids = self._check_ids(ids, mode)
        if len(ids) == 0:
            return (torch.zeros((0, k), dtype=torch.float32,
                                device=self.device),
                    torch.zeros((0, k), dtype=torch.int32,
                                device=self.device))
        live = self._live         # one snapshot: all chunks, one generation
        scores, items = [], []
        with torch.inference_mode():
            for chunk, n in self._bucketed_chunks(ids):
                s, i = _top_k_impl(live.tables, live.colsums,
                                   self._ids(chunk), mode, target, k)
                scores.append(s[:n])
                items.append(i[:n])
            if len(scores) == 1:
                return scores[0], items[0]
            return torch.cat(scores), torch.cat(items)

    # -- online refresh (delta patch + versioned swap) ------------------------

    @property
    def params(self) -> FastTuckerParams:
        """The model currently served (factors kept current by
        ``update_rows`` / ``sync_factor_rows``; a copy is made only on the
        first read after an update)."""
        if self._params_stale:
            self._params = FastTuckerParams(
                tuple(f.clone() for f in self._factors), self._core)
            self._params_stale = False
        return self._params

    @property
    def table_version(self) -> int:
        """Monotone table-generation counter, bumped by every swap."""
        return self._live.version

    @property
    def _tables(self) -> tuple:
        return self._live.tables

    @property
    def _colsums(self) -> tuple:
        return self._live.colsums

    def update_rows(self, mode: int, ids, factor_rows) -> int:
        """Patch the serving tables for changed factor rows of one mode.

        Recomputes ONLY the dirty rows of C^(mode) = A^(mode) B^(mode)
        through ``mode_product_rows`` (f32, rounded once to
        ``table_dtype``), so the patched table is bitwise what a full
        rebuild from the updated params stores; updates the f32 column
        sums incrementally (subtract the old rows, add the new); and
        publishes a new generation with one ``_live`` swap.  The patch
        writes into a clone of the table, never into the live one.

        ``ids`` are unique row ids of ``mode`` (duplicates raise) and
        ``factor_rows`` the matching ``(len(ids), J_mode)`` rows of the
        updated A^(mode) (numpy or a tensor).  Returns the new
        ``table_version`` (unchanged if ``ids`` is empty).
        """
        mode = self._check_mode(mode)
        ids, rows = self._check_rows(mode, ids, factor_rows, "update_rows")
        if len(ids) == 0:
            return self.table_version
        live = self._live
        with torch.no_grad():
            idx = self._ids(ids)
            mirror = self._factors[mode]
            core = self._core[mode]
            old32 = mode_product_rows(mirror.index_select(0, idx), core)
            new32 = mode_product_rows(rows, core)
            colsum = live.colsums[mode] + (new32 - old32).sum(0)
            table = live.tables[mode].clone()
            table.index_copy_(0, idx, new32.to(table.dtype))
            mirror.index_copy_(0, idx, rows)
        self._params_stale = True
        tables = list(live.tables)
        tables[mode] = table
        colsums = list(live.colsums)
        colsums[mode] = colsum
        self._live = _TableSet(live.version + 1, tuple(tables),
                               tuple(colsums))
        return self._live.version

    def sync_factor_rows(self, mode: int, ids, factor_rows) -> None:
        """Write changed factor rows into ``self.params`` WITHOUT
        publishing a table generation (the refresh supervisor's rebuild
        escalation: the rows reach the model, then one ``refresh_tables``
        publishes everything).  The same checks as ``update_rows``."""
        mode = self._check_mode(mode)
        ids, rows = self._check_rows(mode, ids, factor_rows,
                                     "sync_factor_rows")
        if len(ids) == 0:
            return
        with torch.no_grad():
            self._factors[mode].index_copy_(0, self._ids(ids), rows)
        self._params_stale = True

    def refresh_tables(self) -> int:
        """Full-table rebuild from the current ``self.params`` + swap;
        returns the new version."""
        self._live = self._build(self.params, self._live.version + 1)
        return self._live.version

    # -- internals ------------------------------------------------------------

    def _build(self, params: FastTuckerParams, version: int) -> _TableSet:
        """A generation computed from scratch: f32 tables, their f32
        column sums, the tables stored in ``table_dtype``."""
        with torch.no_grad():
            tables32 = mode_products(params.factors, params.core_factors)
            colsums = tuple(t.sum(dim=0) for t in tables32)
            tables = tuple(t.to(self.table_dtype) for t in tables32)
        return _TableSet(version, tables, colsums)

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        """Checked host ids → an int64 index tensor on the device (a
        synchronous copy: the host buffer may be reused at once)."""
        return torch.tensor(ids, dtype=torch.int64, device=self.device)

    def _check_mode(self, mode: int) -> int:
        mode = int(mode)
        if not 0 <= mode < self.order:
            raise ValueError(f"mode {mode} outside 0..{self.order - 1}")
        return mode

    def _check_ids(self, ids, mode: int, *, grow_hint: bool = False
                   ) -> np.ndarray:
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        if ids.ndim != 1:
            raise ValueError(f"ids must be 1-D, got shape {ids.shape}")
        if ids.size and (ids.min() < 0 or ids.max() >= self.dims[mode]):
            bad = ids[(ids < 0) | (ids >= self.dims[mode])]
            msg = (f"ids out of range for mode {mode}: id {int(bad[0])} "
                   f"vs built dim I={self.dims[mode]}")
            if grow_hint:
                msg += (" — online dim growth is not supported: the serving"
                        " tables are built at fixed mode sizes, so new"
                        " entities need a server rebuild from params with"
                        " the grown factor (see ROADMAP 'dim growth')")
            raise ValueError(msg)
        return ids

    def _check_rows(self, mode: int, ids, factor_rows, what: str
                    ) -> tuple[np.ndarray, torch.Tensor]:
        """Checked (ids, rows in the factor's dtype on the device)."""
        ids = self._check_ids(ids, mode, grow_hint=True)
        # duplicates by a sort: numpy 2.3's np.unique hashes integers,
        # which took most of an update_rows call for a refresh's dirty
        # rows on the GPU machine's host (as data/synthetic.py notes)
        s = np.sort(ids)
        dups = int(np.count_nonzero(s[1:] == s[:-1]))
        if dups:
            raise ValueError(f"{what} ids must be unique, got {dups} "
                             "duplicates")
        mirror = self._factors[mode]
        if isinstance(factor_rows, torch.Tensor):
            rows = factor_rows.detach().to(self.device, mirror.dtype)
        else:
            rows = torch.tensor(np.asarray(factor_rows, np.float32),
                                device=self.device).to(mirror.dtype)
        J = int(mirror.shape[1])
        if tuple(rows.shape) != (len(ids), J):
            raise ValueError(f"factor_rows must be {(len(ids), J)}, "
                             f"got {tuple(rows.shape)}")
        return ids, rows

    def _bucketed_chunks(self, arr: np.ndarray):
        """Yield (zero-padded chunk, true length) over the bucket ladder —
        the one chunk/pad policy every query path uses.  Pads along axis 0
        (index-0 rows), any trailing shape."""
        for start, bucket in split_batch(len(arr), self.ladder):
            n = min(bucket, len(arr) - start)
            if n == bucket:
                yield arr[start:start + n], n
            else:
                padded = np.zeros((bucket,) + arr.shape[1:], arr.dtype)
                padded[:n] = arr[start:start + n]
                yield padded, n
