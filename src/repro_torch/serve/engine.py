"""Batched FastTucker inference engine over trained (factors, core_factors).

Counterpart of ``repro.serve.engine``.  The engine caches the
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

The tables are built by the backend's ``mode_product_rows`` and patched
by its ``patch_table_rows`` (on ``"cuda"`` the kernels of
``kernels/mode_product_rows.py``: one launch a mode for a build, one C call
for a patch; on ``"torch"`` the plain ``core.kruskal.mode_product_rows``).
Their per-element arithmetic does not depend on the row count, so a
patched table equals a rebuilt one bit for bit on the CPU and on the card.
The reference pads a patch to a power of two to bound its jit cache; the
port has none and patches the dirty rows as they are.

Sharded serving (``mesh=``, a ``launch.mesh.Mesh`` of in-process workers)
comes in two layouts behind the same API, chosen by ``shard_mode``
(``serve.policy`` decides under ``"auto"``):

  * ``"row"`` — worker m of the mesh's ``data`` axis holds rows
    [m·b, (m+1)·b) of every table and of the factors (b = ⌈I/M⌉, zero
    padded: the strata layout), and queries run shard-local programs whose
    copies between workers are small and explicit
    (``distributed.collectives``): ``predict`` gathers each mode's query
    rows from their owners to worker 0 and runs one ``kruskal_contract``
    a bucket chunk there; ``top_k`` scores each worker's own block and
    all-gathers its best min(k, b) (score, global id) candidates for one
    final stable sort; ``reconstruct_rows`` splits the output over the
    largest free mode.  ``update_rows`` patches on each worker holding
    dirty rows, ``refresh_tables`` rebuilds each block where it lives.
  * ``"batch"`` — every worker holds a replica of the tables and factors;
    the bucket ladder is rounded up to multiples of M and each bucket
    chunk splits into M slices, one a worker, with no copy between workers
    but the answers.  A patch or rebuild runs on every replica (the same
    bits on each).

Every sharded answer is the unsharded server's: ``predict`` bitwise (the
gather copies rows, and a sample's contraction does not depend on its
bucket), ``top_k`` and ``reconstruct_rows`` within f32 rounding (a row
block's matmul or einsum, and in row mode colsums summed by block).  The
bytes each entry point copies between workers are counted in
``self.traffic``.  ``donate=`` and ``predict_cache_size`` have no PyTorch
meaning.
"""
from __future__ import annotations

import collections
import re
import threading
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, from_host
from repro_torch.core.fasttucker import (DTYPES, FastTuckerParams,
                                         _predict_from_rows)
from repro_torch.core.fasttucker import predict as ft_predict
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import (all_gather, broadcast,
                                                 copy_to, gather_rows,
                                                 nbytes)
from repro_torch.kernels import dispatch
from repro_torch.kernels.kruskal_contract import check_widths
from repro_torch.launch.mesh import Mesh

from .bucketing import (
    DEFAULT_MAX_BUCKET, DEFAULT_MIN_BUCKET, bucket_ladder, split_batch,
)
from .policy import ShardDecision, ShardPolicy, choose_shard_mode

_LETTERS = "abcdefghijklmnop"
# leaf names of factor matrices in a checkpoint tree: ``params.factors.0``
# (DistState, TrainState) or ``factors.0`` (bare params), likewise
# ``core_factors``
_FACTOR_LEAF = re.compile(r"(?:^|\.)(core_factors|factors)\.(\d+)$")


class _TableSet(NamedTuple):
    """One immutable generation of serving state, swapped atomically."""

    version: int       # monotone generation counter
    tables: tuple      # per mode: C^(n) in table_dtype storage, or (mesh=)
                       # a tuple of the M workers' row blocks / replicas
    colsums: tuple     # per mode: f32 column sums of the true rows, on
                       # the answering device
    worker_colsums: tuple = ()   # batch mode: worker m's per-mode colsums
                                 # on its device (the bits of ``colsums``)


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
        The server serves on their device (with ``mesh=``, on its
        workers' devices) and never writes into them.
    backend : str | None
        Kernel backend for ``predict`` and the tables (``"cuda"`` |
        ``"torch"``; default ``$REPRO_TORCH_KERNEL_BACKEND`` then
        ``"cuda"``).
    mesh : launch.mesh.Mesh | None
        Serve the C^(n) tables over the mesh's ``data`` workers in the
        layout ``shard_mode`` selects; queries are answered on the first
        worker's device.
    shard_mode : str
        ``"row"`` (tables row-sharded, shard-local query programs),
        ``"batch"`` (tables replicated, request batches split over the
        workers) or ``"auto"`` (``serve.policy`` decides from table bytes
        × ``expected_qps``; the decision is kept on
        ``self.shard_decision``).  Ignored without ``mesh``, except that
        asking for a sharded mode then raises.
    expected_qps : float | None
        Declared query rate, read by the ``"auto"`` policy only.
    policy : ShardPolicy | None
        Threshold overrides for the ``"auto"`` decision.
    max_bucket / min_bucket : int
        Request bucket ladder bounds (``serve.bucketing``); a
        batch-sharded server rounds every bucket up to a multiple of the
        worker count.
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
        shard_mode: str = "auto",
        expected_qps: float | None = None,
        policy: ShardPolicy | None = None,
        max_bucket: int = DEFAULT_MAX_BUCKET,
        min_bucket: int = DEFAULT_MIN_BUCKET,
        table_dtype: str | None = None,
    ):
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
        self._params_stale = False
        # bytes each entry point copied between the mesh's workers (the
        # collectives' count; 0 without a mesh); queries and the refresh
        # supervisor add to it from their own threads
        self.traffic: collections.Counter = collections.Counter()
        self._traffic_lock = threading.Lock()

        # ---- sharded-mode resolution (explicit, never silent) -------------
        self.mesh = mesh
        self.shard_decision: ShardDecision | None = None
        if mesh is None:
            if shard_mode in ("row", "batch"):
                raise ValueError(
                    f"shard_mode={shard_mode!r} requires mesh=")
            self.shard_mode = "none"
        else:
            if "data" not in mesh.axis_names:
                raise ValueError(
                    f"serving mesh needs a 'data' axis, got {mesh.axis_names}")
            M = mesh.shape[mesh.axis_names.index("data")]
            if shard_mode == "auto":
                itemsize = torch.empty((), dtype=self.table_dtype) \
                    .element_size()
                self.shard_decision = choose_shard_mode(
                    sum(d * R * itemsize for d in self.dims), M,
                    expected_qps, policy)
                self.shard_mode = self.shard_decision.mode
            elif shard_mode in ("row", "batch"):
                self.shard_mode = shard_mode
            else:
                raise ValueError(
                    f"unknown shard_mode {shard_mode!r} "
                    "(want 'auto' | 'row' | 'batch')")

        if self.shard_mode == "none":
            self._block_rows = None
            # writable mirror of the factor matrices: ``update_rows`` writes
            # the dirty rows in place (O(dirty) a call), and ``params``
            # re-materializes a copy only when read after an update
            self._factors = [f.detach().clone() for f in params.factors]
            self._eyes = tuple(torch.eye(R, dtype=self.table_dtype,
                                         device=self.device)
                               for _ in range(N))
            # generation 0: queries snapshot self._live, swaps replace it
            self._live = self._build(self._params, 0)
            return

        # the data workers: model index 0 of each data row (the mesh is
        # laid out data-major), as a mesh of their own for the collectives
        mp = mesh.size // M
        self._workers = Mesh(tuple(mesh.devices[::mp]), (M, 1))
        self._M = M
        self.device = self._workers.devices[0]
        if self.shard_mode == "row":
            # worker m holds rows [m·b, (m+1)·b) of each table (b = ⌈I/M⌉,
            # the strata layout); the rows past I are zero padding
            self._block_rows = tuple(-(-d // M) for d in self.dims)
            self._spans = tuple(
                tuple((min(m * b, d), min((m + 1) * b, d)) for m in range(M))
                for d, b in zip(self.dims, self._block_rows))
        else:
            # every worker a replica; every bucket splits evenly over the
            # workers: round the ladder up to multiples of M
            self._block_rows = None
            self._spans = tuple(((0, d),) * M for d in self.dims)
            self.ladder = tuple(sorted({-(-b // M) * M for b in self.ladder}))
        devs = self._workers.devices
        # each worker's factor rows (its block, or a replica) are the
        # mirror its table patches read and write; the core factors and
        # the identity are read-only, shared where the devices agree
        self._factors = [tuple(self._place(f.detach(), n, m)
                               for m in range(M))
                         for n, f in enumerate(params.factors)]
        self._cores = tuple(tuple(c.to(d) for c in self._core) for d in devs)
        self._worker_eyes = tuple(
            tuple(torch.eye(R, dtype=self.table_dtype, device=d)
                  for _ in range(N)) for d in devs)
        self._eyes = self._worker_eyes[0]
        self._live = self._build_sharded(0)

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
        backend (row mode: after the row-owner gather of each mode's
        rows; batch mode: one a worker's slice of the chunk)."""
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
                if self.shard_mode == "row":
                    pred = self._row_predict(live, chunk)
                elif self.shard_mode == "batch":
                    pred = self._batch_predict(live, chunk)
                else:
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
            if self.shard_mode == "row":
                outs = [self._row_reconstruct(live, chunk, mode)[:n]
                        for chunk, n in self._bucketed_chunks(ids)]
            elif self.shard_mode == "batch":
                outs = [self._split(
                    live, chunk,
                    lambda m, tables, cols, idx: _reconstruct_impl(
                        tables, idx, mode))[:n]
                    for chunk, n in self._bucketed_chunks(ids)]
            else:
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
                if self.shard_mode == "row":
                    s, i = self._row_top_k(live, chunk, mode, target, k)
                elif self.shard_mode == "batch":
                    s, i = self._split(
                        live, chunk,
                        lambda m, tables, cols, idx: _top_k_impl(
                            tables, cols, idx, mode, target, k))
                else:
                    s, i = _top_k_impl(live.tables, live.colsums,
                                       self._ids(chunk), mode, target, k)
                scores.append(s[:n])
                items.append(i[:n])
            if len(scores) == 1:
                return scores[0], items[0]
            return torch.cat(scores), torch.cat(items)

    # -- row-sharded query bodies: shard-local work + small copies ------------

    def _row_predict(self, live: _TableSet, chunk: np.ndarray
                     ) -> torch.Tensor:
        """Each mode's query rows copied from their owners to worker 0,
        then one contraction there against I_R: the unsharded bits."""
        rows, moved = [], 0
        for n in range(self.order):
            r, b = gather_rows(live.tables[n], chunk[:, n],
                               self._block_rows[n], self._workers)
            rows.append(r)
            moved += b
        self._count("predict", moved)
        return _predict_from_rows(rows, self._eyes, self.backend)

    def _row_query_weights(self, live: _TableSet, chunk: np.ndarray,
                           mode: int, target: int
                           ) -> tuple[list[torch.Tensor], int]:
        """top_k's query rows of ``mode``, gathered from their owners,
        scaled by the marginalized modes' colsums on worker 0 and copied
        to every worker: (each worker's (B, R) f32 copy, bytes moved)."""
        w, moved = gather_rows(live.tables[mode], chunk,
                               self._block_rows[mode], self._workers)
        w = w.float()
        for n in range(self.order):
            if n not in (mode, target):
                w = w * live.colsums[n]
        ws, b = broadcast(w, self._workers, self._M)
        return ws, moved + b

    def _row_top_k(self, live: _TableSet, chunk: np.ndarray, mode: int,
                   target: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Shard-local top-k merge: gather the query rows, scale them by
        the marginalized modes' colsums and hand them to every worker;
        each scores ONLY its block of C^(target) and keeps its best
        min(k, block rows) by a stable descending sort; the (score,
        global id) candidates are all-gathered in worker order and one
        final stable sort takes the top k.  Among equal scores the
        candidates stand in ascending global id (worker-major, ascending
        within a worker), so ties break as the unsharded sort breaks
        them.  Rows past the true dim score −inf and never win."""
        ws, moved = self._row_query_weights(live, chunk, mode, target)
        tb, dim = self._block_rows[target], self.dims[target]
        k_loc = min(k, tb)
        cand_s, cand_i = [], []
        for m, block in enumerate(live.tables[target]):
            scores = torch.matmul(ws[m], block.float().T)      # (B, tb)
            valid = dim - m * tb
            if valid < tb:
                scores[:, max(valid, 0):] = float("-inf")
            vals, idx = torch.sort(scores, dim=1, descending=True,
                                   stable=True)
            cand_s.append(vals[:, :k_loc])
            cand_i.append(idx[:, :k_loc].to(torch.int32) + m * tb)
        cs, b1 = all_gather(cand_s, self._workers, dim=1)
        ci, b2 = all_gather(cand_i, self._workers, dim=1)
        self._count("top_k", moved + b1 + b2)
        vals, j = torch.sort(cs, dim=1, descending=True, stable=True)
        return vals[:, :k], torch.gather(ci, 1, j[:, :k])

    def _row_reconstruct(self, live: _TableSet, chunk: np.ndarray,
                         mode: int) -> torch.Tensor:
        """Each worker computes the output block owned by its rows of the
        LARGEST free mode; the query rows and the smaller free modes'
        tables are copied to every worker, the blocks all-gathered along
        that mode's axis and its padding trimmed."""
        others = [n for n in range(self.order) if n != mode]
        n1 = max(others, key=lambda n: self.dims[n])
        pos = 1 + others.index(n1)
        w, moved = gather_rows(live.tables[mode], chunk,
                               self._block_rows[mode], self._workers)
        ws, b = broadcast(w, self._workers, self._M)
        moved += b
        blocks = []
        for m in range(self._M):
            operands, subs, out = [ws[m].float()], ["zr"], "z"
            for n in others:
                if n == n1:
                    t = live.tables[n][m]
                else:
                    t, b = all_gather(live.tables[n], self._workers, dst=m)
                    moved += b
                    t = t[: self.dims[n]]
                operands.append(t.float())
                subs.append(f"{_LETTERS[n]}r")
                out += _LETTERS[n]
            blocks.append(torch.einsum(",".join(subs) + "->" + out,
                                       *operands))
        full, b = all_gather(blocks, self._workers, dim=pos)
        self._count("reconstruct_rows", moved + b)
        return full.narrow(pos, 0, self.dims[n1])

    # -- batch-sharded query body: replicated tables, split batches ----------

    def _split(self, live: _TableSet, chunk: np.ndarray, body):
        """``body(m, tables, colsums, idx)`` on each worker's 1/M slice of
        the chunk against its replica, and the answers concatenated in
        worker order on worker 0 (the only copies: ``traffic["answers"]``).
        A slice's answer is the unsharded one's bits."""
        s = len(chunk) // self._M
        outs = []
        for m, dev in enumerate(self._workers.devices):
            idx = torch.tensor(chunk[m * s:(m + 1) * s], dtype=torch.int64,
                               device=dev)
            outs.append(body(m, tuple(t[m] for t in live.tables),
                             live.worker_colsums[m], idx))
        if isinstance(outs[0], tuple):
            parts = [all_gather(list(p), self._workers) for p in zip(*outs)]
            self._count("answers", sum(b for _, b in parts))
            return tuple(t for t, _ in parts)
        out, b = all_gather(outs, self._workers)
        self._count("answers", b)
        return out

    def _batch_predict(self, live: _TableSet, chunk: np.ndarray
                       ) -> torch.Tensor:
        """One contraction a worker on its slice, against its replica; no
        copy between workers but the answers."""
        return self._split(
            live, chunk,
            lambda m, tables, cols, idx: _predict_from_rows(
                tuple(t.index_select(0, idx[:, n])
                      for n, t in enumerate(tables)),
                self._worker_eyes[m], self.backend))

    # -- online refresh (delta patch + versioned swap) ------------------------

    @property
    def params(self) -> FastTuckerParams:
        """The model currently served (factors kept current by
        ``update_rows`` / ``sync_factor_rows``; a copy is made only on the
        first read after an update)."""
        if self._params_stale:
            self._params = FastTuckerParams(
                tuple(self._joined(self._factors[n], n)
                      for n in range(self.order)), self._core)
            self._params_stale = False
        return self._params

    @property
    def table_version(self) -> int:
        """Monotone table-generation counter, bumped by every swap."""
        return self._live.version

    @property
    def _tables(self) -> tuple:
        """The live C^(n): with a mesh, each mode's blocks joined on the
        answering device and trimmed to the true rows (row mode; a copy)
        or worker 0's replica (batch mode)."""
        tables = self._live.tables
        if self.shard_mode == "none":
            return tables
        return tuple(self._joined(t, n) for n, t in enumerate(tables))

    @property
    def _colsums(self) -> tuple:
        return self._live.colsums

    def update_rows(self, mode: int, ids, factor_rows) -> int:
        """Patch the serving tables for changed factor rows of one mode.

        Recomputes ONLY the dirty rows of C^(mode) = A^(mode) B^(mode)
        through the backend's ``patch_table_rows`` (f32, rounded once to
        ``table_dtype``), so the patched table is bitwise what a full
        rebuild from the updated params stores; updates the f32 column
        sums incrementally (add the new rows, subtract the old); and
        publishes a new generation with one ``_live`` swap.  The patch
        writes into a copy of the table, never into the live one.

        With a mesh, row mode routes the dirty ids to the workers that own
        them: one ``patch_table_rows`` on each worker holding dirty rows,
        on its block with local ids, the colsum carried from worker to
        worker in order (a worker with none launches nothing).  Batch mode
        patches every replica from its own mirror (M calls, the same bits
        on each: the kernel is deterministic), so the replicas stay
        bitwise equal with the dirty rows, not the tables, copied.

        ``ids`` are unique row ids of ``mode`` (duplicates raise), on the
        host, and ``factor_rows`` the matching ``(len(ids), J_mode)`` rows
        of the updated A^(mode) (numpy or a tensor; a tensor already on
        the server's device is not copied).  Returns the new
        ``table_version`` (unchanged if ``ids`` is empty).
        """
        mode = self._check_mode(mode)
        ids, rows = self._check_rows(mode, ids, factor_rows, "update_rows")
        if len(ids) == 0:
            return self.table_version
        live = self._live
        be = dispatch.get_backend(self.backend)
        worker_colsums = live.worker_colsums
        with torch.no_grad():
            if self.shard_mode == "none":
                table, colsum = be.patch_table_rows(
                    live.tables[mode], live.colsums[mode],
                    self._factors[mode], self._core[mode], ids, rows)
            else:
                blocks = list(live.tables[mode])
                cols = ([c[mode] for c in worker_colsums]
                        if self.shard_mode == "batch" else None)
                at, colsum, moved = 0, live.colsums[mode], 0
                for m, local, r in self._route(mode, ids, rows):
                    if cols is None:     # row: one colsum, carried along
                        if m != at:
                            colsum = copy_to(colsum, self._workers.devices[m])
                            moved += nbytes(colsum)
                            at = m
                        c = colsum
                    else:
                        c = cols[m]
                    blocks[m], c = be.patch_table_rows(
                        blocks[m], c, self._factors[mode][m],
                        self._cores[m][mode], local, r)
                    moved += 0 if m == 0 else nbytes(r)
                    if cols is None:
                        colsum = c
                    else:
                        cols[m] = c
                if cols is not None:
                    colsum = cols[0]
                    worker_colsums = tuple(
                        wc[:mode] + (cols[m],) + wc[mode + 1:]
                        for m, wc in enumerate(worker_colsums))
                elif at != 0:
                    colsum = copy_to(colsum, self.device)
                    moved += nbytes(colsum)
                self._count("update_rows", moved)
                table = tuple(blocks)
        self._params_stale = True
        tables = list(live.tables)
        tables[mode] = table
        colsums = list(live.colsums)
        colsums[mode] = colsum
        self._live = _TableSet(live.version + 1, tuple(tables),
                               tuple(colsums), worker_colsums)
        return self._live.version

    def sync_factor_rows(self, mode: int, ids, factor_rows) -> None:
        """Write changed factor rows into ``self.params`` WITHOUT
        publishing a table generation (the refresh supervisor's rebuild
        escalation: the rows reach the model, then one ``refresh_tables``
        publishes everything).  The same checks as ``update_rows``; with a
        mesh the rows go to the mirrors of the workers that hold them."""
        mode = self._check_mode(mode)
        ids, rows = self._check_rows(mode, ids, factor_rows,
                                     "sync_factor_rows")
        if len(ids) == 0:
            return
        with torch.no_grad():
            if self.shard_mode == "none":
                self._factors[mode].index_copy_(0, self._ids(ids), rows)
            else:
                moved = 0
                for m, local, r in self._route(mode, ids, rows):
                    mirror = self._factors[mode][m]
                    mirror.index_copy_(0, torch.tensor(
                        local, dtype=torch.int64, device=mirror.device), r)
                    moved += 0 if m == 0 else nbytes(r)
                self._count("sync_factor_rows", moved)
        self._params_stale = True

    def refresh_tables(self) -> int:
        """Full-table rebuild from the current ``self.params`` + swap;
        returns the new version.  With a mesh each worker rebuilds its
        block or replica from its own mirror: one ``mode_product_rows`` a
        mode a worker."""
        version = self._live.version + 1
        if self.shard_mode == "none":
            self._live = self._build(self.params, version)
        else:
            self._live = self._build_sharded(version)
        return self._live.version

    # -- internals ------------------------------------------------------------

    def _build(self, params: FastTuckerParams, version: int) -> _TableSet:
        """A generation computed from scratch: f32 tables, their f32
        column sums, the tables stored in ``table_dtype``."""
        be = dispatch.get_backend(self.backend)
        with torch.no_grad():
            tables32 = tuple(be.mode_product_rows(a, b) for a, b in zip(
                params.factors, params.core_factors))
            colsums = tuple(t.sum(dim=0) for t in tables32)
            tables = tuple(t.to(self.table_dtype) for t in tables32)
        return _TableSet(version, tables, colsums)

    def _build_sharded(self, version: int) -> _TableSet:
        """A sharded generation from the workers' mirrors: each worker
        builds the rows it holds (f32, their column sums, stored in
        ``table_dtype``; a row block zero-padded to ``b`` rows).  Row
        mode adds the workers' column sums in worker order on worker 0
        (within 1e-5 of the unsharded sum, whose order differs); in batch
        mode every worker's sum is the unsharded one's bits."""
        be = dispatch.get_backend(self.backend)
        devs = self._workers.devices
        R = self.core_rank
        tables, colsums, moved = [], [], 0
        per_worker = [[] for _ in devs]
        with torch.no_grad():
            for n, spans in enumerate(self._spans):
                blocks = []
                for m, (lo, hi) in enumerate(spans):
                    mirror = self._factors[n][m]
                    if hi > lo:
                        t32 = be.mode_product_rows(mirror[:hi - lo],
                                                   self._cores[m][n])
                        part = t32.sum(dim=0)
                        t = t32.to(self.table_dtype)
                    else:
                        part = torch.zeros(R, dtype=torch.float32,
                                           device=devs[m])
                        t = torch.empty((0, R), dtype=self.table_dtype,
                                        device=devs[m])
                    if len(t) < len(mirror):
                        t = torch.cat([t, t.new_zeros(
                            (len(mirror) - len(t), R))])
                    blocks.append(t)
                    per_worker[m].append(part)
                tables.append(tuple(blocks))
                if self.shard_mode == "batch":
                    colsums.append(per_worker[0][n])
                else:
                    acc = per_worker[0][n]
                    for m in range(1, len(devs)):
                        part = copy_to(per_worker[m][n], devs[0])
                        moved += nbytes(part)
                        acc = acc + part
                    colsums.append(acc)
        self._count("refresh_tables", moved)
        worker_colsums = (tuple(tuple(c) for c in per_worker)
                          if self.shard_mode == "batch" else ())
        return _TableSet(version, tuple(tables), tuple(colsums),
                         worker_colsums)

    def _place(self, f: torch.Tensor, n: int, m: int) -> torch.Tensor:
        """Worker m's mirror of factor ``f`` (mode n): a replica, or its
        row block zero-padded to ``b`` rows; always a new tensor."""
        dev = self._workers.devices[m]
        if self.shard_mode == "batch":
            return copy_to(f, dev)
        lo, hi = self._spans[n][m]
        block = torch.zeros((self._block_rows[n], f.shape[1]), dtype=f.dtype,
                            device=dev)
        block[:hi - lo].copy_(f[lo:hi])
        return block

    def _joined(self, parts, n: int) -> torch.Tensor:
        """A mode's mirror or table as one tensor on the answering device:
        the unsharded one cloned, worker 0's replica cloned, or the row
        blocks concatenated and trimmed to the true rows."""
        if self.shard_mode == "none":
            return parts.clone()
        if self.shard_mode == "batch":
            return parts[0].clone()
        return all_gather(parts, self._workers)[0][: self.dims[n]]

    def _route(self, mode: int, ids: np.ndarray, rows: torch.Tensor):
        """Yield (worker, its local ids (int32, host), its rows on its
        device) for the workers the dirty rows of ``mode`` go to: each
        row's owner in row mode, every worker in batch mode."""
        devs = self._workers.devices
        if self.shard_mode == "batch":
            for m, dev in enumerate(devs):
                yield m, ids, rows if m == 0 else copy_to(rows, dev)
            return
        b = self._block_rows[mode]
        owner = ids // b
        order = np.argsort(owner, kind="stable")
        if (order[1:] < order[:-1]).any():
            ids, owner = ids[order], owner[order]
            rows = rows.index_select(0, torch.from_numpy(order).to(
                rows.device))
        bounds = np.searchsorted(owner, np.arange(len(devs) + 1))
        for m in range(len(devs)):
            lo, hi = int(bounds[m]), int(bounds[m + 1])
            if hi > lo:
                r = rows[lo:hi]
                yield (m, (ids[lo:hi] - m * b).astype(np.int32),
                       r if m == 0 else copy_to(r, devs[m]))

    def _count(self, entry: str, nbytes_moved: int) -> None:
        with self._traffic_lock:
            self.traffic[entry] += nbytes_moved

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        """Checked host ids → an int64 index tensor on the device (a
        synchronous copy: the host buffer may be reused at once)."""
        return torch.tensor(ids, dtype=torch.int64, device=self.device)

    def _check_mode(self, mode: int) -> int:
        mode = int(mode)
        if not 0 <= mode < self.order:
            raise ValueError(f"mode {mode} outside 0..{self.order - 1}")
        return mode

    def _check_ids(self, ids, mode: int, *, grow_hint: bool = False,
                   ascending: bool = False) -> np.ndarray:
        """``ascending``: the caller found the ids strictly ascending, so
        the first and last are the extremes (no pass for min and max)."""
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        if ids.ndim != 1:
            raise ValueError(f"ids must be 1-D, got shape {ids.shape}")
        if not ids.size:
            return ids
        lo, hi = (ids[0], ids[-1]) if ascending else (ids.min(), ids.max())
        if lo < 0 or hi >= self.dims[mode]:
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
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        # duplicates by a sort: numpy 2.3's np.unique hashes integers,
        # which took most of an update_rows call for a refresh's dirty
        # rows on the GPU machine's host (as data/synthetic.py notes);
        # strictly ascending ids (what a refresh yields) need no sort, and
        # their range is their ends
        ascending = ids.ndim == 1 and bool((ids[1:] > ids[:-1]).all())
        ids = self._check_ids(ids, mode, grow_hint=True, ascending=ascending)
        dups = 0
        if not ascending:
            s = np.sort(ids)
            dups = int(np.count_nonzero(s[1:] == s[:-1]))
        if dups:
            raise ValueError(f"{what} ids must be unique, got {dups} "
                             "duplicates")
        mirror = self._factors[mode]
        if self.shard_mode != "none":
            mirror = mirror[0]
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
