"""``strata`` strategy — the paper's Fig. 2 on an in-process worker mesh.

Counterpart of ``repro.distributed.strata``.  Factor matrices are
ROW-SHARDED over the M workers (each mode padded to a multiple of M rows);
each step handles one stratum s (a generalized diagonal of the M^N block
grid): ``collectives.rotate`` moves each mode's shards by the stratum's
digit so that every worker holds exactly the rows its bucket touches, the
workers update their rows locally (conflict-free by construction), and
the shards rotate back.  Mode 0 is the anchor and never rotates.  The core
factors B^(n) are small and replicated: their gradients are summed over
the workers (``collectives.psum``, or the int8 error-feedback
``compressed_reduce`` with per-worker, core-shaped residuals) and every
replica steps at lr_b/M.

Strata are visited in a pre-sampled Latin-hypercube epoch schedule
(``core.sampling.latin_hypercube_schedule``), every stratum once an epoch.
The data come from resident buckets (``partition_for_workers``, each
worker's slice on its device) or, with ``prepare(..., store=)``, from a
``NonzeroStore`` through a ``StratumPrefetcher`` that places each worker's
slice on its device ``prefetch_depth`` strata ahead: the chunks are the
buckets bit for bit, so the trajectory is too.

Masked padding points at global row 0; localized, it reaches down to
−(M−1)·rows_per_block.  The reference gathers with ``x[idx]``, which wraps
a negative id once and clamps it into range, and scatters with the raw id,
which drops it.  The port gathers through ``local_gather_ids`` (the same
wrap and clamp; a plain ``index_select`` would trip a device assert on
the card) and scatters the raw ids, which both scatter kernels drop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import fasttucker as ft
from repro_torch.core.sptensor import SparseTensor, partition_for_workers

from .base import (DistState, MeshStrategy, WorkerDraws, compressed_reduce,
                   stack_ef, unstack_ef, worker_rng)
from .collectives import Traffic, copy_to, psum, rotate


# ---------------------------------------------------------------------------
# layout: buckets + padded row blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StrataLayout:
    """Host-side prep for the stratified schedule.

    Backed either by resident buckets (``buckets``, from
    ``partition_for_workers`` of the M-padded tensor, on its device) or by
    an out-of-core ``NonzeroStore`` (``store``) whose chunks have the
    identical (S, M, L, ·) layout.
    """
    buckets: dict | None   # from partition_for_workers (resident path)
    rows_per_block: tuple  # per mode (padded row count / M)
    num_workers: int
    store: object = None   # NonzeroStore (out-of-core path)

    @classmethod
    def build(cls, tensor: SparseTensor, num_workers: int) -> "StrataLayout":
        M = num_workers
        padded_dims = tuple(-(-d // M) * M for d in tensor.dims)
        padded = SparseTensor(tensor.indices, tensor.values, padded_dims)
        buckets = partition_for_workers(padded, M)
        return cls(buckets, tuple(d // M for d in padded_dims), M)

    @classmethod
    def from_store(cls, store) -> "StrataLayout":
        """Out-of-core layout: the chunks stay in the store."""
        M = store.num_workers
        return cls(None, tuple(d // M for d in store.padded_dims), M,
                   store=store)

    @property
    def num_strata(self) -> int:
        if self.store is not None:
            return self.store.num_strata
        return self.buckets["indices"].shape[0]

    @property
    def order(self) -> int:
        if self.store is not None:
            return self.store.order
        return self.buckets["indices"].shape[-1]

    @property
    def chunk_len(self) -> int:
        """L, the padded bucket length every worker samples from."""
        if self.store is not None:
            return self.store.chunk_len
        return self.buckets["indices"].shape[2]

    def stratum_digits(self, s: int) -> np.ndarray:
        """Base-M digits (mode 1..N-1 shifts) of stratum s."""
        from repro_torch.core.sampling import stratum_digits

        return stratum_digits(np.asarray([s]), self.num_workers,
                              self.order)[0]


def pad_factors_for_strata(params: ft.FastTuckerParams, plan: StrataLayout
                           ) -> ft.FastTuckerParams:
    """Zero rows appended to each factor up to ``rows_per_block · M``."""
    M = plan.num_workers
    factors = tuple(
        torch.nn.functional.pad(f, (0, 0, 0, plan.rows_per_block[n] * M
                                    - f.shape[0]))
        for n, f in enumerate(params.factors))
    return ft.FastTuckerParams(factors, params.core_factors)


def shard_params(params: ft.FastTuckerParams, layout: StrataLayout,
                 mesh) -> tuple[ft.FastTuckerParams, ...]:
    """Padded global params → worker m's row block of each mode and its
    own copy of the core factors, on its device."""
    out = []
    for m, d in enumerate(mesh.devices):
        shards = tuple(
            copy_to(f[m * r:(m + 1) * r], d)
            for f, r in zip(params.factors, layout.rows_per_block))
        out.append(ft.FastTuckerParams(
            shards, tuple(copy_to(b, d) for b in params.core_factors)))
    return tuple(out)


def gather_shards(workers: Sequence[ft.FastTuckerParams],
                  mesh) -> ft.FastTuckerParams:
    """The inverse of ``shard_params``: padded global factors (the shards
    in worker order) and worker 0's core, new tensors on its device."""
    dev0 = mesh.devices[0]
    N = len(workers[0].factors)
    return ft.FastTuckerParams(
        tuple(torch.cat([w.factors[n].to(dev0) for w in workers])
              for n in range(N)),
        tuple(copy_to(b, dev0) for b in workers[0].core_factors))


# ---------------------------------------------------------------------------
# per-stratum body (shared with ``strata_overlap``)
# ---------------------------------------------------------------------------

def rotate_shard(shards: Sequence[torch.Tensor], shift: int, mesh,
                 traffic: Traffic | None = None) -> list[torch.Tensor]:
    """Rotate one mode's row shards so that worker m ends up holding the
    block owned by (m + shift) mod M.  Shifts compose additively: from
    digits d to d' is a rotation by (d' − d) mod M, home is (−d) mod M."""
    return rotate(shards, shift, mesh, traffic)


def local_gather_ids(lidx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The rows the reference's ``x[idx]`` reads for localized ids
    ``lidx`` (B, N) into blocks of ``rows`` (N,) rows: a negative id wraps
    once (+rows), then every id is clamped into [0, rows − 1]."""
    wrapped = torch.where(lidx < 0, lidx + rows, lidx)
    return torch.minimum(wrapped.clamp_(min=0), rows - 1)


class LocalBatch:
    """One worker's draw from its bucket, localized: everything of its row
    update that does not read the factor shards (computed before the
    rotation that brings them has landed)."""

    __slots__ = ("lidx", "gidx", "val", "msk", "layout")

    def __init__(self, cfg: ft.FastTuckerConfig, block, pick: torch.Tensor,
                 offsets: torch.Tensor, rows: torch.Tensor):
        idx_b, val_b, msk_b = block
        self.val = val_b.index_select(0, pick)
        self.msk = msk_b.index_select(0, pick)
        # localize rows: subtract each mode's block start (a per-mode
        # constant, so the mode-sorted order of the local ids is the
        # global one; masked padding may localize negative)
        self.lidx = idx_b.index_select(0, pick) - offsets
        self.gidx = local_gather_ids(self.lidx, rows)
        self.layout = ft.batch_layout(self.lidx, cfg)


def row_update(cfg: ft.FastTuckerConfig, rot: Sequence[torch.Tensor],
               core_f: Sequence[torch.Tensor], batch: LocalBatch,
               lr_a: torch.Tensor) -> tuple[tuple, tuple]:
    """One worker's conflict-free row update on its rotated shards:
    gradients through the fused kernel (the gather by the clamped ids),
    the row scatter by the raw ids, the update at lr_a.  Returns (updated
    shards, this worker's core gradients)."""
    lparams = ft.FastTuckerParams(tuple(rot), tuple(core_f))
    grads = ft.step_gradients(lparams, batch.gidx, batch.val, cfg,
                              mask=batch.msk)
    dense = ft.scatter_row_grads(rot, batch.lidx, grads.row_grads,
                                 backend=cfg.backend, layout=batch.layout)
    return (tuple(ft._sgd_update(f, lr_a, g) for f, g in zip(rot, dense)),
            grads.core_grads)


def stratum_row_update(cfg: ft.FastTuckerConfig, rot, core_f, block,
                       pick: torch.Tensor, offsets: torch.Tensor,
                       rows: torch.Tensor, lr_a: torch.Tensor):
    """One stratum's local row update of one worker, shards pre-rotated:
    ``block`` its bucket (idx (L, N), val (L,), msk (L,)), ``pick`` (B,)
    the draw from it, ``offsets`` (N,) its blocks' first rows, ``rows``
    (N,) the rows a block.  The core update is left to the caller
    (``core_update``), so it can be ordered after the next rotation is
    issued.  Returns (updated shards, core gradients)."""
    return row_update(cfg, rot, core_f,
                      LocalBatch(cfg, block, pick, offsets, rows), lr_a)


def core_update(cfg: ft.FastTuckerConfig, mesh, core_f: Sequence[tuple],
                core_grads: Sequence[tuple], ef: Sequence[tuple],
                step_no: int, compress: bool,
                traffic: Traffic | None = None) -> tuple[list, list]:
    """Summed (optionally int8-EF-compressed) core-factor update of every
    worker's replica at lr_b/M → (replicas, residuals); the sum is counted
    into ``traffic``."""
    if compress:
        summed, ef = compressed_reduce(core_grads, ef, mesh, traffic)
    else:
        summed = psum(core_grads, mesh, traffic)
    lr_b = ft.dynamic_lr(cfg.alpha_b, cfg.beta_b, step_no) / mesh.size
    return ([tuple(ft._sgd_update(b, lr_b, g) for b, g in zip(c, s))
             for c, s in zip(core_f, summed)], list(ef))


# ---------------------------------------------------------------------------
# strategy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StrataRunPlan:
    cfg: ft.FastTuckerConfig
    mesh: object
    layout: StrataLayout
    schedule: np.ndarray   # (S,) stratum ids: the LHC epoch cover
    digits: np.ndarray     # (S, N) matching digits
    compress: bool
    store: object = None   # NonzeroStore: out-of-core chunk source
    prefetch_depth: int = 2   # blocks placed ahead of use
    worker_buckets: tuple = ()   # M × (idx, val, msk) (S, L, ·), resident


def _prepare_run_plan(tensor, cfg, mesh, compress, seed, store=None,
                      prefetch_depth=2) -> StrataRunPlan:
    from repro_torch.core.sampling import (latin_hypercube_schedule,
                                           stratum_digits)

    M = mesh.size
    if store is not None:
        if store.num_workers != M:
            raise ValueError(
                f"store was sharded for {store.num_workers} workers but "
                f"the mesh has {M} — rebuild it with "
                f"NonzeroStore.build(tensor, {M})")
        layout = StrataLayout.from_store(store)
        wb = ()
    else:
        layout = StrataLayout.build(tensor, M)
        b = layout.buckets
        wb = tuple((b["indices"][:, m].to(d), b["values"][:, m].to(d),
                    b["mask"][:, m].to(d))
                   for m, d in enumerate(mesh.devices))
    # a CPU generator: the same schedule whatever the device
    schedule = latin_hypercube_schedule(torch.Generator().manual_seed(seed),
                                        M, cfg.order).numpy()
    digits = stratum_digits(schedule, M, cfg.order)
    return StrataRunPlan(cfg, mesh, layout, schedule, digits, compress,
                         store, prefetch_depth, wb)


class _MeshBlock:
    """A placed block: per device, the workers' rows of it in flight."""

    __slots__ = ("parts", "where")

    def __init__(self, parts: dict, where: list):
        self.parts, self.where = parts, where

    def ready(self) -> list[tuple]:
        """Worker m's tuple of tensors, once its device's copies are
        waited on."""
        from repro_torch.data.pipeline import StratumPrefetcher

        got = {d: StratumPrefetcher._ready(p) for d, p in self.parts.items()}
        return [tuple(t[j] for t in got[d]) for d, j in self.where]


class MeshPlacer:
    """``place_fn`` for blocks with a leading worker axis: each device's
    workers' rows go onto it through a ``_StagedPlacer`` of its own (pinned
    staging, a side-stream copy on the card); ``ready`` hands worker m its
    slice."""

    def __init__(self, mesh, slots: int):
        from repro_torch.data.pipeline import _StagedPlacer

        devs = mesh.distinct_devices()
        self.workers = {d: [m for m, w in enumerate(mesh.devices) if w == d]
                        for d in devs}
        self.where = [(d, self.workers[d].index(m))
                      for m, d in enumerate(mesh.devices)]
        self.placers = {d: _StagedPlacer(d, slots) for d in devs}
        self.size = mesh.size

    def __call__(self, block) -> _MeshBlock:
        parts = {}
        for d, ws in self.workers.items():
            part = (block if len(ws) == self.size
                    else tuple(np.take(a, ws, axis=0) for a in block))
            parts[d] = self.placers[d](part)
        return _MeshBlock(parts, self.where)

    def release(self) -> None:
        for p in self.placers.values():
            p.release()


def make_stratum_prefetcher(plan: StrataRunPlan):
    """Prefetcher over the LHC schedule, one stratum per step:
    ``take(pos)`` yields the workers' (idx, val, msk) blocks of schedule
    position ``pos``, each on its worker's device, read from the store and
    placed ``plan.prefetch_depth`` strata ahead of use."""
    from repro_torch.data.pipeline import StratumPrefetcher

    store, S = plan.store, len(plan.schedule)
    return StratumPrefetcher(
        lambda pos: store.stratum(int(plan.schedule[pos % S])),
        lambda pos: (pos + 1) % S,
        depth=plan.prefetch_depth,
        place_fn=MeshPlacer(plan.mesh, plan.prefetch_depth + 1))


def _offset_tables(plan: StrataRunPlan) -> dict:
    """Per device, the (S, M, N) int32 block starts of every schedule
    position and the (N,) int32 rows per block: made once, so a step sends
    nothing from the host."""
    M = plan.mesh.size
    rpb = np.asarray(plan.layout.rows_per_block, np.int64)
    m = np.arange(M)[None, :, None]
    off = ((m + np.asarray(plan.digits, np.int64)[:, None, :]) % M) * rpb
    off_t = torch.from_numpy(off.astype(np.int32))
    rows_t = torch.from_numpy(rpb.astype(np.int32))
    return {d: (off_t.to(d), rows_t.to(d))
            for d in plan.mesh.distinct_devices()}


def _blocks_at(plan: StrataRunPlan, pos: int) -> list[tuple]:
    """The workers' (idx, val, msk) blocks of schedule position ``pos``,
    resident or read from the store now."""
    s = int(plan.schedule[pos])
    if plan.store is None:
        return [tuple(t[s] for t in wb) for wb in plan.worker_buckets]
    idx, val, msk = plan.store.stratum(s)
    return [tuple(torch.from_numpy(np.ascontiguousarray(a[m])).to(d)
                  for a in (idx, val, msk))
            for m, d in enumerate(plan.mesh.devices)]


def _strata_step(plan: StrataRunPlan, dstate: DistState, pos: int, blocks,
                 picks, tables: dict, traffic: Traffic) -> DistState:
    """One stratum: rotate in, every worker's row update, rotate home,
    the summed core update."""
    cfg, mesh = plan.cfg, plan.mesh
    M, N = mesh.size, cfg.order
    digits = [int(x) for x in plan.digits[pos]]
    params = dstate.params
    rot = []
    for n in range(N):
        rot.append(rotate_shard([p.factors[n] for p in params], digits[n],
                                mesh, traffic))
    lr_a = ft.dynamic_lr(cfg.alpha_a, cfg.beta_a, dstate.step)
    new, core_grads = [], []
    for m, d in enumerate(mesh.devices):
        off, rows = tables[d]
        nr, cg = stratum_row_update(
            cfg, [rot[n][m] for n in range(N)], params[m].core_factors,
            blocks[m], picks[m], off[pos, m], rows, lr_a)
        new.append(nr)
        core_grads.append(cg)
    back = []
    for n in range(N):
        back.append(rotate_shard([w[n] for w in new], -digits[n], mesh,
                                 traffic))
    core, ef = core_update(cfg, mesh, [p.core_factors for p in params],
                           core_grads, dstate.ef or [()] * M, dstate.step,
                           plan.compress, traffic)
    return DistState(
        tuple(ft.FastTuckerParams(tuple(back[n][m] for n in range(N)),
                                  core[m]) for m in range(M)),
        dstate.step + 1, dstate.rng, tuple(ef) if plan.compress else ())


def make_strata_step(cfg: ft.FastTuckerConfig, mesh, plan: StrataLayout):
    """Legacy entry point: ``step(params, step_no, picks, stratum)`` →
    params, one stratum on global padded parameters (sharded onto the
    workers and gathered back each call); ``picks`` (M, B) index each
    worker's bucket.  New code drives ``StrataStrategy``."""
    run = StrataRunPlan(cfg, mesh, plan, np.arange(plan.num_strata),
                        np.stack([plan.stratum_digits(s)
                                  for s in range(plan.num_strata)]), False)
    b = plan.buckets
    run.worker_buckets = tuple(
        (b["indices"][:, m].to(d), b["values"][:, m].to(d),
         b["mask"][:, m].to(d)) for m, d in enumerate(mesh.devices))

    @torch.no_grad()
    def step(params, step_no, picks, stratum):
        tables = _offset_tables(run)
        state = DistState(shard_params(params, plan, mesh), int(step_no),
                          torch.zeros(0, dtype=torch.uint8))
        picks = [torch.as_tensor(p, dtype=torch.int64, device=d)
                 for p, d in zip(picks, mesh.devices)]
        out = _strata_step(run, state, int(stratum),
                           _blocks_at(run, int(stratum)), picks, tables,
                           Traffic())
        return gather_shards(out.params, mesh)

    return step


def _init_strata_state(plan: StrataRunPlan, state: ft.TrainState,
                       generator: torch.Generator) -> DistState:
    params = pad_factors_for_strata(state.params, plan.layout)
    workers = shard_params(params, plan.layout, plan.mesh)
    # EF lives in the gradient (f32) dtype, one core-shaped set a worker
    ef = (tuple(tuple(torch.zeros(b.shape, dtype=torch.float32,
                                  device=b.device) for b in w.core_factors)
                for w in workers) if plan.compress else ())
    return DistState(workers, int(state.step),
                     worker_rng(generator, plan.mesh), ef)


class StrataStrategy(MeshStrategy):
    name = "strata"

    def prepare(self, tensor: SparseTensor, cfg: ft.FastTuckerConfig, mesh,
                *, compress: bool = False, seed: int = 0, store=None,
                prefetch_depth: int = 2) -> StrataRunPlan:
        return _prepare_run_plan(tensor, cfg, mesh, compress, seed,
                                 store=store, prefetch_depth=prefetch_depth)

    def init(self, plan: StrataRunPlan, state: ft.TrainState,
             generator: torch.Generator) -> DistState:
        return _init_strata_state(plan, state, generator)

    @torch.no_grad()
    def step_batch(self, plan: StrataRunPlan, dstate: DistState,
                   picks) -> DistState:
        """One stratum (schedule position ``step mod S``) on fed picks
        (M, B): worker m's batch is entries ``picks[m]`` of its bucket.
        The generator states carry through."""
        pos = dstate.step % len(plan.schedule)
        picks = [torch.as_tensor(p, dtype=torch.int64, device=d)
                 for p, d in zip(picks, plan.mesh.devices)]
        return _strata_step(plan, dstate, pos, _blocks_at(plan, pos), picks,
                            _offset_tables(plan), Traffic())

    def make_step(self, plan: StrataRunPlan
                  ) -> Callable[[DistState], DistState]:
        S = len(plan.schedule)
        tables = _offset_tables(plan)
        draws = WorkerDraws(plan.mesh)
        highs = [plan.layout.chunk_len] * plan.mesh.size
        traffic = Traffic()
        fetch = make_stratum_prefetcher(plan) if plan.store is not None \
            else None

        @torch.no_grad()
        def step(dstate: DistState) -> DistState:
            pos = dstate.step % S
            # out-of-core: stratum pos + depth is in flight while pos
            # computes; the blocks are the resident bucket slices bit for
            # bit, so the trajectory is too
            blocks = (fetch.take(pos) if fetch is not None
                      else _blocks_at(plan, pos))
            picks, rng = draws.draw(dstate.rng, highs, plan.cfg.batch_size)
            return _strata_step(plan, dstate._replace(rng=rng), pos, blocks,
                                picks, tables, traffic)

        step.traffic = traffic
        step.prefetcher = fetch   # callers close() it
        return step

    def eval_params(self, plan: StrataRunPlan,
                    dstate: DistState) -> ft.FastTuckerParams:
        g = gather_shards(dstate.params, plan.mesh)
        return ft.FastTuckerParams(
            tuple(f[: plan.cfg.dims[n]] for n, f in enumerate(g.factors)),
            g.core_factors)

    def _lift_eval_params(self, plan: StrataRunPlan, dstate: DistState,
                          state: ft.TrainState,
                          rng: torch.Tensor) -> DistState:
        # re-pad the refreshed global-layout factors to the worker
        # multiple and shard them, as init does
        params = pad_factors_for_strata(state.params, plan.layout)
        return DistState(shard_params(params, plan.layout, plan.mesh),
                         state.step, self._worker_rng(dstate, rng),
                         dstate.ef)

    def _globalize(self, plan: StrataRunPlan, dstate: DistState) -> DistState:
        return DistState(gather_shards(dstate.params, plan.mesh),
                         dstate.step, dstate.rng.clone(),
                         stack_ef(dstate.ef, plan.mesh))

    def _localize(self, plan: StrataRunPlan, gstate: DistState) -> DistState:
        return DistState(shard_params(gstate.params, plan.layout, plan.mesh),
                         gstate.step, gstate.rng,
                         unstack_ef(gstate.ef, plan.mesh))
