"""``strata_overlap`` strategy — Fig. 2's pipeline with hidden rotations.

Counterpart of ``repro.distributed.overlap``: the same stratified schedule
and per-stratum math as ``strata``, taken a chunk of K consecutive
schedule positions a call, with the shard rotations issued ahead of use:

  * shards stay in rotated position between strata — moving from stratum
    digits d to d' costs one rotation by (d' − d) mod M a mode instead of
    the rotate-home + rotate-in pair (at most half ``strata``'s bytes,
    none where consecutive digits coincide);
  * on the card the rotation toward stratum k+1 is issued on each
    device's side stream right after stratum k's row update, before
    stratum k's core update and stratum k+1's draw, localization and sort,
    none of which read the rotated shards; the compute stream waits on the
    copies' events only where stratum k+1 gathers its rows
    (``collectives.SideStreams``).

Each stratum draws exactly what ``strata`` draws for it (each worker's
generator advances once a stratum) and runs the same operations on the
same data, and the copies and fixed-order sums are exact, so the
trajectory equals ``strata``'s bit for bit: parameters, core and
generator states.  A chunk ends at the schedule's end, so a resume from any
step starts a (shorter) chunk there.

Out of core, the prefetcher walks K-stratum groups (``strata_block``),
each worker's (K, L, ·) slice placed on its device ahead of the chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import fasttucker as ft
from repro_torch.core.cost import core_update_flops

from .base import DistState, WorkerDraws
from .collectives import SideStreams, Traffic
from .strata import (LocalBatch, MeshPlacer, StrataRunPlan, StrataStrategy,
                     _blocks_at, _offset_tables, _prepare_run_plan,
                     core_update, row_update)

DEFAULT_CHUNK = 4


@dataclasses.dataclass
class OverlapPlan(StrataRunPlan):
    chunk: int = DEFAULT_CHUNK


def _chunk_len(plan: OverlapPlan, pos: int) -> int:
    return min(plan.chunk, len(plan.schedule) - pos)


def _run_chunk(plan: OverlapPlan, dstate: DistState, pos: int, blocks,
               picks_of, tables: dict, side: SideStreams,
               traffic: Traffic) -> DistState:
    """K strata from schedule position ``pos``: ``blocks[k]`` the workers'
    blocks of stratum k, ``picks_of(k, rng)`` its draws → (picks, rng).

    ``traffic`` counts the rotations and the core sums, and as hidden
    FLOPs each core update issued while a non-zero rotation is in flight
    (between its issue and its ``Pending.wait``); the draw, localization
    and sort in the same window are integer work and count nothing."""
    cfg, mesh = plan.cfg, plan.mesh
    M, N = mesh.size, cfg.order
    K = len(blocks)
    home = [0] * N
    params = dstate.params
    core = [p.core_factors for p in params]
    ef = list(dstate.ef) or [()] * M
    rng, step = dstate.rng, dstate.step
    prev = home
    moving = [[p.factors[n] for p in params] for n in range(N)]
    for k in range(K + 1):
        digits = ([int(x) for x in plan.digits[pos + k]] if k < K else home)
        # double buffer: the rotation toward this stratum (home after the
        # last) goes out on the side streams now; the core update of the
        # previous stratum and this stratum's draw below do not read it
        pending = []
        for n in range(N):
            shift = (digits[n] - prev[n]) % M
            pending.append(side.rotate(moving[n], shift, mesh, traffic))
        if k > 0:
            core, ef = core_update(cfg, mesh, core, core_grads, ef, step,
                                   plan.compress, traffic)
            if any((d - p) % M for d, p in zip(digits, prev)):
                traffic.hidden_flops += core_update_flops(cfg, M)
            step += 1
        if k == K:
            break
        picks, rng = picks_of(k, rng)
        batches = [LocalBatch(cfg, blocks[k][m], picks[m],
                              tables[d][0][pos + k, m], tables[d][1])
                   for m, d in enumerate(mesh.devices)]
        rot = [p.wait() for p in pending]
        lr_a = ft.dynamic_lr(cfg.alpha_a, cfg.beta_a, step)
        new, core_grads = [], []
        for m in range(M):
            nr, cg = row_update(cfg, [rot[n][m] for n in range(N)], core[m],
                                batches[m], lr_a)
            new.append(nr)
            core_grads.append(cg)
        moving = [[w[n] for w in new] for n in range(N)]
        prev = digits
    back = [p.wait() for p in pending]
    return DistState(
        tuple(ft.FastTuckerParams(tuple(back[n][m] for n in range(N)),
                                  tuple(core[m])) for m in range(M)),
        step, rng, tuple(ef) if plan.compress else ())


def _make_chunk_prefetcher(plan: OverlapPlan):
    """Prefetcher over K-stratum schedule groups: ``take(pos)`` yields the
    workers' (K, L, ·) blocks, each on its worker's device."""
    from repro_torch.data.pipeline import StratumPrefetcher

    store, S = plan.store, len(plan.schedule)

    def load(pos: int):
        return store.strata_block(plan.schedule[pos: pos + _chunk_len(plan,
                                                                        pos)])

    return StratumPrefetcher(
        load, lambda pos: (pos + _chunk_len(plan, pos)) % S,
        depth=plan.prefetch_depth,
        place_fn=MeshPlacer(plan.mesh, plan.prefetch_depth + 1))


class StrataOverlapStrategy(StrataStrategy):
    """Inherits ``init`` (padded, sharded factors + EF), the row-trimming
    ``eval_params``, refresh and checkpoints from ``StrataStrategy``; only
    the step changes."""

    name = "strata_overlap"

    def __init__(self, chunk: int = DEFAULT_CHUNK):
        self.chunk = chunk

    def prepare(self, tensor, cfg, mesh, *, compress: bool = False,
                seed: int = 0, store=None,
                prefetch_depth: int = 2) -> OverlapPlan:
        base = _prepare_run_plan(tensor, cfg, mesh, compress, seed,
                                 store=store, prefetch_depth=prefetch_depth)
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(base)}
        return OverlapPlan(**fields,
                           chunk=max(1, min(self.chunk, len(base.schedule))))

    def steps_per_call(self, plan: OverlapPlan) -> int:
        return plan.chunk

    @torch.no_grad()
    def step_batch(self, plan: OverlapPlan, dstate: DistState,
                   picks) -> DistState:
        """One chunk from schedule position ``step mod S`` on fed picks
        (K, M, B), K the chunk's length there (``steps_per_call``, shorter
        at the schedule's end)."""
        pos = dstate.step % len(plan.schedule)
        K = _chunk_len(plan, pos)
        if len(picks) != K:
            raise ValueError(f"a chunk at position {pos} takes {K} strata of "
                             f"picks, got {len(picks)}")
        devs = plan.mesh.devices
        fed = [[torch.as_tensor(p, dtype=torch.int64, device=d)
                for p, d in zip(pk, devs)] for pk in picks]
        return _run_chunk(plan, dstate, pos,
                          [_blocks_at(plan, pos + k) for k in range(K)],
                          lambda k, rng: (fed[k], rng),
                          _offset_tables(plan), SideStreams(), Traffic())

    def make_step(self, plan: OverlapPlan
                  ) -> Callable[[DistState], DistState]:
        S = len(plan.schedule)
        tables = _offset_tables(plan)
        draws = WorkerDraws(plan.mesh)
        highs = [plan.layout.chunk_len] * plan.mesh.size
        side, traffic = SideStreams(), Traffic()
        fetch = (_make_chunk_prefetcher(plan) if plan.store is not None
                 else None)

        def picks_of(k, rng):
            return draws.draw(rng, highs, plan.cfg.batch_size)

        @torch.no_grad()
        def step(dstate: DistState) -> DistState:
            pos = dstate.step % S
            K = _chunk_len(plan, pos)
            if fetch is not None:
                got = fetch.take(pos)   # M × (idx, val, msk) of (K, L, ·)
                blocks = [[tuple(t[k] for t in w) for w in got]
                          for k in range(K)]
            else:
                blocks = [_blocks_at(plan, pos + k) for k in range(K)]
            return _run_chunk(plan, dstate, pos, blocks, picks_of, tables,
                              side, traffic)

        step.traffic = traffic
        step.prefetcher = fetch
        return step


__all__ = ["DEFAULT_CHUNK", "OverlapPlan", "StrataOverlapStrategy"]
