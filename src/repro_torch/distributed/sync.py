"""``sync`` strategy — synchronous data-parallel minibatch STD.

Counterpart of ``repro.distributed.sync`` on the in-process worker mesh:
every worker samples |Ψ| from its own shard of Ω, computes its dense
factor and core gradients on its replica of the parameters, the gradients
are summed over the workers (``collectives.psum``, or the int8
error-feedback ``compressed_reduce`` with per-worker, factor-shaped
residuals), and every replica takes the same update at lr/M.  On one
worker it is ``local`` bit for bit (same draws, same operations).

``make_step`` draws each worker's picks from its generator state in
``DistState.rng``; ``SyncStrategy.step_batch`` takes fed picks (M, B).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core import fasttucker as ft
from repro_torch.core.sptensor import SparseTensor

from .base import (DistState, MeshStrategy, WorkerDraws, compressed_reduce,
                   stack_ef, unstack_ef, worker_rng)
from .collectives import Traffic, copy_to, psum


def shard_nonzeros(tensor: SparseTensor, num_shards: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad + split Ω round-robin into (num_shards, L, N) / (num_shards, L)
    tensors on the tensor's device.  The padding tiles Ω (index arithmetic
    mod nnz), so ``nnz < num_shards`` pads by wrapping around."""
    nnz = tensor.nnz
    L = -(-nnz // num_shards)
    sel = torch.arange(L * num_shards, device=tensor.device) % nnz
    return (tensor.indices.index_select(0, sel).reshape(num_shards, L, -1),
            tensor.values.index_select(0, sel).reshape(num_shards, L))


def init_error_feedback(params: ft.FastTuckerParams) -> tuple:
    """Zero EF residuals, factor-shaped, f32 (the legacy replicated
    layout)."""
    return tuple(torch.zeros(f.shape, dtype=torch.float32, device=f.device)
                 for f in params.factors)


def _worker_gradients(cfg: ft.FastTuckerConfig, params: ft.FastTuckerParams,
                      idx: torch.Tensor, val: torch.Tensor):
    """One worker's dense factor gradients and core gradients."""
    layout = ft.batch_layout(idx, cfg)
    grads = ft.step_gradients(params, idx, val, cfg)
    dense = ft.scatter_row_grads(params.factors, idx, grads.row_grads,
                                 backend=cfg.backend, layout=layout)
    return dense, grads.core_grads


def sync_update(cfg: ft.FastTuckerConfig, mesh, compress: bool,
                replicas: Sequence[ft.FastTuckerParams], step_no: int,
                batches: Sequence[tuple[torch.Tensor, torch.Tensor]],
                ef: Sequence[tuple], traffic: Traffic | None = None
                ) -> tuple[list, list]:
    """The body shared by the legacy step and the strategy: worker m's
    batch ``batches[m]`` on ``replicas[m]``; returns (new replicas, new
    per-worker residuals).  The two sums (dense factor gradients, core
    gradients) are counted into ``traffic``."""
    M = mesh.size
    per = [_worker_gradients(cfg, p, i, v)
           for p, (i, v) in zip(replicas, batches)]
    dense = [d for d, _ in per]
    if compress:
        dense, ef = compressed_reduce(dense, ef, mesh, traffic)
    else:
        dense = psum(dense, mesh, traffic)
    core = psum([c for _, c in per], mesh, traffic)
    lr_a = ft.dynamic_lr(cfg.alpha_a, cfg.beta_a, step_no) / M
    lr_b = ft.dynamic_lr(cfg.alpha_b, cfg.beta_b, step_no) / M
    out = [ft.FastTuckerParams(
        tuple(ft._sgd_update(f, lr_a, g) for f, g in zip(p.factors, dg)),
        tuple(ft._sgd_update(b, lr_b, g)
              for b, g in zip(p.core_factors, cg)))
        for p, dg, cg in zip(replicas, dense, core)]
    return out, list(ef)


def make_sync_step(cfg: ft.FastTuckerConfig, mesh, compress: bool = False):
    """Legacy entry point: ``step(params, step_no, picks, idx_shards,
    val_shards, ef)`` → ``(params, ef)`` on global parameters (replicated
    onto the workers and back from worker 0 each call); ``picks`` (M, B)
    index each worker's shard, ``ef`` one residual tuple a worker.  New
    code drives ``SyncStrategy`` through the registry."""
    def step(params, step_no, picks, idx_shards, val_shards, ef=None):
        M = mesh.size
        replicas = [_replicate(params, d) for d in mesh.devices]
        batches = [(idx_shards[m].to(mesh.devices[m]).index_select(
                        0, picks[m].to(mesh.devices[m])),
                    val_shards[m].to(mesh.devices[m]).index_select(
                        0, picks[m].to(mesh.devices[m])))
                   for m in range(M)]
        ef = ef if ef is not None else [() for _ in range(M)]
        out, ef = sync_update(cfg, mesh, compress, replicas, step_no,
                              batches, ef)
        return out[0], ef

    return step


def _replicate(params: ft.FastTuckerParams,
               device: torch.device) -> ft.FastTuckerParams:
    """A copy of ``params`` on ``device`` (always a copy)."""
    return ft.FastTuckerParams(
        tuple(copy_to(f, device) for f in params.factors),
        tuple(copy_to(b, device) for b in params.core_factors))


# ---------------------------------------------------------------------------
# strategy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SyncPlan:
    cfg: ft.FastTuckerConfig
    mesh: object
    idx_shards: tuple    # M × (L, N) int32, worker m's on its device
    val_shards: tuple    # M × (L,) f32
    compress: bool


@torch.no_grad()
def _step_fed(plan: SyncPlan, dstate: DistState,
              picks: Sequence[torch.Tensor],
              traffic: Traffic | None = None) -> DistState:
    batches = [(i.index_select(0, p), v.index_select(0, p))
               for i, v, p in zip(plan.idx_shards, plan.val_shards, picks)]
    params, ef = sync_update(plan.cfg, plan.mesh, plan.compress,
                             dstate.params, dstate.step, batches,
                             dstate.ef or [() for _ in dstate.params],
                             traffic)
    return DistState(tuple(params), dstate.step + 1, dstate.rng,
                     tuple(ef) if plan.compress else ())


class SyncStrategy(MeshStrategy):
    name = "sync"

    def prepare(self, tensor: SparseTensor, cfg: ft.FastTuckerConfig, mesh,
                *, compress: bool = False, seed: int = 0) -> SyncPlan:
        idx_sh, val_sh = shard_nonzeros(tensor, mesh.size)
        return SyncPlan(
            cfg, mesh,
            tuple(idx_sh[m].to(d) for m, d in enumerate(mesh.devices)),
            tuple(val_sh[m].to(d) for m, d in enumerate(mesh.devices)),
            compress)

    def init(self, plan: SyncPlan, state: ft.TrainState,
             generator: torch.Generator) -> DistState:
        mesh = plan.mesh
        replicas = tuple(_replicate(state.params, d) for d in mesh.devices)
        # EF lives in the gradient (f32) dtype, one set a worker
        ef = (tuple(init_error_feedback(p) for p in replicas)
              if plan.compress else ())
        return DistState(replicas, int(state.step),
                         worker_rng(generator, mesh), ef)

    def step_batch(self, plan: SyncPlan, dstate: DistState,
                   picks) -> DistState:
        """One step on fed picks (M, B): worker m's batch is rows
        ``picks[m]`` of its shard.  The generator states carry through."""
        return _step_fed(plan, dstate, [
            torch.as_tensor(p, dtype=torch.int64, device=d)
            for p, d in zip(picks, plan.mesh.devices)])

    def make_step(self, plan: SyncPlan) -> Callable[[DistState], DistState]:
        draws = WorkerDraws(plan.mesh)
        highs = [v.shape[0] for v in plan.val_shards]
        traffic = Traffic()

        def step(dstate: DistState) -> DistState:
            picks, rng = draws.draw(dstate.rng, highs, plan.cfg.batch_size)
            return _step_fed(plan, dstate._replace(rng=rng), picks, traffic)

        step.traffic = traffic
        return step

    def eval_params(self, plan: SyncPlan,
                    dstate: DistState) -> ft.FastTuckerParams:
        return dstate.params[0]

    def _lift_eval_params(self, plan: SyncPlan, dstate: DistState,
                          state: ft.TrainState,
                          rng: torch.Tensor) -> DistState:
        return DistState(
            tuple(_replicate(state.params, d) for d in plan.mesh.devices),
            state.step, self._worker_rng(dstate, rng), dstate.ef)

    def _globalize(self, plan: SyncPlan, dstate: DistState) -> DistState:
        return DistState(_replicate(dstate.params[0], plan.mesh.devices[0]),
                         dstate.step, dstate.rng.clone(),
                         stack_ef(dstate.ef, plan.mesh))

    def _localize(self, plan: SyncPlan, gstate: DistState) -> DistState:
        return DistState(
            tuple(_replicate(gstate.params, d) for d in plan.mesh.devices),
            gstate.step, gstate.rng, unstack_ef(gstate.ef, plan.mesh))
