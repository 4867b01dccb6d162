"""``local`` strategy — single-device SGD through the uniform interface.

Counterpart of ``repro.distributed.local``: the reference trajectory the
distributed strategies are tested against (``needs_mesh = False``).
Uncompressed, a step is ``core.fasttucker.sgd_step_batch`` in every form
the config takes (both update orders, phase-split, sorted batches, bf16).
With ``compress=True`` the dense factor gradients go through the same
int8 error-feedback round trip the distributed strategies apply around
their collectives (no reduction here), making this the single-device
numerics reference for compressed runs.

``make_step`` draws each batch from the generator state carried in
``DistState.rng`` (see ``base``); ``step_batch`` takes a fed batch and
is what the parity tests drive.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import fasttucker as ft
from repro_torch.core.sampling import sample_batch_arrays
from repro_torch.core.sptensor import SparseTensor

from .base import DistState, DistStrategy, compressed_reduce
from .collectives import Traffic


@dataclasses.dataclass(frozen=True)
class LocalPlan:
    cfg: ft.FastTuckerConfig
    indices: torch.Tensor
    values: torch.Tensor
    compress: bool


@torch.no_grad()
def _compressed_step(plan: LocalPlan, dstate: DistState, idx: torch.Tensor,
                     val: torch.Tensor) -> DistState:
    cfg = plan.cfg
    layout = ft.batch_layout(idx, cfg)
    grads = ft.step_gradients(dstate.params, idx, val, cfg)
    dense = ft.scatter_row_grads(dstate.params.factors, idx, grads.row_grads,
                                 backend=cfg.backend, layout=layout)
    dense, ef = compressed_reduce(dense, dstate.ef)
    lr_a = ft.dynamic_lr(cfg.alpha_a, cfg.beta_a, dstate.step)
    lr_b = ft.dynamic_lr(cfg.alpha_b, cfg.beta_b, dstate.step)
    factors = tuple(ft._sgd_update(f, lr_a, g)
                    for f, g in zip(dstate.params.factors, dense))
    core = tuple(ft._sgd_update(b, lr_b, g)
                 for b, g in zip(dstate.params.core_factors,
                                 grads.core_grads))
    return DistState(ft.FastTuckerParams(factors, core), dstate.step + 1,
                     dstate.rng, ef)


def step_batch(plan: LocalPlan, dstate: DistState, idx: torch.Tensor,
               val: torch.Tensor) -> DistState:
    """One step on a fed batch (idx (B, N) int32, val (B,) f32); the
    generator state is carried through unchanged."""
    if plan.compress:
        return _compressed_step(plan, dstate, idx, val)
    # uncompressed local IS the core trainer: reuse it rather than keep a
    # parallel copy
    st = ft.sgd_step_batch(ft.TrainState(dstate.params, dstate.step), idx,
                           val, plan.cfg)
    return DistState(st.params, st.step, dstate.rng, dstate.ef)


class LocalStrategy(DistStrategy):
    name = "local"
    needs_mesh = False

    def prepare(self, tensor: SparseTensor, cfg: ft.FastTuckerConfig,
                mesh=None, *, compress: bool = False,
                seed: int = 0) -> LocalPlan:
        if compress and cfg.update_order == "gauss_seidel":
            raise ValueError(
                "local --compress is only defined for the jacobi update "
                "order (gauss_seidel updates modes sequentially; there is "
                "no single dense gradient to quantize)")
        return LocalPlan(cfg, tensor.indices, tensor.values, compress)

    def init(self, plan: LocalPlan, state: ft.TrainState,
             generator: torch.Generator) -> DistState:
        # EF residuals live in the GRADIENT (accum) dtype — f32 even when
        # the factors are stored bf16
        ef = (tuple(torch.zeros(f.shape, dtype=torch.float32,
                                device=f.device)
                    for f in state.params.factors)
              if plan.compress else ())
        return DistState(state.params, int(state.step),
                         generator.get_state(), ef)

    def make_step(self, plan: LocalPlan) -> Callable[[DistState], DistState]:
        gen = torch.Generator(device=plan.values.device)

        def step(dstate: DistState) -> DistState:
            gen.set_state(dstate.rng)
            idx, val = sample_batch_arrays(gen, plan.indices, plan.values,
                                           plan.cfg.batch_size)
            return step_batch(plan, dstate._replace(rng=gen.get_state()),
                              idx, val)

        step.traffic = Traffic()   # one device: no collective, all zeros
        return step
