"""Step factories: the training step, prefill and greedy decode.

Counterpart of ``TrainState``, ``make_train_step``, ``make_prefill_step``
and ``make_decode_step`` in ``repro.launch.steps``.  The reference returns
functions to ``jax.jit``; here they run eagerly (no ``torch.compile``).
The cache index is a Python int.  The training step is ``loss_fn`` →
``torch.autograd.grad`` → ``adamw.update``, which writes the new
parameters and moments in place (``optim.adamw``).
``make_sharded_train_step`` is the same step with the parameters and
moments sharded over an in-process mesh (``distributed.sharded_lm``): the
reference's jitted step with ``in_shardings`` (``launch.train``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs import require_ported
from repro_torch.distributed.collectives import Traffic
from repro_torch.distributed.sharding import ShardedTensor
from repro_torch.distributed.sharded_lm import ShardedLM
from repro_torch.models import Model, decode_step, init_model, loss_fn
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Model
    opt: adamw.AdamWState


def init_train_state(cfg, generator: torch.Generator | None = None,
                     device=None) -> TrainState:
    """Random weights (``init_model``), each a leaf that takes a gradient,
    and fresh AdamW moments."""
    params = init_model(cfg, generator, device)
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(params, adamw.init(params))


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig,
                    backend: str | None = None):
    """(state, batch) → (state, metrics with ``loss``, ``grad_norm`` and
    ``lr`` as 0-dim device tensors).  Every ported config trains, MLA,
    MoE and ``mixed_precision`` (bf16 copies of the f32 parameters a step,
    ``models.model.forward``) included."""
    require_ported(cfg)

    def train_step(state: TrainState, batch: dict):
        params = adamw.named(state.params)
        loss = loss_fn(state.params, cfg, batch, backend=backend)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        _, opt, metrics = adamw.update(grads, state.opt, params, opt_cfg)
        metrics["loss"] = loss.detach()
        return TrainState(state.params, opt), metrics

    return train_step


def make_sharded_train_step(cfg, opt_cfg: adamw.AdamWConfig, mesh, layouts,
                            backend: str | None = None, *,
                            policy: str = "fsdp_tp"):
    """(state, batch) → (state, metrics), the state's parameters and
    moments ``ShardedTensor``s on ``layouts`` ({name: Layout}, as
    ``launch.train.build_state`` makes them) and the batch the global one
    (split by ``sharding.batch_spec`` under ``policy``).  ``step.traffic``
    accumulates the collectives' bytes a worker (``collectives.Traffic``)
    over the steps run.  Every ported config trains: MLA (its heads split
    over ``model``), MoE (the dispatch over the global batch, or the
    expert-parallel island under ``moe_sharded``) and ``mixed_precision``
    (bf16 all-gathers) included (``ShardedLM``)."""
    traffic = Traffic()
    lm = ShardedLM(cfg, mesh, layouts, policy, backend, traffic)

    def train_step(state: TrainState, batch: dict):
        names = list(state.params)
        loss = lm.loss(state.params, batch)
        flat = [p for n in names for p in state.params[n].parts]
        got = iter(torch.autograd.grad(loss, flat))
        grads = {n: ShardedTensor([next(got) for _ in state.params[n].parts],
                                  state.params[n].layout) for n in names}
        _, opt, metrics = adamw.update(grads, state.opt, state.params,
                                       opt_cfg)
        metrics["loss"] = loss.detach()
        return TrainState(state.params, opt), metrics

    train_step.traffic = traffic
    return train_step


def make_prefill_step(cfg, backend: str | None = None):
    """Prompt → (last-position logits, filled caches)."""
    def prefill_step(params, batch: dict, caches):
        logits, caches = decode_step(params, cfg, batch, caches, 0,
                                     backend=backend)
        return logits[:, -1], caches

    return prefill_step


def make_decode_step(cfg, backend: str | None = None):
    """(params, caches, index, tokens (B, 1)) → (next tokens, caches,
    index + 1), greedy."""
    def serve_step(params, caches, index: int, batch: dict):
        logits, caches = decode_step(params, cfg, batch, caches, index,
                                     backend=backend)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], caches, index + 1

    return serve_step
