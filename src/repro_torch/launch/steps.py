"""Step factories: the training step, prefill and greedy decode.

Counterpart of ``TrainState``, ``make_train_step``, ``make_prefill_step``
and ``make_decode_step`` in ``repro.launch.steps``.  The reference returns
functions to ``jax.jit``; here they run eagerly (no ``torch.compile``).
The cache index is a Python int.  The training step is ``loss_fn`` →
``torch.autograd.grad`` → ``adamw.update``, which writes the new
parameters and moments in place (``optim.adamw``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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
    ``lr`` as 0-dim device tensors)."""
    def train_step(state: TrainState, batch: dict):
        params = adamw.named(state.params)
        loss = loss_fn(state.params, cfg, batch, backend=backend)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        _, opt, metrics = adamw.update(grads, state.opt, params, opt_cfg)
        metrics["loss"] = loss.detach()
        return TrainState(state.params, opt), metrics

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
