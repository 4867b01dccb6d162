"""Step factories and input specs: the training step, prefill, greedy
decode and the encoder step.

Counterpart of ``TrainState``, ``input_specs``, ``concretize``,
``make_train_step``, ``make_prefill_step``, ``make_decode_step`` and
``make_encoder_step`` in ``repro.launch.steps``.  The reference returns
functions to ``jax.jit``; here they run eagerly (no ``torch.compile``).
``input_specs`` gives each model input of a shape cell as a ``Spec``
(shape, torch dtype), the reference's ``ShapeDtypeStruct`` stand-ins;
``concretize`` draws a batch of them from an explicit ``torch.Generator``
in the reference's ranges (integers in [0, 128), floats standard normal;
not its bits: the generators differ).  The step functions take such a
batch as it is: frames (audio), patches before tokens (vision), tokens.
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

from repro_torch.configs import ModelConfig, ShapeCell, require_ported
from repro_torch.distributed.collectives import Traffic
from repro_torch.distributed.sharding import ShardedTensor
from repro_torch.distributed.sharded_lm import ShardedLM
from repro_torch.models import (Model, decode_step, forward, init_model,
                                loss_fn)
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Model
    opt: adamw.AdamWState


class Spec(NamedTuple):
    """One model input's shape and dtype (nothing allocated)."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The model inputs of one shape cell (a train batch or a serve
    request), as the reference's ``input_specs``: a vision cell holds
    ``num_patches`` patches and S − P tokens, an audio cell S frames, a
    decode cell one new token a sequence."""
    B, S = cell.global_batch, cell.seq_len
    f32, i32 = torch.float32, torch.int32
    if cell.kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            out = {"frames": Spec((B, S, cfg.frontend_dim), f32)}
            text = S
        elif cfg.frontend == "vision":
            P = cfg.num_patches
            out = {"patches": Spec((B, P, cfg.frontend_dim), f32),
                   "tokens": Spec((B, S - P), i32)}
            text = S - P
        else:
            out = {"tokens": Spec((B, S), i32)}
            text = S
        if cell.kind == "train":
            out["labels"] = Spec((B, text), i32)
        return out
    # decode: one new token against a seq_len-deep cache
    return {"tokens": Spec((B, 1), i32)}


def concretize(specs: dict, generator: torch.Generator,
               device=None) -> dict:
    """Random tensors matching ``specs``, drawn in their order from
    ``generator`` (on ``device``): integers in [0, 128), floats standard
    normal."""
    out = {}
    for name, s in specs.items():
        if s.dtype.is_floating_point:
            out[name] = torch.randn(s.shape, generator=generator,
                                    dtype=s.dtype, device=device)
        else:
            out[name] = torch.randint(0, 128, s.shape, generator=generator,
                                      dtype=s.dtype, device=device)
    return out


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
    ``models.model.forward``) included.  A parameter the batch does not
    read (a vision frontend's projection under a text-only batch) takes
    a zero gradient, as under ``jax.grad``: AdamW still decays it."""
    require_ported(cfg)

    def train_step(state: TrainState, batch: dict):
        params = adamw.named(state.params)
        loss = loss_fn(state.params, cfg, batch, backend=backend)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
        for name, g in grads.items():   # unread by this batch: JAX's zero
            if g is None:
                grads[name] = torch.zeros_like(params[name])
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


def make_encoder_step(cfg, backend: str | None = None):
    """Encoder-only "prefill": (params, batch) → the whole sequence's
    logits (B, S, vocab), ``forward`` with no cache."""
    def encode_step(params, batch: dict):
        return forward(params, cfg, batch, backend=backend)

    return encode_step
