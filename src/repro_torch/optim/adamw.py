"""AdamW with global-norm clipping and a warmup-cosine schedule.

Counterpart of ``repro.optim.adamw`` with its numerics: moments in f32,
the gradient scaled by min(1, clip / (‖g‖ + 1e-9)), bias correction with
the step in f32, decoupled weight decay on every leaf with ``ndim >= 1``,
and the update computed in f32 and rounded to the parameter's dtype.
The schedule and the bias corrections are 0-dim f32 tensors on the
parameters' device, so a step never waits for the host.

The reference is functional; at Qwen3-14B's width a second copy of the
parameters and moments would not fit the card, so ``update`` writes the
new parameters and moments into the tensors it is given and returns them.
Parameters and their gradients are name → tensor mappings (an
``nn.Module`` stands for its ``named_parameters()``); the moments use the
same names.  A leaf may be a ``distributed.sharding.ShardedTensor`` (sharded
training): its moments take its layout (ZeRO), and the update, being
elementwise, runs on each worker's part; ``global_norm`` counts each
element once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch
from torch import nn

from repro_torch.distributed.sharding import ShardedTensor


class AdamWState(NamedTuple):
    step: torch.Tensor                # int32, 0-dim
    m: dict[str, torch.Tensor]        # f32, per parameter name (sharded
    v: dict[str, torch.Tensor]        # as the parameter is)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named(params) -> dict[str, torch.Tensor]:
    """``params`` as a name → tensor dict (a module's named parameters)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay, in f32 as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp(warm, max=1.0) * cos


def _parts(t) -> list[torch.Tensor]:
    return t.parts if isinstance(t, ShardedTensor) else [t]


def _zeros(t):
    """f32 zeros shaped and laid out as ``t``."""
    z = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for p in _parts(t)]
    return ShardedTensor(z, t.layout) if isinstance(t, ShardedTensor) \
        else z[0]


def init(params) -> AdamWState:
    """Zero moments (f32) and step 0, on the parameters' device (worker
    0's for sharded parameters)."""
    p = named(params)
    dev = _parts(next(iter(p.values())))[0].device if p else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: _zeros(t) for n, t in p.items()},
        v={n: _zeros(t) for n, t in p.items()})


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of their squares, in f32.  A sharded
    leaf adds its owners' parts (``Layout.owners``: a part replicated over
    an axis counted from the axis's index-0 worker only), in worker order,
    on the first leaf's device."""
    total = None
    for x in tree.values():
        if isinstance(x, ShardedTensor):
            terms = [x.parts[m] for m in x.layout.owners()]
        else:
            terms = [x]
        for t in terms:
            s = torch.sum(torch.square(t.float()))
            total = s if total is None else total + s.to(total.device)
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: AdamWState, params,
           cfg: AdamWConfig) -> tuple[dict, AdamWState, dict]:
    """One AdamW step, in place → (params, new state, metrics).

    ``metrics`` holds ``grad_norm`` (before clipping) and ``lr``, 0-dim
    device tensors.
    """
    p = named(params)
    if set(grads) != set(p):
        raise ValueError("gradients and parameters differ in names: "
                         f"{sorted(set(grads) ^ set(p))}")
    step = state.step + 1
    stepf = step.to(torch.float32)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    scalars = {stepf.device: (scale, lr, bc1, bc2)}
    # the reference's expressions, each product and sum in its order, with
    # the temporaries reused in place (a 3.1 GB leaf at full width)
    for name, leaf in p.items():
        for w, g, m, v in zip(_parts(leaf), _parts(grads[name]),
                              _parts(state.m[name]), _parts(state.v[name])):
            if w.device not in scalars:
                scalars[w.device] = tuple(t.to(w.device)
                                          for t in scalars[stepf.device])
            sc, lr_w, bc1_w, bc2_w = scalars[w.device]
            _update_leaf(w, g, m, v, sc, lr_w, bc1_w, bc2_w, cfg)
    return params, AdamWState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}


def _update_leaf(w, g, m, v, scale, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(g.square_().mul_(1 - b2))
    del g
    delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
    if w.dim() >= 1:  # decoupled weight decay
        delta.add_(w.float() * cfg.weight_decay)
    delta.mul_(lr)
    if w.dtype == torch.float32:
        w.sub_(delta)
    else:
        w.copy_((w.float() - delta).to(w.dtype))
