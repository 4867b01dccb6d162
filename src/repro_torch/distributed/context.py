"""Ambient mesh and activation-layout hooks (the port's copy of
``repro.distributed.context``).

Model code is mesh-agnostic; a launcher may install a function applied to
the residual stream at every layer boundary (``constrain``) and one
applied to the logits (``constrain_logits``), and the active mesh
(``set_mesh``/``current_mesh``; the reference's MoE reads it to take its
expert-parallel island, the port's sharded step hands its layers the
mesh's split explicitly, ``distributed.sharded_lm``).  By default all
three are no-ops.  The reference's
``make_seq_constraint``/``make_logits_constraint`` build XLA sharding
constraints for its dry run, which is not ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

_CONSTRAIN: Optional[Callable] = None
_CONSTRAIN_LOGITS: Optional[Callable] = None
_MESH = None


def set_mesh(mesh) -> None:
    """Install the active mesh."""
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


def set_activation_constraint(fn: Optional[Callable]) -> None:
    global _CONSTRAIN
    _CONSTRAIN = fn


def constrain(x: torch.Tensor) -> torch.Tensor:
    if _CONSTRAIN is None:
        return x
    return _CONSTRAIN(x)


def set_logits_constraint(fn: Optional[Callable]) -> None:
    global _CONSTRAIN_LOGITS
    _CONSTRAIN_LOGITS = fn


def constrain_logits(x: torch.Tensor) -> torch.Tensor:
    if _CONSTRAIN_LOGITS is None:
        return x
    return _CONSTRAIN_LOGITS(x)
