"""Distributed layer: the strategy registry (counterpart of
``repro.distributed``).

``get_strategy("local")`` returns a ``DistStrategy`` — the uniform
prepare/init/step/eval_params/save/restore interface the launcher drives.
The reference's ``"sync"``, ``"strata"`` and ``"strata_overlap"`` raise
``NotImplementedError`` until they are ported (ROADMAP.md, Queue 1 item
4).  See ``base`` for the contract.
"""
from .base import (
    DistState,
    DistStrategy,
    available_strategies,
    compressed_reduce,
    get_strategy,
    register_strategy,
)
from .local import LocalPlan, LocalStrategy

register_strategy(LocalStrategy())

__all__ = [
    "DistState",
    "DistStrategy",
    "available_strategies",
    "compressed_reduce",
    "get_strategy",
    "register_strategy",
    "LocalPlan",
    "LocalStrategy",
]
