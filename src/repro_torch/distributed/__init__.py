"""Distributed layer: the strategy registry (counterpart of
``repro.distributed``).

``get_strategy("local" | "sync" | "strata" | "strata_overlap")`` returns a
``DistStrategy`` — the uniform prepare/init/step/eval_params/save/restore
interface the launchers drive.  ``local`` runs on one device; the other
three run on an in-process worker mesh (``launch.mesh.make_host_mesh``),
one worker a shard, with ``collectives`` doing the rotations and sums as
explicit copies; every step function carries its ``collectives.Traffic``
as ``step.traffic`` (``benchmarks.bench_multidev`` reads it).  See
``base`` for the contract, ``strata``/``overlap`` for the paper's Fig.-2
scheme and its variant with the rotations issued ahead of use.

Sharded LM training: ``sharding`` holds the reference's logical-axis rules
(``tp``, ``fsdp_tp``, ``fsdp_tp_v2``, ``zero3``, ``zero3_dp``), ``spec_for``
and the ``Layout`` a spec gives a leaf on a mesh; ``context`` the ambient
mesh and activation hooks the model calls; ``sharded_lm`` the LM's loss
over the workers, through ``collectives``' differentiable all-gather and
psum (``launch.steps.make_sharded_train_step``, ``launch.train --mesh``).
"""
from . import context, sharding
from .base import (
    DistState,
    DistStrategy,
    available_strategies,
    compressed_reduce,
    get_strategy,
    register_strategy,
    resolve_strategy_name,
)
from .local import LocalPlan, LocalStrategy
from .overlap import StrataOverlapStrategy
from .strata import StrataStrategy
from .sync import SyncStrategy

register_strategy(LocalStrategy())
register_strategy(SyncStrategy())
register_strategy(StrataStrategy())
register_strategy(StrataOverlapStrategy())

__all__ = [
    "context",
    "sharding",
    "DistState",
    "DistStrategy",
    "available_strategies",
    "compressed_reduce",
    "get_strategy",
    "register_strategy",
    "resolve_strategy_name",
    "LocalPlan",
    "LocalStrategy",
    "SyncStrategy",
    "StrataStrategy",
    "StrataOverlapStrategy",
]
