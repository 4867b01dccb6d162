"""Compatibility shim (counterpart of ``repro.distributed.strategy``): the
pre-registry multi-device entry points, re-exported unchanged.

New code picks a strategy from the registry (``repro_torch.distributed``):

    from repro_torch.distributed import get_strategy
    strategy = get_strategy("strata")          # or sync / strata_overlap

    ``shard_nonzeros`` / ``make_sync_step`` / ``init_error_feedback``
        → ``repro_torch.distributed.sync``
    ``StrataPlan`` (now ``StrataLayout``) / ``pad_factors_for_strata`` /
    ``make_strata_step``
        → ``repro_torch.distributed.strata``
"""
from __future__ import annotations

from .strata import (                                         # noqa: F401
    StrataLayout as StrataPlan,
    make_strata_step,
    pad_factors_for_strata,
)
from .sync import (                                           # noqa: F401
    init_error_feedback,
    make_sync_step,
    shard_nonzeros,
)

__all__ = [
    "shard_nonzeros",
    "make_sync_step",
    "init_error_feedback",
    "StrataPlan",
    "pad_factors_for_strata",
    "make_strata_step",
]
