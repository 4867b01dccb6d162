"""Adaptive Kruskal-core rank: plateau-driven grow/shrink of R_core.

Counterpart of ``repro.core.adaptive``.  The controller starts small and
reacts to the validation-RMSE trajectory:

* **plateau** (relative improvement < ``tol`` for ``patience``
  consecutive observations) → double the rank, up to ``max_rank``;
* if the *last* growth bought less than ``grow_gain`` relative RMSE,
  shrink back to the pre-growth rank and stop adapting (the model is
  rank-saturated).

Transitions are pure pad/truncate on the core factors
(``resize_core_rank``): growth appends damped random columns (zero
columns would be dead under the multiplicative Eq.-17 gradient), drawn
from a ``torch.Generator`` or fed (``pad=``, the parity tests' way in);
shrink keeps the top-``R`` columns by multiplicative column energy
Π_n‖B^(n)_{:,r}‖, in their original order.  ``refine_factors`` polishes
the factor matrices with exact ALS / CCD epochs (``core.als`` /
``core.ccd``, whose segment sums fold in a fixed order) against the
materialized Kruskal core; the core factors are kept.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .fasttucker import FastTuckerConfig, FastTuckerParams, init_scale
from .sptensor import SparseTensor


@dataclasses.dataclass(frozen=True)
class RankDecision:
    action: str      # "grow" | "shrink"
    new_rank: int
    reason: str


class RankController:
    """Validation-RMSE plateau detector driving rank transitions.

    Feed every eval's RMSE to ``observe``; it returns a ``RankDecision``
    when the rank should change (the caller applies it with
    ``resize_core_rank``) and ``None`` otherwise.  ``done`` goes True once
    growth stopped paying (or ``max_rank`` plateaued); after that
    ``observe`` only records.  Pure Python: the same RMSE sequence gives
    the reference's decisions.
    """

    def __init__(self, rank: int, max_rank: int, *, tol: float = 0.01,
                 patience: int = 2, grow_gain: float = 0.02):
        if rank < 1 or max_rank < rank:
            raise ValueError(
                f"need 1 <= rank <= max_rank, got {rank}, {max_rank}")
        if tol <= 0 or grow_gain < 0 or patience < 1:
            raise ValueError("tol > 0, grow_gain >= 0, patience >= 1")
        self.rank = rank
        self.max_rank = max_rank
        self.tol = tol
        self.patience = patience
        self.grow_gain = grow_gain
        self.best: float | None = None     # best RMSE at the current rank
        self.stale = 0
        self.grew_from: int | None = None  # rank before the last grow
        self.pre_grow_best: float | None = None
        self.done = False
        self.history: list[tuple[float, int]] = []  # (rmse, rank at obs)

    def observe(self, rmse: float) -> RankDecision | None:
        rmse = float(rmse)
        self.history.append((rmse, self.rank))
        if self.done:
            return None
        if self.best is None or rmse < self.best * (1.0 - self.tol):
            self.best = rmse if self.best is None else min(self.best, rmse)
            self.stale = 0
            return None
        self.best = min(self.best, rmse)
        self.stale += 1
        if self.stale < self.patience:
            return None
        self.stale = 0
        # plateaued at the current rank
        if (self.grew_from is not None
                and self.best > self.pre_grow_best * (1.0 - self.grow_gain)):
            new = self.grew_from
            self.done = True
            self.rank, self.grew_from = new, None
            return RankDecision(
                "shrink", new,
                f"growth to {self.history[-1][1]} bought < "
                f"{self.grow_gain:.0%} RMSE — reverting, rank saturated")
        if self.rank < self.max_rank:
            self.grew_from = self.rank
            self.pre_grow_best = self.best
            self.rank = min(self.rank * 2, self.max_rank)
            self.best = None
            return RankDecision(
                "grow", self.rank,
                f"plateau at rank {self.grew_from} "
                f"(no {self.tol:.0%} improvement for {self.patience} evals)")
        self.done = True
        return None


def core_column_energy(
    core_factors: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Multiplicative column energy e_r = Π_n ‖B^(n)_{:,r}‖₂, the scale of
    rank-one term r in the Kruskal expansion."""
    e = None
    for b in core_factors:
        norms = torch.linalg.vector_norm(b.float(), dim=0)
        e = norms if e is None else e * norms
    return e


def resize_core_rank(
    params: FastTuckerParams,
    cfg: FastTuckerConfig,
    new_rank: int,
    generator: torch.Generator | None = None,
    grow_scale: float = 0.1,
    pad: Sequence[torch.Tensor] | None = None,
) -> tuple[FastTuckerParams, FastTuckerConfig]:
    """Pad or truncate the Kruskal core factors to ``new_rank`` columns.

    Growth appends uniform columns U(0, 2·grow_scale·s) (s the cold scale
    at the new rank), drawn from ``generator`` mode by mode, or the fed
    ``pad`` (per mode (J_n, new_rank − R), f32).  Shrink keeps the
    ``new_rank`` highest-energy columns in their original order: an exact
    joint column sub-selection.  Returns the resized params and the
    rank-updated config; the factor matrices are untouched.
    """
    if new_rank < 1:
        raise ValueError(f"new_rank must be ≥ 1, got {new_rank}")
    new_cfg = dataclasses.replace(cfg, core_rank=new_rank)
    R = params.core_factors[0].shape[1]
    if new_rank == R:
        return params, new_cfg
    if new_rank > R:
        if pad is None:
            if generator is None:
                raise ValueError("growing the rank needs a generator or a "
                                 "fed pad")
            s = grow_scale * init_scale(new_cfg)
            pad = tuple(torch.empty(
                (b.shape[0], new_rank - R), dtype=torch.float32,
                device=b.device).uniform_(0.0, 2 * s, generator=generator)
                for b in params.core_factors)
        core = tuple(torch.cat([b, p.to(device=b.device, dtype=b.dtype)],
                               dim=1)
                     for b, p in zip(params.core_factors, pad))
    else:
        e = core_column_energy(params.core_factors)
        keep = torch.sort(torch.argsort(-e, stable=True)[:new_rank]).values
        core = tuple(b.index_select(1, keep) for b in params.core_factors)
    return FastTuckerParams(params.factors, core), new_cfg


def refine_factors(
    params: FastTuckerParams,
    cfg: FastTuckerConfig,
    tensor: SparseTensor,
    method: str = "als",
    passes: int = 1,
) -> FastTuckerParams:
    """Polish the factor matrices with exact ALS / CCD epochs.

    Materializes the Kruskal core once and runs the baseline's factor-only
    epochs against it in f32 (results rounded back to the storage dtype),
    through ``cfg.backend``'s ``segment_reduce``, the nonzeros sorted once
    for all passes; the Kruskal core factors pass through unchanged.
    ``tensor`` should be a bounded subsample: ALS builds (I_n, J, J) Grams.
    """
    from . import als as als_mod
    from . import ccd as ccd_mod
    from .cutucker import CuTuckerParams
    from .kruskal import kruskal_to_core
    from .sampling import sorted_batch_order

    if method == "als":
        rcfg = als_mod.ALSConfig(dims=cfg.dims, ranks=cfg.ranks,
                                 lambda_a=cfg.lambda_a)
        epoch = als_mod.als_epoch
    elif method == "ccd":
        rcfg = ccd_mod.CCDConfig(dims=cfg.dims, ranks=cfg.ranks,
                                 lambda_a=cfg.lambda_a)
        epoch = ccd_mod.ccd_epoch
    else:
        raise ValueError(f"method must be 'als' or 'ccd', got {method!r}")
    facs = tuple(f.float() for f in params.factors)
    core = kruskal_to_core(tuple(b.float() for b in params.core_factors))
    cup = CuTuckerParams(facs, core)
    order = sorted_batch_order(tensor.indices)
    for _ in range(passes):
        cup = epoch(cup, tensor, rcfg, backend=cfg.backend, order=order)
    factors = tuple(f.to(p.dtype) for f, p in zip(cup.factors,
                                                  params.factors))
    return FastTuckerParams(factors, params.core_factors)


__all__ = [
    "RankDecision",
    "RankController",
    "core_column_energy",
    "resize_core_rank",
    "refine_factors",
]
