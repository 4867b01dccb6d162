"""The step's arithmetic, counted from its shapes.

``kruskal_grad_cost`` is what one ``kruskal_grad`` call must move and do,
its inputs read once and its outputs written once: the count behind the
kernel's bound in ``chip_smoke.py``.  ``step_flops`` adds the rest of one
worker's step under each distributed strategy, and ``core_update_flops``
is the part of it that ``strata_overlap`` issues behind a rotation.  The
counts are exact for the jacobi joint step (the paths ``bench_multidev``
drives); the sampler's and the localization's integer work is not counted.
"""
from __future__ import annotations

STRATA = ("strata", "strata_overlap")


def kruskal_grad_cost(N: int, B: int, J: int, R: int, st: int, nrow: int,
                      core: bool, c_in: bool, c_out: bool
                      ) -> tuple[int, int]:
    """(bytes, flops) one kruskal_grad call must move and do: inputs read
    once (rows and factors in ``st`` bytes), outputs written once."""
    nbytes = st * (N * B * J + N * J * R) + 4 * (2 * B + 5) + 4 * 2 * B
    flops = 3 * N * B * R + 2 * B * R + 4 * B   # chains, pred, err
    if c_in:
        nbytes += 4 * N * B * R
    else:
        flops += 2 * N * B * J * R              # the N mode dots
    if c_out:
        nbytes += 4 * N * B * R
    nbytes += 4 * nrow * B * J
    flops += nrow * B * (2 * J * R + 4 * J)     # Eq. 13 rows
    if core:
        nbytes += 4 * N * J * R
        flops += N * B * (2 * J * R + R) + 2 * N * J * R  # Eq. 17 + seed
    return nbytes, flops


def _ring_adds(elements: int, workers: int) -> float:
    """One worker's adds in a ring all-reduce of ``elements``."""
    return elements * (workers - 1) / workers


def core_update_flops(cfg, workers: int) -> float:
    """One worker's core-factor update: its share of the sum's adds (the
    ring rule, (M − 1)/M of the N·J·R core elements), then p − lr·g, two
    an element."""
    core = sum(J * cfg.core_rank for J in cfg.ranks)
    return _ring_adds(core, workers) + 2 * core


def step_flops(strategy: str, cfg, workers: int) -> float:
    """One worker's FLOPs in one jacobi joint step of ``strategy`` with
    ``workers`` workers and ``cfg.batch_size`` samples a worker:

    * the ``kruskal_grad`` call (``kruskal_grad_cost``: every mode's Eq. 13
      rows and the Eq. 17 core gradient);
    * the row scatter, N·B·J adds;
    * the factor update p − lr·g, two an element, over the rows the worker
      holds: every row of each mode (``local``, ``sync``: dense), or its
      block of ⌈I_n / M⌉ rows (the strata flavours);
    * ``sync``'s dense gradient: its share of the sum of the dense factor
      gradients, (M − 1)/M of Σ I_n·J_n adds (the ring rule);
    * the core update (``core_update_flops``).
    """
    N, B = len(cfg.dims), cfg.batch_size
    J = max(cfg.ranks)
    M = 1 if strategy == "local" else workers
    _, flops = kruskal_grad_cost(N, B, J, cfg.core_rank, 4, N, True, False,
                                 False)
    flops += sum(B * Jn for Jn in cfg.ranks)                   # scatter
    if strategy in STRATA:
        rows = [-(-I // M) for I in cfg.dims]
    else:
        rows = list(cfg.dims)
    factor = sum(I * Jn for I, Jn in zip(rows, cfg.ranks))
    flops += 2 * factor                                         # update
    if strategy == "sync":
        flops += _ring_adds(factor, M)                          # the sum
    return flops + core_update_flops(cfg, M)


__all__ = ["core_update_flops", "kruskal_grad_cost", "step_flops"]
