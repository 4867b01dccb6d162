"""Randomized sketched warm start (``FastTuckerConfig(init="sketched")``).

Counterpart of ``repro.core.sketch``.  Cold SGD spends its first steps
escaping a uniform random init, and with the paper's decaying learning
rate it then plateaus above the noise floor.  The warm start buys both
back with sketched solves over sampled nonzeros, never densifying the
tensor:

1. **Range finders for A^(n).**  Gaussian test matrices
   ``G^(k) ∈ R^{I_k × R_s}`` (R_s = max J + ``sketch_oversample``) and the
   sampled Khatri–Rao sketch of each matricization,
   ``Y_n[i_n, :] = Σ_{(i, x) ∈ Ψ} x · Π_{k≠n} G^(k)[i_k, :]``.  The
   per-sample products are the Eq.-13 exclusive products with identity
   Kruskal factors, so they run through the registry's ``kruskal_grad``
   (``err_override`` = the values, no core stage), shard by shard; the
   rows are summed by ONE ``scatter_row_grads`` over the concatenated
   sample set (the ``scatter_accum`` kernel on ``"cuda"``).  A reduced QR
   of each ``Y_n`` gives orthonormal warm factors; where I_n < J_n the
   missing columns are filled from a cold-scale uniform draw.
2. **Sketched ridge LS for B^(n).**  With A^(n) fixed, x̂ is linear in
   each Kruskal core factor; Gauss–Seidel sweeps solve the
   (J_n·R × J_n·R) normal equations over fresh sample draws, with a ridge
   relative to the Gram's own scale (``_ridge_core_solve``).
3. **Alternating refinement** (``sketch_refine_passes``): one exact ALS
   factor epoch (``core.als.als_update_mode`` against the materialized
   Kruskal core, over all training nonzeros unless
   ``sketch_refine_batch`` caps them) and one core LS sweep a pass.  The
   nonzeros are sorted once per mode and the order reused by every pass.

``_damp_core`` (shrink predictions to the data RMS) and ``_rebalance``
(prediction-preserving rescales to the cold init's magnitudes) keep the
iterate tame between stages.

Parity goes through fed inputs.  PyTorch cannot replay JAX's threefry
keys, so every draw is made first, from one ``torch.Generator`` in a fixed
order (``draw_sketch`` → ``SketchDraws``), and the rest is a pure
function of the draws (``sketched_init_from_draws``); the tests rebuild
the reference's draws from its salts into a ``SketchDraws``.

Determinism and sharding: every cross-sample reduction is one global op
over the concatenated samples, and the per-sample work computed shard by
shard (``num_shards``) does not depend on the shard's size: stage 1's
products against identity factors are exact, and stage 2's mode products
go through ``core.kruskal.mode_product_rows`` (the same operations
whatever the row count; a matmul picks its algorithm by it).  ALS folds
its sums in sorted order (``core.als``).  So the warm start is bitwise
deterministic under a seed and bitwise invariant to ``num_shards``.

Width: the ``"cuda"`` ``kruskal_grad`` takes J, R ≤ 64, so on ``"cuda"``
a sketch width R_s above 64 is refused at the start (``ValueError``); the
``"torch"`` backend takes any width.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import dispatch
from .fasttucker import (FastTuckerConfig, FastTuckerParams, gather_rows,
                         init_scale, scatter_row_grads)
from .kruskal import mode_product_rows
from .sampling import sample_batch_arrays, sorted_batch_order

# the widest J, R the "cuda" kruskal_grad takes (kernels/kruskal_grad.py
# MAX_WIDTH; not imported here: kernels.ref imports this package)
SKETCH_MAX_WIDTH = 64

Pair = tuple[torch.Tensor, torch.Tensor]


def sketch_width(cfg: FastTuckerConfig) -> int:
    """R_s = max J_n + ``sketch_oversample``."""
    return max(cfg.ranks) + cfg.sketch_oversample


def check_sketch_width(cfg: FastTuckerConfig) -> None:
    """Refuse, on ``"cuda"``, a sketch wider than ``kruskal_grad`` takes."""
    R_s = sketch_width(cfg)
    if cfg.backend == "cuda" and R_s > SKETCH_MAX_WIDTH:
        raise ValueError(
            f"sketched warm start: sketch width R_s = max J + oversample = "
            f"{max(cfg.ranks)} + {cfg.sketch_oversample} = {R_s} is above "
            f"{SKETCH_MAX_WIDTH}, the widest the 'cuda' kruskal_grad takes; "
            "lower the rank or the oversample, or use backend='torch'")


class SketchDraws(NamedTuple):
    """Every random input of the warm start (f32 values, int32 indices)."""
    gauss: tuple[torch.Tensor, ...]     # N × (I_n, R_s) N(0, 1) test matrices
    range_samples: Pair                 # (passes·B_s, N), (passes·B_s,)
    fill: tuple[torch.Tensor, ...]      # N × (I_n, short_n) U(0, 2s)
    core0: tuple[torch.Tensor, ...]     # N × (J_n, R) U(0, 2s) LS start
    core_samples: tuple[Pair, ...]      # sweeps·N draws, sweep-major
    damp: Pair                          # the damping estimate's draw
    refine_cap: Pair | None             # sketch_refine_batch draw, or None
    refine_samples: tuple[Pair, ...]    # one core-LS draw per refine pass


def _shard_slices(total: int, num_shards: int) -> list[tuple[int, int]]:
    """Contiguous [start, stop) slices covering ``total`` samples."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be ≥ 1, got {num_shards}")
    num_shards = min(num_shards, total)
    base, rem = divmod(total, num_shards)
    bounds = [0]
    for s in range(num_shards):
        bounds.append(bounds[-1] + base + (1 if s < rem else 0))
    return [(bounds[s], bounds[s + 1]) for s in range(num_shards)]


def _fill_width(cfg: FastTuckerConfig, n: int) -> int:
    """Columns the reduced QR of mode n cannot give (I_n < J_n)."""
    return cfg.ranks[n] - min(cfg.dims[n], sketch_width(cfg), cfg.ranks[n])


def _check_indices(cfg: FastTuckerConfig, indices: torch.Tensor) -> None:
    if indices.dim() != 2 or indices.shape[1] != cfg.order:
        raise ValueError(f"indices must be (nnz, {cfg.order}), got "
                         f"{tuple(indices.shape)}")


def sketch_samples(
    generator: torch.Generator,
    cfg: FastTuckerConfig,
    indices: torch.Tensor,
    values: torch.Tensor,
) -> Pair:
    """The concatenated range-finder sample set: ``sketch_passes`` draws of
    ``sketch_batch_size`` nonzeros each."""
    draws = [sample_batch_arrays(generator, indices, values,
                                 cfg.sketch_batch_size)
             for _ in range(cfg.sketch_passes)]
    return (torch.cat([i for i, _ in draws]),
            torch.cat([v for _, v in draws]).float())


def draw_sketch(
    generator: torch.Generator,
    cfg: FastTuckerConfig,
    indices: torch.Tensor,
    values: torch.Tensor,
) -> SketchDraws:
    """All draws of the warm start from ``generator`` (on the nonzeros'
    device), in this order: the test matrices, the range-finder samples,
    the fill columns, the core start, the core-LS draws, the damping draw,
    the refine cap and the refine draws."""
    check_sketch_width(cfg)
    _check_indices(cfg, indices)
    dev = values.device
    N, R_s, s = cfg.order, sketch_width(cfg), init_scale(cfg)

    def uniform(shape):
        return torch.empty(shape, dtype=torch.float32, device=dev).uniform_(
            0.0, 2 * s, generator=generator)

    def draw(batch):
        i, v = sample_batch_arrays(generator, indices, values, batch)
        return i, v.float()

    gauss = tuple(torch.randn((cfg.dims[n], R_s), generator=generator,
                              dtype=torch.float32, device=dev)
                  for n in range(N))
    range_samples = sketch_samples(generator, cfg, indices, values)
    fill = tuple(uniform((cfg.dims[n], _fill_width(cfg, n)))
                 for n in range(N))
    core0 = tuple(uniform((cfg.ranks[n], cfg.core_rank)) for n in range(N))
    core_samples = tuple(draw(cfg.sketch_batch_size)
                         for _ in range(cfg.sketch_core_sweeps * N))
    damp = draw(cfg.sketch_batch_size)
    refine_cap = (draw(cfg.sketch_refine_batch)
                  if cfg.sketch_refine_passes and cfg.sketch_refine_batch
                  else None)
    refine_samples = tuple(draw(cfg.sketch_batch_size)
                           for _ in range(cfg.sketch_refine_passes))
    return SketchDraws(gauss, range_samples, fill, core0, core_samples,
                       damp, refine_cap, refine_samples)


def _sketch_contributions(bk, gausses, idx, val):
    """Per-sample Khatri–Rao contributions x·Π_{k≠n} G-rows, a tuple of
    (B, R_s) per mode: the fused-gradient pass with identity Kruskal
    factors, row_grads[n] = err_override · (pexc_n @ I) = x · pexc_n."""
    rows = gather_rows(gausses, idx)
    R_s = gausses[0].shape[1]
    eye = torch.eye(R_s, dtype=torch.float32, device=val.device)
    kg = bk.kruskal_grad(
        rows, (eye,) * len(gausses), torch.zeros_like(val),
        lambda_a=0.0, lambda_b=0.0, row_mean=False, core_mean=False,
        err_override=val, want_core=False)
    return kg.row_grads


def sketch_range_finders(
    cfg: FastTuckerConfig,
    gausses: Sequence[torch.Tensor],
    idx: torch.Tensor,
    val: torch.Tensor,
    fill: Sequence[torch.Tensor],
    *,
    num_shards: int = 1,
) -> tuple[torch.Tensor, ...]:
    """Warm factor matrices A^(n): sampled sketch → reduced QR.

    Per-mode (I_n, J_n) f32 with orthonormal columns; ``fill[n]`` supplies
    the columns the QR cannot give where I_n < J_n.  ``num_shards``
    kernel calls compute the contributions; ONE scatter sums them.
    """
    bk = dispatch.get_backend(cfg.backend)
    parts = [_sketch_contributions(bk, gausses, idx[a:b], val[a:b])
             for a, b in _shard_slices(idx.shape[0], num_shards)]
    contrib = tuple(torch.cat([p[n] for p in parts])
                    for n in range(cfg.order))
    Y = scatter_row_grads(gausses, idx, contrib, backend=cfg.backend)
    factors = []
    for n in range(cfg.order):
        q, _ = torch.linalg.qr(Y[n])          # (I_n, min(I_n, R_s))
        a = q[:, :cfg.ranks[n]]
        if fill[n].shape[1]:
            a = torch.cat([a, fill[n]], dim=1)
        factors.append(a.contiguous())
    return tuple(factors)


def _design(rows, core, n, mode_dot):
    """D_b = rows_n[b] ⊗ pexc_b flattened to (B, J_n·R): x̂ = D vec B^(n)."""
    c = [mode_dot(rows[k], core[k]) for k in range(len(rows))]
    pexc = None
    for k in range(len(rows)):
        if k != n:
            pexc = c[k] if pexc is None else pexc * c[k]
    return (rows[n][:, :, None] * pexc[:, None, :]).reshape(
        rows[n].shape[0], -1)


def _matmul(rows, core):
    return rows.float() @ core.float()


def _ridge_core_solve(cfg: FastTuckerConfig, n: int, D: torch.Tensor,
                      val: torch.Tensor) -> torch.Tensor:
    """Solve (DᵀD + λI) vec B = Dᵀval with a scale-relative ridge.

    The orthonormal warm A^(n) make the design entries tiny, so an
    absolute λ_b ridge would collapse B to zero (dead under the
    multiplicative Eq.-17 gradient); shrink by a λ_b fraction of the
    Gram's own scale instead.
    """
    JR = cfg.ranks[n] * cfg.core_rank
    gram = D.T @ D
    lam = cfg.lambda_b * (torch.trace(gram) / JR + 1e-30)
    gram = gram + lam * torch.eye(JR, dtype=torch.float32, device=D.device)
    return torch.linalg.solve(gram, D.T @ val).reshape(cfg.ranks[n],
                                                       cfg.core_rank)


def sketch_core_factors(
    cfg: FastTuckerConfig,
    factors: Sequence[torch.Tensor],
    core0: Sequence[torch.Tensor],
    samples: Sequence[Pair],
    *,
    num_shards: int = 1,
) -> tuple[torch.Tensor, ...]:
    """Warm Kruskal core factors B^(n) by sketched ridge least squares:
    Gauss–Seidel sweeps from ``core0``, one fed draw per (sweep, mode).
    The designs are computed shard by shard (``mode_product_rows``), the
    Gram over the concatenated designs."""
    N = cfg.order
    core = list(core0)
    for k, (idx, val) in enumerate(samples):
        n = k % N
        D = torch.cat([
            _design(gather_rows(factors, idx[a:b]), core, n,
                    mode_product_rows)
            for a, b in _shard_slices(idx.shape[0], num_shards)])
        core[n] = _ridge_core_solve(cfg, n, D, val)
    return tuple(core)


@torch.no_grad()
def _refine_pass(factors, core, idx, val, sidx, sval, cfg, order=None):
    """One alternating-LS pass: an exact ALS factor epoch against the
    materialized Kruskal core over ``idx``/``val`` (``order``: their
    per-mode sort), then one core-LS sweep over the ``sidx``/``sval``
    draw."""
    from .als import als_update_mode
    from .cutucker import CuTuckerParams
    from .kruskal import kruskal_to_core

    dense = kruskal_to_core(core)
    facs = list(factors)
    for n in range(cfg.order):
        facs[n] = als_update_mode(
            CuTuckerParams(tuple(facs), dense), idx, val, n, cfg.dims[n],
            cfg.lambda_a, backend=cfg.backend, order=order)
    factors = tuple(facs)
    core = list(core)
    rows = gather_rows(factors, sidx)
    for n in range(cfg.order):
        core[n] = _ridge_core_solve(cfg, n, _design(rows, core, n, _matmul),
                                    sval)
    return factors, tuple(core)


def sketch_refine(
    cfg: FastTuckerConfig,
    factors: Sequence[torch.Tensor],
    core: Sequence[torch.Tensor],
    ridx: torch.Tensor,
    rval: torch.Tensor,
    samples: Sequence[Pair],
) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """``len(samples)`` alternating-LS passes (stage 3) over the factor
    set ``ridx``/``rval``, sorted once per mode for all passes."""
    order = sorted_batch_order(ridx)
    rval = rval.float()
    factors, core = tuple(factors), tuple(core)
    for sidx, sval in samples:
        factors, core = _refine_pass(factors, core, ridx, rval, sidx, sval,
                                     cfg, order)
    return factors, core


def _damp_core(cfg, factors, core, idx, val):
    """Shrink the core factors so prediction RMS ≤ value RMS on ``idx``:
    one global β^(1/N) per mode, a no-op (β = 1) for healthy fits, that
    keeps an overshooting stage-2 LS from overflowing f32 later."""
    rows = gather_rows(factors, idx)
    c = None
    for k in range(cfg.order):
        ck = rows[k] @ core[k]
        c = ck if c is None else c * ck
    pred_rms = torch.sqrt(torch.mean(torch.sum(c, -1) ** 2))
    val_rms = torch.sqrt(torch.mean(val.float() ** 2))
    beta = torch.clamp(val_rms / torch.clamp(pred_rms, min=1e-30),
                       max=1.0) ** (1.0 / cfg.order)
    return tuple(b * beta for b in core)


def _rebalance(cfg, factors, core):
    """Prediction-preserving rescale to SGD-friendly magnitudes.

    Column j of A^(n) scaled by β and row j of B^(n) by 1/β pins each
    factor column to the cold init's expected norm 2s√(I_n/3); per-rank
    column scalings with Π_n γ_{n,r} = 1 then equalize each rank-one
    term's magnitude across modes (CP-style balancing).  No prediction
    changes but for rounding.
    """
    s = init_scale(cfg)
    a_out, b_out = [], []
    for n, (a, b) in enumerate(zip(factors, core)):
        target = torch.sqrt(torch.tensor(cfg.dims[n] / 3.0,
                                         dtype=torch.float32)) * (2.0 * s)
        beta = target.to(a.device) / torch.clamp(
            torch.linalg.vector_norm(a, dim=0), min=1e-30)
        a_out.append(a * beta[None, :])
        b_out.append(b / beta[:, None])
    norms = torch.clamp(torch.stack(
        [torch.linalg.vector_norm(b, dim=0) for b in b_out]), min=1e-30)
    geo = torch.exp(torch.mean(torch.log(norms), dim=0))
    b_out = [b * (geo / norms[n])[None, :] for n, b in enumerate(b_out)]
    return tuple(a_out), tuple(b_out)


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@torch.no_grad()
def sketched_init_from_draws(
    draws: SketchDraws,
    cfg: FastTuckerConfig,
    indices: torch.Tensor,
    values: torch.Tensor,
    *,
    num_shards: int = 1,
    timings: dict | None = None,
) -> FastTuckerParams:
    """The warm start as a pure function of its draws: range finders →
    core LS → damping and rebalance → refinement → rebalance, stored in
    ``cfg.param_dtype``.  ``timings``, when given, gets each stage's
    seconds (the device synchronized at each stage's end)."""
    check_sketch_width(cfg)
    _check_indices(cfg, indices)
    clock = [time.perf_counter()]

    def stage(name):
        if timings is not None:
            _sync(values)
            now = time.perf_counter()
            timings[name] = now - clock[0]
            clock[0] = now

    factors = sketch_range_finders(cfg, draws.gauss, *draws.range_samples,
                                   draws.fill, num_shards=num_shards)
    stage("range_finder")
    core = sketch_core_factors(cfg, factors, draws.core0,
                               draws.core_samples, num_shards=num_shards)
    stage("core_ls")
    core = _damp_core(cfg, factors, core, *draws.damp)
    factors, core = _rebalance(cfg, factors, core)
    stage("damp_rebalance")
    if draws.refine_samples:
        ridx, rval = draws.refine_cap or (indices, values)
        factors, core = sketch_refine(cfg, factors, core, ridx, rval,
                                      draws.refine_samples)
        factors, core = _rebalance(cfg, factors, core)
    stage("refine")
    return FastTuckerParams(
        tuple(f.to(cfg.param_dtype) for f in factors),
        tuple(b.to(cfg.param_dtype) for b in core))


def sketched_init_params(
    generator: torch.Generator,
    cfg: FastTuckerConfig,
    indices: torch.Tensor,
    values: torch.Tensor,
    *,
    num_shards: int = 1,
    timings: dict | None = None,
) -> FastTuckerParams:
    """The full warm start: ``draw_sketch`` then
    ``sketched_init_from_draws``.  Deterministic under the generator's
    seed and invariant to ``num_shards`` (bitwise)."""
    t0 = time.perf_counter()
    draws = draw_sketch(generator, cfg, indices, values)
    if timings is not None:
        _sync(values)
        timings["draw"] = time.perf_counter() - t0
    return sketched_init_from_draws(draws, cfg, indices, values,
                                    num_shards=num_shards, timings=timings)


__all__ = [
    "SKETCH_MAX_WIDTH",
    "SketchDraws",
    "check_sketch_width",
    "draw_sketch",
    "sketch_core_factors",
    "sketch_range_finders",
    "sketch_refine",
    "sketch_samples",
    "sketch_width",
    "sketched_init_from_draws",
    "sketched_init_params",
]
