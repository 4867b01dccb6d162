"""FastTucker: Kruskal-core sparse Tucker decomposition with SGD (the paper).

Counterpart of ``repro.core.fasttucker`` for one device: the jacobi and
Gauss–Seidel orders, the joint and the phase-split step, unsorted and
mode-sorted batches, f32 and bf16 storage.

Model state:
    factors      : tuple of A^(n) ∈ R^{I_n × J_n}      (feature matrices)
    core_factors : tuple of B^(n) ∈ R^{J_n × R_core}   (Kruskal core, Eq. 9)

Per sampled nonzero (i_1..i_N, x):
    c_r^(n)  = ⟨a_{i_n}, b_{:,r}^(n)⟩                       (Theorem 1)
    x̂        = Σ_r Π_n c_r^(n)
    err      = x̂ − x
    ∂/∂a_{i_n} = err · (Pexc^(n) B^(n)ᵀ) + λ_a a_{i_n}       (Eq. 13 factored)
    ∂/∂B^(n)   = a_{i_n}ᵀ (err ⊙ Pexc^(n)) + λ_b B^(n)       (Eq. 17 factored)
with Pexc^(n)[r] = Π_{k≠n} c_r^(k) (division-free exclusive products).

Kernel selection goes through ``repro_torch.kernels.dispatch``:
``FastTuckerConfig(backend="torch")`` is the plain PyTorch oracle,
``"cuda"`` (the default) routes the contraction, the fused gradients and
the factor-row scatters through the hand-written CUDA kernels.

The step is functional like the reference's: it returns new parameter
tensors and leaves the ones it was given untouched.  ``sgd_step_batch``
takes a fed batch (the parity tests use it); ``sgd_step`` draws the batch
from an explicit ``torch.Generator`` and calls it.

Phase-split step (cuFasterTucker's invariant-intermediate caching): a
factor phase (Eq. 13, B^(n) frozen) emits the mode products
``c^(n) = a_rows^(n) B^(n)`` in ``StepIntermediates``, and the core phase
(Eq. 17) consumes them instead of redoing the N mode dots.  The kernel's
tiling does not depend on its flags, so the jacobi phase-split step equals
the joint step bit for bit, on the card too.  ``factor_phase_step`` and
``core_phase_step`` expose the two phases as separate calls.

Mode-sorted batches (``sorted_batches=True``): every batch is sorted per
mode by ``core.sampling.sorted_batch_order``, and the row gradients are
permuted into that order and scattered through the ``segment_reduce`` op,
which folds each row's duplicates in batch order with no atomics.  The
rows are gathered as on the unsorted path: the reference's dedup gather
(each unique row read once, expanded through the inverse index) gives the
same bits and, in eager PyTorch, costs two gathers of B rows instead of
one.  The sorted step equals the unsorted one bit for bit on the
``"torch"`` backend on the CPU.

bf16 storage (``dtype="bfloat16"``): factors and core factors are stored in
bf16; every dot, residual and gradient is f32, and each update is applied
in f32 and rounded back to bf16.  The sketched warm start is not ported:
``init="sketched"`` raises.

Online refresh (``refresh_step_batch`` on a fed batch, ``refresh_steps``
drawing from a generator): K factor-phase steps with the core frozen, and
the per-mode rows they touched, which the serving tables patch
(``repro_torch.serve``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from .sampling import (SortedBatchOrder, sample_batch_arrays,
                       sorted_batch_order)
from .sptensor import SparseTensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
UPDATE_ORDERS = ("jacobi", "gauss_seidel")


class FastTuckerParams(NamedTuple):
    factors: tuple[torch.Tensor, ...]       # A^(n): (I_n, J_n)
    core_factors: tuple[torch.Tensor, ...]  # B^(n): (J_n, R_core)


@dataclasses.dataclass(frozen=True)
class FastTuckerConfig:
    dims: tuple[int, ...]
    ranks: tuple[int, ...]          # J_n per mode
    core_rank: int                  # R_core
    lambda_a: float = 0.01
    lambda_b: float = 0.01
    alpha_a: float = 0.006          # initial lr, factors (paper Table 7)
    beta_a: float = 0.05
    alpha_b: float = 0.0045         # initial lr, core factors
    beta_b: float = 0.1
    batch_size: int = 4096          # |Ψ|
    init_scale: float | None = None
    update_order: str = "jacobi"    # "jacobi" | "gauss_seidel"
    backend: str | None = None      # None: $REPRO_TORCH_KERNEL_BACKEND/"cuda"
    phase_split: bool = False       # cached two-phase step
    sorted_batches: bool = False    # mode-sorted layout + segment_reduce
    dtype: str = "float32"          # parameter STORAGE dtype (+"bfloat16")
    accum_dtype: str = "float32"    # dot / gradient accumulation dtype
    init: str = "random"            # "sketched" is not ported

    def __post_init__(self) -> None:
        object.__setattr__(self, "backend",
                           dispatch.resolve_backend_name(self.backend))
        dispatch.get_backend(self.backend)  # fail fast on unknown names
        if self.update_order not in UPDATE_ORDERS:
            raise ValueError(f"update_order must be one of {UPDATE_ORDERS}, "
                             f"got {self.update_order!r}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got "
                             f"{self.dtype!r}")
        if self.accum_dtype != "float32":
            raise ValueError(f"accum_dtype must be 'float32' (bf16 storage "
                             f"still accumulates in f32), got "
                             f"{self.accum_dtype!r}")
        if self.init != "random":
            raise NotImplementedError(
                f"FastTuckerConfig(init={self.init!r}) is not ported yet; "
                "the port runs init='random'")

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def param_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def init_scale(cfg: FastTuckerConfig) -> float:
    """The cold-init uniform half-range s, rounded through f32 like the
    reference's ``jnp.sqrt``."""
    if cfg.init_scale is not None:
        return cfg.init_scale
    meanJ = sum(cfg.ranks) / cfg.order
    return float(np.float32((1.0 / cfg.core_rank) ** (0.5 / cfg.order))
                 / np.sqrt(np.float32(meanJ)))


def init_params(
    generator: torch.Generator,
    cfg: FastTuckerConfig,
    device: str | torch.device | None = None,
) -> FastTuckerParams:
    """Cold init: every entry ~ U(0, 2s), drawn from ``generator``.

    x̂ sums R terms, each a product of N dot products of J-vectors; with
    entries ~ U(0, s) its magnitude is ≈ R (s²J)^N, hence ``init_scale``.
    The draw is f32 whatever the storage dtype (the same random stream),
    then rounded to it.  The generator must live on ``device``.
    """
    device = resolve_device(device)
    scale = init_scale(cfg)

    def draw(shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.uniform_(0.0, 2 * scale, generator=generator)
        return t.to(cfg.param_dtype)

    N = cfg.order
    factors = tuple(draw((cfg.dims[n], cfg.ranks[n])) for n in range(N))
    core_factors = tuple(draw((cfg.ranks[n], cfg.core_rank))
                         for n in range(N))
    return FastTuckerParams(factors, core_factors)


def params_from_numpy(
    params,
    device: str | torch.device | None = None,
    dtype: str = "float32",
) -> FastTuckerParams:
    """Any object with ``factors``/``core_factors`` sequences of arrays
    (the reference's ``FastTuckerParams`` included) → tensors of the
    storage ``dtype`` ("float32" or "bfloat16"; bf16 arrays convert
    exactly)."""
    device = resolve_device(device)
    dt = DTYPES[dtype]

    def conv(x):
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        return t.to(device=device, dtype=dt)

    return FastTuckerParams(tuple(conv(f) for f in params.factors),
                            tuple(conv(b) for b in params.core_factors))


def params_to_numpy(params: FastTuckerParams) -> FastTuckerParams:
    """The parameters as numpy f32 arrays (in the same NamedTuple); bf16
    storage converts exactly."""
    def conv(t):
        return t.detach().float().cpu().numpy()

    return FastTuckerParams(tuple(conv(f) for f in params.factors),
                            tuple(conv(b) for b in params.core_factors))


def dynamic_lr(alpha: float, beta: float, t: int) -> torch.Tensor:
    """NOMAD-style decaying rate γ_t = α / (1 + β·t^1.5)   [paper §6.1].

    Every operation in f32, on 0-dim CPU tensors, as the reference does it:
    ``pow`` of two 0-dim f32 CPU tensors is the C library's ``powf``, which
    is what the reference's CPU backend evaluates.  The result is a 0-dim
    f32 CPU tensor; PyTorch passes such a tensor to a CUDA kernel as a
    scalar, so using it costs no copy.
    """
    f32 = torch.float32
    p = torch.pow(torch.tensor(float(t), dtype=f32),
                  torch.tensor(1.5, dtype=f32))
    return torch.tensor(alpha, dtype=f32) / (
        torch.tensor(1.0, dtype=f32) + torch.tensor(beta, dtype=f32) * p)


# ---------------------------------------------------------------------------
# Forward / gradients (batched over the sampling set Ψ)
# ---------------------------------------------------------------------------

def gather_rows(
    factors: Sequence[torch.Tensor],
    idx: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """A^(n)[idx[:, n]] for each mode → tuple of (B, J_n)."""
    return tuple(f.index_select(0, idx[:, n]) for n, f in enumerate(factors))


def _predict_from_rows(
    rows: Sequence[torch.Tensor],
    core_factors: Sequence[torch.Tensor],
    backend: str,
) -> torch.Tensor:
    """Theorem-1 x̂ from already-gathered rows."""
    if backend == "torch":
        # natively differentiable; no autograd Function on the oracle path
        pred, _ = dispatch.get_backend("torch").kruskal_contract(
            rows, core_factors)
        return pred
    return dispatch.kruskal_predict(backend, tuple(rows), tuple(core_factors))


def predict(
    params: FastTuckerParams, idx: torch.Tensor, backend: str | None = None
) -> torch.Tensor:
    """x̂ for a batch of indices (B, N) → (B,).

    Differentiable on every backend: ``"cuda"`` goes through
    ``dispatch.KruskalPredict``, whose backward pass is the fused gradient
    kernel.
    """
    backend = dispatch.resolve_backend_name(backend)
    rows = gather_rows(params.factors, idx)
    return _predict_from_rows(rows, params.core_factors, backend)


def sampled_loss(
    params: FastTuckerParams,
    idx: torch.Tensor,
    val: torch.Tensor,
    lambda_a: float,
    lambda_b: float,
    row_mean: bool = False,
    backend: str | None = None,
) -> torch.Tensor:
    """Sampled objective whose exact gradient the hand-derived forms compute.

    ``row_mean=False`` (paper M=1 semantics): 0.5·Σ_b err² + 0.5·λ_a·Σ_b
    Σ_n‖a_rows‖² + B·0.5·λ_b·Σ_n‖B^(n)‖².  ``row_mean=True``: everything
    averaged over the batch.
    """
    backend = dispatch.resolve_backend_name(backend)
    rows = gather_rows(params.factors, idx)
    pred = _predict_from_rows(rows, params.core_factors, backend)
    err = pred - val
    B = idx.shape[0]
    red = torch.mean if row_mean else torch.sum
    data = 0.5 * red(err ** 2)
    reg_a = 0.5 * lambda_a * sum(red(torch.sum(r ** 2, -1)) for r in rows)
    scale_b = 1.0 if row_mean else float(B)
    reg_b = scale_b * 0.5 * lambda_b * sum(
        torch.sum(b ** 2) for b in params.core_factors)
    return data + reg_a + reg_b


class BatchGrads(NamedTuple):
    row_grads: tuple[torch.Tensor, ...]   # per-mode (B, J_n) — pre-scatter
    core_grads: tuple[torch.Tensor, ...]  # per-mode (J_n, R)
    err: torch.Tensor                     # (B,)
    pred: torch.Tensor                    # (B,)


class StepIntermediates(NamedTuple):
    """Invariant intermediates shared by the two phases of one step.

    B^(n) is frozen during the factor phase and the gathered rows during
    the core phase (jacobi semantics), so the mode products ``c^(n)`` are
    the same in both: the factor phase emits them once and the core phase
    consumes them instead of redoing the N mode dots.
    """
    rows: tuple[torch.Tensor, ...]   # per-mode (B, J_n), storage dtype
    c: tuple[torch.Tensor, ...]      # per-mode (B, R) mode products, f32
    pred: torch.Tensor               # (B,) f32
    err: torch.Tensor                # (B,) masked residual, f32


def batch_gradients(
    params: FastTuckerParams,
    idx: torch.Tensor,
    val: torch.Tensor,
    lambda_a: float,
    lambda_b: float,
    mask: torch.Tensor | None = None,
    row_mean: bool = False,
    backend: str | None = None,
) -> BatchGrads:
    """Fused Eq.13 + Eq.17 gradients for the sampled set (the joint pass).

    ``mask`` (B,) bool zeroes the contributions of padding entries.
    ``row_mean=False`` keeps the paper's per-sample (M=1) row updates; the
    core-factor gradient is always batch-averaged (M=|Ψ|).  On ``"cuda"``
    the contraction and both gradient stages are one kernel call.
    """
    rows = gather_rows(params.factors, idx)
    kg = dispatch.get_backend(backend).kruskal_grad(
        rows, params.core_factors, val,
        mask=mask, lambda_a=lambda_a, lambda_b=lambda_b, row_mean=row_mean)
    return BatchGrads(kg.row_grads, kg.core_grads, kg.err, kg.pred)


def factor_phase_gradients(
    params: FastTuckerParams,
    idx: torch.Tensor,
    val: torch.Tensor,
    lambda_a: float,
    lambda_b: float,
    mask: torch.Tensor | None = None,
    row_mean: bool = False,
    backend: str | None = None,
) -> tuple[BatchGrads, StepIntermediates]:
    """Factor phase: Eq.-13 row gradients + the emitted intermediates.

    One kernel pass computes the mode products, the residual and the row
    gradients, and skips the Eq.-17 stage (``want_core=False``).  Returns
    the gradients (``core_grads=()``) and the ``StepIntermediates`` that
    ``core_phase_gradients`` consumes.
    """
    rows = gather_rows(params.factors, idx)
    kg = dispatch.get_backend(backend).kruskal_grad(
        rows, params.core_factors, val,
        mask=mask, lambda_a=lambda_a, lambda_b=lambda_b, row_mean=row_mean,
        want_core=False, emit_c=True)
    inter = StepIntermediates(rows, kg.c, kg.pred, kg.err)
    return BatchGrads(kg.row_grads, (), kg.err, kg.pred), inter


def core_phase_gradients(
    params: FastTuckerParams,
    idx: torch.Tensor,
    val: torch.Tensor,
    lambda_a: float,
    lambda_b: float,
    mask: torch.Tensor | None = None,
    row_mean: bool = False,
    backend: str | None = None,
    intermediates: StepIntermediates | None = None,
) -> BatchGrads:
    """Core phase: Eq.-17 core-factor gradients (``row_grads=()``).

    With ``intermediates`` the cached rows and mode products are consumed:
    no gather and no mode dots.  Without, the phase gathers and recomputes
    both.
    """
    if intermediates is None:
        rows = gather_rows(params.factors, idx)
        c = None
    else:
        rows, c = intermediates.rows, intermediates.c
    kg = dispatch.get_backend(backend).kruskal_grad(
        rows, params.core_factors, val,
        mask=mask, lambda_a=lambda_a, lambda_b=lambda_b, row_mean=row_mean,
        c=c, row_modes=(), want_core=True)
    return BatchGrads((), kg.core_grads, kg.err, kg.pred)


def batch_layout(
    idx: torch.Tensor, cfg: FastTuckerConfig
) -> SortedBatchOrder | None:
    """The per-mode sort of a sampled batch, or ``None`` when the config
    keeps the unsorted path.  Computed on the batch's device."""
    return sorted_batch_order(idx) if cfg.sorted_batches else None


def step_gradients(
    params: FastTuckerParams,
    idx: torch.Tensor,
    val: torch.Tensor,
    cfg: FastTuckerConfig,
    mask: torch.Tensor | None = None,
) -> BatchGrads:
    """Config-routed gradients: the joint pass, or the two phases with the
    cache handed across.  The same bits either way (f32)."""
    if not cfg.phase_split:
        return batch_gradients(
            params, idx, val, cfg.lambda_a, cfg.lambda_b, mask=mask,
            backend=cfg.backend)
    fg, inter = factor_phase_gradients(
        params, idx, val, cfg.lambda_a, cfg.lambda_b, mask=mask,
        backend=cfg.backend)
    cg = core_phase_gradients(
        params, idx, val, cfg.lambda_a, cfg.lambda_b, mask=mask,
        backend=cfg.backend, intermediates=inter)
    return BatchGrads(fg.row_grads, cg.core_grads, inter.err, inter.pred)


def _scatter_mode(
    bk,
    grads: torch.Tensor,
    idx: torch.Tensor,
    n: int,
    num_rows: int,
    layout: SortedBatchOrder | None,
) -> torch.Tensor:
    """One mode's dense row-gradient scatter: ``scatter_accum`` of the
    unsorted grads, or ``segment_reduce`` of the grads permuted into mode
    n's sorted order."""
    if layout is None:
        return bk.scatter_accum(grads, idx[:, n], num_rows)
    return bk.segment_reduce(grads.index_select(0, layout.perm[n]),
                             layout.sorted_rows[n], num_rows)


def scatter_row_grads(
    factors: Sequence[torch.Tensor],
    idx: torch.Tensor,
    row_grads: Sequence[torch.Tensor],
    backend: str | None = None,
    layout: SortedBatchOrder | None = None,
) -> tuple[torch.Tensor, ...]:
    """Σ_b contributions into dense (I_n, J_n) gradients (segment sum)."""
    bk = dispatch.get_backend(backend)
    return tuple(_scatter_mode(bk, row_grads[n], idx, n, f.shape[0], layout)
                 for n, f in enumerate(factors))


# ---------------------------------------------------------------------------
# SGD steps
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: FastTuckerParams
    step: int


def init_state(
    generator: torch.Generator,
    cfg: FastTuckerConfig,
    device: str | torch.device | None = None,
) -> TrainState:
    """Fresh ``TrainState`` at step 0 (cold init)."""
    return TrainState(init_params(generator, cfg, device), 0)


def _sgd_update(p: torch.Tensor, lr: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """p − lr·g in the gradient dtype (f32), stored in p's dtype; lr·g is
    rounded before the subtraction, as in the reference.  For f32 storage
    the casts are no-ops; for bf16 only the final write rounds."""
    return (p.to(g.dtype) - lr * g).to(p.dtype)


def _apply_updates(
    params: FastTuckerParams,
    idx: torch.Tensor,
    grads: BatchGrads,
    lr_a: torch.Tensor,
    lr_b: torch.Tensor,
    update_factors: bool = True,
    update_core: bool = True,
    backend: str | None = None,
    layout: SortedBatchOrder | None = None,
) -> FastTuckerParams:
    """Dense updates: every A^(n) is rewritten from its dense (I_n, J_n)
    scattered gradient, as the reference does."""
    factors = params.factors
    core_factors = params.core_factors
    if update_factors:
        dense = scatter_row_grads(factors, idx, grads.row_grads,
                                  backend=backend, layout=layout)
        factors = tuple(_sgd_update(f, lr_a, g)
                        for f, g in zip(factors, dense))
    if update_core:
        core_factors = tuple(_sgd_update(b, lr_b, g)
                             for b, g in zip(core_factors, grads.core_grads))
    return FastTuckerParams(factors, core_factors)


def _replace_factor(params: FastTuckerParams, n: int,
                    f: torch.Tensor) -> FastTuckerParams:
    factors = list(params.factors)
    factors[n] = f
    return FastTuckerParams(tuple(factors), params.core_factors)


def _gauss_seidel_joint(params, idx, val, lr_a, lr_b, cfg,
                        update_factors, update_core, layout=None):
    """Gauss–Seidel: one full joint gradient pass per mode, each on the
    rows updated so far (+ one for the core)."""
    bk = dispatch.get_backend(cfg.backend)
    if update_factors:
        for n in range(cfg.order):
            grads = batch_gradients(
                params, idx, val, cfg.lambda_a, cfg.lambda_b,
                backend=cfg.backend)
            g_n = _scatter_mode(bk, grads.row_grads[n], idx, n,
                                params.factors[n].shape[0], layout)
            params = _replace_factor(
                params, n, _sgd_update(params.factors[n], lr_a, g_n))
    if update_core:
        grads = batch_gradients(
            params, idx, val, cfg.lambda_a, cfg.lambda_b,
            backend=cfg.backend)
        params = _apply_updates(
            params, idx, grads, lr_a, lr_b, update_factors=False,
            update_core=True, backend=cfg.backend, layout=layout)
    return params


def _gauss_seidel_phase_split(params, idx, val, lr_a, lr_b, cfg,
                              update_factors, update_core, layout=None):
    """Gauss–Seidel with the cache: updating mode n leaves every other
    mode's product c^(k≠n) and all of B untouched, so the cache holds all
    N mode products and only mode n's is refreshed (one ``mode_dot``)
    after its row update.  Per step 4N dots, against 3N(N+1) in the
    joint form."""
    bk = dispatch.get_backend(cfg.backend)
    N = cfg.order
    rows = list(gather_rows(params.factors, idx))
    c = [bk.mode_dot(rows[n], params.core_factors[n]) for n in range(N)]
    if update_factors:
        for n in range(N):
            kg = bk.kruskal_grad(
                tuple(rows), params.core_factors, val,
                lambda_a=cfg.lambda_a, lambda_b=cfg.lambda_b,
                c=tuple(c), row_modes=(n,), want_core=False)
            g_n = _scatter_mode(bk, kg.row_grads[0], idx, n,
                                params.factors[n].shape[0], layout)
            params = _replace_factor(
                params, n, _sgd_update(params.factors[n], lr_a, g_n))
            rows[n] = params.factors[n].index_select(0, idx[:, n])
            c[n] = bk.mode_dot(rows[n], params.core_factors[n])
    if update_core:
        kg = bk.kruskal_grad(
            tuple(rows), params.core_factors, val,
            lambda_a=cfg.lambda_a, lambda_b=cfg.lambda_b,
            c=tuple(c), row_modes=(), want_core=True)
        params = FastTuckerParams(params.factors, tuple(
            _sgd_update(b, lr_b, g)
            for b, g in zip(params.core_factors, kg.core_grads)))
    return params


@torch.no_grad()
def sgd_step_batch(
    state: TrainState,
    idx: torch.Tensor,
    val: torch.Tensor,
    cfg: FastTuckerConfig,
    update_factors: bool = True,
    update_core: bool = True,
) -> TrainState:
    """One step on a fed batch (idx (B, N) int32, val (B,) f32): the body
    of the reference's ``sgd_step`` without its sampler.

    ``update_core=False`` is the paper's "Factor"-only update; both True is
    "Factor+Core".  ``cfg.update_order``, ``cfg.phase_split`` and
    ``cfg.sorted_batches`` pick the branch.
    """
    layout = batch_layout(idx, cfg)
    lr_a = dynamic_lr(cfg.alpha_a, cfg.beta_a, state.step)
    lr_b = dynamic_lr(cfg.alpha_b, cfg.beta_b, state.step)

    if cfg.update_order == "gauss_seidel":
        gs = (_gauss_seidel_phase_split if cfg.phase_split
              else _gauss_seidel_joint)
        params = gs(state.params, idx, val, lr_a, lr_b, cfg,
                    update_factors, update_core, layout=layout)
    elif cfg.phase_split:
        # jacobi, phased: the core phase consumes the intermediates, whose
        # rows are the ones from before the factor update (joint semantics)
        fg, inter = factor_phase_gradients(
            state.params, idx, val, cfg.lambda_a, cfg.lambda_b,
            backend=cfg.backend)
        params = state.params
        if update_factors:
            params = _apply_updates(
                params, idx, fg, lr_a, lr_b, update_factors=True,
                update_core=False, backend=cfg.backend, layout=layout)
        if update_core:
            cg = core_phase_gradients(
                state.params, idx, val, cfg.lambda_a, cfg.lambda_b,
                backend=cfg.backend, intermediates=inter)
            params = _apply_updates(
                params, idx, cg, lr_a, lr_b, update_factors=False,
                update_core=True, backend=cfg.backend, layout=layout)
    else:  # jacobi: one fused gradient pass, all variables step together
        grads = batch_gradients(
            state.params, idx, val, cfg.lambda_a, cfg.lambda_b,
            backend=cfg.backend)
        params = _apply_updates(
            state.params, idx, grads, lr_a, lr_b,
            update_factors=update_factors, update_core=update_core,
            backend=cfg.backend, layout=layout)
    return TrainState(params, state.step + 1)


def sgd_step(
    state: TrainState,
    generator: torch.Generator,
    indices: torch.Tensor,
    values: torch.Tensor,
    cfg: FastTuckerConfig,
    update_factors: bool = True,
    update_core: bool = True,
) -> TrainState:
    """One stochastic step: draw Ψ from ``generator``, then
    ``sgd_step_batch``."""
    idx, val = sample_batch_arrays(generator, indices, values,
                                   cfg.batch_size)
    return sgd_step_batch(state, idx, val, cfg, update_factors, update_core)


# ---------------------------------------------------------------------------
# the two phases as separate calls (the paper's two-kernel structure)
# ---------------------------------------------------------------------------

@torch.no_grad()
def factor_phase_step(
    state: TrainState,
    generator: torch.Generator,
    indices: torch.Tensor,
    values: torch.Tensor,
    cfg: FastTuckerConfig,
) -> tuple[TrainState, torch.Tensor, torch.Tensor, StepIntermediates]:
    """Phase 1: sample Ψ, update the factor matrices, emit the
    ``StepIntermediates``.

    Returns ``(state', idx, val, intermediates)``; hand all three to
    ``core_phase_step`` to finish the step.  The step counter advances in
    the core phase, so both phases share one learning-rate step.
    """
    idx, val = sample_batch_arrays(generator, indices, values,
                                   cfg.batch_size)
    layout = batch_layout(idx, cfg)
    lr_a = dynamic_lr(cfg.alpha_a, cfg.beta_a, state.step)
    fg, inter = factor_phase_gradients(
        state.params, idx, val, cfg.lambda_a, cfg.lambda_b,
        backend=cfg.backend)
    params = _apply_updates(
        state.params, idx, fg, lr_a, torch.zeros((), dtype=torch.float32),
        update_factors=True, update_core=False, backend=cfg.backend,
        layout=layout)
    return TrainState(params, state.step), idx, val, inter


@torch.no_grad()
def core_phase_step(
    state: TrainState,
    idx: torch.Tensor,
    val: torch.Tensor,
    cfg: FastTuckerConfig,
    intermediates: StepIntermediates | None = None,
) -> TrainState:
    """Phase 2: update the core factors.

    With ``intermediates`` (from ``factor_phase_step``) the cached rows and
    mode products are consumed.  Without, the phase recomputes them from
    ``state.params``, which must then still be the pre-factor-update
    parameters for joint jacobi semantics.
    """
    lr_b = dynamic_lr(cfg.alpha_b, cfg.beta_b, state.step)
    cg = core_phase_gradients(
        state.params, idx, val, cfg.lambda_a, cfg.lambda_b,
        backend=cfg.backend, intermediates=intermediates)
    params = _apply_updates(
        state.params, idx, cg, torch.zeros((), dtype=torch.float32), lr_b,
        update_factors=False, update_core=True, backend=cfg.backend)
    return TrainState(params, state.step + 1)


# ---------------------------------------------------------------------------
# online refresh (bounded factor-phase catch-up over recent nonzeros)
# ---------------------------------------------------------------------------

@torch.no_grad()
def refresh_step_batch(
    state: TrainState,
    idx: torch.Tensor,
    val: torch.Tensor,
    cfg: FastTuckerConfig,
    dirty: Sequence[torch.Tensor],
) -> TrainState:
    """One factor-phase step on a fed batch, core frozen, and the dirty-row
    masks: the body of the reference's ``_refresh_step`` without its
    sampler.  ``dirty[n]`` (a bool tensor of ``I_n`` rows) gets
    ``idx[:, n]`` set in place."""
    layout = batch_layout(idx, cfg)
    lr_a = dynamic_lr(cfg.alpha_a, cfg.beta_a, state.step)
    fg, _ = factor_phase_gradients(
        state.params, idx, val, cfg.lambda_a, cfg.lambda_b,
        backend=cfg.backend)
    params = _apply_updates(
        state.params, idx, fg, lr_a, torch.zeros((), dtype=torch.float32),
        update_factors=True, update_core=False, backend=cfg.backend,
        layout=layout)
    for n, m in enumerate(dirty):
        m[idx[:, n].long()] = True
    return TrainState(params, state.step + 1)


def refresh_steps(
    state: TrainState,
    generator: torch.Generator,
    indices: torch.Tensor,
    values: torch.Tensor,
    cfg: FastTuckerConfig,
    num_steps: int,
) -> tuple[TrainState, tuple[np.ndarray, ...]]:
    """K bounded factor-phase SGD steps over a recent-nonzero window.

    Each step draws Ψ from ``generator`` (on the window's device) and runs
    ``refresh_step_batch``.  The core is frozen, so the serving tables
    C^(n) = A^(n) B^(n) change exactly in the rows the window sampled; the
    returned ``dirty[n]`` is the sorted int32 ``np.ndarray`` of mode-``n``
    row ids touched by any of the K steps, the ids
    ``TuckerServer.update_rows`` must patch.  Returns ``(state', dirty)``.
    """
    if num_steps < 1:
        raise ValueError(f"num_steps must be ≥ 1, got {num_steps}")
    dirty = tuple(torch.zeros((f.shape[0],), dtype=torch.bool,
                              device=f.device)
                  for f in state.params.factors)
    for _ in range(num_steps):
        idx, val = sample_batch_arrays(generator, indices, values,
                                       cfg.batch_size)
        state = refresh_step_batch(state, idx, val, cfg, dirty)
    return state, tuple(torch.nonzero(m).flatten().to(torch.int32).cpu()
                        .numpy() for m in dirty)


def train(
    generator: torch.Generator,
    tensor: SparseTensor,
    cfg: FastTuckerConfig,
    num_steps: int,
    eval_every: int = 0,
    test: SparseTensor | None = None,
    update_core: bool = True,
) -> tuple[TrainState, list[dict]]:
    """Simple single-device training loop on the tensor's device.

    ``generator`` (on the same device) draws the cold init, then every
    batch.  ``update_core=False`` trains the factors alone.
    """
    from .metrics import rmse_mae

    state = init_state(generator, cfg, tensor.device)
    history: list[dict] = []
    for step in range(num_steps):
        state = sgd_step(state, generator, tensor.indices, tensor.values, cfg,
                         update_core=update_core)
        if eval_every and ((step + 1) % eval_every == 0) and test is not None:
            r, m = rmse_mae(state.params, test,
                            lambda p, i: predict(p, i, cfg.backend))
            history.append({"step": step + 1, "rmse": float(r),
                            "mae": float(m)})
    return state, history
