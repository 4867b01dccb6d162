"""FastTucker: Kruskal-core sparse Tucker decomposition with SGD (the paper).

Counterpart of ``repro.core.fasttucker``, for this slice of the port: the
jacobi joint step on unsorted batches in f32 storage.

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
the factor-row scatter through the hand-written CUDA kernels.

The step is functional like the reference's: it returns new parameter
tensors and leaves the ones it was given untouched.  ``sgd_step_batch``
takes a fed batch (the parity tests use it); ``sgd_step`` draws the batch
from an explicit ``torch.Generator`` and calls it.  Still to port: the
Gauss–Seidel order, the phase-split step, sorted batches, bf16 storage
and the sketched warm start — the config raises on each.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from .sampling import sample_batch_arrays
from .sptensor import SparseTensor


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
    update_order: str = "jacobi"
    backend: str | None = None      # None: $REPRO_TORCH_KERNEL_BACKEND/"cuda"
    phase_split: bool = False
    sorted_batches: bool = False
    dtype: str = "float32"          # parameter storage dtype
    accum_dtype: str = "float32"
    init: str = "random"

    def __post_init__(self) -> None:
        object.__setattr__(self, "backend",
                           dispatch.resolve_backend_name(self.backend))
        dispatch.get_backend(self.backend)  # fail fast on unknown names
        later = {
            "update_order": (self.update_order, "jacobi"),
            "phase_split": (self.phase_split, False),
            "sorted_batches": (self.sorted_batches, False),
            "dtype": (self.dtype, "float32"),
            "accum_dtype": (self.accum_dtype, "float32"),
            "init": (self.init, "random"),
        }
        for field, (got, supported) in later.items():
            if got != supported:
                raise NotImplementedError(
                    f"FastTuckerConfig({field}={got!r}) is not ported yet; "
                    f"this slice of the port runs {field}={supported!r}")

    @property
    def order(self) -> int:
        return len(self.dims)


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
    The generator must live on ``device``.
    """
    device = resolve_device(device)
    scale = init_scale(cfg)

    def draw(shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.uniform_(0.0, 2 * scale, generator=generator)

    N = cfg.order
    factors = tuple(draw((cfg.dims[n], cfg.ranks[n])) for n in range(N))
    core_factors = tuple(draw((cfg.ranks[n], cfg.core_rank))
                         for n in range(N))
    return FastTuckerParams(factors, core_factors)


def params_from_numpy(
    params, device: str | torch.device | None = None
) -> FastTuckerParams:
    """Any object with ``factors``/``core_factors`` sequences of arrays
    (the reference's ``FastTuckerParams`` included) → f32 tensors."""
    device = resolve_device(device)

    def conv(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return FastTuckerParams(tuple(conv(f) for f in params.factors),
                            tuple(conv(b) for b in params.core_factors))


def params_to_numpy(params: FastTuckerParams) -> FastTuckerParams:
    """The parameters as numpy f32 arrays (in the same NamedTuple)."""
    def conv(t):
        return t.detach().cpu().numpy()

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
    factors: Sequence[torch.Tensor], idx: torch.Tensor
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


def scatter_row_grads(
    factors: Sequence[torch.Tensor],
    idx: torch.Tensor,
    row_grads: Sequence[torch.Tensor],
    backend: str | None = None,
) -> tuple[torch.Tensor, ...]:
    """Σ_b contributions into dense (I_n, J_n) gradients (segment sum)."""
    bk = dispatch.get_backend(backend)
    cols = idx.t().contiguous()  # (N, B): one contiguous id row per mode
    return tuple(bk.scatter_accum(row_grads[n], cols[n], f.shape[0])
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
    """p − lr·g in the gradient dtype, stored in p's dtype; lr·g is
    rounded before the subtraction, as in the reference."""
    return (p.to(g.dtype) - lr * g).to(p.dtype)


def _apply_updates(
    params: FastTuckerParams,
    idx: torch.Tensor,
    grads: BatchGrads,
    lr_a: torch.Tensor,
    lr_b: torch.Tensor,
    backend: str | None = None,
) -> FastTuckerParams:
    """Dense updates: every A^(n) is rewritten from its dense (I_n, J_n)
    scattered gradient, as the reference does."""
    dense = scatter_row_grads(params.factors, idx, grads.row_grads,
                              backend=backend)
    return FastTuckerParams(
        tuple(_sgd_update(f, lr_a, g)
              for f, g in zip(params.factors, dense)),
        tuple(_sgd_update(b, lr_b, g)
              for b, g in zip(params.core_factors, grads.core_grads)))


@torch.no_grad()
def sgd_step_batch(
    state: TrainState,
    idx: torch.Tensor,
    val: torch.Tensor,
    cfg: FastTuckerConfig,
) -> TrainState:
    """One jacobi step on a fed batch (idx (B, N) int32, val (B,) f32).

    One fused gradient pass, then all variables step together: the core
    gradient uses the rows from before the update.
    """
    lr_a = dynamic_lr(cfg.alpha_a, cfg.beta_a, state.step)
    lr_b = dynamic_lr(cfg.alpha_b, cfg.beta_b, state.step)
    grads = batch_gradients(state.params, idx, val, cfg.lambda_a,
                            cfg.lambda_b, backend=cfg.backend)
    params = _apply_updates(state.params, idx, grads, lr_a, lr_b,
                            backend=cfg.backend)
    return TrainState(params, state.step + 1)


def sgd_step(
    state: TrainState,
    generator: torch.Generator,
    indices: torch.Tensor,
    values: torch.Tensor,
    cfg: FastTuckerConfig,
) -> TrainState:
    """One stochastic step: draw Ψ from ``generator``, then
    ``sgd_step_batch`` (the paper's "Factor+Core" update)."""
    idx, val = sample_batch_arrays(generator, indices, values,
                                   cfg.batch_size)
    return sgd_step_batch(state, idx, val, cfg)


def train(
    generator: torch.Generator,
    tensor: SparseTensor,
    cfg: FastTuckerConfig,
    num_steps: int,
    eval_every: int = 0,
    test: SparseTensor | None = None,
) -> tuple[TrainState, list[dict]]:
    """Simple single-device training loop on the tensor's device.

    ``generator`` (on the same device) draws the cold init, then every
    batch.
    """
    from .metrics import rmse_mae

    state = init_state(generator, cfg, tensor.device)
    history: list[dict] = []
    for step in range(num_steps):
        state = sgd_step(state, generator, tensor.indices, tensor.values, cfg)
        if eval_every and ((step + 1) % eval_every == 0) and test is not None:
            r, m = rmse_mae(state.params, test,
                            lambda p, i: predict(p, i, cfg.backend))
            history.append({"step": step + 1, "rmse": float(r),
                            "mae": float(m)})
    return state, history
