"""cuTucker baseline: stochastic STD with the FULL core tensor (no Kruskal).

Counterpart of ``repro.core.cutucker``: the paper's primary ablation — the
same one-step sampling SGD, but the core is a dense ``G ∈ R^{J_1×…×J_N}``
and the per-sample coefficients carry the exponential ``O(Π_n J_n)`` cost
(§4.3, "condition without the Kruskal product").

Two contraction paths:
  * ``einsum``  — contract G against the gathered rows mode by mode (the
                  efficient dense realization; still exponential state).
  * ``kron``    — materialize the Kronecker rows S^(n)_{j,:} (the naive
                  coefficient construction; exponential memory too).

The dense-core contractions are ``torch.einsum`` (cuBLAS on the card, f32:
the package turns TF32 off), as the reference's are jnp outside any
Pallas kernel.  The row-gradient scatter goes through the kernel registry
(``fasttucker.scatter_row_grads``), so ``CuTuckerConfig(backend="cuda")``
runs the ``scatter_accum`` kernel on the card; the reference passes no
backend there.  The row update is ``f − lr·g`` with no rounding to a
storage dtype (everything is f32), unlike FastTucker's ``_sgd_update``.
``sgd_step_batch`` takes a fed batch (the parity tests use it);
``sgd_step`` draws the batch from a ``torch.Generator`` and calls it.
"""
from __future__ import annotations

import dataclasses
import string
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from .fasttucker import dynamic_lr, gather_rows, scatter_row_grads
from .sampling import sample_batch_arrays

CONTRACTIONS = ("einsum", "kron")


class CuTuckerParams(NamedTuple):
    factors: tuple[torch.Tensor, ...]  # A^(n): (I_n, J_n)
    core: torch.Tensor                 # G: (J_1, ..., J_N)


@dataclasses.dataclass(frozen=True)
class CuTuckerConfig:
    dims: tuple[int, ...]
    ranks: tuple[int, ...]
    lambda_a: float = 0.01
    lambda_g: float = 0.01
    alpha_a: float = 0.006
    beta_a: float = 0.05
    alpha_g: float = 0.0045
    beta_g: float = 0.1
    batch_size: int = 4096
    contraction: str = "einsum"  # "einsum" | "kron"
    backend: str | None = None   # the row scatter's; None: the registry's

    def __post_init__(self) -> None:
        object.__setattr__(self, "backend",
                           dispatch.resolve_backend_name(self.backend))
        dispatch.get_backend(self.backend)  # fail fast on unknown names
        if self.contraction not in CONTRACTIONS:
            raise ValueError(f"contraction must be one of {CONTRACTIONS}, "
                             f"got {self.contraction!r}")

    @property
    def order(self) -> int:
        return len(self.dims)


def init_scale(cfg: CuTuckerConfig) -> float:
    """Half-range s of the U(0, 2s) init, chosen so that E[x̂] ≈ 1 (the
    reference's heuristic, in Python floats)."""
    N = cfg.order
    meanJ = sum(cfg.ranks) / N
    core_n = 1.0
    for j in cfg.ranks:
        core_n *= j
    s = (1.0 / core_n) ** (1.0 / (2 * (N + 1)))
    return s / (meanJ ** (N / (2.0 * (N + 1))))


def init_params(
    generator: torch.Generator,
    cfg: CuTuckerConfig,
    device: str | torch.device | None = None,
) -> CuTuckerParams:
    """Every entry ~ U(0, 2s): the factors in mode order, then the core,
    drawn from ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    s = init_scale(cfg)

    def draw(shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.uniform_(0.0, 2 * s, generator=generator)

    factors = tuple(draw((cfg.dims[n], cfg.ranks[n]))
                    for n in range(cfg.order))
    return CuTuckerParams(factors, draw(tuple(cfg.ranks)))


def params_from_numpy(
    params, device: str | torch.device | None = None
) -> CuTuckerParams:
    """Any object with ``factors`` and ``core`` arrays (the reference's
    ``CuTuckerParams`` included) → f32 tensors on ``device``."""
    device = resolve_device(device)

    def conv(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return CuTuckerParams(tuple(conv(f) for f in params.factors),
                          conv(params.core))


def params_to_numpy(params: CuTuckerParams) -> CuTuckerParams:
    """The parameters as numpy f32 arrays (in the same NamedTuple)."""
    def conv(t):
        return t.detach().float().cpu().numpy()

    return CuTuckerParams(tuple(conv(f) for f in params.factors),
                          conv(params.core))


_LETTERS = string.ascii_lowercase


def _contract_all(core: torch.Tensor,
                  rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """x̂[b] = G ×₁ a^(1)[b] … ×_N a^(N)[b]  → (B,). Einsum path."""
    N = core.dim()
    row_subs = [f"z{_LETTERS[n]}" for n in range(N)]
    expr = _LETTERS[:N] + "," + ",".join(row_subs) + "->z"
    return torch.einsum(expr, core, *rows)


def _contract_except(core: torch.Tensor, rows: Sequence[torch.Tensor],
                     n: int) -> torch.Tensor:
    """d^(n)[b] = G ×_{k≠n} a^(k)[b]  → (B, J_n)."""
    N = core.dim()
    row_subs = [f"z{_LETTERS[k]}" for k in range(N) if k != n]
    operands = [rows[k] for k in range(N) if k != n]
    expr = (_LETTERS[:N] + "," + ",".join(row_subs)
            + f"->z{_LETTERS[n]}")
    return torch.einsum(expr, core, *operands)


def _kron_rows(rows: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """Materialize the S^(n) rows: ⊗_{k≠n, descending} a^(k)[b]
    → (B, Π_{k≠n} J_k), the per-sample Kronecker product of the rows in
    descending mode order (the naive exponential-memory path)."""
    out = None
    for k in reversed([k for k in range(len(rows)) if k != n]):
        r = rows[k]
        out = r if out is None else (
            out[:, :, None] * r[:, None, :]).reshape(r.shape[0], -1)
    return out


def predict(params: CuTuckerParams, idx: torch.Tensor) -> torch.Tensor:
    rows = gather_rows(params.factors, idx)
    return _contract_all(params.core, rows)


def sampled_loss(params, idx, val, lambda_a, lambda_g, row_mean=False):
    """The sampled objective whose gradient ``batch_gradients`` computes
    (see ``fasttucker.sampled_loss`` for the scaling)."""
    rows = gather_rows(params.factors, idx)
    err = _contract_all(params.core, rows) - val
    B = idx.shape[0]
    red = torch.mean if row_mean else torch.sum
    data = 0.5 * red(err ** 2)
    reg_a = 0.5 * lambda_a * sum(red(torch.sum(r ** 2, -1)) for r in rows)
    scale_g = 1.0 if row_mean else float(B)
    reg_g = scale_g * 0.5 * lambda_g * torch.sum(params.core ** 2)
    return data + reg_a + reg_g


class CuGrads(NamedTuple):
    row_grads: tuple[torch.Tensor, ...]
    core_grad: torch.Tensor
    err: torch.Tensor


def batch_gradients(
    params: CuTuckerParams,
    idx: torch.Tensor,
    val: torch.Tensor,
    lambda_a: float,
    lambda_g: float,
    contraction: str = "einsum",
    row_mean: bool = False,
) -> CuGrads:
    rows = gather_rows(params.factors, idx)
    N = len(rows)
    B = idx.shape[0]
    core = params.core
    if contraction == "kron":
        # literal coefficient construction: d^(n) = G^(n) S^(n)ᵀ rows
        pred = None
        dvecs = []
        for n in range(N):
            s_rows = _kron_rows(rows, n)                      # (B, Πk≠n Jk)
            # the kron rows run over the other modes in DESCENDING order:
            # match them with the unfolding whose remaining axes are
            # reversed
            rest = [k for k in range(N) if k != n]
            g_perm = core.permute([n] + rest[::-1]).reshape(
                core.shape[n], -1)
            d = s_rows @ g_perm.T                              # (B, J_n)
            dvecs.append(d)
            if pred is None:
                pred = torch.sum(rows[n] * d, dim=-1)
    else:
        dvecs = [_contract_except(core, rows, n) for n in range(N)]
        pred = torch.sum(rows[0] * dvecs[0], dim=-1)
    err = pred - val
    row_denom = float(B) if row_mean else 1.0
    w_row = err / row_denom
    w_core = err / B
    row_grads = tuple(
        w_row[:, None] * dvecs[n] + (lambda_a / row_denom) * rows[n]
        for n in range(N))
    # ∂/∂G = Σ_b w_b · ⊗_n a^(n)[b]  + λ_g G   (exponential-size outer)
    outer_sub = ",".join(f"z{_LETTERS[n]}" for n in range(N))
    core_grad = (torch.einsum("z," + outer_sub + "->" + _LETTERS[:N],
                              w_core, *rows)
                 + lambda_g * core)
    return CuGrads(row_grads, core_grad, err)


class CuState(NamedTuple):
    params: CuTuckerParams
    step: int


def init_state(
    generator: torch.Generator,
    cfg: CuTuckerConfig,
    device: str | torch.device | None = None,
) -> CuState:
    return CuState(init_params(generator, cfg, device), 0)


@torch.no_grad()
def sgd_step_batch(
    state: CuState,
    idx: torch.Tensor,
    val: torch.Tensor,
    cfg: CuTuckerConfig,
    update_core: bool = True,
) -> CuState:
    """One step on a fed batch (idx (B, N) int32, val (B,) f32): the body
    of the reference's ``sgd_step`` without its sampler."""
    grads = batch_gradients(state.params, idx, val, cfg.lambda_a,
                            cfg.lambda_g, cfg.contraction)
    lr_a = dynamic_lr(cfg.alpha_a, cfg.beta_a, state.step)
    lr_g = dynamic_lr(cfg.alpha_g, cfg.beta_g, state.step)
    dense = scatter_row_grads(state.params.factors, idx, grads.row_grads,
                              backend=cfg.backend)
    factors = tuple(f - lr_a * g for f, g in zip(state.params.factors, dense))
    core = state.params.core
    if update_core:
        core = core - lr_g * grads.core_grad
    return CuState(CuTuckerParams(factors, core), state.step + 1)


def sgd_step(
    state: CuState,
    generator: torch.Generator,
    indices: torch.Tensor,
    values: torch.Tensor,
    cfg: CuTuckerConfig,
    update_core: bool = True,
) -> CuState:
    """One stochastic step: draw Ψ from ``generator``, then
    ``sgd_step_batch``."""
    idx, val = sample_batch_arrays(generator, indices, values,
                                   cfg.batch_size)
    return sgd_step_batch(state, idx, val, cfg, update_core)
