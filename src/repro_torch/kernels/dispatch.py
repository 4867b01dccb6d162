"""Named kernel-backend registry, counterpart of ``repro.kernels.dispatch``.

    ``"torch"``  plain PyTorch ops; the numerics oracle (the reference's
                 ``"xla"`` backend); runs on any device
    ``"cuda"``   the hand-written CUDA kernels (``kruskal_contract``,
                 ``kruskal_grad``, ``scatter_accum``, ``segment_reduce``,
                 ``tucker_matmul``, ``flash_attention``,
                 ``flash_attention_bwd``, ``mode_product_rows``,
                 ``patch_table_rows``); the default.  On CPU
                 tensors each kernel wrapper computes its plain version,
                 so this backend is testable on the CPU the way the
                 reference's ``"pallas_interpret"`` is; on CUDA tensors it
                 launches the kernels or raises

Resolution order for ``get_backend(name)``:

    explicit ``name`` argument  >  ``$REPRO_TORCH_KERNEL_BACKEND``  >  ``"cuda"``

``register_backend`` adds another (a benchmark's variant); an existing name
is refused.

Both backends speak the tuple-of-modes layout (per-mode ``(B, J_n)``
gathered rows and ``(J_n, R)`` Kruskal factors with possibly distinct
``J_n``); the ``"cuda"`` backend zero-pads to the stacked ``(N, B, J)``
kernel layout and unpads the results — exact, since padded columns add 0
to every dot product and get zero gradients.

Ops per backend: ``kruskal_contract`` (``want_pexc=False`` returns ``pred``
alone), ``kruskal_grad`` (every phase flag),
``scatter_accum`` (unsorted batches), ``segment_reduce`` (mode-sorted
batches, ``core.sampling.sorted_batch_order``), ``mode_dot`` (a plain
matmul on both), and the LM's ``tucker_matmul`` (Tucker-2 factorized
linear), ``flash_attention`` (softmax attention of the model's
(B, S, H, D) layout with grouped KV heads, ``q_offset`` and ``kv_len``;
``return_lse`` also gives the rows' log-sum-exps) and
``flash_attention_bwd`` (its gradients, recomputed from that lse); and
the serving tables' ``mode_product_rows`` (C = A B, the same bits for a
row whatever the row count) and ``patch_table_rows`` (the row patch of
``TuckerServer.update_rows``).
Rows and factors may be stored in bf16; every dot, residual and gradient is f32, the only accumulation dtype the reference's
config takes.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"
DEFAULT_BACKEND = "cuda"


class KruskalGrads(NamedTuple):
    """Fused forward+gradient results in the tuple-of-modes layout.

    ``row_grads`` follows the requested ``row_modes`` order (all modes by
    default) and is ``()`` when the row stage was skipped; ``core_grads``
    is ``()`` when ``want_core=False``; ``c`` holds the per-mode ``(B, R)``
    mode products when ``emit_c=True`` and ``()`` otherwise.
    """
    pred: torch.Tensor                       # (B,)
    err: torch.Tensor                        # (B,) masked residual
    row_grads: tuple[torch.Tensor, ...]      # per requested mode (B, J_n)
    core_grads: tuple[torch.Tensor, ...]     # per-mode (J_n, R)
    c: tuple[torch.Tensor, ...] = ()         # per-mode (B, R) when emitted


def _mode_dot(rows_n: torch.Tensor, core_n: torch.Tensor) -> torch.Tensor:
    """Single-mode product c^(n) = a_rows^(n) B^(n) → (B, R) in f32: a
    plain matmul on every backend, never a kernel of this package (the
    Gauss–Seidel phase-split step refreshes one cached product with it)."""
    return torch.matmul(rows_n.float(), core_n.float())


def _denominators(
    batch: int,
    mask: torch.Tensor | None,
    row_mean: bool,
    core_mean: bool,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_denom ρ, core_denom δ) matching the paper's M=1 semantics."""
    one = torch.ones((), dtype=torch.float32, device=device)
    if core_mean:
        if mask is not None:
            core = torch.clamp(mask.sum(dtype=torch.float32), min=1.0)
        else:
            core = torch.full((), float(batch), dtype=torch.float32,
                              device=device)
    else:
        core = one
    row = core if row_mean else one
    return row, core


# ---------------------------------------------------------------------------
# "torch" — plain PyTorch reference backend
# ---------------------------------------------------------------------------

class TorchBackend:
    """Plain PyTorch ops; the numerics oracle the kernels must match."""

    name = "torch"

    mode_dot = staticmethod(_mode_dot)

    def kruskal_contract(
        self,
        rows: Sequence[torch.Tensor],
        core_factors: Sequence[torch.Tensor],
        want_pexc: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        from repro_torch.core.kruskal import exclusive_products, mode_dots

        full, pexc = exclusive_products(mode_dots(rows, core_factors))
        return full.sum(dim=-1), (pexc if want_pexc else None)

    def kruskal_grad(
        self,
        rows: Sequence[torch.Tensor],
        core_factors: Sequence[torch.Tensor],
        val: torch.Tensor,
        *,
        mask: torch.Tensor | None = None,
        lambda_a: float = 0.0,
        lambda_b: float = 0.0,
        row_mean: bool = False,
        core_mean: bool = True,
        err_override: torch.Tensor | None = None,
        c: Sequence[torch.Tensor] | None = None,
        row_modes: tuple[int, ...] | None = None,
        want_core: bool = True,
        emit_c: bool = False,
    ) -> KruskalGrads:
        from repro_torch.core.kruskal import exclusive_products, mode_dots

        N = len(rows)
        if row_modes is None:
            row_modes = tuple(range(N))
        if c is None:
            c_stack = None
            pred, pexc = self.kruskal_contract(rows, core_factors)
        else:
            c_stack = torch.stack(tuple(c), dim=0).float()  # (N, B, R)
            full, pexc = exclusive_products(c_stack)
            pred = full.sum(dim=-1)
        err = err_override if err_override is not None else pred - val
        if mask is not None:
            err = torch.where(mask, err, torch.zeros_like(err))
        row_denom, core_denom = _denominators(
            val.shape[0], mask, row_mean, core_mean, val.device)
        w_row = err / row_denom
        w_core = err / core_denom
        row_grads = []
        for n in row_modes:
            # (B, J_n)
            d_n = torch.matmul(pexc[n], core_factors[n].float().T)
            reg_rows = rows[n].float()
            if mask is not None:
                reg_rows = torch.where(mask[:, None], reg_rows,
                                       torch.zeros_like(reg_rows))
            row_grads.append(
                w_row[:, None] * d_n + (lambda_a / row_denom) * reg_rows)
        core_grads = []
        if want_core:
            for n in range(N):
                # λ_b·B in the storage dtype, as the reference's "xla"
                core_grads.append(
                    torch.matmul(rows[n].float().T, w_core[:, None] * pexc[n])
                    + lambda_b * core_factors[n])
        c_out = ()
        if emit_c:
            if c_stack is None:
                c_stack = mode_dots(rows, core_factors)
            c_out = tuple(c_stack[n] for n in range(N))
        return KruskalGrads(pred, err, tuple(row_grads), tuple(core_grads),
                            c_out)

    def scatter_accum(
        self, grads: torch.Tensor, idx: torch.Tensor, num_rows: int
    ) -> torch.Tensor:
        from .ref import scatter_accum_ref

        return scatter_accum_ref(grads, idx, num_rows)

    def segment_reduce(
        self, grads: torch.Tensor, idx: torch.Tensor, num_rows: int
    ) -> torch.Tensor:
        """Sorted-batch scatter: ``grads``/``idx`` in mode-sorted order
        (duplicates adjacent, in batch order), folded in that order —
        bitwise equal to ``scatter_accum`` of the unsorted batch on the
        CPU."""
        from .ref import segment_reduce_ref

        return segment_reduce_ref(grads, idx, num_rows)

    def mode_product_rows(self, rows: torch.Tensor,
                          core: torch.Tensor) -> torch.Tensor:
        from .ref import mode_product_rows_ref

        return mode_product_rows_ref(rows, core)

    def patch_table_rows(self, table, colsum, mirror, core, ids, rows):
        from .ref import patch_table_rows_ref

        return patch_table_rows_ref(table, colsum, mirror, core, ids, rows)

    def tucker_matmul(self, x, u1, g, u2) -> torch.Tensor:
        from .ref import tucker_matmul_ref

        return tucker_matmul_ref(x, u1, g, u2)

    def flash_attention(self, q, k, v, *, causal: bool = True,
                        kv_len: int | None = None, q_offset: int = 0,
                        return_lse: bool = False):
        from .ref import flash_attention_ref

        return flash_attention_ref(q, k, v, causal, kv_len=kv_len,
                                   q_offset=q_offset, return_lse=return_lse)

    def flash_attention_bwd(self, q, k, v, o, lse, dout, *,
                            causal: bool = True, kv_len: int | None = None,
                            q_offset: int = 0):
        from .ref import flash_attention_bwd_ref

        return flash_attention_bwd_ref(q, k, v, o, lse, dout, causal,
                                       kv_len=kv_len, q_offset=q_offset)


# ---------------------------------------------------------------------------
# "cuda" — the hand-written kernels
# ---------------------------------------------------------------------------

def _stack_padded_rows(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    jmax = max(r.shape[-1] for r in rows)
    return torch.stack(
        [r if r.shape[-1] == jmax else F.pad(r, (0, jmax - r.shape[-1]))
         for r in rows], dim=0)


def _stack_padded_factors(core_factors: Sequence[torch.Tensor]) -> torch.Tensor:
    jmax = max(cf.shape[0] for cf in core_factors)
    return torch.stack(
        [cf if cf.shape[0] == jmax else F.pad(cf, (0, 0, 0, jmax - cf.shape[0]))
         for cf in core_factors], dim=0)


def _kernel_scalars(
    batch: int,
    mask: torch.Tensor | None,
    row_mean: bool,
    core_mean: bool,
    lambda_a: float,
    lambda_b: float,
    pred_coef: float,
    device: torch.device,
) -> torch.Tensor:
    """The (5,) ``[1/ρ, 1/δ, λ_a, λ_b, pred_coef]`` vector of the kernel.

    Without a mask every entry is known on the host, so it is formed there
    in f32 (the same divisions the device would do) and copied once;
    with a mask δ is a device-side count.
    """
    if mask is None:
        one = np.float32(1.0)
        core = np.float32(batch) if core_mean else one
        row = core if row_mean else one
        host = np.array([one / row, one / core, lambda_a, lambda_b,
                         pred_coef], dtype=np.float32)
        return torch.from_numpy(host).to(device)
    row_denom, core_denom = _denominators(batch, mask, row_mean, core_mean,
                                          device)
    consts = torch.tensor([lambda_a, lambda_b, pred_coef],
                          dtype=torch.float32).to(device)
    return torch.cat([(1.0 / row_denom).reshape(1),
                      (1.0 / core_denom).reshape(1), consts])


# An all-ones mask per (device, batch), made once: the kernel only reads it,
# and a fresh one each call would be a fill kernel in every step.
_ONES: dict[tuple[torch.device, int], torch.Tensor] = {}


def _ones_mask(val: torch.Tensor) -> torch.Tensor:
    key = (val.device, val.shape[0])
    ones = _ONES.get(key)
    if ones is None:
        ones = torch.ones(val.shape[0], dtype=torch.float32, device=val.device)
        _ONES[key] = ones
    return ones


class CudaBackend:
    """The CUDA kernels; on CPU tensors each wrapper's plain version."""

    name = "cuda"

    mode_dot = staticmethod(_mode_dot)

    def kruskal_contract(
        self,
        rows: Sequence[torch.Tensor],
        core_factors: Sequence[torch.Tensor],
        want_pexc: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        from .kruskal_contract import kruskal_contract as kc

        return kc(_stack_padded_rows(rows),
                  _stack_padded_factors(core_factors), want_pexc)

    def kruskal_grad(
        self,
        rows: Sequence[torch.Tensor],
        core_factors: Sequence[torch.Tensor],
        val: torch.Tensor,
        *,
        mask: torch.Tensor | None = None,
        lambda_a: float = 0.0,
        lambda_b: float = 0.0,
        row_mean: bool = False,
        core_mean: bool = True,
        err_override: torch.Tensor | None = None,
        c: Sequence[torch.Tensor] | None = None,
        row_modes: tuple[int, ...] | None = None,
        want_core: bool = True,
        emit_c: bool = False,
    ) -> KruskalGrads:
        from .kruskal_grad import kruskal_grad as kg

        a = _stack_padded_rows(rows)
        b = _stack_padded_factors(core_factors)
        if mask is None:
            mask_f = _ones_mask(val)
        else:
            mask_f = mask.to(torch.float32)
        if err_override is not None:
            # err = (0·pred − (−ḡ))·mask = ḡ EXACTLY — not pred − (pred − ḡ),
            # which cancels to 0 in f32 whenever |ḡ| < ulp(pred)
            val_in, pred_coef = -err_override, 0.0
        else:
            val_in, pred_coef = val, 1.0
        scal = _kernel_scalars(val.shape[0], mask, row_mean, core_mean,
                               lambda_a, lambda_b, pred_coef, val.device)
        c_stacked = (None if c is None
                     else torch.stack(tuple(c), dim=0).float())
        outs = kg(a, b, val_in.float().contiguous(), mask_f, scal,
                  c_stacked, row_modes=row_modes, want_core=want_core,
                  emit_c=emit_c)
        if row_modes is None:
            row_modes = tuple(range(len(rows)))
        row_grads = tuple(
            outs.row_grads[j, :, : rows[n].shape[-1]]
            for j, n in enumerate(row_modes)) if row_modes else ()
        core_grads = tuple(
            outs.core_grads[n, : cf.shape[0]]
            for n, cf in enumerate(core_factors)) if want_core else ()
        c_out = (tuple(outs.c[n] for n in range(len(rows)))
                 if emit_c else ())
        return KruskalGrads(outs.pred, outs.err, row_grads, core_grads, c_out)

    def scatter_accum(
        self, grads: torch.Tensor, idx: torch.Tensor, num_rows: int
    ) -> torch.Tensor:
        from .scatter_accum import scatter_accum as sa

        return sa(grads.contiguous(), idx.to(torch.int32).contiguous(),
                  num_rows)

    def segment_reduce(
        self, grads: torch.Tensor, idx: torch.Tensor, num_rows: int
    ) -> torch.Tensor:
        from .segment_reduce import segment_reduce as sr

        return sr(grads.contiguous(), idx.to(torch.int32).contiguous(),
                  num_rows)

    def mode_product_rows(self, rows: torch.Tensor,
                          core: torch.Tensor) -> torch.Tensor:
        from .mode_product_rows import mode_product_rows as mpr

        return mpr(rows.contiguous(), core.contiguous())

    def patch_table_rows(self, table, colsum, mirror, core, ids, rows):
        from .mode_product_rows import patch_table_rows as ptr

        return ptr(table, colsum, mirror, core.contiguous(), ids,
                   rows.contiguous())

    def tucker_matmul(self, x, u1, g, u2) -> torch.Tensor:
        from .tucker_matmul import tucker_matmul as tm

        return tm(x.contiguous(), u1.contiguous(), g.contiguous(),
                  u2.contiguous())

    def flash_attention(self, q, k, v, *, causal: bool = True,
                        kv_len: int | None = None, q_offset: int = 0,
                        return_lse: bool = False):
        from .flash_attention import flash_attention as fa

        return fa(q, k, v, causal=causal, kv_len=kv_len, q_offset=q_offset,
                  return_lse=return_lse)

    def flash_attention_bwd(self, q, k, v, o, lse, dout, *,
                            causal: bool = True, kv_len: int | None = None,
                            q_offset: int = 0):
        from .flash_attention_bwd import flash_attention_bwd as fb

        return fb(q, k, v, o, lse, dout, causal=causal, kv_len=kv_len,
                  q_offset=q_offset)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, object] = {
    b.name: b for b in (TorchBackend(), CudaBackend())}


def register_backend(backend) -> None:
    """Register ``backend`` (any object with the op methods + ``name``)
    under a name not yet taken."""
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_backend_name(name: str | None = None) -> str:
    """explicit arg > $REPRO_TORCH_KERNEL_BACKEND > "cuda"."""
    if name:
        return name
    return os.environ.get(ENV_VAR) or DEFAULT_BACKEND


def get_backend(name: str | None = None):
    resolved = resolve_backend_name(name)
    try:
        return _REGISTRY[resolved]
    except KeyError:
        raise KeyError(
            f"unknown kernel backend {resolved!r}; "
            f"available: {available_backends()}") from None


# ---------------------------------------------------------------------------
# differentiable entry point
# ---------------------------------------------------------------------------

class KruskalPredict(torch.autograd.Function):
    """Theorem-1 prediction whose two passes both run through a backend.

    Forward: the backend's ``kruskal_contract``, asked for ``pred`` alone
    (nothing reads the exclusive products here, so the kernel does not
    write them).  Backward: its fused
    ``kruskal_grad`` with the cotangent ḡ injected as the residual
    (``err_override``), unit denominators and zero regularizers — which
    yields exactly ``∂pred/∂rows·ḡ`` and ``∂pred/∂B·ḡ``.  Counterpart of
    the reference's ``kruskal_predict`` custom VJP.
    """

    @staticmethod
    def forward(ctx, backend_name: str, n_modes: int, *tensors):
        rows, core_factors = tensors[:n_modes], tensors[n_modes:]
        pred, _ = get_backend(backend_name).kruskal_contract(
            rows, core_factors, want_pexc=False)
        ctx.backend_name = backend_name
        ctx.n_modes = n_modes
        ctx.save_for_backward(*tensors)
        return pred

    @staticmethod
    def backward(ctx, g):
        tensors = ctx.saved_tensors
        rows, core_factors = tensors[:ctx.n_modes], tensors[ctx.n_modes:]
        g = g.contiguous()
        kg = get_backend(ctx.backend_name).kruskal_grad(
            rows, core_factors, torch.zeros_like(g),
            mask=None, lambda_a=0.0, lambda_b=0.0,
            row_mean=False, core_mean=False, err_override=g)
        return (None, None,
                *(t.to(r.dtype) for t, r in zip(kg.row_grads, rows)),
                *(t.to(b.dtype) for t, b in zip(kg.core_grads,
                                                core_factors)))


def kruskal_predict(
    backend_name: str,
    rows: Sequence[torch.Tensor],
    core_factors: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Differentiable x̂ through ``KruskalPredict`` on the named backend."""
    return KruskalPredict.apply(backend_name, len(rows), *rows,
                                *core_factors)


__all__ = [
    "ENV_VAR",
    "DEFAULT_BACKEND",
    "KruskalGrads",
    "TorchBackend",
    "CudaBackend",
    "register_backend",
    "available_backends",
    "resolve_backend_name",
    "get_backend",
    "KruskalPredict",
    "kruskal_predict",
]
