"""Layer library: parameter modules, initializers and the core NN ops.

Counterpart of ``repro.models.layers``.  Parameters live in ``nn.Module``s
whose attribute names are the reference's dict keys (``ln1.scale``,
``mixer.wq``, ``ffn.up.u1``, …), so ``models.convert`` maps the
reference's parameter tree onto them by name.  The ops are plain
functions on those modules and tensors.  Each parameter carries the
reference's logical axes as ``param.axes`` (its ``Boxed.axes``: one
logical name or ``None`` a dimension); ``models.param_axes`` collects them
by name for ``distributed.sharding``.

dtype promotion: JAX promotes a bf16 × f32 product to f32, PyTorch refuses
a mixed matmul.  ``promote`` casts both operands to
``torch.promote_types`` and every product of the model goes through it,
so under ``dtype="bfloat16"`` the residual stream is bf16 while the
projections against f32 weights run in f32, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def promote(a: torch.Tensor, b: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``a`` and ``b`` cast to their promoted dtype (JAX's rule for a
    bf16 × f32 product)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(*promote(a, b))


# ---------------------------------------------------------------------------
# initializers (in place, on the tensor's own device)
# ---------------------------------------------------------------------------

_TRUNC = 2.0  # truncation at ±2 standard deviations, as the reference's


def truncated_normal_(t: torch.Tensor, scale: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place from N(0, 1) truncated to [−2, 2], times
    ``scale`` — the reference's ``dense_init`` distribution (not its bits:
    the generators differ).  Inverse-CDF sampling, so it allocates nothing
    beside ``t`` and runs on ``t``'s device."""
    lo = 0.5 * (1.0 + math.erf(-_TRUNC / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(_TRUNC / math.sqrt(2.0)))
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0) * scale)
    return t.clamp_(-_TRUNC * scale, _TRUNC * scale)


def _with_axes(p: nn.Parameter, axes) -> nn.Parameter:
    axes = tuple(axes)
    if len(axes) != p.dim():
        raise ValueError(f"axes {axes} for a {p.dim()}-D parameter")
    p.axes = axes
    return p


def dense_param(shape, generator: torch.Generator, device, axes,
                scale: float | None = None) -> nn.Parameter:
    """Truncated-normal fan-in (LeCun) init with logical ``axes``; fan-in
    is ``shape[0]`` for a matrix or higher, as in the reference's
    ``dense_init``.  On the ``meta`` device nothing is drawn."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if t.device.type != "meta":
        with torch.no_grad():
            truncated_normal_(t, s, generator)
    return _with_axes(nn.Parameter(t, requires_grad=False), axes)


def const_param(shape, value: float, device, axes) -> nn.Parameter:
    return _with_axes(nn.Parameter(
        torch.full(tuple(shape), value, dtype=torch.float32, device=device),
        requires_grad=False), axes)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None, axis: str = "embed"):
        super().__init__()
        self.scale = const_param((dim,), 1.0, device, (axis,))


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's cast order: rsqrt in f32, cast to x's dtype, then
    the scale cast to x's dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * params.scale.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, device=None, axis: str = "embed"):
        super().__init__()
        self.scale = const_param((dim,), 1.0, device, (axis,))
        self.bias = const_param((dim,), 0.0, device, (axis,))


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y.to(x.dtype) * params.scale.to(x.dtype)
            + params.bias.to(x.dtype))


def make_norm(norm_type: str):
    """(module class, apply function) of the config's norm."""
    if norm_type == "layernorm":
        return LayerNorm, layernorm
    return RMSNorm, rmsnorm


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    return F.silu(x)


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated: bool,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.wi = dense_param((d_model, d_ff), generator, device,
                              ("embed", "mlp"))
        self.wo = dense_param((d_ff, d_model), generator, device,
                              ("mlp", "embed"))
        if gated:
            self.wg = dense_param((d_model, d_ff), generator, device,
                                  ("embed", "mlp"))


def mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = matmul(x, params.wi)
    if hasattr(params, "wg"):
        h = activation(act, matmul(x, params.wg)) * h
    else:
        h = activation(act, h)
    return matmul(h, params.wo)


# ---------------------------------------------------------------------------
# Tucker-compressed linear (the paper's technique applied to LM weights)
# ---------------------------------------------------------------------------

class TuckerLinear(nn.Module):
    """W ≈ U1 G U2ᵀ: u1 (d_in, rank), g (rank, rank), u2 (d_out, rank);
    the rows of u1 and u2 take the input's and the output's logical
    axes."""

    def __init__(self, d_in: int, d_out: int, rank: int,
                 generator: torch.Generator, device=None,
                 in_axis: str = "embed", out_axis: str = "mlp"):
        super().__init__()
        self.u1 = dense_param((d_in, rank), generator, device,
                              (in_axis, None))
        self.g = dense_param((rank, rank), generator, device, (None, None),
                             scale=1.0 / math.sqrt(rank))
        self.u2 = dense_param((d_out, rank), generator, device,
                              (out_axis, None))


def init_tucker_linear(generator: torch.Generator, d_in: int, d_out: int,
                       rank: int, device=None, in_axis: str = "embed",
                       out_axis: str = "mlp") -> TuckerLinear:
    return TuckerLinear(d_in, d_out, rank, generator, device, in_axis,
                        out_axis)


class TuckerMatmul(torch.autograd.Function):
    """y = ((x U1) G) U2ᵀ through the backend's ``tucker_matmul``, with its
    gradient.

    The reference differentiates ``((x @ u1) @ g) @ u2.T`` through XLA.
    Here dx = ((ȳ U2) Gᵀ) U1ᵀ is the same kernel with the factors in the
    other roles, ``tucker_matmul(ȳ, U2, Gᵀ, U1)`` (the shape its ``plan``
    takes in the other FFN direction); dU1 = xᵀ(ȳ U2 Gᵀ), dG = (x U1)ᵀ(ȳ U2)
    and dU2 = ȳᵀ(x U1 G) are plain f32 matmuls, as in the reference (TF32
    is off, ``repro_torch/__init__.py``).  Each gradient is cast back to
    its input's dtype.  Only x and the factors are saved: x U1 is
    recomputed in the backward.
    """

    @staticmethod
    def forward(ctx, x, u1, g, u2, backend: str | None):
        from repro_torch.kernels import dispatch

        ctx.save_for_backward(x, u1, g, u2)
        ctx.backend = backend
        return dispatch.get_backend(backend).tucker_matmul(x, u1, g, u2)

    @staticmethod
    def backward(ctx, gy):
        from repro_torch.kernels import dispatch

        x, u1, g, u2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = du1 = dg = du2 = None
        gy = gy.contiguous()
        if need[0]:
            dx = dispatch.get_backend(ctx.backend).tucker_matmul(
                gy, u2, g.t(), u1).to(x.dtype)
        if any(need[1:4]):
            xf, gf, u1f, u2f, gyf = (t.float() for t in (x, g, u1, u2, gy))
            t1 = xf @ u1f                  # x U1      (M, R1)
            s2 = gyf @ u2f                 # ȳ U2      (M, R2)
            if need[1]:
                du1 = (xf.T @ (s2 @ gf.T)).to(u1.dtype)
            if need[2]:
                dg = (t1.T @ s2).to(g.dtype)
            if need[3]:
                du2 = (gyf.T @ (t1 @ gf)).to(u2.dtype)
        return dx, du1, dg, du2, None


def tucker_linear(params, x: torch.Tensor,
                  backend: str | None = None) -> torch.Tensor:
    """Tucker-2 factorized dense layer through the kernel registry.

    ``backend=None`` resolves as every port path does
    (``$REPRO_TORCH_KERNEL_BACKEND``, else ``"cuda"``): the LM runs the
    hand-written ``tucker_matmul`` forward and in its backward
    (``TuckerMatmul``), which the reference reaches only on request
    (``backend="pallas"``; its default is ``"xla"``, because the Pallas
    kernel has no VJP).
    """
    shape = x.shape
    y = TuckerMatmul.apply(x.reshape(-1, shape[-1]), params.u1, params.g,
                           params.u2, backend)
    return y.reshape(*shape[:-1], -1)


# ---------------------------------------------------------------------------
# embeddings / rotary
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.embedding = dense_param((vocab, d_model), generator, device,
                                     ("vocab", "embed"), scale=1.0)


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params.embedding[tokens]


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    The head is split into two halves (x1, x2) — not interleaved pairs, as
    Hugging Face's Qwen does — exactly as the reference does.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    angles = positions[..., :, None].float() * freqs           # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)
