"""Block composition: per-layer specs, init, and apply (with caches).

Counterpart of ``repro.models.blocks`` for the specs the port runs,
``"gqa+tucker_mlp"`` and ``"gqa+mlp"``; ``layer_specs`` names the
attention specs as the reference does, and ``init_layer`` refuses the
others.  The
reference stacks runs of identical layers and scans them (a compile-time
win under ``jit``); PyTorch runs eagerly, so the port keeps one module per
layer and loops (``models.convert`` unstacks the reference's groups).
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
from .layers import (MLP, init_tucker_linear, make_norm, mlp,
                     tucker_linear)

PORTED_SPECS = ("gqa+tucker_mlp", "gqa+mlp")


def layer_specs(cfg) -> list[str]:
    """The reference's spec per layer, for the attention mixers (the SSM
    and xLSTM mixers are refused earlier, by ``require_ported``)."""
    mixer = "mla" if cfg.use_mla else "gqa"
    specs = []
    for i in range(cfg.num_layers):
        if cfg.num_experts and i >= cfg.first_k_dense:
            ffn = "moe"
        elif cfg.tucker_rank:
            ffn = "tucker_mlp"
        else:
            ffn = "mlp"
        specs.append(f"{mixer}+{ffn}")
    return specs


def group_specs(specs: list[str]) -> list[tuple[str, int]]:
    """Run-length encode: [(spec, count), ...] — the reference's layer
    groups, whose parameters it stacks along a leading axis."""
    groups: list[tuple[str, int]] = []
    for s in specs:
        if groups and groups[-1][0] == s:
            groups[-1] = (s, groups[-1][1] + 1)
        else:
            groups.append((s, 1))
    return groups


class TuckerMLP(nn.Module):
    """The gated FFN with each of its three weights Tucker-2 factorized."""

    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, f, r = cfg.d_model, cfg.d_ff, cfg.tucker_rank
        self.up = init_tucker_linear(generator, d, f, r, device)
        self.gate = init_tucker_linear(generator, d, f, r, device)
        self.down = init_tucker_linear(generator, f, d, r, device)


class Layer(nn.Module):
    def __init__(self, cfg, spec: str, generator: torch.Generator,
                 device=None):
        super().__init__()
        if spec not in PORTED_SPECS:
            raise NotImplementedError(
                f"layer spec {spec!r} is not ported to repro_torch yet "
                f"(ported: {PORTED_SPECS}; see ROADMAP.md)")
        norm_cls, _ = make_norm(cfg.norm_type)
        self.spec = spec
        self.ln1 = norm_cls(cfg.d_model, device)
        self.mixer = attn.init_gqa(cfg, generator, device)
        self.ln2 = norm_cls(cfg.d_model, device)
        if spec.endswith("+tucker_mlp"):
            self.ffn = TuckerMLP(cfg, generator, device)
        else:
            self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.activation != "gelu",
                           generator, device)


def init_layer(cfg, spec: str, generator: torch.Generator,
               device=None) -> Layer:
    return Layer(cfg, spec, generator, device)


def apply_layer(
    params: Layer,
    cfg,
    spec: str,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: dict | None = None,
    cache_index: int | None = None,
    backend: str | None = None,
) -> tuple[torch.Tensor, dict | None]:
    _, norm = make_norm(cfg.norm_type)
    causal = not cfg.encoder_only
    new_cache: dict = {}

    h = norm(params.ln1, x, cfg.norm_eps)
    sub = cache.get("attn") if cache else None
    y, nc = attn.gqa_attention(params.mixer, cfg, h, positions,
                               causal=causal, cache=sub,
                               cache_index=cache_index, backend=backend)
    if nc is not None:
        new_cache["attn"] = nc
    x = x + y.to(x.dtype)

    h = norm(params.ln2, x, cfg.norm_eps)
    if spec.endswith("+tucker_mlp"):
        ffn = params.ffn
        up = tucker_linear(ffn.up, h, backend)
        gate = tucker_linear(ffn.gate, h, backend)
        y = tucker_linear(ffn.down, torch.nn.functional.silu(gate) * up,
                          backend)
    else:
        y = mlp(params.ffn, h, cfg.activation)
    x = x + y.to(x.dtype)
    return x, (new_cache if new_cache else None)


def init_layer_cache(cfg, spec: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    if not spec.startswith("gqa"):
        raise NotImplementedError(f"cache of layer spec {spec!r} is not "
                                  "ported to repro_torch yet")
    return {"attn": attn.init_gqa_cache(cfg, batch, max_len, dtype, device)}
