"""Block composition: per-layer specs, init, and apply (with caches).

Counterpart of ``repro.models.blocks`` for the specs the port runs
(``PORTED_SPECS``: GQA or MLA attention, a dense, Tucker-compressed or
MoE FFN); ``layer_specs`` names the attention specs as the reference
does, and ``init_layer`` refuses the others.  As in the reference, the
first ``first_k_dense`` layers of an MoE config take a dense MLP at
``dense_d_ff``.  The reference stacks runs of identical layers and scans
them (a compile-time win under ``jit``); PyTorch runs eagerly, so the port
keeps one module per layer and loops (``models.convert`` unstacks the
reference's groups).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from . import attention as attn
from . import moe as moe_mod
from .layers import (MLP, init_tucker_linear, make_norm, mlp,
                     tucker_linear)

PORTED_SPECS = ("gqa+tucker_mlp", "gqa+mlp", "mla+mlp", "mla+moe",
                "gqa+moe")


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
        self.down = init_tucker_linear(generator, f, d, r, device,
                                       in_axis="mlp", out_axis="embed")


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
        init_mixer = (attn.init_mla if spec.startswith("mla")
                      else attn.init_gqa)
        self.mixer = init_mixer(cfg, generator, device)
        self.ln2 = norm_cls(cfg.d_model, device)
        if spec.endswith("+moe"):
            self.ffn = moe_mod.init_moe(cfg, generator, device)
        elif spec.endswith("+tucker_mlp"):
            self.ffn = TuckerMLP(cfg, generator, device)
        else:
            dff = (cfg.dense_d_ff if cfg.num_experts and cfg.dense_d_ff
                   else cfg.d_ff)
            self.ffn = MLP(cfg.d_model, dff, cfg.activation != "gelu",
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
    (x,), (new_cache,) = apply_layer_workers(
        [params], cfg, spec, [x], positions=[positions], caches=[cache],
        cache_index=cache_index, backend=backend)
    return x, new_cache


def apply_layer_workers(
    params: list,
    cfg,
    spec: str,
    xs: list[torch.Tensor],
    *,
    positions: list[torch.Tensor],
    caches: list[dict | None] | None = None,
    cache_index: int | None = None,
    backend: str | None = None,
    reduce: Callable[[str, list], list] | None = None,
    moe: moe_mod.MoESplit | None = None,
) -> tuple[list[torch.Tensor], list[dict | None]]:
    """The layer body, over the workers of a mesh (one entry of ``params``,
    ``xs`` and ``positions`` a worker; one worker is ``apply_layer``).
    Each sublayer runs on every worker, then ``reduce(sublayer, outputs)``
    (``"attn"``, ``"ffn"``; e.g. the sum of tensor-parallel partial
    outputs) before its residual add.  ``moe``: how an MoE FFN splits over
    the workers (``ffn_workers``)."""
    _, norm = make_norm(cfg.norm_type)
    causal = not cfg.encoder_only
    caches = caches if caches is not None else [None] * len(xs)
    attend = (attn.mla_attention if spec.startswith("mla")
              else attn.gqa_attention)
    new_caches: list[dict | None] = []
    ys = []
    for p, x, pos, cache in zip(params, xs, positions, caches):
        h = norm(p.ln1, x, cfg.norm_eps)
        sub = cache.get("attn") if cache else None
        y, nc = attend(p.mixer, cfg, h, pos, causal=causal, cache=sub,
                       cache_index=cache_index, backend=backend)
        ys.append(y)
        new_caches.append({"attn": nc} if nc is not None else None)
    if reduce is not None:
        ys = reduce("attn", ys)
    xs = [x + y.to(x.dtype) for x, y in zip(xs, ys)]

    ys = ffn_workers([p.ffn for p in params], cfg, spec,
                     [norm(p.ln2, x, cfg.norm_eps) for p, x in
                      zip(params, xs)], backend, moe)
    if reduce is not None:
        ys = reduce("ffn", ys)
    return [x + y.to(x.dtype) for x, y in zip(xs, ys)], new_caches


def ffn_workers(ffns: list, cfg, spec: str, hs: list,
                backend: str | None = None,
                moe: moe_mod.MoESplit | None = None) -> list:
    """The FFN sublayer's output on every worker.  An MoE on a mesh
    (``moe`` given) routes the workers' tokens together
    (``moe.moe_ffn_workers``): the expert-parallel island where
    ``cfg.moe_sharded`` asks for it, as the reference's ``apply_layer``
    takes ``moe_ffn_sharded`` when a mesh is current, else GSPMD's form of
    ``moe_ffn`` over the global batch.  Otherwise each worker runs
    ``ffn_out``."""
    if moe is not None and spec.endswith("+moe"):
        return moe_mod.moe_ffn_workers(ffns, cfg, hs, moe)
    return [ffn_out(f, cfg, spec, h, backend) for f, h in zip(ffns, hs)]


def ffn_out(ffn, cfg, spec: str, h: torch.Tensor,
            backend: str | None = None) -> torch.Tensor:
    """The FFN sublayer's output (before the residual add)."""
    if spec.endswith("+moe"):
        return moe_mod.moe_ffn(ffn, cfg, h)
    if spec.endswith("+tucker_mlp"):
        up = tucker_linear(ffn.up, h, backend)
        gate = tucker_linear(ffn.gate, h, backend)
        return tucker_linear(ffn.down, torch.nn.functional.silu(gate) * up,
                             backend)
    return mlp(ffn, h, cfg.activation)


def init_layer_cache(cfg, spec: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    mixer = spec.split("+")[0]
    if mixer == "gqa":
        return {"attn": attn.init_gqa_cache(cfg, batch, max_len, dtype,
                                            device)}
    if mixer == "mla":
        return {"attn": attn.init_mla_cache(cfg, batch, max_len, dtype,
                                            device)}
    raise NotImplementedError(f"cache of layer spec {spec!r} is not ported "
                              "to repro_torch yet (see ROADMAP.md)")
