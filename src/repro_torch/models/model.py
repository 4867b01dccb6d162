"""Top-level model: embeddings/frontends → layers → head.

Counterpart of ``repro.models.model`` for the GQA and MLA models (dense,
Tucker-compressed or MoE FFNs), with the reference's stub frontends: the
audio frontend (HuBERT) projects precomputed frame embeddings
(``frontend.proj``, (frontend_dim, d_model)) and has no token embedding;
the vision frontend (InternVL2) projects precomputed patch embeddings,
placed before the text's token embeddings, and its loss reads the text
positions only.  A decode after a vision prefill of P patches and T
tokens continues from cache index P + T.
``init_model`` builds an ``nn.Module`` (a ``ModuleList`` of layers) on the
device, from a ``torch.Generator`` on that device, so a full-size model's
weights are drawn where they live; ``forward``/``decode_step`` take it as
their ``params``.  Its parameters take no gradient unless a caller asks
(``launch.steps.init_train_state`` does; serving builds no autograd
graph).  ``param_axes`` is the reference's ``axes_tree`` by parameter
name, without the stacked groups' leading ``"layers"`` axis.  As in the
reference, ``distributed.context.constrain`` is applied to the residual
stream after every layer and ``constrain_logits`` to the forward's
logits (no-ops unless a launcher installs them).  Dropped, being
JAX-only: the ``_grad_safe_barrier`` (an identity), ``remat`` (training
keeps every activation: at the trained depth they fit the card, and the
flash attention saves only O(S) of its own) and the scan over stacked
layer groups (an eager loop here).  ``backend`` selects the kernel backend of
``tucker_linear`` and of the flash region of ``chunked_attention``
(``None``: ``$REPRO_TORCH_KERNEL_BACKEND``, else ``"cuda"``).
``mixed_precision`` (with ``dtype="bfloat16"``) is the reference's
``_cast_params``: ``forward`` and ``decode_step`` run on a bf16 copy of
every f32 parameter (``cast_params``), made once a call, so the f32
masters take the gradients through the cast.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import require_ported
from repro_torch.device import resolve_device
from repro_torch.distributed import context as dist_ctx

from .blocks import apply_layer, init_layer, init_layer_cache, layer_specs
from .layers import Embedding, dense_param, embed, make_norm, matmul


def activation_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Frontend(nn.Module):
    """A stub frontend: the projection of precomputed frame or patch
    embeddings into the model's width."""

    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        self.proj = dense_param((cfg.frontend_dim, cfg.d_model), generator,
                                device, (None, "embed"))


class Model(nn.Module):
    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        require_ported(cfg)
        norm_cls, _ = make_norm(cfg.norm_type)
        self.specs = layer_specs(cfg)
        if cfg.frontend != "audio":
            self.embed = Embedding(cfg.vocab_size, cfg.d_model, generator,
                                   device)
        if cfg.frontend in ("audio", "vision"):
            self.frontend = Frontend(cfg, generator, device)
        self.layers = nn.ModuleList(
            init_layer(cfg, spec, generator, device) for spec in self.specs)
        self.ln_f = norm_cls(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = dense_param((cfg.d_model, cfg.vocab_size),
                                       generator, device, ("embed", "vocab"))


def init_model(cfg, generator: torch.Generator | None = None,
               device=None) -> Model:
    """Random weights drawn on ``device`` (default: the current card) from
    ``generator`` (default: one on that device seeded 0).  On the
    ``meta`` device only the shapes and axes are made."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    return Model(cfg, generator, device)


def param_axes(model: Model) -> dict[str, tuple]:
    """{parameter name: its logical axes} (the reference's ``axes_tree``
    of an unstacked layer)."""
    return {n: p.axes for n, p in model.named_parameters()}


def _cast_view(module: nn.Module) -> nn.Module:
    """A structural copy of ``module`` whose f32 parameters are bf16
    tensors cast from them (differentiable: their gradients reach the
    parameters); ``module`` itself is not touched."""
    view = object.__new__(type(module))
    view.__dict__ = dict(module.__dict__)
    view._parameters = {
        n: (p.to(torch.bfloat16) if p is not None
            and p.dtype == torch.float32 else p)
        for n, p in module._parameters.items()}
    view._modules = {n: _cast_view(m) for n, m in module._modules.items()}
    return view


def cast_params(params: Model, cfg) -> Model:
    """Mixed precision, the reference's ``_cast_params``: under
    ``cfg.mixed_precision`` and ``dtype="bfloat16"`` a view of ``params``
    with every f32 leaf cast to bf16 (router, norm scales, Tucker factors,
    embedding and head included), else ``params`` as it is.  One copy a
    call; the state keeps only the f32 masters."""
    if not (cfg.mixed_precision and cfg.dtype == "bfloat16"):
        return params
    return _cast_view(params)


def embed_inputs(params: Model, cfg, batch: dict) -> torch.Tensor:
    """batch → (B, S, d) activations in the config's dtype, with the
    reference's casts in its order: audio, ``frames`` (B, S, frontend_dim)
    @ proj; vision with ``patches`` (B, P, frontend_dim), their projection
    cast to the embedding's dtype and placed before ``tokens``' (B, T)
    embeddings; otherwise (a vision decode too: the patches are already
    in the cache) the tokens' embeddings."""
    if cfg.frontend == "audio":
        x = matmul(batch["frames"], params.frontend.proj)
    elif cfg.frontend == "vision" and "patches" in batch:
        patches = matmul(batch["patches"], params.frontend.proj)
        toks = embed(params.embed, batch["tokens"])
        x = torch.cat([patches.to(toks.dtype), toks], dim=1)
    else:
        x = embed(params.embed, batch["tokens"])
    return x.to(activation_dtype(cfg))


def _run_layers(params: Model, cfg, x, positions, *, caches=None,
                cache_index=None, backend=None):
    new_caches = [] if caches is not None else None
    for i, (layer, spec) in enumerate(zip(params.layers, params.specs)):
        x, nc = apply_layer(layer, cfg, spec, x, positions=positions,
                            cache=caches[i] if caches is not None else None,
                            cache_index=cache_index, backend=backend)
        x = dist_ctx.constrain(x)
        if new_caches is not None:
            new_caches.append(nc)
    return x, new_caches


def _head(params: Model, cfg, x: torch.Tensor) -> torch.Tensor:
    _, norm = make_norm(cfg.norm_type)
    x = norm(params.ln_f, x, cfg.norm_eps)
    head = (params.embed.embedding.T if cfg.tie_embeddings
            else params.lm_head)
    return x @ head.to(x.dtype)   # a per-call copy of the head, as x.dtype


def forward(params: Model, cfg, batch: dict, *,
            backend: str | None = None) -> torch.Tensor:
    """Training/prefill forward → logits (B, S, vocab), no cache."""
    params = cast_params(params, cfg)
    x = embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_layers(params, cfg, x, positions, backend=backend)
    return dist_ctx.constrain_logits(_head(params, cfg, x))


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> list:
    """One cache per layer (the reference stacks them per layer group)."""
    device = resolve_device(device)
    return [init_layer_cache(cfg, spec, batch, max_len, dtype, device)
            for spec in layer_specs(cfg)]


def decode_step(params: Model, cfg, batch: dict, caches: list,
                cache_index: int, *, backend: str | None = None):
    """One step from ``cache_index``: batch["tokens"] (B, S) → (logits
    (B, S, V), caches).  S = 1 decodes; S > 1 from index 0 is prefill (a
    vision prefill's batch also holds ``patches``, the P positions before
    the tokens).
    The caches are updated in place and returned."""
    params = cast_params(params, cfg)
    x = embed_inputs(params, cfg, batch)
    positions = cache_index + torch.arange(x.shape[1], device=x.device)
    x, new_caches = _run_layers(params, cfg, x, positions, caches=caches,
                                cache_index=cache_index, backend=backend)
    return _head(params, cfg, x), new_caches


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean CE over non-ignored positions; stable log-softmax in f32."""
    nll, valid = nll_terms(logits, labels, ignore_index)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def nll_terms(logits: torch.Tensor, labels: torch.Tensor,
              ignore_index: int = -100) -> tuple[torch.Tensor, torch.Tensor]:
    """(each position's negative log-likelihood, 0 where ignored; the
    valid-position mask)."""
    logits = logits.float()
    valid = labels != ignore_index
    labels_safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    return (logz - gold) * valid, valid


def loss_fn(params: Model, cfg, batch: dict, *,
            backend: str | None = None) -> torch.Tensor:
    logits = forward(params, cfg, batch, backend=backend)
    labels = batch["labels"]
    if cfg.frontend == "vision":   # the labels cover the text positions
        logits = logits[:, -labels.shape[1]:]
    return cross_entropy_loss(logits, labels)
