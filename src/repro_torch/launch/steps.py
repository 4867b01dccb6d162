"""Serving step factories: prefill and greedy decode.

Counterpart of ``make_prefill_step`` / ``make_decode_step`` in
``repro.launch.steps``.  The reference returns functions to ``jax.jit``;
here they run eagerly.  The cache index is a Python int.
"""
from __future__ import annotations

import torch

from repro_torch.models import decode_step


def make_prefill_step(cfg, backend: str | None = None):
    """Prompt → (last-position logits, filled caches)."""
    def prefill_step(params, batch: dict, caches):
        logits, caches = decode_step(params, cfg, batch, caches, 0,
                                     backend=backend)
        return logits[:, -1], caches

    return prefill_step


def make_decode_step(cfg, backend: str | None = None):
    """(params, caches, index, tokens (B, 1)) → (next tokens, caches,
    index + 1), greedy."""
    def serve_step(params, caches, index: int, batch: dict):
        logits, caches = decode_step(params, cfg, batch, caches, index,
                                     backend=backend)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], caches, index + 1

    return serve_step
