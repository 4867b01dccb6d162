"""One-step stochastic sampling sets Ψ, counterpart of ``repro.core.sampling``.

Every update step draws ``|Ψ|`` nonzeros uniformly, with replacement, from
Ω on the tensor's own device.  The draw comes from an explicit
``torch.Generator``, which gives other numbers than JAX's threefry keys:
parity with the reference therefore goes through fed batches
(``fasttucker.sgd_step_batch``), never through this sampler.
"""
from __future__ import annotations

import torch


def sample_batch_arrays(
    generator: torch.Generator,
    indices: torch.Tensor,
    values: torch.Tensor,
    batch_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw Ψ: returns (indices (B, N), values (B,)) on the tensor's device."""
    pick = torch.randint(0, values.shape[0], (batch_size,),
                         generator=generator, device=values.device)
    return indices.index_select(0, pick), values.index_select(0, pick)
