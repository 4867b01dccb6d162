"""Device resolution for the port's entry points.

The port runs on the CUDA card unless the caller asks for the CPU.  It
never continues on the CPU by itself: without CUDA and without an
explicit ``device=`` every entry point raises.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on "
            "the CPU")
    return torch.device("cuda", torch.cuda.current_device())
