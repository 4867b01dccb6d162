"""Optimizers (counterpart of ``repro.optim``: AdamW only so far)."""
from . import adamw

__all__ = ["adamw"]
