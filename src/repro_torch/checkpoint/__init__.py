"""Checkpointing (counterpart of ``repro.checkpoint``)."""
from .manager import CheckpointManager, flatten

__all__ = ["CheckpointManager", "flatten"]
