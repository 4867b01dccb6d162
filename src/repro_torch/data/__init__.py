"""Synthetic data for the port (numpy draws identical to the reference's)."""
from .pipeline import TokenPipeline, TokenPipelineConfig
from .synthetic import planted_arrays, planted_tensor, ratings_tensor

__all__ = ["TokenPipeline", "TokenPipelineConfig", "planted_arrays",
           "planted_tensor", "ratings_tensor"]
