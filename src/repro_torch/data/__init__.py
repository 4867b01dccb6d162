"""Synthetic data for the port (numpy draws identical to the reference's)."""
from .synthetic import planted_arrays, planted_tensor, ratings_tensor

__all__ = ["planted_arrays", "planted_tensor", "ratings_tensor"]
