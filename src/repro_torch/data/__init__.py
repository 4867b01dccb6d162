"""The port's data layer: synthetic data (numpy draws identical to the
reference's), the LM token pipeline, the STD Ψ stream, the out-of-core
nonzero store and its stratum prefetcher."""
from .pipeline import (NonzeroStore, StratumPrefetcher, TensorStream,
                       TokenPipeline, TokenPipelineConfig)
from .synthetic import planted_arrays, planted_tensor, ratings_tensor

__all__ = ["NonzeroStore", "StratumPrefetcher", "TensorStream",
           "TokenPipeline", "TokenPipelineConfig", "planted_arrays",
           "planted_tensor", "ratings_tensor"]
