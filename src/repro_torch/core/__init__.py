"""Core: FastTucker STD with a Kruskal core + SGD (single-device slice)."""
from .fasttucker import (
    FastTuckerConfig,
    FastTuckerParams,
    TrainState,
    batch_gradients,
    dynamic_lr,
    init_params,
    init_state,
    params_from_numpy,
    params_to_numpy,
    predict,
    sampled_loss,
    sgd_step,
    sgd_step_batch,
    train,
)
from .metrics import rmse_mae
from .sptensor import SparseTensor

__all__ = [
    "SparseTensor",
    "FastTuckerConfig",
    "FastTuckerParams",
    "TrainState",
    "batch_gradients",
    "dynamic_lr",
    "init_params",
    "init_state",
    "params_from_numpy",
    "params_to_numpy",
    "predict",
    "sampled_loss",
    "sgd_step",
    "sgd_step_batch",
    "train",
    "rmse_mae",
]
