"""Core: FastTucker STD with a Kruskal core + SGD on one device, and the
paper's baselines (``cutucker``: the full core; ``als`` and ``ccd``: exact
per-row solvers)."""
from . import als, ccd, cutucker
from .fasttucker import (
    FastTuckerConfig,
    FastTuckerParams,
    StepIntermediates,
    TrainState,
    batch_gradients,
    core_phase_gradients,
    core_phase_step,
    dynamic_lr,
    factor_phase_gradients,
    factor_phase_step,
    init_params,
    init_state,
    params_from_numpy,
    params_to_numpy,
    predict,
    sampled_loss,
    sgd_step,
    sgd_step_batch,
    step_gradients,
    train,
)
from .metrics import rmse_mae
from .sampling import (SortedBatchLayout, SortedBatchOrder,
                       sorted_batch_layout, sorted_batch_order)
from .sptensor import SparseTensor

__all__ = [
    "als",
    "ccd",
    "cutucker",
    "SparseTensor",
    "FastTuckerConfig",
    "FastTuckerParams",
    "SortedBatchLayout",
    "SortedBatchOrder",
    "StepIntermediates",
    "TrainState",
    "batch_gradients",
    "core_phase_gradients",
    "core_phase_step",
    "dynamic_lr",
    "factor_phase_gradients",
    "factor_phase_step",
    "init_params",
    "init_state",
    "params_from_numpy",
    "params_to_numpy",
    "predict",
    "sampled_loss",
    "sgd_step",
    "sgd_step_batch",
    "sorted_batch_layout",
    "sorted_batch_order",
    "step_gradients",
    "train",
    "rmse_mae",
]
