"""Quickstart: decompose a sparse tensor with the PyTorch/CUDA FastTucker.

Counterpart of ``examples/quickstart.py``: the same tensor, configuration,
steps and check (held-out RMSE below 0.25; the noise floor is 0.05).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import FastTuckerConfig, rmse_mae, train
from repro_torch.core import fasttucker as ft
from repro_torch.data.synthetic import planted_tensor
from repro_torch.device import resolve_device


def main(argv: list[str] | None = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # a 3-order HOHDST with a planted rank-4 Tucker structure + noise
    dims = (800, 600, 400)
    tensor = planted_tensor(dims, nnz=300_000, rank=4, core_rank=4,
                            noise=0.05, seed=0, device=device)
    train_t, test_t = tensor.split(test_fraction=0.1)

    cfg = FastTuckerConfig(
        dims=dims,
        ranks=(4, 4, 4),      # J_n
        core_rank=4,          # R_core (Kruskal rank of the core tensor)
        batch_size=4096,      # |Ψ| one-step sampling set
        backend=args.backend,
    )

    state, history = train(
        torch.Generator(device=device).manual_seed(0), train_t, cfg,
        num_steps=800, eval_every=200, test=test_t,
    )
    for h in history:
        print(f"step {h['step']:4d}  RMSE {h['rmse']:.4f}  MAE {h['mae']:.4f}")

    rmse, mae = rmse_mae(state.params, test_t,
                         lambda p, i: ft.predict(p, i, cfg.backend))
    print(f"\nfinal: RMSE {float(rmse):.4f} (noise floor ≈ 0.05)")
    assert float(rmse) < 0.25
    return float(rmse)


if __name__ == "__main__":
    main()
