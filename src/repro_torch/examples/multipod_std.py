"""Multi-device STD with the paper's stratified Fig.-2 schedule.

Counterpart of ``examples/multipod_std.py``: the same tensor (planted
512 × 384 × 256, 200,000 nonzeros, noise 0.05, 10 % held out), J = R = 8,
batch 2048 a worker and a held-out RMSE every 50 steps (and, here, at
step 0 and at the last step), through the
distributed-strategy registry: any of local / sync / strata /
strata_overlap with ``--strategy``; the default ``strata_overlap`` runs
the Latin-hypercube epoch schedule with the factor shard rotations issued
ahead of use.  The reference simulates 8 host devices; here the
``WORKERS`` = 8 workers of ``make_host_mesh`` share the device.

    PYTHONPATH=src python -m repro_torch.examples.multipod_std \\
        [--strategy strata] [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import FastTuckerConfig, rmse_mae
from repro_torch.core import fasttucker as ft
from repro_torch.data.synthetic import planted_tensor
from repro_torch.device import resolve_device
from repro_torch.distributed import get_strategy
from repro_torch.launch.mesh import make_host_mesh

EVAL_EVERY = 50
WORKERS = 8


def main(argv: list[str] | None = None) -> list[tuple[int, float]]:
    """Train; returns the (step, held-out RMSE) of every evaluation."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--strategy", default="strata_overlap")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    dims = (512, 384, 256)
    tensor = planted_tensor(dims, 200_000, noise=0.05, seed=0, device=device)
    train_t, test_t = tensor.split(0.1)
    cfg = FastTuckerConfig(dims=dims, ranks=(8,) * 3, core_rank=8,
                           batch_size=2048, backend=args.backend)

    mesh = make_host_mesh(num_workers=WORKERS, device=device)
    M = mesh.size
    print(f"running the {args.strategy!r} strategy on {M} workers "
          f"({M}^{len(dims)} = {M ** len(dims)} blocks, "
          f"{M ** (len(dims) - 1)} strata)")

    strategy = get_strategy(args.strategy)
    plan = strategy.prepare(train_t, cfg,
                            mesh if strategy.needs_mesh else None, seed=0)
    gen = torch.Generator(device=device).manual_seed(0)
    dstate = strategy.init(plan, ft.init_state(gen, cfg, device), gen)
    step = strategy.make_step(plan)

    def evaluate() -> None:
        r, _ = rmse_mae(strategy.eval_params(plan, dstate), test_t,
                        lambda p, i: ft.predict(p, i, cfg.backend))
        history.append((dstate.step, float(r)))
        print(f"step {dstate.step:3d}  RMSE {float(r):.4f}")

    history = []
    evaluate()                     # where the init lands
    next_eval = EVAL_EVERY
    while dstate.step < args.steps:
        dstate = step(dstate)
        if dstate.step >= next_eval or dstate.step >= args.steps:
            next_eval += EVAL_EVERY
            evaluate()
    print("conflict-free multi-device decomposition complete")
    return history


if __name__ == "__main__":
    main()
