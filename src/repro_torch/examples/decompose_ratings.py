"""End-to-end driver: decompose a recommender-style ratings tensor.

Counterpart of ``examples/decompose_ratings.py``: FastTucker against the
full-core cuTucker baseline (paper Fig. 3) on the reference's Netflix/100
ratings tensor (4802 × 1777 × 218, 800,000 nonzeros, 10 % held out), J = R
= 8, batch 8192, with a checkpoint every ``--eval-every`` steps through the
port's ``CheckpointManager``: stop it and run it again, and it resumes from
the last commit.  Step i draws its batch from a generator seeded with i
(the reference's ``fold_in(key, i)``), so a resumed run ends on the bits of
an uninterrupted one.  ``--dims``/``--nnz``/``--batch`` cut the tensor for
a quick run; the defaults are the reference's.

    PYTHONPATH=src python -m repro_torch.examples.decompose_ratings \\
        [--steps 800] [--device cpu] [--ckpt-dir DIR]
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import cutucker as cu
from repro_torch.core import fasttucker as ft
from repro_torch.core.metrics import rmse_mae
from repro_torch.data.synthetic import ratings_tensor
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch


def _seeded(gen: torch.Generator, stream: int, i: int) -> torch.Generator:
    """``gen`` reseeded for step ``i`` of stream ``stream``."""
    return gen.manual_seed((stream << 32) | i)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--eval-every", type=int, default=200)
    ap.add_argument("--dims", default="4802,1777,218")
    ap.add_argument("--nnz", type=int, default=800_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ratings_ckpt"))
    args = ap.parse_args(argv)

    backend = dispatch.resolve_backend_name(args.backend)
    dispatch.get_backend(backend)  # fail fast on typos, before data gen
    device = resolve_device(args.device)
    print(f"kernel backend: {backend}, device: {device}")

    dims = tuple(int(d) for d in args.dims.split(","))
    tensor = ratings_tensor(dims, nnz=args.nnz, seed=0, device=device)
    train_t, test_t = tensor.split(0.1)

    cfg = ft.FastTuckerConfig(dims=dims, ranks=(8, 8, 8), core_rank=8,
                              batch_size=args.batch, alpha_a=0.005,
                              alpha_b=0.0035, backend=backend)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    gen = torch.Generator(device=device)
    predict = lambda p, i: ft.predict(p, i, backend)  # noqa: E731

    state = ft.init_state(gen.manual_seed(0), cfg, device)
    start = 0
    if ckpt.latest_step() is not None:
        like = {"params": state.params, "step": torch.zeros((),
                                                            dtype=torch.int64)}
        restored, start = ckpt.restore(like)
        state = ft.TrainState(restored["params"], int(restored["step"]))
        print(f"resumed from step {start}")

    history = []
    t0 = time.time()
    for i in range(start, args.steps):
        state = ft.sgd_step(state, _seeded(gen, 0, i), train_t.indices,
                            train_t.values, cfg)
        if (i + 1) % args.eval_every == 0:
            r, m = rmse_mae(state.params, test_t, predict)
            history.append({"step": i + 1, "rmse": float(r),
                            "mae": float(m)})
            print(f"step {i+1:4d}  RMSE {float(r):.4f}  MAE {float(m):.4f} "
                  f" ({time.time()-t0:.1f}s)")
            ckpt.save(i + 1, {"params": state.params,
                              "step": torch.tensor(state.step)})

    # full-core baseline at the same rank budget
    ccfg = cu.CuTuckerConfig(dims=dims, ranks=(8, 8, 8),
                             batch_size=args.batch, alpha_a=0.005,
                             alpha_g=0.0035, backend=backend)
    cstate = cu.init_state(gen.manual_seed(0), ccfg, device)
    t1 = time.time()
    for i in range(args.steps):
        cstate = cu.sgd_step(cstate, _seeded(gen, 1, i), train_t.indices,
                             train_t.values, ccfg)
    r2, _ = rmse_mae(cstate.params, test_t, cu.predict)
    print(f"\ncuTucker  (full core): RMSE {float(r2):.4f} "
          f"({time.time()-t1:.1f}s for {args.steps} steps)")
    r1, _ = rmse_mae(state.params, test_t, predict)
    print(f"cuFastTucker (Kruskal): RMSE {float(r1):.4f} "
          f"({time.time()-t0:.1f}s incl. evals)")
    if not (math.isfinite(float(r1)) and math.isfinite(float(r2))):
        raise AssertionError(f"non-finite RMSE: FastTucker {float(r1)}, "
                             f"cuTucker {float(r2)}")
    return {"start": start, "history": history, "state": state,
            "fasttucker_rmse": float(r1), "cutucker_rmse": float(r2)}


if __name__ == "__main__":
    main()
