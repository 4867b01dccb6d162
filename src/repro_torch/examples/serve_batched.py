"""Train → checkpoint → serve, end to end, on synthetic ratings.

Counterpart of ``examples/serve_batched.py``: fit a Kruskal-core Tucker
model to a recommender-style sparse tensor (400 users × 250 items × 30
contexts, 40,000 ratings, J = R = 8, batch 2048, 300 steps of the
``local`` strategy), checkpoint it, load it into a
``serve.TuckerServer`` and answer the three query classes — batched x̂
prediction, top-k recommendation and factored slice reconstruction —
without forming the dense tensor.  It checks that the held-out RMSE beats
the zero predictor, and that the top-k scores and the slice are finite and
shaped as asked.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        [--device cpu] [--steps 300]
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import fasttucker as ft
from repro_torch.core.metrics import rmse_mae
from repro_torch.data.synthetic import ratings_tensor
from repro_torch.device import resolve_device
from repro_torch.distributed import get_strategy
from repro_torch.serve import TuckerServer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    dims = (400, 250, 30)                     # users × items × contexts
    tensor = ratings_tensor(dims, nnz=40_000, seed=0, device=device)
    train_t, test_t = tensor.split(0.1)
    cfg = ft.FastTuckerConfig(dims=dims, ranks=(8,) * 3, core_rank=8,
                              batch_size=2048, backend=args.backend)
    predict = lambda p, i: ft.predict(p, i, cfg.backend)  # noqa: E731

    # -- train (local strategy) + checkpoint ---------------------------------
    st = get_strategy("local")
    plan = st.prepare(train_t, cfg, None, seed=0)
    ds = st.init(plan, ft.init_state(
        torch.Generator(device=device).manual_seed(0), cfg, device),
        torch.Generator(device=device).manual_seed(1))
    step = st.make_step(plan)
    t0 = time.time()
    while int(ds.step) < args.steps:
        ds = step(ds)
    r, _ = rmse_mae(st.eval_params(plan, ds), test_t, predict)
    zero = float(test_t.values.double().pow(2).mean().sqrt())
    print(f"trained {args.steps} steps in {time.time()-t0:.1f}s — "
          f"held-out rmse {float(r):.4f} (zero predictor {zero:.4f})")

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_serve_demo_")
    st.save(plan, CheckpointManager(ckpt_dir), ds)
    print(f"checkpointed to {ckpt_dir}")

    # -- serve from the checkpoint ------------------------------------------
    server = TuckerServer.from_checkpoint(ckpt_dir, dims=dims, device=device,
                                          backend=cfg.backend)

    queries = test_t.indices[:512].cpu().numpy()
    t1 = time.time()
    preds = server.predict(queries)
    _sync(device)
    cold = time.time() - t1
    t1 = time.time()
    server.predict(queries)
    _sync(device)
    warm = time.time() - t1
    err = (preds.cpu() - test_t.values[:512].cpu()).abs().numpy()
    print(f"served {len(queries)} queries: cold {cold*1e3:.1f}ms, "
          f"warm {warm*1e3:.1f}ms ({len(queries)/max(warm,1e-9):.0f} q/s), "
          f"mean |err| {err.mean():.3f}")

    scores, items = server.top_k(0, [0, 1, 2], k=5)
    scores, items = scores.cpu().numpy(), items.cpu().numpy()
    for u in range(3):
        print(f"user {u}: top-5 items {items[u].tolist()} "
              f"(scores {[round(float(x), 2) for x in scores[u]]})")

    slice_ = server.reconstruct_rows(0, [0])
    print(f"factored reconstruction of user 0: shape {tuple(slice_.shape)} "
          f"(dense tensor of {np.prod(dims):,} entries never formed)")
    if not (float(r) < zero and np.isfinite(scores).all()
            and np.isfinite(err).all()
            and tuple(slice_.shape) == (1,) + dims[1:]
            and bool(torch.isfinite(slice_).all())):
        raise AssertionError(
            f"serve_batched: rmse {float(r)} (zero predictor {zero}), top-k "
            f"scores {scores.tolist()}, slice {tuple(slice_.shape)}")
    return {"rmse": float(r), "zero_rmse": zero, "scores": scores,
            "items": items, "mean_abs_err": float(err.mean())}


if __name__ == "__main__":
    main()
