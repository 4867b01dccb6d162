"""STD (sparse Tucker) training driver on one device — the paper's workload.

Counterpart of ``repro.launch.std_train`` with ``--strategy local``: a
planted tensor (``data.synthetic.planted_tensor``, 10 % held out), cold
init, ``sgd_step`` on batches drawn on the device, and held-out RMSE/MAE
through ``predict`` before training, every ``--eval-every`` steps and at
the end.  It logs steps/s and nnz/s over the training intervals (evals
excluded, each interval closed by a device synchronize) and the peak
device bytes (``torch.cuda.max_memory_allocated``).  Checkpoints and the
multi-device strategies are not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.std_train \\
        --dims 1000,800,600 --nnz 200000 --steps 300 --batch 4096

Runs on the CUDA card with the ``"cuda"`` kernels by default; ``--device
cpu --backend torch`` runs the plain path on the CPU.
"""
from __future__ import annotations

import argparse
import logging
import time
from functools import partial

import torch

from repro_torch.core import fasttucker as ft
from repro_torch.core.metrics import rmse_mae
from repro_torch.data.synthetic import planted_tensor
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch

log = logging.getLogger("repro_torch.std")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dims", default="1000,800,600")
    ap.add_argument("--nnz", type=int, default=200_000)
    ap.add_argument("--rank", type=int, default=8,
                    help="J_n of every mode (planted and model)")
    ap.add_argument("--core-rank", type=int, default=8)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0,
                    help="data/split/init/sampling seed")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; "
                         "cpu must be asked for)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """Generate, split, train and evaluate; returns the run's record."""
    device = resolve_device(args.device)
    backend = dispatch.resolve_backend_name(args.backend)
    dispatch.get_backend(backend)  # fail fast on typos, before data gen
    dims = tuple(int(x) for x in args.dims.split(","))
    log.info("device %s, kernel backend %s, dims %s, nnz %d, J=%d, R=%d, "
             "batch %d", device, backend, dims, args.nnz, args.rank,
             args.core_rank, args.batch)

    t0 = time.perf_counter()
    tensor = planted_tensor(dims, args.nnz, rank=args.rank,
                            core_rank=args.core_rank, noise=0.05,
                            seed=args.seed, device=device)
    train_t, test_t = tensor.split(0.1)
    del tensor
    _sync(device)
    data_s = time.perf_counter() - t0
    log.info("data: %d train / %d test nonzeros in %.1fs", train_t.nnz,
             test_t.nnz, data_s)

    cfg = ft.FastTuckerConfig(
        dims=dims, ranks=(args.rank,) * len(dims), core_rank=args.core_rank,
        batch_size=args.batch, backend=backend)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = ft.init_state(gen, cfg, device)
    predict_fn = partial(ft.predict, backend=backend)

    def evaluate(step: int) -> dict:
        r, m = rmse_mae(state.params, test_t, predict_fn)
        rec = {"step": step, "rmse": float(r), "mae": float(m)}
        log.info("step %d rmse %.4f mae %.4f", step, rec["rmse"], rec["mae"])
        return rec

    history = [evaluate(0)]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    train_s = 0.0
    t_int = time.perf_counter()
    last = 0
    for i in range(1, args.steps + 1):
        state = ft.sgd_step(state, gen, train_t.indices, train_t.values, cfg)
        if i % args.eval_every == 0 or i == args.steps:
            _sync(device)
            dt = time.perf_counter() - t_int
            train_s += dt
            sps = (i - last) / dt
            log.info("throughput: %.1f steps/s, %.4g nnz/s", sps,
                     sps * cfg.batch_size)
            history.append(evaluate(i))
            last = i
            t_int = time.perf_counter()
    steps_per_s = args.steps / train_s if train_s > 0 else float("nan")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    log.info("done: %d steps, %.1f steps/s, %.4g nnz/s, peak device bytes "
             "%s", args.steps, steps_per_s, steps_per_s * cfg.batch_size,
             "not measured (cpu)" if peak is None else f"{peak:,}")
    return {
        "history": history,
        "steps_per_s": steps_per_s,
        "nnz_per_s": steps_per_s * cfg.batch_size,
        "peak_device_bytes": peak,
        "data_seconds": data_s,
        "train_seconds": train_s,
        "device": str(device),
        "backend": backend,
        "cfg": cfg,
        "state": state,
        "train": train_t,
        "test": test_t,
    }


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
