"""Fig. 3/4 analogue on the port: accuracy (RMSE/MAE) of FastTucker against
cuTucker, and of Factor+Core against Factor-only.

Counterpart of ``benchmarks/bench_accuracy.py``: the same ``FULL`` and
``SMOKE`` configurations, the same rows and the same schema
(``bench_accuracy/v1``), checked by the port's own
``benchmarks.common.validate_bench_accuracy``: per rank, FastTucker
Factor+Core within 10 % of cuTucker's RMSE and no worse than Factor-only by
more than 2 %, and every row better than the zero predictor.  Each run
draws from its own ``torch.Generator`` (FastTucker: seed 0 for the init and
the batches; cuTucker: seed 0 for the init, seed 1 for the batches), so
the numbers are the port's, not the reference's.  ``platform`` names the
card (or ``cpu``).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_accuracy \\
        [--smoke] [--out BENCH_torch_accuracy.json] [--device cpu] \\
        [--backend torch]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from .common import BENCH_ACCURACY_SCHEMA, validate_bench_accuracy

FULL = dict(dims=(1200, 900, 120), nnz=300_000, steps=400,
            batch=4096, ranks=(4, 8), seed=3)
SMOKE = dict(dims=(150, 120, 40), nnz=20_000, steps=120,
             batch=2048, ranks=(4,), seed=3)
OUT_NAME = "BENCH_torch_accuracy.json"
REFERENCE_NAME = "BENCH_accuracy.json"   # the reference's; never written


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(smoke: bool, device: torch.device, backend: str) -> dict:
    from repro_torch.core import cutucker as cu
    from repro_torch.core import fasttucker as ft
    from repro_torch.core.metrics import rmse_mae
    from repro_torch.data.synthetic import ratings_tensor

    p = SMOKE if smoke else FULL
    dims, steps = p["dims"], p["steps"]
    t = ratings_tensor(dims, p["nnz"], seed=p["seed"], device=device)
    train_t, test_t = t.split(0.1, seed=p["seed"])

    results = []
    for J in p["ranks"]:
        cfg = ft.FastTuckerConfig(dims=dims, ranks=(J,) * 3, core_rank=J,
                                  batch_size=p["batch"], alpha_a=0.005,
                                  alpha_b=0.0035, backend=backend)
        for variant, kw in (("factor+core", {}),
                            ("factor_only", {"update_core": False})):
            t0 = time.perf_counter()
            gen = torch.Generator(device=device).manual_seed(0)
            _, hist = ft.train(gen, train_t, cfg, num_steps=steps,
                               eval_every=steps, test=test_t, **kw)
            results.append({
                "model": "fasttucker", "variant": variant, "rank": J,
                "rmse": float(hist[-1]["rmse"]),
                "mae": float(hist[-1]["mae"]),
                "train_s": time.perf_counter() - t0,
            })

        ccfg = cu.CuTuckerConfig(dims=dims, ranks=(J,) * 3,
                                 batch_size=p["batch"], alpha_a=0.005,
                                 alpha_g=0.0035, backend=backend)
        t0 = time.perf_counter()
        cstate = cu.init_state(
            torch.Generator(device=device).manual_seed(0), ccfg, device)
        gen = torch.Generator(device=device).manual_seed(1)
        for _ in range(steps):
            cstate = cu.sgd_step(cstate, gen, train_t.indices,
                                 train_t.values, ccfg)
        _sync(device)
        train_s = time.perf_counter() - t0
        r, m = rmse_mae(cstate.params, test_t, cu.predict)
        results.append({
            "model": "cutucker", "variant": "baseline", "rank": J,
            "rmse": float(r), "mae": float(m), "train_s": train_s,
        })

    return {
        "config": {
            "dims": list(dims), "nnz": p["nnz"], "steps": steps,
            "batch": p["batch"], "seed": p["seed"],
            "value_rms": float(np.sqrt(np.mean(
                test_t.values.double().cpu().numpy() ** 2))),
        },
        "results": results,
    }


def run(smoke: bool = False, out_path: str | None = None,
        device: str | torch.device | None = None,
        backend: str | None = None) -> dict:
    if out_path and os.path.basename(out_path) == REFERENCE_NAME:
        raise ValueError(f"{REFERENCE_NAME} is the reference's document; "
                         f"write the port's to {OUT_NAME}")
    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    res = measure(smoke, device, backend)
    doc = {
        "schema": BENCH_ACCURACY_SCHEMA,
        "generated_by": "src/repro_torch/benchmarks/bench_accuracy.py",
        "smoke": smoke,
        "platform": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else device.type),
        "backend": backend,
        **res,
    }
    validate_bench_accuracy(doc)

    steps = doc["config"]["steps"]
    for r in doc["results"]:
        print(f"acc/{r['model']}_{r['variant']}_J{r['rank']},"
              f"{r['train_s'] / steps * 1e6:.1f},"
              f"rmse={r['rmse']:.4f};mae={r['mae']:.4f}", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"# wrote {out_path}", flush=True)
    return doc


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes / short runs (schema check)")
    ap.add_argument("--out", default="",
                    help=f"write the validated document here (the port's "
                         f"name is {OUT_NAME})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    args = ap.parse_args(argv)
    return run(smoke=args.smoke, out_path=args.out or None,
               device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
