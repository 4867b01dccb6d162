"""Batched FastTucker serving CLI — a microbatch queue over a TuckerServer.

Counterpart of ``repro.launch.serve_tucker`` on one device: loads trained
``(factors, core_factors)`` from a ``checkpoint.manager`` directory (the
newest commit; what ``std_train --ckpt-dir`` writes), or trains a quick
``local`` model first when the directory is empty (saving it there), stands
up a ``repro_torch.serve.TuckerServer`` and pushes ``--requests``
variable-size query batches through a microbatch queue, reporting the
flush latency percentiles and the sustained queries/s, then a top-k demo.

    PYTHONPATH=src python -m repro_torch.launch.serve_tucker \\
        --dims 300,200,40 --nnz 30000 --train-steps 200 --requests 200 \\
        --microbatch 256 [--device cpu]

``--qps RATE --duration SECONDS`` switches to the closed-loop front end
(``repro_torch.serve.frontend``): concurrent clients offer ``RATE``
queries/s through the asyncio microbatch queue with admission control
(``--admission-max-queue``, ``--admission-deadline-ms``), and the CLI
prints the report as JSON: achieved QPS, shed counts and per-bucket
latency percentiles.

Runs on the CUDA card with the ``"cuda"`` kernels by default; ``--device
cpu`` runs on the CPU (the ``"cuda"`` backend's wrappers then take their
plain paths).  The reference's ``--sharded``, ``--shard-mode`` and
``--expected-qps`` wait for the multi-device strategies (ROADMAP.md,
Queue 1 item 4).
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import fasttucker as ft
from repro_torch.core.metrics import rmse_mae
from repro_torch.data.synthetic import ratings_tensor
from repro_torch.device import resolve_device
from repro_torch.distributed import get_strategy
from repro_torch.kernels import dispatch
from repro_torch.serve import (
    AdmissionConfig, TuckerServer, load_params_from_checkpoint,
    run_closed_loop,
)

log = logging.getLogger("repro_torch.serve_tucker")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Batched FastTucker (STD) serving; LM decoding is "
                    "repro_torch.launch.serve.")
    ap.add_argument("--dims", default="300,200,40")
    ap.add_argument("--nnz", type=int, default=30_000)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--core-rank", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2048,
                    help="training |Ψ| (only when training fresh)")
    ap.add_argument("--ckpt-dir", default="",
                    help="load factors from here when it has a committed "
                         "step; otherwise train then save here")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; "
                         "cpu must be asked for)")
    ap.add_argument("--requests", type=int, default=200,
                    help="number of query batches to stream")
    ap.add_argument("--max-request", type=int, default=512,
                    help="largest single request (batch sizes are drawn "
                         "log-uniform in [1, max])")
    ap.add_argument("--microbatch", type=int, default=256,
                    help="queue flush threshold (queries per served batch)")
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--qps", type=float, default=None,
                    help="closed-loop mode: offered query rate (switches "
                         "to the async front end)")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="closed-loop mode: seconds of offered load")
    ap.add_argument("--concurrency", type=int, default=16,
                    help="closed-loop mode: number of clients")
    ap.add_argument("--admission-max-queue", type=int, default=4096,
                    help="bounded queue: max waiting queries before "
                         "submissions shed")
    ap.add_argument("--admission-deadline-ms", type=float, default=200.0,
                    help="shed queued requests older than this at flush")
    ap.add_argument("--admission-max-wait-ms", type=float, default=2.0,
                    help="flush timer: max time a lone request waits "
                         "for a microbatch to fill")
    ap.add_argument("--admission-slo-ms", type=float, default=None,
                    help="latency SLO budget per request (alarm counter "
                         "slo_violations in the closed-loop report; "
                         "answers still flow past the budget)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _train_and_save(args, tensor, cfg, ckpt, device):
    """Quick ``local``-strategy training run so the CLI works standalone."""
    st = get_strategy("local")
    plan = st.prepare(tensor, cfg, None, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    ds = st.init(plan, ft.init_state(gen, cfg, device), gen)
    step = st.make_step(plan)
    t0 = time.perf_counter()
    while ds.step < args.train_steps:
        ds = step(ds)
    log.info("trained %d steps in %.1fs", args.train_steps,
             time.perf_counter() - t0)
    if ckpt is not None:
        st.save(plan, ckpt, ds)
        log.info("checkpointed step %d to %s", ds.step, ckpt.dir)
    return st.eval_params(plan, ds)


def run(args: argparse.Namespace) -> dict:
    """Train or load, serve, and return the report (the closed loop's, or
    the microbatch stream's)."""
    device = resolve_device(args.device)
    backend = dispatch.resolve_backend_name(args.backend)
    dispatch.get_backend(backend)  # fail fast on typos, before data gen

    dims = tuple(int(x) for x in args.dims.split(","))
    tensor = ratings_tensor(dims, nnz=args.nnz, seed=args.seed, device=device)
    train_t, test_t = tensor.split(0.1)
    cfg = ft.FastTuckerConfig(
        dims=dims, ranks=(args.rank,) * len(dims), core_rank=args.core_rank,
        batch_size=args.batch, backend=backend)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and ckpt.latest_step() is not None:
        params, step = load_params_from_checkpoint(args.ckpt_dir, dims=dims,
                                                   device=device)
        log.info("loaded checkpoint step %d from %s", step, args.ckpt_dir)
    else:
        params = _train_and_save(args, train_t, cfg, ckpt, device)

    server = TuckerServer(params, backend=backend)
    r, m = rmse_mae(params, test_t, lambda p, i: ft.predict(p, i, backend))
    log.info("serving %s on %s (backend=%s) — held-out rmse %.4f mae %.4f",
             "×".join(map(str, dims)), device, backend, float(r), float(m))
    pool = test_t.indices.cpu().numpy()

    if args.qps is not None:
        # ---- closed-loop async front end with admission control -----------
        admission = AdmissionConfig(
            max_queue=args.admission_max_queue,
            deadline_ms=args.admission_deadline_ms,
            microbatch=args.microbatch,
            max_wait_ms=args.admission_max_wait_ms,
            slo_ms=args.admission_slo_ms,
        )
        report = run_closed_loop(
            server, qps=args.qps, duration_s=args.duration,
            concurrency=args.concurrency, max_request=args.max_request,
            admission=admission, request_pool=pool, seed=args.seed + 1,
        )
        log.info("closed loop: offered %.0f q/s → achieved %.0f q/s over "
                 "%.1fs (%d served / %d shed-queue / %d shed-deadline), "
                 "latency p50 %.2fms p99 %.2fms across %d flushes",
                 report["offered_qps"], report["achieved_qps"],
                 report["duration_s"], report["served_requests"],
                 report["shed_queue_full"], report["shed_deadline"],
                 report["latency_ms"]["p50"] or float("nan"),
                 report["latency_ms"]["p99"] or float("nan"),
                 report["flushes"])
        for bucket, row in report["by_bucket"].items():
            log.info("  bucket %s: p50 %.2fms p95 %.2fms p99 %.2fms "
                     "(%d requests)", bucket, row["p50"], row["p95"],
                     row["p99"], row["count"])
        if report.get("slo_violations"):
            log.info("  SLO violations (budget %s ms): %s",
                     report["slo_budget_ms"], report["slo_violations"])
        return report

    # ---- microbatch queue over a stream of variable-size requests ----------
    rng = np.random.default_rng(args.seed + 1)
    sizes = np.exp(rng.uniform(0, np.log(args.max_request),
                               args.requests)).astype(int).clip(1)
    queue: list[np.ndarray] = []
    queued = 0
    flush_lat: list[float] = []
    served = 0

    def flush() -> int:
        batch = np.concatenate(queue)
        t1 = time.perf_counter()
        server.predict(batch).cpu()       # the copy waits for the device
        flush_lat.append(time.perf_counter() - t1)
        queue.clear()
        return len(batch)

    t0 = time.perf_counter()
    for sz in sizes:
        queue.append(pool[rng.integers(0, len(pool), int(sz))])
        queued += int(sz)
        if queued >= args.microbatch:
            served += flush()
            queued = 0
    if queue:
        served += flush()
    wall = time.perf_counter() - t0
    lat = np.array(flush_lat) * 1e3
    report = {"served_queries": served, "flushes": len(flush_lat),
              "seconds": wall, "qps": served / max(wall, 1e-9),
              "flush_ms": {"p50": float(np.percentile(lat, 50)),
                           "p95": float(np.percentile(lat, 95))},
              "rmse": float(r), "mae": float(m)}
    log.info("served %d queries in %d flushes / %.2fs — %.0f q/s, "
             "flush latency p50 %.2fms p95 %.2fms (ladder of %d buckets)",
             served, len(flush_lat), wall, report["qps"],
             report["flush_ms"]["p50"], report["flush_ms"]["p95"],
             len(server.ladder))

    # ---- top-k recommendation demo -----------------------------------------
    ids = rng.integers(0, dims[0], 3)
    scores, items = server.top_k(0, ids, k=args.top_k)
    scores, items = scores.cpu().numpy(), items.cpu().numpy()
    for b, uid in enumerate(ids):
        log.info("mode-0 entity %d → top-%d mode-1 items %s (scores %s)",
                 int(uid), args.top_k, items[b].tolist(),
                 np.round(scores[b], 3).tolist())
    report["top_k"] = {"ids": ids.tolist(), "items": items.tolist(),
                       "scores": scores.tolist()}
    return report


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    report = run(args)
    if args.qps is not None:
        print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
