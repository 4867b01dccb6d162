"""Serving-path benchmark on the port → ``BENCH_torch_serve.json``.

Counterpart of ``benchmarks/bench_serve.py`` at its ``FULL`` and ``SMOKE``
points, with the reference's schema (``bench_serve/v1``) and validator
(``common.validate_bench_serve``).  The document holds:

  * **throughput** — bucketed batched serving (``TuckerServer.predict`` of
    requests of 1–512 queries on the bucket ladder) against the
    per-query path (one ``core.fasttucker.predict`` of one query a call,
    closed by a synchronize: the reference's jitted single-query call),
    and ``sweep_compiles``.  PyTorch compiles nothing, so that field
    counts what the reference's bounds: the distinct bucket lengths that
    a 1→512 sweep of ``predict`` calls launched, read from the server's
    own chunking (a hook on ``_bucketed_chunks``), which must stay within
    ``ladder_bound`` (the ladder's length).
  * **collectives** (``devices > 1``) — the bytes the row-sharded
    ``top_k``'s copies move between workers for one bucket of
    ``microbatch`` queries of mode 1 scored against mode 0 at ``k``,
    counted by ``distributed.collectives`` (the server's ``traffic``),
    against the baseline on the same row-sharded tables: the unsharded
    program's data flow, where every worker scores its block and the
    (B, rows) score matrix is all-gathered before one top-k — what the
    reference's GSPMD compile of the unsharded program does.  The field
    keeps the reference's name ``gspmd_operand_bytes``; ``baseline``
    says what it counts.
  * **closed_loop** — the front end (``serve.run_closed_loop``): the
    unsharded server at the first offered predict rate, and at
    ``devices > 1`` the row and batch servers' ``predict`` at every
    offered rate, the row ``top_k`` and the baseline's ``top_k``
    (``shard_mode`` ``"gspmd"``, the reference's name for it), every
    ladder bucket served once before each server's rows.
  * **crossover** (``devices > 1``) — the row and batch layouts' largest
    achieved ``predict`` q/s and their ratio.

The sharded servers run on ``launch.mesh.make_host_mesh(num_workers=
devices)``: in-process workers, which on one card share it.  The model is
a random init (seed 0), as in the reference; the queries are nonzeros of
``ratings_tensor``.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_serve \\
        [--smoke] [--devices 4] [--out BENCH_torch_serve.json] \\
        [--device cpu] [--backend torch]
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

from .common import BENCH_SERVE_SCHEMA, row, validate_bench_serve

FULL = dict(dims=(2000, 1200, 150), nnz=100_000, rank=8, k=10,
            microbatch=256, max_request=64, duration_s=3.0,
            predict_qps=(4_000.0, 16_000.0, 64_000.0),
            top_k_qps=2_000.0, concurrency=16)
SMOKE = dict(dims=(120, 90, 30), nnz=4_000, rank=4, k=5,
             microbatch=64, max_request=16, duration_s=1.0,
             predict_qps=(2_000.0,),
             top_k_qps=500.0, concurrency=8)

DEVICES = 4

OUT_NAME = "BENCH_torch_serve.json"
REFERENCE_NAME = "BENCH_serve.json"   # the reference's; never written


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _closed_loop_row(server, *, shard_mode: str, query: str, qps: float,
                     cfgp: dict, pool, top_k_args=None, seed=0) -> dict:
    from repro_torch.serve import AdmissionConfig, run_closed_loop

    rep = run_closed_loop(
        server, qps=qps, duration_s=cfgp["duration_s"],
        concurrency=cfgp["concurrency"], max_request=cfgp["max_request"],
        admission=AdmissionConfig(microbatch=cfgp["microbatch"]),
        query=query, top_k_args=top_k_args,
        request_pool=pool if query == "predict" else None, seed=seed)
    lat = rep["latency_ms"]
    return {
        "shard_mode": shard_mode,
        "query": query,
        "offered_qps": float(qps),
        "achieved_qps": float(rep["achieved_qps"]),
        "p50_ms": float(lat["p50"] if lat["p50"] is not None else -1.0),
        "p99_ms": float(lat["p99"] if lat["p99"] is not None else -1.0),
        "served_requests": int(rep["served_requests"]),
        "shed": int(rep["shed_queue_full"] + rep["shed_deadline"]),
        "by_bucket": rep["by_bucket"],
    }


def sweep_bucket_lengths(server, queries: np.ndarray) -> set[int]:
    """The distinct chunk lengths the server's ``predict`` launched over
    the reference's 1→512 request sweep (a hook on ``_bucketed_chunks``)."""
    lengths: set[int] = set()
    chunks = server._bucketed_chunks

    def recorded(arr):
        for chunk, n in chunks(arr):
            lengths.add(len(chunk))
            yield chunk, n

    server._bucketed_chunks = recorded
    try:
        for b in range(1, 513):
            if b in (1, 2, 3, 5, 7) or b % 16 == 0 or b in (511, 512):
                server.predict(queries[:b])
    finally:
        del server._bucketed_chunks
    return lengths


BASELINE = ("the unsharded top_k's data flow on the same row-sharded "
            "tables: the query rows gathered and copied to every worker, "
            "each worker's (B, block rows) f32 scores all-gathered on the "
            "answering worker before one top-k (what the reference's GSPMD "
            "compile of the unsharded program all-gathers); both figures "
            "count elements x item size of every tensor copied between "
            "workers")


def score_gather_server(params, **kw):
    """A row-sharded ``TuckerServer`` whose ``top_k`` is the baseline:
    every worker scores its block of the target table and the (B, block
    rows) score blocks are all-gathered on the answering worker, which
    sorts the whole row once (the unsharded program's data flow)."""
    from repro_torch.distributed.collectives import all_gather
    from repro_torch.serve import TuckerServer

    class ScoreGatherServer(TuckerServer):
        def _row_top_k(self, live, chunk, mode, target, k):
            ws, moved = self._row_query_weights(live, chunk, mode, target)
            blocks = [torch.matmul(ws[m], b.float().T)
                      for m, b in enumerate(live.tables[target])]
            scores, b = all_gather(blocks, self._workers, dim=1)
            self._count("top_k", moved + b)
            vals, items = torch.sort(scores[:, : self.dims[target]], dim=1,
                                     descending=True, stable=True)
            return vals[:, :k], items[:, :k].to(torch.int32)

    return ScoreGatherServer(params, mesh=kw.pop("mesh"), shard_mode="row",
                             **kw)


def top_k_bytes(server, ids: np.ndarray, k: int) -> int:
    """Bytes one ``top_k`` of ``ids`` (mode 1 against mode 0) copied
    between the server's workers."""
    before = server.traffic["top_k"]
    server.top_k(1, ids, k, target_mode=0)
    return server.traffic["top_k"] - before


def measure(smoke: bool, device: torch.device, backend: str,
            devices: int = DEVICES) -> dict:
    from repro_torch.core import fasttucker as ft
    from repro_torch.data.synthetic import ratings_tensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import TuckerServer

    cfgp = SMOKE if smoke else FULL
    dims, J, k = cfgp["dims"], cfgp["rank"], cfgp["k"]
    tensor = ratings_tensor(dims, nnz=cfgp["nnz"], rank=J, seed=0,
                            device=device)
    cfg = ft.FastTuckerConfig(dims=dims, ranks=(J,) * len(dims),
                              core_rank=J, batch_size=1024, backend=backend)
    params = ft.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    rng = np.random.default_rng(0)
    all_idx = tensor.indices.cpu().numpy().astype(np.int32)
    queries = all_idx[rng.integers(0, len(all_idx), 2048)]

    out: dict = {"devices": devices}
    base = TuckerServer(params, backend=backend)

    # ---- throughput: bucketed batched vs per-query, bounded buckets --------
    def single(q):
        return ft.predict(params, torch.tensor(q, device=device), backend)

    single(queries[:1])
    _sync(device)
    n_pq = 128 if smoke else 256
    t0 = time.perf_counter()
    for q in range(n_pq):
        single(queries[q:q + 1])
        _sync(device)
    per_query_qps = n_pq / (time.perf_counter() - t0)

    sizes = rng.integers(1, 513, 32 if smoke else 64)
    requests, used = [], 0
    for sz in sizes:
        sel = np.arange(used, used + int(sz)) % len(queries)
        requests.append(queries[sel])
        used += int(sz)
    for r_ in requests:                       # every bucket served once
        base.predict(r_)
    _sync(device)
    total = sum(len(r_) for r_ in requests)
    t0 = time.perf_counter()
    for r_ in requests:
        base.predict(r_)
    _sync(device)
    bucketed_qps = total / (time.perf_counter() - t0)

    sweep = TuckerServer(params, backend=backend)
    out["throughput"] = {
        "per_query_qps": float(per_query_qps),
        "bucketed_qps": float(bucketed_qps),
        "speedup": float(bucketed_qps / per_query_qps),
        "sweep_compiles": len(sweep_bucket_lengths(sweep, queries)),
        "ladder_bound": len(sweep.ladder),
    }

    # ---- closed loop: the unsharded server ----------------------------------
    def warm(server, query="predict"):
        # steady state: every ladder bucket served once
        for b in server.ladder:
            if query == "predict":
                server.predict(queries[np.arange(b) % len(queries)])
            else:
                server.top_k(1, np.zeros(b, np.int32), k, target_mode=0)
        _sync(device)

    warm(base)
    rows = [_closed_loop_row(base, shard_mode="none", query="predict",
                             qps=cfgp["predict_qps"][0], cfgp=cfgp,
                             pool=queries)]
    if devices > 1:
        mesh = make_host_mesh(num_workers=devices, device=device)
        row_srv = TuckerServer(params, backend=backend, mesh=mesh,
                               shard_mode="row")
        batch_srv = TuckerServer(params, backend=backend, mesh=mesh,
                                 shard_mode="batch")
        base_srv = score_gather_server(params, backend=backend, mesh=mesh)

        # ---- collectives: bytes between workers, shard-local merge vs
        # the score gather, one bucket of mode-1 queries against mode 0
        bucket = cfgp["microbatch"]
        ids = queries[:bucket, 1].copy()
        sharded = top_k_bytes(row_srv, ids, k)
        baseline = top_k_bytes(base_srv, ids, k)
        out["collectives"] = {
            "devices": devices,
            "bucket": int(bucket),
            "k": int(k),
            "sharded_operand_bytes": int(sharded),
            "gspmd_operand_bytes": int(baseline),
            "reduction": float(baseline / max(sharded, 1)),
            "baseline": BASELINE,
        }

        # ---- closed loop: the sharded layouts ----------------------------
        warm(row_srv)
        warm(batch_srv)
        warm(row_srv, "top_k")
        warm(base_srv, "top_k")
        for qps in cfgp["predict_qps"]:
            for name, srv in (("row", row_srv), ("batch", batch_srv)):
                rows.append(_closed_loop_row(
                    srv, shard_mode=name, query="predict", qps=qps,
                    cfgp=cfgp, pool=queries))
        for name, srv in (("row", row_srv), ("gspmd", base_srv)):
            rows.append(_closed_loop_row(
                srv, shard_mode=name, query="top_k", qps=cfgp["top_k_qps"],
                cfgp=cfgp, pool=None, top_k_args=(1, k, 0)))

        row_max = max(r["achieved_qps"] for r in rows
                      if r["shard_mode"] == "row" and r["query"] == "predict")
        batch_max = max(r["achieved_qps"] for r in rows
                        if r["shard_mode"] == "batch")
        out["crossover"] = {
            "row_max_qps": float(row_max),
            "batch_max_qps": float(batch_max),
            "batch_vs_row": float(batch_max / row_max),
            "note": "max achieved predict q/s per table layout at the "
                    "offered-load ladder; serve.policy picks 'batch' "
                    "when traffic clears its threshold and the tables "
                    "fit replicated",
        }
    out["closed_loop"] = {"rows": rows}
    return out


def run(smoke: bool = False, out_path: str | None = None,
        device: str | torch.device | None = None,
        backend: str | None = None, devices: int = DEVICES) -> dict:
    if out_path and os.path.basename(out_path) == REFERENCE_NAME:
        raise ValueError(f"{REFERENCE_NAME} is the reference's document; "
                         f"write the port's to {OUT_NAME}")
    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    cfgp = SMOKE if smoke else FULL
    res = measure(smoke, device, backend, devices)

    doc = {
        "schema": BENCH_SERVE_SCHEMA,
        "generated_by": "src/repro_torch/benchmarks/bench_serve.py",
        "smoke": smoke,
        "platform": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else device.type),
        "config": {
            "dims": list(cfgp["dims"]),
            "nnz": cfgp["nnz"],
            "rank": cfgp["rank"],
            "core_rank": cfgp["rank"],
            "k": cfgp["k"],
            "backend": backend,
            "devices": res["devices"],
            "microbatch": cfgp["microbatch"],
            "max_request": cfgp["max_request"],
            "duration_s": cfgp["duration_s"],
            "concurrency": cfgp["concurrency"],
        },
        "throughput": res["throughput"],
        "closed_loop": res["closed_loop"],
    }
    for key in ("collectives", "crossover"):
        if key in res:
            doc[key] = res[key]
    validate_bench_serve(doc)

    thr = doc["throughput"]
    row("serve/per_query_us", 1e6 / thr["per_query_qps"],
        f"{thr['per_query_qps']:.0f} q/s")
    row("serve/bucketed_us", 1e6 / thr["bucketed_qps"],
        f"{thr['bucketed_qps']:.0f} q/s")
    row("serve/speedup_x", thr["speedup"], "bucketed vs per-query")
    row("serve/sweep_compiles", thr["sweep_compiles"],
        f"ladder bound {thr['ladder_bound']} (distinct bucket lengths "
        "launched)")
    if "collectives" in doc:
        col = doc["collectives"]
        row("serve/topk_collective_sharded_B", col["sharded_operand_bytes"],
            f"M={col['devices']} bucket={col['bucket']} k={col['k']}")
        row("serve/topk_collective_gspmd_B", col["gspmd_operand_bytes"],
            f"{col['reduction']:.1f}x more than shard-local merge "
            "(baseline: the score gather)")
    for r in doc["closed_loop"]["rows"]:
        row(f"serve/loop_{r['shard_mode']}_{r['query']}"
            f"@{r['offered_qps']:.0f}",
            r["p50_ms"] * 1e3,
            f"p99={r['p99_ms']:.1f}ms achieved={r['achieved_qps']:.0f}q/s "
            f"shed={r['shed']}")
    if "crossover" in doc:
        x = doc["crossover"]
        row("serve/crossover_batch_vs_row", x["batch_vs_row"],
            f"row={x['row_max_qps']:.0f} batch={x['batch_max_qps']:.0f} q/s")
    if thr["speedup"] < 10:
        print(f"WARNING: bucketed speedup {thr['speedup']:.1f}x below "
              f"the 10x target", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"# wrote {out_path}", flush=True)
    return doc


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes / short loops (schema check)")
    ap.add_argument("--out", default="",
                    help=f"write the validated document here (the port's "
                         f"name is {OUT_NAME})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    ap.add_argument("--devices", type=int, default=DEVICES,
                    help="workers of the sharded sections (1 skips them)")
    args = ap.parse_args(argv)
    return run(smoke=args.smoke, out_path=args.out or None,
               device=args.device, backend=args.backend,
               devices=args.devices)


if __name__ == "__main__":
    main()
