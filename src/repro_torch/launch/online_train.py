"""Online training: supervised ingest → refresh → publish rounds behind
a live ``TuckerServer``.

Counterpart of ``repro.launch.online_train``.  The warm-up and the
refresh run under ``--strategy`` (``local``, or ``sync``, ``strata`` and
``strata_overlap`` on ``launch.mesh.make_host_mesh()``'s workers, with the
ingest store built at the mesh's worker count, as the reference builds
it).  After the offline warm-up the round runs on the background thread of
``serve.supervisor.RefreshSupervisor``:

    1. **Ingest** — the round's arrivals fold into a ``NonzeroStore``
       (``store.append``; spilled to memory-mapped files with
       ``--spill-dir``) and the recent-nonzero window advances;
    2. **Refresh** — ``strategy.refresh_steps`` runs K factor-phase SGD
       steps over the window and reports the dirty rows of each mode;
    3. **Publish** — ``TuckerServer.update_rows`` patches only the dirty
       rows of the tables, or one ``refresh_tables()`` rebuilds them when
       the drift tracker says so,

each stage with retry and backoff, a breaker into degraded serving and a
recovery after.  ``run`` submits each round's arrivals, drains,
probes the live server with 64 of them and evaluates the held-out RMSE.

The data are the reference's: a planted tensor, 10 % held out, and the
last ``--stream-fraction`` of the training nonzeros held back to arrive in
``--rounds`` equal rounds.  The warm-up's init and batches follow
``std_train``: one ``torch.Generator`` seeded with ``--seed`` (the
reference's threefry keys cannot be reproduced), so the store and the
arrivals equal the reference's and the trajectory does not.
``--inject-faults`` threads a ``FaultPlan`` (``site@i:j``, ``site%p`` over
ingest, transfer, refresh, publish) through the supervisor;
``--expect-breaker`` asserts that the run degraded and recovered;
``--verify`` holds the patched tables against a fresh server's from the
refreshed parameters, in the same layout (bitwise for f32 tables, every
worker's block or replica; banded for bf16).

Runs on the CUDA card with the ``"cuda"`` kernels by default; ``--device
cpu`` runs on the CPU (``REPRO_FORCE_HOST_DEVICES=4`` gives the mesh
strategies four workers there).  ``--serve-shard-mode row|batch`` serves
the tables sharded over the training mesh when the strategy has one, else
over ``make_host_mesh()``'s workers.

    PYTHONPATH=src python -m repro_torch.launch.online_train \\
        --dims 16,12,10 --nnz 400 --warmup-steps 4 --rounds 2 \\
        --refresh-steps 2 --batch 64 --rank 2 --core-rank 2 --window 128 \\
        --spill-dir /tmp/spill --verify --device cpu [--strategy strata]
"""
from __future__ import annotations

import argparse
import logging
import time
from functools import partial

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.core import fasttucker as ft
from repro_torch.core.metrics import rmse_mae
from repro_torch.core.sptensor import SparseTensor
from repro_torch.data.pipeline import NonzeroStore
from repro_torch.data.synthetic import planted_tensor
from repro_torch.device import resolve_device
from repro_torch.distributed import get_strategy
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.fault import FaultPlan
from repro_torch.serve import RefreshSupervisor, SupervisorConfig, TuckerServer

log = logging.getLogger("repro_torch.online")
PROBES = 64          # arrivals each round's probe sends to the live server
DRAIN_TIMEOUT_S = 600


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--strategy", default="local",
                    help="training strategy for warm-up and refresh: local "
                         "| sync | strata | strata_overlap")
    ap.add_argument("--dims", default="200,160,120")
    ap.add_argument("--nnz", type=int, default=20_000,
                    help="total planted nonzeros; --stream-fraction of "
                         "the training ones arrive during the rounds")
    ap.add_argument("--stream-fraction", type=float, default=0.3)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--core-rank", type=int, default=4)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--warmup-steps", type=int, default=50,
                    help="offline SGD steps before serving starts")
    ap.add_argument("--rounds", type=int, default=5,
                    help="online ingest→refresh→publish rounds")
    ap.add_argument("--refresh-steps", type=int, default=4,
                    help="factor-phase steps per round (K)")
    ap.add_argument("--window", type=int, default=0,
                    help="recent-nonzero window per refresh "
                         "(0: one round's arrivals)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; "
                         "cpu must be asked for)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve-shard-mode", default="none",
                    choices=["none", "row", "batch"],
                    help="serving-table layout (row/batch: over the "
                         "training mesh, else a host mesh)")
    ap.add_argument("--table-dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--spill-dir", default="",
                    help="spill the ingest store to memory-mapped chunks")
    ap.add_argument("--verify", action="store_true",
                    help="assert the final patched tables match a full "
                         "server rebuild (bitwise for f32 tables)")
    ap.add_argument("--inject-faults", default="",
                    help="deterministic FaultPlan spec, e.g. "
                         "'refresh@0:1:2,publish%%0.1' (sites: ingest, "
                         "transfer, refresh, publish)")
    ap.add_argument("--expect-breaker", action="store_true",
                    help="assert the supervisor tripped into degraded "
                         "mode AND recovered")
    ap.add_argument("--max-attempts", type=int, default=3,
                    help="per-cycle retry budget before the breaker trips")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launch_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in K.launch_counts().items()}


def run(
    args: argparse.Namespace,
    data: tuple[SparseTensor, SparseTensor] | None = None,
) -> dict:
    """Warm up, then serve and refresh ``--rounds`` rounds; returns the
    run's record (one entry a round, the final health, the verify result,
    and the live objects: server, supervisor state, store).

    ``data``, an already-built ``(train, test)`` pair on the device, skips
    the generation; ``--dims`` must match it.
    """
    # refusals first, before any data is made
    strategy = get_strategy(args.strategy)
    device = resolve_device(args.device)
    backend = dispatch.resolve_backend_name(args.backend)
    dispatch.get_backend(backend)
    dims = tuple(int(x) for x in args.dims.split(","))
    cfg = ft.FastTuckerConfig(
        dims=dims, ranks=(args.rank,) * len(dims), core_rank=args.core_rank,
        batch_size=args.batch, backend=backend)
    fault_plan = (FaultPlan.parse(args.inject_faults, seed=args.seed)
                  if args.inject_faults else None)

    t_start = time.perf_counter()
    if data is None:
        tensor = planted_tensor(dims, args.nnz, rank=args.rank,
                                core_rank=args.core_rank, noise=0.05,
                                seed=args.seed, device=device)
        train_t, test_t = tensor.split(0.1)
        del tensor
    else:
        train_t, test_t = data
        if train_t.dims != dims:
            raise ValueError(f"--dims {dims} do not match the given data's "
                             f"{train_t.dims}")

    # hold back the streaming tail: not in the warm-up set, it arrives
    # round by round
    n_stream = int(train_t.nnz * args.stream_fraction)
    n_warm = train_t.nnz - n_stream
    warm_t = SparseTensor(train_t.indices[:n_warm], train_t.values[:n_warm],
                          dims)
    stream_idx = train_t.indices[n_warm:].cpu().numpy()
    stream_val = train_t.values[n_warm:].cpu().numpy()
    per_round = max(1, n_stream // max(args.rounds, 1))
    window = args.window or per_round

    mesh = make_host_mesh(device=device) if strategy.needs_mesh else None
    t0 = time.perf_counter()
    plan = strategy.prepare(warm_t, cfg, mesh, seed=args.seed)
    _sync(device)
    prepare_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dstate = strategy.init(plan, ft.init_state(gen, cfg, device), gen)

    # the ingest store mirrors the warm-up set at the mesh's worker count
    # (the strata layout of a later out-of-core retrain); each round
    # appends to it
    t0 = time.perf_counter()
    store = NonzeroStore.build(warm_t, mesh.size if mesh is not None else 1,
                               spill_dir=args.spill_dir or None)
    store_s = time.perf_counter() - t0
    store_bytes = store.nbytes
    log.info("store: %d nonzeros, %d bytes, %s, built in %.2fs", store.nnz,
             store.nbytes, f"spilled to {store.path}" if store.spilled
             else "in memory", store_s)

    log.info("warmup: %d steps of %s (%d workers, plan in %.2fs) on %d "
             "resident nnz (%d held back to stream), device %s, backend %s",
             args.warmup_steps, strategy.name,
             mesh.size if mesh is not None else 1, prepare_s, n_warm,
             n_stream, device, backend)
    step_fn = strategy.make_step(plan)
    t0 = time.perf_counter()
    while dstate.step < args.warmup_steps:
        dstate = step_fn(dstate)
    _sync(device)
    warm_s = time.perf_counter() - t0
    predict_fn = partial(ft.predict, backend=backend)
    params = strategy.eval_params(plan, dstate)
    r, m = rmse_mae(params, test_t, predict_fn)
    log.info("warmup done at step %d in %.2fs: rmse %.4f mae %.4f",
             dstate.step, warm_s, r, m)
    warmup = {"steps": dstate.step, "seconds": warm_s, "rmse": float(r),
              "mae": float(m), "prepare_seconds": prepare_s}

    serve_mesh = None
    if args.serve_shard_mode in ("row", "batch"):
        serve_mesh = (mesh if mesh is not None
                      else make_host_mesh(device=device))
    server = TuckerServer(
        params, backend=backend, mesh=serve_mesh,
        shard_mode=args.serve_shard_mode if serve_mesh else "auto",
        table_dtype=args.table_dtype)
    log.info("serving %s tables (%s%s, version %d)", server.shard_mode,
             server.table_dtype,
             f", {serve_mesh.size} workers" if serve_mesh is not None
             else "", server.table_version)
    # only the last `window` warm nonzeros can enter a window
    lo = max(0, n_warm - window)
    history = (train_t.indices[lo:n_warm].cpu().numpy(),
               train_t.values[lo:n_warm].cpu().numpy())
    sup = RefreshSupervisor(
        server, strategy, plan, dstate, store=store,
        config=SupervisorConfig(
            refresh_steps=args.refresh_steps, window=window,
            max_attempts=args.max_attempts, backoff_base_s=0.005,
            backoff_cap_s=0.05, degraded_retry_s=0.02, seed=args.seed),
        fault_plan=fault_plan, history=history)
    rounds = []
    sup.start()
    try:
        for rd in range(args.rounds):
            lo = rd * per_round
            hi = n_stream if rd == args.rounds - 1 else (rd + 1) * per_round
            new_idx, new_val = stream_idx[lo:hi], stream_val[lo:hi]
            if len(new_val) == 0:
                break
            counts = K.launch_counts()
            t0 = time.perf_counter()
            sup.submit(new_idx, new_val)
            if not sup.drain(timeout=DRAIN_TIMEOUT_S):
                raise RuntimeError(
                    f"round {rd} did not publish within "
                    f"{DRAIN_TIMEOUT_S}s: {sup.health()}")
            _sync(device)
            drain_s = time.perf_counter() - t0
            launches = _launch_delta(counts)
            # probe the LIVE server with queries drawn from the arrivals
            pred = server.predict(new_idx[:PROBES]).float().cpu().numpy()
            params = strategy.eval_params(plan, sup.dstate)
            r, m = rmse_mae(params, test_t, predict_fn)
            h = sup.health()
            rec = {
                "round": rd, "arrivals": len(new_val),
                "store_nnz": sup.store.nnz, "store_bytes": sup.store.nbytes,
                "stage_seconds": h["stage_seconds"],
                "dirty": h["last_dirty"],
                "publish": h["last_publish"]["kind"],
                "generation": h["generation"], "state": h["state"],
                "probe_abs_mean": float(np.abs(pred).mean()),
                "rmse": float(r), "mae": float(m), "drain_s": drain_s,
                "round_ms": (time.perf_counter() - t0) * 1e3,
                "launches": launches,
            }
            rounds.append(rec)
            log.info(
                "round %d: +%d nnz (store %d, %d bytes), ingest %.3fs, "
                "refresh K=%d %.3fs, publish %.3fs, dirty %s, table v%d %s, "
                "state %s (trips %d, recoveries %d, faults %d), probe |x̂| "
                "%.3f, rmse %.4f mae %.4f (%.0f ms)", rd, len(new_val),
                rec["store_nnz"], rec["store_bytes"],
                rec["stage_seconds"].get("ingest", 0.0), args.refresh_steps,
                rec["stage_seconds"].get("refresh", 0.0),
                rec["stage_seconds"].get("publish", 0.0), rec["dirty"],
                rec["generation"], rec["publish"], rec["state"],
                h["breaker_trips"], h["recoveries"], h["faults_injected"],
                rec["probe_abs_mean"], r, m, rec["round_ms"])
    finally:
        sup.stop()

    health = sup.health()
    params = strategy.eval_params(plan, sup.dstate)
    if args.inject_faults:
        if not health["faults_injected"] > 0:
            raise AssertionError(
                "--inject-faults given but no fault fired — check the spec "
                f"against the round count: {args.inject_faults!r}")
        log.info("fault injection: %d faults fired (%s), %d retries, "
                 "%d breaker trips, %d recoveries",
                 health["faults_injected"], fault_plan.fired_by_site(),
                 health["retries"], health["breaker_trips"],
                 health["recoveries"])
    if args.expect_breaker:
        if not (health["breaker_trips"] >= 1 and health["recoveries"] >= 1):
            raise AssertionError(
                f"expected a breaker trip and a recovery after it: {health}")
        log.info("degraded-then-recovered contract OK (%d trips, "
                 "%d recoveries)", health["breaker_trips"],
                 health["recoveries"])

    verify = None
    if args.verify:
        verify = _verify(server, params, backend, args.table_dtype)
        log.info("verify OK: patched tables match a full rebuild (%s) after "
                 "%d generations", "bitwise" if verify["exact"]
                 else "tolerance-banded", verify["generations"])
    return {
        "warmup": warmup, "rounds": rounds, "health": health,
        "verify": verify, "store_build_seconds": store_s,
        "store_build_bytes": store_bytes,
        "seconds": time.perf_counter() - t_start, "n_warm": n_warm,
        "n_stream": n_stream, "window": window, "device": str(device),
        "workers": mesh.size if mesh is not None else 1,
        "serve_workers": serve_mesh.size if serve_mesh is not None else 1,
        "backend": backend, "strategy": strategy.name, "cfg": cfg,
        "server": server, "dstate": sup.dstate, "store": sup.store,
        "params": params, "train": train_t, "test": test_t,
    }


def _verify(server: TuckerServer, params, backend: str,
            table_dtype: str | None) -> dict:
    """The patched server against a fresh one built from ``params`` in
    its layout: f32 tables bitwise (every worker's block or replica),
    bf16 tables within the reference's band (0.05); the column sums
    within 1e-4."""
    sharded = server.mesh is not None
    ref = TuckerServer(params, backend=backend, mesh=server.mesh,
                       shard_mode=server.shard_mode if sharded else "auto",
                       table_dtype=table_dtype)
    exact = server.table_dtype == torch.float32
    for n in range(server.order):
        got, want = server._live.tables[n], ref._live.tables[n]
        for a, b in zip(got if sharded else (got,),
                        want if sharded else (want,)):
            a, b = a.float(), b.float()
            if exact:
                if not torch.equal(a, b):
                    raise AssertionError(f"mode {n}: patched ≠ rebuilt")
            else:
                torch.testing.assert_close(a, b, rtol=0.05, atol=0.05)
        torch.testing.assert_close(server._colsums[n], ref._colsums[n],
                                   rtol=1e-4, atol=1e-4)
    return {"exact": exact, "generations": server.table_version}


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
