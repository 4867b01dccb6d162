"""Delta patch against full rebuild for online serve refreshes, on the port.

Counterpart of ``benchmarks/bench_refresh.py``: the same ``FULL`` and
``SMOKE`` points, dirty fractions, schema (``bench_refresh/v1``) and
``validate``, word for word — the delta patch (``TuckerServer.update_rows``
of mode 0's dirty rows) must beat the full rebuild
(``TuckerServer.refresh_tables`` of every mode) at every dirty fraction
≤ 10 %.  A row is

    {dirty_fraction, dirty_rows, patch_ms, rebuild_ms, speedup}

with ``speedup`` = rebuild_ms / patch_ms, each the median of ``iters``
calls closed by a ``torch.cuda.synchronize()``, the two taken in turns.
The new factor rows are already on the device, as the reference's are;
the ids are a sorted numpy array.  ``--supervised`` adds the optional
``supervised`` section: round latency through
``serve.supervisor.RefreshSupervisor`` (the ``local`` strategy) and the
cost of riding out an injected refresh fault.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_refresh \\
        [--smoke] [--supervised] [--out BENCH_torch_refresh.json] \\
        [--table-dtype bfloat16] [--device cpu] [--backend torch]
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

from .common import row

SCHEMA = "bench_refresh/v1"

FULL = dict(dims=(60_000, 40_000, 20_000), rank=64, iters=7)
SMOKE = dict(dims=(8_000, 6_000, 4_000), rank=48, iters=5)

FRACTIONS = (0.01, 0.02, 0.05, 0.10, 0.25)
# the contract bench + CI assert: delta-patch faster than rebuild here
CONTRACT_MAX_FRACTION = 0.10

OUT_NAME = "BENCH_torch_refresh.json"
REFERENCE_NAME = "BENCH_refresh.json"   # the reference's; never written


def validate(doc: dict) -> None:
    """Raise ``ValueError`` unless ``doc`` is a valid BENCH_refresh doc."""
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"schema must be {SCHEMA!r}, got {doc.get('schema')!r}")
    rows = doc.get("rows")
    if not isinstance(rows, list) or not rows:
        raise ValueError("rows must be a non-empty list")
    for i, r in enumerate(rows):
        for field, typ in (("dirty_fraction", float), ("dirty_rows", int),
                          ("patch_ms", float), ("rebuild_ms", float),
                          ("speedup", float)):
            if not isinstance(r.get(field), typ):
                raise ValueError(f"rows[{i}].{field} must be {typ.__name__}")
        if r["patch_ms"] <= 0 or r["rebuild_ms"] <= 0:
            raise ValueError(f"rows[{i}]: latencies must be > 0")
        if (r["dirty_fraction"] <= CONTRACT_MAX_FRACTION
                and r["speedup"] <= 1.0):
            raise ValueError(
                f"rows[{i}]: delta patch must beat rebuild at dirty "
                f"fraction {r['dirty_fraction']} (speedup "
                f"{r['speedup']:.2f} <= 1)")
    sup = doc.get("supervised")
    if sup is not None:   # optional section — absent in older documents
        for field in ("rounds", "clean_round_ms", "faulted_round_ms",
                      "faults_injected", "breaker_trips", "recoveries"):
            if not isinstance(sup.get(field), (int, float)):
                raise ValueError(f"supervised.{field} must be numeric")
        if sup["rounds"] <= 0 or sup["clean_round_ms"] <= 0:
            raise ValueError("supervised: rounds and latency must be > 0")
        if sup["faults_injected"] > 0 and sup["recoveries"] < 1:
            raise ValueError(
                "supervised: injected faults must end in a recovery — a "
                "benchmark that leaves the supervisor degraded measured "
                "an outage, not an overhead")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_s(fn, device: torch.device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def _median_ms(times: list[float]) -> float:
    return sorted(times)[len(times) // 2] * 1e3


def _platform(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def measure(smoke: bool, table_dtype: str | None = None,
            device: str | torch.device | None = None,
            backend: str | None = None) -> dict:
    from repro_torch.core.fasttucker import FastTuckerParams
    from repro_torch.serve import TuckerServer

    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    point = SMOKE if smoke else FULL
    dims, J, iters = point["dims"], point["rank"], point["iters"]
    rng = np.random.default_rng(0)
    factors = tuple(
        torch.tensor(rng.standard_normal((d, J)), dtype=torch.float32,
                     device=device) for d in dims)
    cores = tuple(
        torch.tensor(rng.standard_normal((J, J)), dtype=torch.float32,
                     device=device) for _ in dims)
    srv = TuckerServer(FastTuckerParams(factors, cores), backend=backend,
                       table_dtype=table_dtype)

    # mode 0 (the largest mode — the expensive table either way)
    I0 = dims[0]

    def patch(ids, rows_):
        srv.update_rows(0, ids, rows_)
        return srv._tables[0]

    def rebuild():
        srv.refresh_tables()
        return srv._tables[0]

    # warm both paths (kernel loads, allocator) before any timing
    warm_ids = np.arange(min(32, I0), dtype=np.int32)
    patch(warm_ids, torch.tensor(
        rng.standard_normal((len(warm_ids), J)), dtype=torch.float32,
        device=device))
    rebuild()

    rows = []
    for frac in FRACTIONS:
        f = max(1, int(I0 * frac))
        ids = np.sort(rng.permutation(I0)[:f]).astype(np.int32)
        new_rows = torch.tensor(rng.standard_normal((f, J)),
                                dtype=torch.float32, device=device)
        patch(ids, new_rows)      # this size once off the clock
        # the patch and the rebuild in turns, so both see the same host (a
        # host stall over one stretch of calls reaches both alike); the
        # factors' copy that the first read of params after a patch makes
        # is taken off the clock, so each rebuild is timed as a rebuild
        # after a rebuild
        patch_s, rebuild_s = [], []
        for _ in range(iters):
            patch_s.append(_timed_s(lambda: patch(ids, new_rows), device))
            _ = srv.params
            rebuild_s.append(_timed_s(rebuild, device))
        patch_ms, rebuild_ms = _median_ms(patch_s), _median_ms(rebuild_s)
        r = {
            "dirty_fraction": float(frac),
            "dirty_rows": int(f),
            "patch_ms": round(patch_ms, 4),
            "rebuild_ms": round(rebuild_ms, 4),
            "speedup": round(rebuild_ms / patch_ms, 4),
        }
        rows.append(r)
        row(f"refresh/dirty{frac:g}", patch_ms * 1e3,
            f"rebuild={rebuild_ms:.2f}ms,speedup={r['speedup']:.2f}x")

    return {
        "schema": SCHEMA,
        "generated_by": "src/repro_torch/benchmarks/bench_refresh.py",
        "smoke": smoke,
        "platform": _platform(device),
        "config": {"dims": list(dims), "rank": J,
                   "table_dtype": str(srv.table_dtype).replace("torch.", ""),
                   "final_table_version": srv.table_version,
                   "backend": backend},
        "contract_max_fraction": CONTRACT_MAX_FRACTION,
        "rows": rows,
    }


SUP_FULL = dict(dims=(200, 160, 120), nnz=20_000, warmup=30, rounds=5)
SUP_SMOKE = dict(dims=(24, 18, 12), nnz=800, warmup=6, rounds=3)


def measure_supervised(smoke: bool, device: str | torch.device | None = None,
                       backend: str | None = None) -> dict:
    """Supervised round latency + the cost of riding out a refresh fault."""
    from repro_torch.core import FastTuckerConfig, init_state
    from repro_torch.core.sptensor import SparseTensor
    from repro_torch.data.synthetic import planted_tensor
    from repro_torch.distributed import get_strategy
    from repro_torch.runtime.fault import FaultPlan
    from repro_torch.serve import (RefreshSupervisor, SupervisorConfig,
                                   TuckerServer)

    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    point = SUP_SMOKE if smoke else SUP_FULL
    dims, nnz = point["dims"], point["nnz"]
    t = planted_tensor(dims, nnz, rank=4, core_rank=4, noise=0.05, seed=0,
                       device=device)
    idx, val = t.indices.cpu().numpy(), t.values.cpu().numpy()
    n_stream = nnz // 4
    n_warm = nnz - n_stream
    strategy = get_strategy("local")
    cfg = FastTuckerConfig(dims=dims, ranks=(4,) * 3, core_rank=4,
                           batch_size=256, backend=backend)
    plan = strategy.prepare(
        SparseTensor.from_numpy(idx[:n_warm], val[:n_warm], dims,
                                device=device), cfg, None, seed=0)
    dstate = strategy.init(
        plan, init_state(torch.Generator(device=device).manual_seed(0), cfg,
                         device),
        torch.Generator(device=device).manual_seed(1))
    step = strategy.make_step(plan)
    for _ in range(point["warmup"]):
        dstate = step(dstate)
    params = strategy.eval_params(plan, dstate)
    per = n_stream // (point["rounds"] + 1)
    sup_cfg = SupervisorConfig(refresh_steps=2, window=per,
                               backoff_base_s=0.002, backoff_cap_s=0.02,
                               degraded_retry_s=0.01)

    def rounds_through(fault_plan):
        sup = RefreshSupervisor(
            TuckerServer(params, backend=backend), strategy, plan, dstate,
            config=sup_cfg, fault_plan=fault_plan,
            history=(idx[:n_warm], val[:n_warm]))
        times = []
        for rd in range(point["rounds"]):
            lo = n_warm + rd * per
            t0 = time.perf_counter()
            sup.run_round(idx[lo:lo + per], val[lo:lo + per])
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        return times, sup.health()

    clean_times, clean_h = rounds_through(None)
    # round 0 pays the first-use costs: the clean figure is the later rounds
    clean_ms = float(np.median(clean_times[1:]) if len(clean_times) > 1
                     else clean_times[0])
    # blow the whole retry budget once (3 hits vs max_attempts=3), so the
    # faulted round's latency includes a breaker trip + degraded cadence
    fault_times, fault_h = rounds_through(
        FaultPlan.parse("refresh@0:1:2", seed=0))
    faulted_ms = float(max(fault_times))
    sec = {
        "rounds": int(point["rounds"]),
        "window": int(per),
        "clean_round_ms": round(clean_ms, 4),
        "faulted_round_ms": round(faulted_ms, 4),
        "fault_overhead_ms": round(faulted_ms - clean_ms, 4),
        "publish_kinds": {"clean": clean_h["last_publish"]["kind"],
                          "faulted": fault_h["last_publish"]["kind"]},
        "faults_injected": int(fault_h["faults_injected"]),
        "retries": int(fault_h["retries"]),
        "breaker_trips": int(fault_h["breaker_trips"]),
        "recoveries": int(fault_h["recoveries"]),
    }
    row("refresh/supervised_round", clean_ms * 1e3,
        f"faulted={faulted_ms:.2f}ms,trips={sec['breaker_trips']},"
        f"recoveries={sec['recoveries']}")
    return sec


def run(smoke: bool = False, supervised: bool = False,
        table_dtype: str | None = None, out_path: str | None = None,
        device: str | torch.device | None = None,
        backend: str | None = None) -> dict:
    if out_path and os.path.basename(out_path) == REFERENCE_NAME:
        raise ValueError(f"{REFERENCE_NAME} is the reference's document; "
                         f"write the port's to {OUT_NAME}")
    doc = measure(smoke, table_dtype, device, backend)
    if supervised:
        doc["supervised"] = measure_supervised(smoke, device, backend)
    validate(doc)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"# wrote {out_path}", flush=True)
    return doc


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes (schema + contract check)")
    ap.add_argument("--table-dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--supervised", action="store_true",
                    help="add the optional supervised-round section "
                         "(round latency + injected-fault overhead)")
    ap.add_argument("--out", default="",
                    help=f"write the validated document here (the port's "
                         f"name is {OUT_NAME})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    args = ap.parse_args(argv)
    return run(smoke=args.smoke, supervised=args.supervised,
               table_dtype=args.table_dtype, out_path=args.out or None,
               device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
