"""Ingestion-bound sweep: the out-of-core store + stratum prefetch pipeline.

Counterpart of ``benchmarks/bench_ingest.py``, in process on
``make_host_mesh(num_workers=DEVICES)`` (the reference forces that many
host devices in a subprocess; here the workers share the device).  It
measures what ``NonzeroStore`` + ``StratumPrefetcher`` buy the strata
strategy, per nonzero scale:

    ``us_per_step_resident``  resident device buckets (skipped, recorded
                              as null, above the residency budget — the
                              memory-bounded regime the store exists for)
    ``us_per_step_sync``      store-fed, prefetch depth 0: the stratum is
                              read and placed on the hot path every step
    ``us_per_step_stream``    store-fed, prefetch depth ≥ 1: the stratum
                              is placed from a background thread ahead of
                              use
    ``us_per_stratum_load``   one stratum read from the store and placed
                              on every worker through the strategy's
                              ``MeshPlacer``, closed by a synchronize
    ``transfer_hidden_fraction``  (sync − stream) / load, clipped to
                              [0, 1]

plus the full-epoch streaming stats (the second, warm epoch: every stored
nonzero moved to the device once).  Each step time is the median of one
epoch of individually timed steps after one untimed epoch.  Where the
resident path runs, the store-fed runs' final states (every worker's
shards, core replicas and generator states) must equal its state bitwise.
The budget is the reference's simulated premise, not the device's memory.
``--attach`` merges the sweep into a BENCH_torch_step document as its v3
``ingest`` section (``bench_sota_time.attach_ingest``).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_ingest \\
        [--smoke] [--devices 4] [--attach BENCH_torch_step.json] \\
        [--spill-root DIR] [--device cpu] [--backend torch]
"""
from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch

from .common import row

DEVICES = 4

# full sweep: parity point (resident fits comfortably) + the 10^7-nnz
# scale the resident path is budget-excluded from
FULL_POINTS = (
    dict(dims=(6000, 4000, 2000), nnz=1_000_000, rank=8, batch=4096),
    dict(dims=(20000, 15000, 10000), nnz=10_000_000, rank=8, batch=4096),
)
SMOKE_POINTS = (
    dict(dims=(40, 30, 20), nnz=4_000, rank=3, batch=256),
)

# simulated per-run device residency budget for the RESIDENT buckets (the
# paper's premise: Ω does not fit next to the factors). ~17 B/nnz puts
# 10^7 nnz well past this; the store streams one ~budget/S stratum at a
# time instead.
RESIDENT_BUDGET_BYTES = 128 * 2**20


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_steps(step_fn, dstate, iters: int, device: torch.device):
    """Median µs a step over ``iters`` individually timed steps."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        dstate = step_fn(dstate)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6, dstate


def _leaves(dstate) -> list[torch.Tensor]:
    out = [dstate.rng]
    for w in dstate.params:
        out += list(w.factors) + list(w.core_factors)
    return out


def same_state(a, b) -> bool:
    """Bitwise: every worker's shards, core replicas and generator
    states, and the step."""
    return a.step == b.step and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(_leaves(a), _leaves(b)))


def _load_us(plan, store, device: torch.device) -> float:
    """Median µs of one stratum read and placed on every worker through
    the strategy's ``MeshPlacer`` (over the first 8 strata)."""
    from repro_torch.distributed.strata import MeshPlacer

    placer = MeshPlacer(plan.mesh, 1)
    loads = []
    try:
        for s in range(min(store.num_strata, 8)):
            t0 = time.perf_counter()
            placer(store.stratum(s)).ready()
            _sync(device)
            loads.append(time.perf_counter() - t0)
    finally:
        placer.release()
    return statistics.median(loads) * 1e6


def _measure_point(point: dict, spill_root: str, depth: int, devices: int,
                   device: torch.device, backend: str) -> dict:
    from repro_torch.core import fasttucker as ft
    from repro_torch.data.pipeline import NonzeroStore
    from repro_torch.data.synthetic import planted_tensor
    from repro_torch.distributed import get_strategy
    from repro_torch.launch.mesh import make_host_mesh

    dims, nnz, J, batch = (tuple(point["dims"]), point["nnz"], point["rank"],
                           point["batch"])
    mesh = make_host_mesh(num_workers=devices, device=device)
    M = mesh.size
    st = get_strategy("strata")
    cfg = ft.FastTuckerConfig(dims=dims, ranks=(J,) * len(dims),
                              core_rank=J, batch_size=batch, backend=backend)
    tensor = planted_tensor(dims, nnz, rank=J, core_rank=J, seed=0,
                            device=device)

    t0 = time.perf_counter()
    store = NonzeroStore.build(
        tensor, M, spill_dir=os.path.join(spill_root, f"nnz{nnz}"))
    build_s = time.perf_counter() - t0
    S = store.num_strata

    gen = torch.Generator(device=device).manual_seed(0)
    state0 = ft.init_state(gen, cfg, device)
    loop_state = gen.get_state()

    def fresh_gen() -> torch.Generator:
        g = torch.Generator(device=device)
        g.set_state(loop_state)
        return g

    out = {
        "nnz": int(nnz), "dims": list(dims), "rank": J, "batch": batch,
        "devices": M, "store": "spill", "prefetch_depth": depth,
        "num_strata": S, "store_build_s": round(build_s, 3),
        "store_mb": round(store.nbytes / 2**20, 2),
        "stratum_mb": round(store.stratum_nbytes / 2**20, 3),
    }
    out["us_per_stratum_load"] = _load_us(
        st.prepare(tensor, cfg, mesh, seed=0, store=store), store, device)

    def run_config(store_arg, d):
        plan = st.prepare(tensor, cfg, mesh, seed=0, store=store_arg,
                          prefetch_depth=d)
        dstate = st.init(plan, state0, fresh_gen())
        step_fn = st.make_step(plan)
        try:
            for _ in range(S):          # one untimed epoch
                dstate = step_fn(dstate)
            _sync(device)
            return _time_steps(step_fn, dstate, S, device)
        finally:
            if step_fn.prefetcher is not None:
                step_fn.prefetcher.close()

    resident = None
    if store.nbytes <= RESIDENT_BUDGET_BYTES:   # resident = every chunk
        out["us_per_step_resident"], resident = run_config(None, 0)
    else:
        out["us_per_step_resident"] = None
        out["resident_skipped"] = (
            f"buckets need {store.nbytes / 2**20:.0f} MiB device "
            f"residency > {RESIDENT_BUDGET_BYTES / 2**20:.0f} MiB budget")

    out["us_per_step_sync"], synced = run_config(store, 0)
    out["us_per_step_stream"], streamed = run_config(store, depth)
    if resident is not None:
        out["stream_bitwise_resident"] = (same_state(synced, resident)
                                          and same_state(streamed, resident))
        if not out["stream_bitwise_resident"]:
            raise AssertionError(
                f"ingest nnz {nnz}: the store-fed strata state differs "
                "from the resident one")

    hidden = ((out["us_per_step_sync"] - out["us_per_step_stream"])
              / max(out["us_per_stratum_load"], 1e-9))
    out["transfer_hidden_fraction"] = round(min(max(hidden, 0.0), 1.0), 4)
    if out["us_per_step_resident"]:
        out["stream_vs_resident"] = round(
            out["us_per_step_stream"] / out["us_per_step_resident"], 4)

    # the full streaming epoch at this scale: every stored nonzero placed
    # on the device once (steady state: the second epoch)
    plan = st.prepare(tensor, cfg, mesh, seed=0, store=store,
                      prefetch_depth=depth)
    dstate = st.init(plan, state0, fresh_gen())
    step_fn = st.make_step(plan)
    try:
        for _ in range(S):
            dstate = step_fn(dstate)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(S):
            dstate = step_fn(dstate)
        _sync(device)
        epoch_s = time.perf_counter() - t0
    finally:
        step_fn.prefetcher.close()
    out["epoch_steps"] = S
    out["epoch_s"] = round(epoch_s, 4)
    out["ingest_nnz_per_s"] = round(store.nnz / epoch_s, 1)
    return out


def measure(smoke: bool, depth: int = 2, devices: int = DEVICES,
            device: str | torch.device | None = None,
            spill_root: str | None = None,
            backend: str | None = None) -> dict:
    """The sweep's ``ingest`` section.  The stores spill under
    ``spill_root`` (default: a temporary directory, removed after)."""
    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    points = SMOKE_POINTS if smoke else FULL_POINTS
    if spill_root is None:
        with tempfile.TemporaryDirectory(prefix="bench_ingest_") as spill:
            rows = [_measure_point(p, spill, depth, devices, device, backend)
                    for p in points]
    else:
        os.makedirs(spill_root, exist_ok=True)
        rows = [_measure_point(p, spill_root, depth, devices, device,
                               backend) for p in points]
    return {
        "generated_by": "src/repro_torch/benchmarks/bench_ingest.py",
        "smoke": smoke,
        "platform": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else device.type),
        "resident_budget_mb": RESIDENT_BUDGET_BYTES // 2**20,
        "rows": rows,
    }


def run(smoke: bool = False, devices: int = DEVICES, depth: int = 2,
        attach: str | None = None, device: str | torch.device | None = None,
        spill_root: str | None = None, backend: str | None = None) -> dict:
    ingest = measure(smoke, depth, devices, device, spill_root, backend)
    for r in ingest["rows"]:
        tag = f"ingest/nnz{r['nnz']}"
        if r.get("us_per_step_resident"):
            row(f"{tag}/resident", r["us_per_step_resident"], "1.00x")
        else:
            print(f"{tag}/resident,skipped,"
                  f"{r.get('resident_skipped', '')}", flush=True)
        row(f"{tag}/sync_depth0", r["us_per_step_sync"])
        row(f"{tag}/stream_depth{r['prefetch_depth']}",
            r["us_per_step_stream"],
            f"hidden={r['transfer_hidden_fraction']:.2f}")
        row(f"{tag}/stratum_load", r["us_per_stratum_load"],
            f"epoch={r['epoch_s']}s,{r['ingest_nnz_per_s']:.3g}nnz/s")
    if attach:
        from .bench_sota_time import attach_ingest

        attach_ingest(ingest, attach)
    return ingest


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (schema check)")
    ap.add_argument("--devices", type=int, default=DEVICES,
                    help="workers of the in-process mesh")
    ap.add_argument("--prefetch-depth", type=int, default=2)
    ap.add_argument("--attach", default="",
                    help="merge results into this BENCH_torch_step.json "
                         "(upgrades it to schema v3)")
    ap.add_argument("--spill-root", default=None,
                    help="directory for the spilled stores (default: a "
                         "temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    args = ap.parse_args(argv)
    return run(smoke=args.smoke, devices=args.devices,
               depth=args.prefetch_depth, attach=args.attach or None,
               device=args.device, spill_root=args.spill_root,
               backend=args.backend)


if __name__ == "__main__":
    main()
