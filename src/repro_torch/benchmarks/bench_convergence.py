"""Convergence speed on the port: steps and wall-clock to an RMSE target,
the sketched warm start (``core.sketch``) against the cold init.

Counterpart of ``benchmarks/bench_convergence.py``, in process: the same
schema (``bench_convergence/v1``, checked by the port's own
``benchmarks.common.validate_bench_convergence``) and the reference's
``FULL`` and ``SMOKE`` configurations, ``planted_local`` on one device and
``planted_strata`` on ``make_host_mesh(num_workers=DEVICES)`` (the
reference's ``DEVICES = 2`` forced host devices; here two workers sharing
the device); each config's ``backend`` is the run's.

Both arms share one config, one strategy plan and one step function; the
warm arm's parameters come from ``sketched_init_params`` (what
``FastTuckerConfig(init="sketched")`` calls), drawn from a generator
seeded with the config's seed.  Both arms draw the same batches: the batch
generator draws the cold init, and each arm starts from the state it is
left in, as ``std_train`` does.  A throwaway lap first (``eval_every``
steps, and one sketch from another seed) so that neither arm pays for
first calls.  Wall-clock is the training time between evaluations (each
interval closed by a device synchronize, evaluations excluded), plus the
whole sketch for the warm arm.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_convergence \\
        [--smoke] [--out BENCH_torch_convergence.json] [--device cpu] \\
        [--backend torch]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from .common import BENCH_CONVERGENCE_SCHEMA, validate_bench_convergence

DEVICES = 2   # workers of the strata configs' mesh

FULL = [
    dict(name="planted_local", strategy="local",
         dims=(400, 300, 200), nnz=150_000, rank=8, core_rank=8,
         batch=2048, sketch_batch=16_384, seed=0,
         target_rmse=0.12, horizon_steps=800, eval_every=50),
    dict(name="planted_strata", strategy="strata",
         dims=(400, 300, 200), nnz=150_000, rank=8, core_rank=8,
         batch=2048, sketch_batch=16_384, seed=0,
         target_rmse=0.12, horizon_steps=800, eval_every=50),
]
SMOKE = [
    dict(name="planted_local", strategy="local",
         dims=(60, 50, 40), nnz=8_000, rank=4, core_rank=4,
         batch=1024, sketch_batch=4_096, seed=0,
         target_rmse=0.30, horizon_steps=160, eval_every=20),
    dict(name="planted_strata", strategy="strata",
         dims=(60, 50, 40), nnz=8_000, rank=4, core_rank=4,
         batch=1024, sketch_batch=4_096, seed=0,
         target_rmse=0.30, horizon_steps=160, eval_every=20),
]
OUT_NAME = "BENCH_torch_convergence.json"
REFERENCE_NAME = "BENCH_convergence.json"   # the reference's; never written
WARMUP_SEED_OFFSET = 99   # the throwaway sketch's seed, past the config's


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_arm(strategy, plan, state0, loop_state, test_t, c, predict_fn,
             device) -> dict:
    """Train one arm to the horizon; trajectory and time to the target."""
    from repro_torch.core.metrics import rmse_mae

    gen = torch.Generator(device=device)
    gen.set_state(loop_state)
    step_fn = strategy.make_step(plan)
    dstate = strategy.init(plan, state0, gen)
    start = dstate.step

    def ev() -> float:
        r, _ = rmse_mae(strategy.eval_params(plan, dstate), test_t,
                        predict_fn)
        return float(r)

    traj = [[0, ev()]]                      # step-0 eval: where init lands
    train_s = 0.0
    wall_at = {0: 0.0}
    while dstate.step - start < c["horizon_steps"]:
        t0 = time.perf_counter()
        for _ in range(c["eval_every"]):
            dstate = step_fn(dstate)
        _sync(device)
        train_s += time.perf_counter() - t0
        done = dstate.step - start
        traj.append([done, ev()])
        wall_at[done] = train_s
    reached = [s for s, r in traj if r <= c["target_rmse"]]
    hit = min(reached) if reached else c["horizon_steps"]
    return {
        "reached": bool(reached),
        "steps_to_target": int(hit),
        "train_s_to_target": wall_at[hit],
        "final_rmse": traj[-1][1],
        "trajectory": traj,
    }


def _measure_config(c: dict, device: torch.device, backend: str) -> dict:
    from repro_torch.core import fasttucker as ft
    from repro_torch.core.sketch import sketched_init_params
    from repro_torch.data.synthetic import planted_tensor
    from repro_torch.distributed import get_strategy
    from repro_torch.launch.mesh import make_host_mesh

    dims = tuple(c["dims"])
    tensor = planted_tensor(dims, c["nnz"], rank=c["rank"],
                            core_rank=c["core_rank"], noise=0.05,
                            seed=c["seed"], device=device)
    train_t, test_t = tensor.split(0.1)
    cfg = ft.FastTuckerConfig(
        dims=dims, ranks=(c["rank"],) * len(dims), core_rank=c["core_rank"],
        batch_size=c["batch"], backend=backend,
        sketch_batch=c["sketch_batch"])
    strategy = get_strategy(c["strategy"])
    mesh = (make_host_mesh(num_workers=DEVICES, device=device)
            if strategy.needs_mesh else None)
    plan = strategy.prepare(train_t, cfg, mesh, seed=c["seed"])
    predict_fn = lambda p, i: ft.predict(p, i, backend)  # noqa: E731

    gen = torch.Generator(device=device).manual_seed(c["seed"])
    cold0 = ft.init_state(gen, cfg, device)
    loop_state = gen.get_state()

    def sketch(seed):
        return sketched_init_params(
            torch.Generator(device=device).manual_seed(seed), cfg,
            train_t.indices, train_t.values)

    # the throwaway lap: first calls of the step, the evaluation, the sketch
    _run_arm(strategy, plan, cold0, loop_state, test_t,
             {**c, "horizon_steps": c["eval_every"]}, predict_fn, device)
    sketch(c["seed"] + WARMUP_SEED_OFFSET)
    _sync(device)

    cold = _run_arm(strategy, plan, cold0, loop_state, test_t, c,
                    predict_fn, device)
    cold["init_s"] = 0.0
    t0 = time.perf_counter()
    warm_params = sketch(c["seed"])
    _sync(device)
    init_s = time.perf_counter() - t0
    warm = _run_arm(strategy, plan, ft.TrainState(warm_params, 0),
                    loop_state, test_t, c, predict_fn, device)
    warm["init_s"] = init_s

    for arm in (cold, warm):
        arm["wallclock_s_to_target"] = (
            arm.pop("train_s_to_target") + arm["init_s"])
    out = dict(c, backend=backend, dims=list(dims))
    out["cold"], out["sketched"] = cold, warm
    out["speedup_vs_cold"] = (cold["steps_to_target"]
                              / max(warm["steps_to_target"], 1))
    out["wallclock_speedup_vs_cold"] = (
        cold["wallclock_s_to_target"]
        / max(warm["wallclock_s_to_target"], 1e-9))
    return out


def run(smoke: bool = False, out_path: str | None = None,
        device: str | torch.device | None = None,
        backend: str | None = None) -> dict:
    if out_path and os.path.basename(out_path) == REFERENCE_NAME:
        raise ValueError(f"{REFERENCE_NAME} is the reference's document; "
                         f"write the port's to {OUT_NAME}")
    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    doc = {
        "schema": BENCH_CONVERGENCE_SCHEMA,
        "generated_by": "src/repro_torch/benchmarks/bench_convergence.py",
        "smoke": smoke,
        "platform": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else device.type),
        "devices": DEVICES,
        "configs": [_measure_config(c, device, backend)
                    for c in (SMOKE if smoke else FULL)],
    }
    validate_bench_convergence(doc)

    for c in doc["configs"]:
        cold, warm = c["cold"], c["sketched"]
        print(f"conv/{c['name']}_cold_steps,{cold['steps_to_target']},"
              f"reached={cold['reached']};final={cold['final_rmse']:.4f}",
              flush=True)
        print(f"conv/{c['name']}_warm_steps,{warm['steps_to_target']},"
              f"reached={warm['reached']};final={warm['final_rmse']:.4f};"
              f"init={warm['init_s']:.3f}s", flush=True)
        print(f"conv/{c['name']}_speedup_steps,{c['speedup_vs_cold']},"
              f"target_rmse={c['target_rmse']}", flush=True)
        print(f"conv/{c['name']}_speedup_wall,"
              f"{c['wallclock_speedup_vs_cold']:.3f},"
              f"cold={cold['wallclock_s_to_target']:.3f}s;"
              f"warm={warm['wallclock_s_to_target']:.3f}s", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"# wrote {out_path}", flush=True)
    return doc


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes / short horizons (schema check)")
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
