#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FastTucker on one CUDA card and check it.

    python3 chip_smoke.py [--steps 600] [--nnz 99072112] [--report PATH]

Phases (each failure ends the run with a non-zero exit code):

1. Environment: the card's name and power limit (``nvidia-smi``), torch and
   nvcc versions, and the parallel ``nvcc`` build of the three kernels
   from ``src/repro_torch/kernels/csrc`` (with ptxas' register report).
2. Each kernel against its plain PyTorch version on the card, over
   N ∈ {3, 4}, J = R ∈ {4, 16, 32}, B ∈ {4096, 4099, 262144}, with masked
   rows, ``pred_coef = 0`` and scatter ids outside ``[0, rows)``.
3. The slice at the paper's size: a planted tensor of the Netflix tensor's
   published shape (480,189 × 17,770 × 2,182, 99,072,112 nonzeros),
   J_n = R = 4, 10 % held out, ``--steps`` SGD steps at batch 4096 through
   ``repro_torch.launch.std_train`` on the ``"cuda"`` backend, held-out
   RMSE/MAE before and after.  The launch counts are set to 0 just before
   and read just after: each kernel must have run.
4. Parity on the card: 20 fed-batch steps on ``"cuda"`` against
   ``"torch"`` from the same parameters.
5. Times at the path's shapes (B = 4096 for the gradient and the scatter,
   B = 262,144 for the contraction): median device time per call (CUDA
   events, calls queued behind a sleep so the host's launch latency is not
   in them), the plain version's, ``index_add_`` for the scatter, and the
   bound (larger of bytes at 3.35 TB/s and f32 flops at 67 TFLOP/s, the
   H100 SXM's published peaks).
6. A ``torch.profiler`` trace of steady training steps: device time per
   kernel and the device's busy share.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  ``--report PATH`` also writes the full
record there as JSON.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
NETFLIX_DIMS = (480_189, 17_770, 2_182)
NETFLIX_NNZ = 99_072_112
TRAIN_BATCH = 4096
EVAL_CHUNK = 262_144
TOL = {  # max |kernel − plain| / max |plain|, f32, sums in another order
    "kruskal_contract": 2e-5,
    "kruskal_grad.rows": 2e-5,
    "kruskal_grad.core": 1e-4,   # sums over up to 262,144 samples
    "scatter_accum": 2e-5,       # atomics: run-to-run order of duplicates
    "trajectory": 1e-4,          # 20 steps, each op within the above
}
REPLACES = {
    "kruskal_contract": "src/repro/kernels/kruskal_contract.py:30",
    "kruskal_grad": "src/repro/kernels/kruskal_grad.py:83",
    "scatter_accum": "src/repro/kernels/scatter_accum.py:26",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> tuple[float, float]:
    """(max |got − want|, that over max |want|)."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return err, err / scale if scale > 0 else err


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_environment(torch, build) -> dict:
    smi = nvidia_smi_line()
    log(smi)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    import numpy

    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc}; "
        f"numpy {numpy.__version__}")
    log(f"card: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    secs = build.build()
    wall = time.perf_counter() - t0
    log(f"kernel build (one nvcc per source, in parallel): {wall:.1f}s wall; "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    ptxas = {}
    for name in build.SOURCES:
        logf = build.library_path(name).with_suffix(".log")
        lines = [ln.strip() for ln in logf.read_text().splitlines()
                 if "registers" in ln or "spill" in ln] if logf.exists() \
            else []
        ptxas[name] = lines
        for ln in lines:
            log(f"  ptxas {name}: {ln}")
    return {"nvidia_smi": smi, "nvcc": nvcc, "torch": torch.__version__,
            "build_seconds": secs, "build_wall_seconds": wall,
            "ptxas": ptxas}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase_kernels_vs_plain(torch, K) -> dict:
    ref = K.ref
    kc = K.kruskal_contract.kruskal_contract
    kg = K.kruskal_grad.kruskal_grad
    sa = K.scatter_accum.scatter_accum
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = {k: [0.0, 0.0] for k in TOL if k != "trajectory"}

    def record(key, got, want, what):
        e, r = rel_err(got, want)
        worst[key][0] = max(worst[key][0], e)
        worst[key][1] = max(worst[key][1], r)
        if not r <= TOL[key]:
            raise AssertionError(f"{key} {what}: max abs err {e:.3g}, "
                                 f"relative {r:.3g} > {TOL[key]}")

    cases = 0
    for N in (3, 4):
        for JR in (4, 16, 32):
            for B in (4096, 4099, 262_144):
                what = f"N={N} J=R={JR} B={B}"
                a = 0.5 * torch.randn((N, B, JR), generator=gen, device=dev)
                b = 0.5 * torch.randn((N, JR, JR), generator=gen, device=dev)
                pred, pexc = kc(a, b)
                pred_r, pexc_r = ref.kruskal_contract_ref(a, b)
                record("kruskal_contract", pred, pred_r, what + " pred")
                record("kruskal_contract", pexc, pexc_r, what + " pexc")

                val = torch.randn((B,), generator=gen, device=dev)
                mask = (torch.rand((B,), generator=gen, device=dev)
                        > 0.1).float()                  # masked rows
                for pred_coef in (1.0, 0.0):            # 0: autograd pass
                    scal = torch.tensor(
                        [1.0, 1.0 / max(mask.sum().item(), 1.0), 0.01, 0.02,
                         pred_coef], dtype=torch.float32, device=dev)
                    got = kg(a, b, val, mask, scal)
                    want = ref.kruskal_grad_ref(a, b, val, mask, scal)
                    tag = f"{what} pred_coef={pred_coef}"
                    record("kruskal_grad.rows", got.pred, want[0],
                           tag + " pred")
                    record("kruskal_grad.rows", got.err, want[1],
                           tag + " err")
                    record("kruskal_grad.rows", got.row_grads, want[2],
                           tag + " row grads")
                    record("kruskal_grad.core", got.core_grads, want[3],
                           tag + " core grads")

                rows = max(64, B // 8)
                g = torch.randn((B, JR), generator=gen, device=dev)
                idx = torch.randint(-5, rows + 5, (B,), generator=gen,
                                    device=dev, dtype=torch.int32)
                record("scatter_accum", sa(g, idx, rows),
                       ref.scatter_accum_ref(g, idx, rows),
                       f"{what} rows={rows} (ids outside [0, rows))")
                cases += 1
    # the training path's widest scatter: mode 0 of the Netflix shape
    g = torch.randn((TRAIN_BATCH, 4), generator=gen, device=dev)
    idx = torch.randint(0, NETFLIX_DIMS[0], (TRAIN_BATCH,), generator=gen,
                        device=dev, dtype=torch.int32)
    record("scatter_accum", sa(g, idx, NETFLIX_DIMS[0]),
           ref.scatter_accum_ref(g, idx, NETFLIX_DIMS[0]), "Netflix mode 0")
    torch.cuda.synchronize()
    for key, (e, r) in worst.items():
        log(f"{key}: max abs err {e:.3g}, max relative err {r:.3g} "
            f"(tolerance {TOL[key]}) over {cases} shapes")
    return {k: {"max_abs_err": e, "max_rel_err": r, "tol": TOL[k]}
            for k, (e, r) in worst.items()}


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_slice(torch, K, std_train, steps: int, nnz: int) -> dict:
    if nnz != NETFLIX_NNZ:
        log(f"CUT: {nnz:,} nonzeros instead of the Netflix tensor's "
            f"{NETFLIX_NNZ:,}")
    args = std_train.parse_args([
        "--dims", ",".join(map(str, NETFLIX_DIMS)), "--nnz", str(nnz),
        "--rank", "4", "--core-rank", "4", "--steps", str(steps),
        "--batch", str(TRAIN_BATCH), "--eval-every", str(max(steps // 2, 1)),
        "--seed", "0", "--backend", "cuda", "--device", "cuda"])
    K.reset_launch_counts()
    res = std_train.run(args)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    hist = res["history"]
    log(f"slice: data {res['data_seconds']:.1f}s, {steps} steps at "
        f"{res['steps_per_s']:.1f} steps/s = {res['nnz_per_s']:.4g} nnz/s, "
        f"peak device bytes {res['peak_device_bytes']:,}")
    log("slice: rmse " + " -> ".join(f"{h['rmse']:.5f}@{h['step']}"
                                     for h in hist))
    log(f"slice: launch counts {counts}")
    if not all(math.isfinite(h["rmse"]) and math.isfinite(h["mae"])
               for h in hist):
        raise AssertionError(f"non-finite RMSE/MAE: {hist}")
    if not hist[-1]["rmse"] < hist[0]["rmse"]:
        raise AssertionError(f"RMSE did not drop: {hist}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return {"result": res, "counts": counts}


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def phase_parity(torch, ft, res) -> dict:
    from repro_torch.core.sampling import sample_batch_arrays

    train_t = res["train"]
    start = res["state"]
    gen = torch.Generator(device="cuda").manual_seed(99)
    batches = [sample_batch_arrays(gen, train_t.indices, train_t.values,
                                   TRAIN_BATCH) for _ in range(20)]
    finals = {}
    for backend in ("cuda", "torch"):
        cfg = ft.FastTuckerConfig(
            dims=res["cfg"].dims, ranks=res["cfg"].ranks,
            core_rank=res["cfg"].core_rank, batch_size=TRAIN_BATCH,
            backend=backend)
        st = start
        for idx, val in batches:
            st = ft.sgd_step_batch(st, idx, val, cfg)
        finals[backend] = st.params
    torch.cuda.synchronize()
    worst = 0.0
    worst_abs = 0.0
    for got, want in zip(finals["cuda"].factors + finals["cuda"].core_factors,
                         finals["torch"].factors
                         + finals["torch"].core_factors):
        e, r = rel_err(got, want)
        worst, worst_abs = max(worst, r), max(worst_abs, e)
    log(f"parity: 20 fed-batch steps cuda vs torch: max abs diff "
        f"{worst_abs:.3g}, max relative diff {worst:.3g} "
        f"(tolerance {TOL['trajectory']})")
    if not worst <= TOL["trajectory"]:
        raise AssertionError(f"trajectory differs: {worst:.3g}")
    return {"max_rel_diff": worst, "max_abs_diff": worst_abs}


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def device_ms(torch, fn, iters: int = 100) -> float:
    """Median device time of one ``fn()`` call, in ms.

    All calls and their event pairs are queued behind a device-side sleep,
    so the card runs them back to back and an event pair spans only the
    call's own kernels, not the host's launch latency.
    """
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device cycles
    for s, e in evs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(torch, K, ft, res, counts) -> list[dict]:
    from repro_torch.core.sampling import sample_batch_arrays
    from repro_torch.kernels.dispatch import (_kernel_scalars,
                                              _stack_padded_factors,
                                              _stack_padded_rows)

    ref = K.ref
    params = res["state"].params
    train_t, test_t = res["train"], res["test"]
    cfg = res["cfg"]
    N, J, R = cfg.order, cfg.ranks[0], cfg.core_rank
    gen = torch.Generator(device="cuda").manual_seed(7)
    idx, val = sample_batch_arrays(gen, train_t.indices, train_t.values,
                                   TRAIN_BATCH)
    a = _stack_padded_rows(ft.gather_rows(params.factors, idx))
    b = _stack_padded_factors(params.core_factors)
    mask = torch.ones_like(val)
    scal = _kernel_scalars(TRAIN_BATCH, None, False, True, cfg.lambda_a,
                           cfg.lambda_b, 1.0, val.device)
    eidx = test_t.indices[:EVAL_CHUNK]
    ea = _stack_padded_rows(ft.gather_rows(params.factors, eidx))
    Be = ea.shape[1]
    rg = K.kruskal_grad.kruskal_grad(a, b, val, mask, scal).row_grads
    g0 = rg[0].contiguous()
    cols = idx.t().contiguous()
    rows0 = cfg.dims[0]
    torch.cuda.synchronize()
    out = []

    # kruskal_grad
    B = TRAIN_BATCH
    ms = device_ms(torch, lambda: K.kruskal_grad.kruskal_grad(
        a, b, val, mask, scal))
    plain = device_ms(torch, lambda: ref.kruskal_grad_ref(
        a, b, val, mask, scal))
    t_b, by = bound(4 * (2 * N * B * J + 2 * N * J * R + 4 * B + 5),
                    6 * N * B * J * R + 3 * N * B * R + 2 * B * R
                    + 4 * N * B * J + 6 * B)
    out.append(("kruskal_grad", ms, plain, None, t_b, by,
                "1 per training step; 1 per autograd backward"))

    # scatter_accum, mode 0 (the widest: I_0 = 480,189 rows)
    ms = device_ms(torch, lambda: K.scatter_accum.scatter_accum(
        g0, cols[0], rows0))
    plain = device_ms(torch, lambda: ref.scatter_accum_ref(g0, cols[0],
                                                           rows0))
    long_ids = cols[0].long()
    lib = device_ms(torch, lambda: torch.zeros(
        (rows0, J), device="cuda").index_add_(0, long_ids, g0))
    t_b, by = bound(4 * (B * J + B + rows0 * J), B * J)
    out.append(("scatter_accum", ms, plain, lib, t_b, by,
                f"{N} per training step (one per mode; timed at mode 0, "
                f"{rows0:,} rows)"))
    for n in range(1, N):
        gn = rg[n].contiguous()
        ms_n = device_ms(torch, lambda: K.scatter_accum.scatter_accum(
            gn, cols[n], cfg.dims[n]))
        log(f"scatter_accum mode {n} ({cfg.dims[n]:,} rows): "
            f"{ms_n * 1e3:.2f} us")

    # kruskal_contract at the evaluation chunk
    ms = device_ms(torch, lambda: K.kruskal_contract.kruskal_contract(ea, b))
    plain = device_ms(torch, lambda: ref.kruskal_contract_ref(ea, b))
    t_b, by = bound(4 * (N * Be * J + N * J * R + Be + N * Be * R),
                    2 * N * Be * J * R + 3 * N * Be * R + 2 * Be * R)
    out.append(("kruskal_contract", ms, plain, None, t_b, by,
                f"{math.ceil(test_t.nnz / EVAL_CHUNK)} per evaluation "
                "(one per 262,144-row chunk)"))

    rows_out = []
    for name, ms, plain, lib, t_b, by, per in out:
        log(f"{name}: {ms * 1e3:.2f} us/call (plain {plain * 1e3:.2f} us"
            + (f", index_add_ {lib * 1e3:.2f} us" if lib is not None else "")
            + f"), bound {t_b * 1e3:.3f} us by {by}; main-path launches "
            f"{counts[name]}; {per}")
        rows_out.append({"name": name, "ms": ms, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": t_b, "bound_by": by,
                         "launches_note": per})
    return rows_out


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

def phase_profile(torch, ft, res, steps: int = 50) -> dict:
    from torch.profiler import ProfilerActivity, profile

    cfg = res["cfg"]
    train_t = res["train"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    st = res["state"]
    for _ in range(10):
        st = ft.sgd_step(st, gen, train_t.indices, train_t.values, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            st = ft.sgd_step(st, gen, train_t.indices, train_t.values, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.events():
        if "CUDA" in str(ev.device_type):   # a kernel or copy on the card
            kernels.setdefault(ev.name, [0, 0.0])
            kernels[ev.name][0] += 1
            kernels[ev.name][1] += ev.time_range.elapsed_us()
    busy_us = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    if not kernels:
        log("profile: the profiler recorded no device time (not measured)")
        return {"measured": False, "wall_ms_per_step": wall / steps * 1e3}
    log(f"profile: {steps} steps, {wall / steps * 1e3:.3f} ms/step under "
        f"the profiler; device busy {busy_us / steps:.1f} us/step = "
        f"{busy_us / (wall * 1e6):.1%} of wall")
    for name, (cnt, us) in top:
        log(f"  {us / steps:8.2f} us/step  {cnt / steps:5.1f}/step  "
            f"{name[:90]}")
    return {"measured": True, "steps": steps,
            "wall_ms_per_step": wall / steps * 1e3,
            "device_busy_us_per_step": busy_us / steps,
            "top_kernels": [{"name": n, "calls_per_step": c / steps,
                             "us_per_step": us / steps}
                            for n, (c, us) in top]}


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on the card.")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--nnz", type=int, default=NETFLIX_NNZ,
                    help="nonzeros of the Netflix-shaped tensor (a cut is "
                         "printed)")
    ap.add_argument("--report", default="",
                    help="also write the full record as JSON to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels as K
    from repro_torch.core import fasttucker as ft
    from repro_torch.kernels import build
    from repro_torch.launch import std_train

    t_start = time.perf_counter()
    report = {"environment": phase_environment(torch, build)}
    report["kernels_vs_plain"] = phase_kernels_vs_plain(torch, K)
    slice_ = phase_slice(torch, K, std_train, args.steps, args.nnz)
    res, counts = slice_["result"], slice_["counts"]
    report["slice"] = {k: v for k, v in res.items()
                       if k in ("history", "steps_per_s", "nnz_per_s",
                                "peak_device_bytes", "data_seconds",
                                "train_seconds")}
    report["slice"]["nnz"] = args.nnz
    report["slice"]["launch_counts"] = counts
    report["parity"] = phase_parity(torch, ft, res)
    times = phase_times(torch, K, ft, res, counts)
    report["times"] = times
    report["profile"] = phase_profile(torch, ft, res)
    report["seconds"] = time.perf_counter() - t_start

    errs = report["kernels_vs_plain"]
    max_err = {
        "kruskal_contract": errs["kruskal_contract"]["max_abs_err"],
        "kruskal_grad": max(errs["kruskal_grad.rows"]["max_abs_err"],
                            errs["kruskal_grad.core"]["max_abs_err"]),
        "scatter_accum": errs["scatter_accum"]["max_abs_err"],
    }
    kernels = []
    for t in sorted(times, key=lambda t: t["name"]):
        name = t["name"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    report["kernels"] = kernels
    if args.report:
        path = Path(args.report)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1, default=str))
    log(f"total {report['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
