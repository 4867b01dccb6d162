"""Fig. 7b/c on the port: multi-device STD scaling, through the registry.

Counterpart of ``benchmarks/bench_multidev.py``, at its shapes: a planted
1024 × 768 × 512 tensor of 100,000 nonzeros (seed 0), J = R = 8, a fixed
global batch of 8192 split over M ∈ {2, 4} workers (``batch_size = 8192 //
M``), every strategy in ``distributed.available_strategies()``; the mesh
strategies on ``make_host_mesh(num_workers=M)``, ``local`` alone on its
device (``needs_mesh``).  The reference reads its figures out of one
compiled step's HLO; the port has no compiled program, so it counts them
as they happen.  Each strategy runs one untimed epoch of M^(N−1) steps and
then one timed epoch, whose counts are divided by its steps:

  * ``flops/dev``: one worker's FLOPs a step from the shapes
    (``core.cost.step_flops``; exact, not sampled), and
    ``work_scaling_eff``, M₀·flops(M₀) / (M·flops(M)) against the first M:
    the work really divides;
  * ``psum/step`` and ``permute/step``: the step function's
    ``collectives.Traffic``, per worker by the reference's rules (a ring
    all-reduce, 2·b·(M − 1)/M; a rotation, the shard it moves), and
    ``coll/step``, their sum: sync sums dense factor gradients (∝ the
    model), the strata flavours rotate factor shards and sum the core;
  * for the strata flavours ``permutes/step`` (non-zero rotations),
    ``hidden_flops/step`` (``strata_overlap``'s core updates issued while
    a rotation is in flight) and ``async_starts`` (rotations a side CUDA
    stream carried over the epoch; 0 on the CPU, where copies are
    synchronous);
  * ``us_per_call``: the median µs a step on the host clock, each call
    closed by a device synchronize (the reference leaves it 0.0), and
    each kernel's launches a step (0 on the CPU: the plain paths count
    nothing).

``fig7bc/overlap_check_M{M}``: over the epoch, ``coll_no_worse`` (overlap
moves no more bytes than strata) and ``rotation_hidden`` (a hiding
window: hidden FLOPs or side-stream starts); on the card also the share of
side-copy time that a compute-stream kernel ran beside, from the profiler
over one chunk (reported, not asserted).  The reference lowers only
``schedule[0]``'s stratum for strata, which rotates nothing, so its check
compares overlap's rotations against a strata step without any and reads
``coll_no_worse=False``; the epoch count has no such blind spot.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_multidev \\
        [--device cpu] [--backend torch]
"""
from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch

from .common import row

DIMS = (1024, 768, 512)
NNZ = 100_000
RANK = 8
GLOBAL_BATCH = 8192       # strong scaling: |Ψ| split over the workers
WORKERS = (2, 4)
KERNELS = ("kruskal_grad", "scatter_accum")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_epoch(step, dstate, steps: int, device: torch.device):
    """``steps`` steps of ``step`` → (state, µs a step of each call), each
    call closed by a device synchronize."""
    start, times = dstate.step, []
    while dstate.step - start < steps:
        s0, t0 = dstate.step, time.perf_counter()
        dstate = step(dstate)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e6 / (dstate.step - s0))
    return dstate, times


def prepare(name: str, tensor, M: int, device: torch.device,
            backend: str | None = None):
    """(strategy, plan, fresh state) of ``name`` at M workers on the
    benchmark's config."""
    from repro_torch.core import fasttucker as ft
    from repro_torch.distributed import get_strategy
    from repro_torch.launch.mesh import make_host_mesh

    st = get_strategy(name)
    cfg = ft.FastTuckerConfig(dims=DIMS, ranks=(RANK,) * len(DIMS),
                              core_rank=RANK, batch_size=GLOBAL_BATCH // M,
                              backend=backend)
    mesh = (make_host_mesh(num_workers=M, device=device) if st.needs_mesh
            else None)
    plan = st.prepare(tensor, cfg, mesh, seed=0)
    gen = torch.Generator(device=device).manual_seed(0)
    return st, plan, st.init(plan, ft.init_state(gen, cfg, device), gen)


def measure(name: str, tensor, M: int, device: torch.device,
            backend: str | None = None) -> dict:
    """One strategy at M workers: the counts of its second epoch, a
    step."""
    from repro_torch import kernels as K
    from repro_torch.core.cost import step_flops

    st, plan, dstate = prepare(name, tensor, M, device, backend)
    step = st.make_step(plan)
    S = M ** (len(DIMS) - 1)
    dstate, _ = run_epoch(step, dstate, S, device)      # untimed
    step.traffic.reset()
    before = K.launch_counts()
    dstate, times = run_epoch(step, dstate, S, device)
    after = K.launch_counts()
    t = step.traffic
    out = {"flops": step_flops(name, plan.cfg, M),
           "psum": t.psum_bytes / S, "permute": t.permute_bytes / S,
           "coll": (t.psum_bytes + t.permute_bytes) / S,
           "permutes": t.permutes / S, "hidden_flops": t.hidden_flops / S,
           "async_starts": t.async_starts,
           "us_per_step": statistics.median(times),
           "launches": {k: (after[k] - before[k]) / S for k in KERNELS}}
    if name == "strata_overlap" and device.type == "cuda":
        out["side_copies"] = side_copy_share(step, dstate)
    return out


def side_copy_share(step, dstate) -> dict:
    """One call of ``step`` under ``torch.profiler``: the side-stream
    copies' time and the part of it that a compute-stream kernel ran
    beside (the streams that ran a kernel are the compute streams)."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(dstate)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        trace = Path(d) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text()).get("traceEvents", [])
    kern = [e for e in events if e.get("cat") == "kernel"]
    compute = {e["args"].get("stream") for e in kern}
    side = [e for e in events if e.get("cat") == "gpu_memcpy"
            and e["args"].get("stream") not in compute]

    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))

    busy = [span(e) for e in kern]
    side_us = sum(float(e.get("dur", 0.0)) for e in side)
    beside = sum(max(0.0, min(b, y) - max(a, x))
                 for a, b in map(span, side) for x, y in busy)
    return {"copies": len(side), "side_copy_us": side_us,
            "beside_compute_us": beside,
            "share": beside / side_us if side_us else 0.0}


def sweep(device: str | torch.device | None = None,
          backend: str | None = None) -> dict[int, dict[str, dict]]:
    """{M: {strategy: counts a step}} over ``WORKERS``, with
    ``work_scaling_eff`` against the first M."""
    from repro_torch.data.synthetic import planted_tensor
    from repro_torch.distributed import available_strategies

    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    tensor = planted_tensor(DIMS, NNZ, seed=0, device=device)
    res, base = {}, {}
    for M in WORKERS:
        res[M] = {name: measure(name, tensor, M, device, backend)
                  for name in available_strategies()}
        for name, s in res[M].items():
            base.setdefault(name, s["flops"] * M)
            s["work_scaling_eff"] = base[name] / (s["flops"] * M)
    return res


def overlap_check(r: dict[str, dict]) -> dict:
    """The headline over the epoch: overlap moves no more bytes than
    strata, and it has a hiding window."""
    ov, st = r["strata_overlap"], r["strata"]
    return {"coll_no_worse": ov["coll"] <= st["coll"] + 1e-6,
            "rotation_hidden": (ov["hidden_flops"] > 0
                                or ov["async_starts"] > 0)}


def rows(res: dict[int, dict[str, dict]]) -> list[str]:
    """The CSV rows of a ``sweep``."""
    out = []
    for M, r in res.items():
        for name, s in sorted(r.items()):
            extras = (f"flops/dev={s['flops']:.6g};coll/step={s['coll']:.6g}B;"
                      f"psum/step={s['psum']:.6g}B;"
                      f"permute/step={s['permute']:.6g}B;"
                      f"work_scaling_eff={s['work_scaling_eff']:.4f};"
                      + ";".join(f"{k}/step={v:g}"
                                 for k, v in s["launches"].items()))
            if name.startswith("strata"):
                extras += (f";permutes/step={s['permutes']:.4g};"
                           f"hidden_flops/step={s['hidden_flops']:.6g};"
                           f"async_starts={s['async_starts']}")
            out.append(row(f"fig7bc/{name}_M{M}", s["us_per_step"], extras))
        if "strata" in r and "strata_overlap" in r:
            chk = overlap_check(r)
            extras = (f"coll_no_worse={chk['coll_no_worse']};"
                      f"rotation_hidden={chk['rotation_hidden']}")
            side = r["strata_overlap"].get("side_copies")
            if side is not None:
                extras += f";side_copy_beside_compute={side['share']:.4f}"
            out.append(row(f"fig7bc/overlap_check_M{M}", 0.0, extras))
    return out


def run(device: str | torch.device | None = None,
        backend: str | None = None) -> list[str]:
    return rows(sweep(device, backend))


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    args = ap.parse_args(argv)
    return run(device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
