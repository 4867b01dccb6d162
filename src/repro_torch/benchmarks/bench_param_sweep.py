"""Fig. 5 on the port: time per FastTucker step against J and against R_core.

Counterpart of ``benchmarks/bench_param_sweep.py``, at its shapes: the
planted tensor 2000 × 1500 × 1000 with 200,000 nonzeros, batch 4096;
FastTucker steps at J ∈ {4, 8, 16, 32} with R = 8 and at R ∈ {4, 8, 16,
32} with J = 8; the full-core baseline (cuTucker) at J ∈ {4, 8, 16}.  The
paper's claim: FastTucker's cost grows linearly in J and R (Theorems 1–2),
the full core's as Π_n J_n.  Each row's derived column is the growth
factor against the previous point.  The steps are host-bound on the card
(a few dozen operations each), so the wall clock shows the launch floor;
``chip_smoke.py`` reads each point's device time beside it.

``SMOKE`` (the port's own; the reference has none) cuts the tensor for a
CPU check of the rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_param_sweep \\
        [--smoke] [--device cpu] [--backend torch]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch

from .common import row, time_call

DIMS = (2000, 1500, 1000)
NNZ = 200_000
BATCH = 4096
J_SWEEP = (4, 8, 16, 32)      # at R = 8
R_SWEEP = (4, 8, 16, 32)      # at J = 8
FULL_CORE_J = (4, 8, 16)      # full core: J^3 cells — stop before blowup
SMOKE = dict(dims=(60, 50, 40), nnz=5_000, batch=512)


def points(smoke: bool = False, device: str | torch.device | None = None,
           backend: str | None = None) -> list[tuple[str, str, object]]:
    """(sweep, row name, one step as a callable) of every point, in row
    order."""
    from repro_torch.core import cutucker as cu
    from repro_torch.core import fasttucker as ft
    from repro_torch.data.synthetic import planted_tensor

    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    dims, nnz, batch = ((SMOKE["dims"], SMOKE["nnz"], SMOKE["batch"])
                        if smoke else (DIMS, NNZ, BATCH))
    t = planted_tensor(dims, nnz, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = []

    def fast(sweep, name, J, R):
        cfg = ft.FastTuckerConfig(dims=dims, ranks=(J,) * 3, core_rank=R,
                                  batch_size=batch, backend=backend)
        state = ft.init_state(torch.Generator(device=device).manual_seed(0),
                              cfg, device)
        out.append((sweep, name, lambda: ft.sgd_step(
            state, gen, t.indices, t.values, cfg)))

    for J in J_SWEEP:
        fast("J", f"fig5/fast_J{J}_R8", J, 8)
    for R in R_SWEEP:
        fast("R", f"fig5/fast_J8_R{R}", 8, R)
    for J in FULL_CORE_J:
        ccfg = cu.CuTuckerConfig(dims=dims, ranks=(J,) * 3,
                                 batch_size=batch, backend=backend)
        cstate = cu.init_state(torch.Generator(device=device).manual_seed(0),
                               ccfg, device)
        out.append(("full", f"fig5/full_J{J}",
                    lambda s=cstate, c=ccfg: cu.sgd_step(
                        s, gen, t.indices, t.values, c)))
    return out


def growth_rows(pts, us: list[float], tag: str = "vs_prev") -> list[str]:
    """The CSV rows, each with its growth factor against the previous
    point of its sweep."""
    out, prev = [], {}
    for (sweep, name, _), t in zip(pts, us):
        growth = "" if sweep not in prev else f"x{t / prev[sweep]:.2f}_{tag}"
        out.append(row(name, t, growth))
        prev[sweep] = t
    return out


def run(smoke: bool = False, device: str | torch.device | None = None,
        backend: str | None = None) -> list[str]:
    pts = points(smoke, device, backend)
    return growth_rows(pts, [time_call(fn) for _, _, fn in pts])


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a small tensor (a CPU check of the rows)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    args = ap.parse_args(argv)
    return run(args.smoke, args.device, args.backend)


if __name__ == "__main__":
    main()
