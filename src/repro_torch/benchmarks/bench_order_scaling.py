"""Fig. 7a on the port: time per step against the tensor order N = 3..8.

Counterpart of ``benchmarks/bench_order_scaling.py``, at its shapes: 200
ids a mode, J = R = 4, 100,000 planted nonzeros (seed = N), batch 4096,
one warm-up call and the median of three; FastTucker at N = 3..8 and the
full-core baseline (cuTucker) at N = 3..6.  The paper's claim:
FastTucker's cost grows linearly in N (one J·R dot product a mode and
sample), the full core's exponentially (J^N cells).  The derived column is
the growth factor against the previous order.

``SMOKE`` (the port's own; the reference has none) cuts the tensor for a
CPU check of the rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_order_scaling \\
        [--smoke] [--device cpu] [--backend torch]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch

from .bench_param_sweep import growth_rows
from .common import time_call

J = 4
BATCH = 4096
PER_MODE = 200
NNZ = 100_000
ORDERS = (3, 4, 5, 6, 7, 8)
FULL_CORE_ORDERS = (3, 4, 5, 6)   # full core: J^order cells
SMOKE = dict(per_mode=20, nnz=2_000, batch=256)


def points(smoke: bool = False, device: str | torch.device | None = None,
           backend: str | None = None) -> list[tuple[str, str, object]]:
    """(sweep, row name, one step as a callable) of every point, in row
    order."""
    from repro_torch.core import cutucker as cu
    from repro_torch.core import fasttucker as ft
    from repro_torch.data.synthetic import planted_tensor

    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    per, nnz, batch = ((SMOKE["per_mode"], SMOKE["nnz"], SMOKE["batch"])
                       if smoke else (PER_MODE, NNZ, BATCH))
    gen = torch.Generator(device=device).manual_seed(0)
    tensors = {order: planted_tensor((per,) * order, nnz, rank=J,
                                     core_rank=J, seed=order, device=device)
               for order in ORDERS}
    out = []
    for order in ORDERS:
        t = tensors[order]
        cfg = ft.FastTuckerConfig(dims=t.dims, ranks=(J,) * order,
                                  core_rank=J, batch_size=batch,
                                  backend=backend)
        state = ft.init_state(torch.Generator(device=device).manual_seed(0),
                              cfg, device)
        out.append(("fast", f"fig7a/fast_order{order}",
                    lambda s=state, c=cfg, t=t: ft.sgd_step(
                        s, gen, t.indices, t.values, c)))
    for order in FULL_CORE_ORDERS:
        t = tensors[order]
        ccfg = cu.CuTuckerConfig(dims=t.dims, ranks=(J,) * order,
                                 batch_size=batch, backend=backend)
        cstate = cu.init_state(torch.Generator(device=device).manual_seed(0),
                               ccfg, device)
        out.append(("full", f"fig7a/full_order{order}",
                    lambda s=cstate, c=ccfg, t=t: cu.sgd_step(
                        s, gen, t.indices, t.values, c)))
    return out


def run(smoke: bool = False, device: str | torch.device | None = None,
        backend: str | None = None) -> list[str]:
    pts = points(smoke, device, backend)
    return growth_rows(pts, [time_call(fn, warmup=1, iters=3)
                             for _, _, fn in pts], "vs_prev_order")


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
