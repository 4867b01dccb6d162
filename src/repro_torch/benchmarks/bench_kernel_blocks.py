"""Tables 8–12 on the port: the fused-against-unfused gradient compare.

Counterpart of the second half of ``benchmarks/bench_kernel_blocks.py``,
at its shape (N, B, J, R = 3, 16384, 16, 16): the UNFUSED pipeline (the
``kruskal_contract`` kernel, then the Eq. 13/17 gradients as PyTorch ops)
against the FUSED ``kruskal_grad`` kernel, which does the whole
per-nonzero forward and gradient pass in one launch (the cuFasterTucker
compare).  The structural check counts launches where the reference
counts ``pallas_call``s: ``core.fasttucker.batch_gradients`` on
``"cuda"`` must be exactly one ``kruskal_grad`` launch and nothing else
of the registry (``kernels.launch_counts()``; the wrappers count only
their CUDA launches, so on the CPU every count is 0).

The reference's first sweep, the ``kruskal_contract`` batch tile against
the TPU's ~16 MB VMEM budget, has no counterpart on this card: the CUDA
kernels pick their tiles from the shape (``plan()`` of each wrapper)
within a block's 227 KB of shared memory.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernel_blocks \\
        [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device

from .common import row, time_call

N, B, J, R = 3, 16384, 16, 16


def _unfused_grads(a, b, val):
    """Forward kernel + PyTorch gradient stage (the pre-fusion pipeline)."""
    from repro_torch.kernels.kruskal_contract import kruskal_contract

    pred, pexc = kruskal_contract(a, b)
    err = pred - val
    w_core = err / val.shape[0]
    rg = err[None, :, None] * torch.einsum("nbr,njr->nbj", pexc, b)
    cg = torch.einsum("nbj,nbr->njr", a, w_core[None, :, None] * pexc)
    return pred, err, rg, cg


def batch_gradients_launches(device: torch.device) -> dict[str, int]:
    """Launches of each kernel in one ``batch_gradients`` call on
    ``"cuda"`` (the counts' change, which it does not reset)."""
    from repro_torch import kernels as K
    from repro_torch.core import fasttucker as ft

    cfg = ft.FastTuckerConfig(dims=(64, 64, 64), ranks=(J,) * N,
                              core_rank=R, batch_size=256, backend="cuda")
    g = torch.Generator(device=device).manual_seed(1)
    params = ft.init_params(g, cfg, device)
    idx = torch.randint(0, 64, (256, N), generator=g, device=device,
                        dtype=torch.int32)
    v = torch.randn((256,), generator=g, device=device)
    before = K.launch_counts()
    ft.batch_gradients(params, idx, v, 0.01, 0.01, backend="cuda")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {k: n - before[k] for k, n in K.launch_counts().items()}


def run(device: str | torch.device | None = None) -> list[str]:
    from repro_torch.kernels.kruskal_grad import kruskal_grad

    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((N, B, J), generator=g, device=device)
    b = torch.randn((N, J, R), generator=g, device=device)
    val = torch.randn((B,), generator=g, device=device)
    mask = torch.ones((B,), device=device)
    scal = torch.tensor([1.0, 1.0 / B, 0.01, 0.01, 1.0],
                        dtype=torch.float32, device=device)
    out = []
    us_unfused = time_call(lambda: _unfused_grads(a, b, val),
                           warmup=1, iters=3)
    out.append(row("fusion/unfused_contract+torch_grads", us_unfused))
    us_fused = time_call(lambda: kruskal_grad(a, b, val, mask, scal),
                         warmup=1, iters=3)
    out.append(row("fusion/fused_kruskal_grad", us_fused,
                   f"{us_unfused / us_fused:.2f}x_vs_unfused"))

    # structural check: batch_gradients on "cuda" is ONE kruskal_grad
    # launch (contraction + Eq.13/17 gradients) and no other kernel
    counts = batch_gradients_launches(device)
    others = sum(v for k, v in counts.items() if k != "kruskal_grad")
    out.append(row("fusion/batch_gradients_kruskal_grad_launches",
                   float(counts["kruskal_grad"]),
                   f"want=1;other_launches={others}"
                   if device.type == "cuda" else
                   "plain_path_on_cpu;launches_not_counted"))
    return out


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
