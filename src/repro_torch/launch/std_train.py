"""STD (sparse Tucker) training driver on one device — the paper's workload.

Counterpart of ``repro.launch.std_train``: a planted tensor
(``data.synthetic.planted_tensor``, 10 % held out), cold init, and one
strategy-agnostic loop that drives a ``DistStrategy`` from the port's
registry (``repro_torch.distributed``; ``--strategy local``, the only one
ported, is the default).
Held-out RMSE/MAE through ``predict`` before training, every
``--eval-every`` steps and at the end.  It logs steps/s and nnz/s over the
training intervals (evals and checkpoints excluded, each interval closed
by a device synchronize) and the peak device bytes
(``torch.cuda.max_memory_allocated``).

The step flags are the reference's: ``--phase-split``,
``--sorted-batches``, ``--dtype`` and ``--accum-dtype`` (``update_order``
stays config-only, as there); ``--compress`` runs the int8 error-feedback
gradient round trip.  ``--ckpt-dir`` saves the strategy state (parameters,
step, the sampling generator's state and the EF residuals) at every
evaluation through ``checkpoint.manager.CheckpointManager``; ``--resume``
restores its latest committed step and continues, drawing the same
batches the uninterrupted run draws, so a resumed run ends on its bits.
The reference's ``--mode`` alias, ``--donate``, the sketched warm start,
the adaptive rank and the out-of-core store are not ported: argparse
refuses their flags.

    PYTHONPATH=src python -m repro_torch.launch.std_train \\
        --dims 1000,800,600 --nnz 200000 --steps 300 --batch 4096 \\
        --sorted-batches --phase-split [--dtype bfloat16] [--compress] \\
        [--ckpt-dir DIR [--resume]]

Runs on the CUDA card with the ``"cuda"`` kernels by default; ``--device
cpu --backend torch`` runs the plain path on the CPU.
"""
from __future__ import annotations

import argparse
import logging
import time
from functools import partial

import torch

from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.core import fasttucker as ft
from repro_torch.core.metrics import rmse_mae
from repro_torch.core.sptensor import SparseTensor
from repro_torch.data.synthetic import planted_tensor
from repro_torch.device import resolve_device
from repro_torch.distributed import available_strategies, get_strategy
from repro_torch.distributed.base import checkpoint_tree
from repro_torch.kernels import dispatch

log = logging.getLogger("repro_torch.std")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--strategy", default="local",
                    help="training strategy: local (sync, strata and "
                         "strata_overlap are not ported yet)")
    ap.add_argument("--dims", default="1000,800,600")
    ap.add_argument("--nnz", type=int, default=200_000)
    ap.add_argument("--rank", type=int, default=8,
                    help="J_n of every mode (planted and model)")
    ap.add_argument("--core-rank", type=int, default=8)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--seed", type=int, default=0,
                    help="data/split/init/sampling seed")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; "
                         "cpu must be asked for)")
    ap.add_argument("--phase-split", action="store_true",
                    help="two-phase factor/core step with the "
                         "StepIntermediates cache (the same bits as the "
                         "joint step)")
    ap.add_argument("--sorted-batches", action="store_true",
                    help="sort each batch per mode and scatter the row "
                         "gradients through the segment_reduce kernel (no "
                         "atomics)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="parameter storage dtype (dots and gradients stay "
                         "f32)")
    ap.add_argument("--accum-dtype", default="float32", choices=["float32"],
                    help="dot / gradient accumulation dtype; only float32, "
                         "kept so that the reference's command lines run "
                         "unchanged")
    ap.add_argument("--ckpt-dir", default="",
                    help="save the strategy state here at every evaluation")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir (the "
                         "dir must belong to a run with the same config and "
                         "strategy)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    args: argparse.Namespace,
    data: tuple[SparseTensor, SparseTensor] | None = None,
) -> dict:
    """Generate, split, train and evaluate; returns the run's record.

    ``data``, an already-built ``(train, test)`` pair on the device, skips
    the generation (several runs over one tensor); ``--dims`` must match
    it, and ``--nnz`` and the data seed are then not used.
    """
    device = resolve_device(args.device)
    backend = dispatch.resolve_backend_name(args.backend)
    # fail fast on strategy typos and unported strategies, before the data
    strategy = get_strategy(args.strategy)
    dims = tuple(int(x) for x in args.dims.split(","))
    # fail fast on bad options, before the data is made
    cfg = ft.FastTuckerConfig(
        dims=dims, ranks=(args.rank,) * len(dims), core_rank=args.core_rank,
        batch_size=args.batch, backend=backend,
        phase_split=args.phase_split, sorted_batches=args.sorted_batches,
        dtype=args.dtype, accum_dtype=args.accum_dtype)
    log.info("strategy %s (available: %s), device %s, kernel backend %s, "
             "dims %s, nnz %d, J=%d, R=%d, batch %d, phase_split %s, "
             "sorted_batches %s, dtype %s, accum_dtype %s, compress %s",
             strategy.name, "/".join(available_strategies()), device,
             backend, dims, args.nnz, args.rank, args.core_rank, args.batch,
             cfg.phase_split, cfg.sorted_batches, cfg.dtype, cfg.accum_dtype,
             args.compress)

    t0 = time.perf_counter()
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
    _sync(device)
    data_s = time.perf_counter() - t0
    log.info("data: %d train / %d test nonzeros in %.1fs", train_t.nnz,
             test_t.nnz, data_s)

    plan = strategy.prepare(train_t, cfg, None, compress=args.compress,
                            seed=args.seed)
    # one generator draws the cold init, then every batch
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dstate = strategy.init(plan, ft.init_state(gen, cfg, device), gen)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    resumed_from = None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        dstate = strategy.restore(plan, ckpt, dstate)
        resumed_from = dstate.step
        log.info("resumed from step %d", dstate.step)
        if dstate.step >= args.steps:
            log.warning(
                "checkpoint step %d >= --steps %d: nothing to train — is %s "
                "a stale dir from another run?", dstate.step, args.steps,
                args.ckpt_dir)
    predict_fn = partial(ft.predict, backend=backend)

    def evaluate() -> dict:
        params = strategy.eval_params(plan, dstate)
        r, m = rmse_mae(params, test_t, predict_fn)
        rec = {"step": dstate.step, "rmse": float(r), "mae": float(m)}
        log.info("step %d rmse %.4f mae %.4f", rec["step"], rec["rmse"],
                 rec["mae"])
        return rec

    step_fn = strategy.make_step(plan)
    nnz_step = strategy.nnz_per_step(plan)
    history = [evaluate()]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    start = last = dstate.step
    train_s = ckpt_s = 0.0
    ckpt_bytes = None
    t_int = time.perf_counter()
    while dstate.step < args.steps:
        dstate = step_fn(dstate)
        i = dstate.step
        # crossing an --eval-every boundary (a strategy may advance more
        # than one step a call)
        if i // args.eval_every > last // args.eval_every or i >= args.steps:
            _sync(device)
            dt = time.perf_counter() - t_int
            train_s += dt
            sps = (i - last) / dt
            log.info("throughput: %.1f steps/s, %.4g nnz/s", sps,
                     sps * nnz_step)
            history.append(evaluate())
            last = i
            if ckpt:
                t_ck = time.perf_counter()
                strategy.save(plan, ckpt, dstate)
                ckpt_s += time.perf_counter() - t_ck
                leaves = flatten(checkpoint_tree(dstate)).values()
                ckpt_bytes = sum(t.numel() * t.element_size()
                                 for t in leaves)
            t_int = time.perf_counter()
    steps_done = dstate.step - start
    steps_per_s = steps_done / train_s if train_s > 0 else float("nan")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    log.info("done: %d steps, %.1f steps/s, %.4g nnz/s, peak device bytes "
             "%s", steps_done, steps_per_s, steps_per_s * nnz_step,
             "not measured (cpu)" if peak is None else f"{peak:,}")
    if ckpt:
        log.info("checkpoints: %s bytes each, %.3fs in all", ckpt_bytes,
                 ckpt_s)
    return {
        "history": history,
        "steps_per_s": steps_per_s,
        "nnz_per_s": steps_per_s * nnz_step,
        "peak_device_bytes": peak,
        "data_seconds": data_s,
        "train_seconds": train_s,
        "device": str(device),
        "backend": backend,
        "strategy": strategy.name,
        "resumed_from": resumed_from,
        "ckpt_seconds": ckpt_s,
        "ckpt_bytes": ckpt_bytes,
        "cfg": cfg,
        "state": ft.TrainState(strategy.eval_params(plan, dstate),
                               dstate.step),
        "dstate": dstate,
        "train": train_t,
        "test": test_t,
    }


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
