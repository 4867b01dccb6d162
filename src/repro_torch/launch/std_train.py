"""STD (sparse Tucker) training driver — the paper's workload.

Counterpart of ``repro.launch.std_train``: a planted tensor
(``data.synthetic.planted_tensor``, 10 % held out), cold init, and one
strategy-agnostic loop that drives a ``DistStrategy`` from the port's
registry (``repro_torch.distributed``):

    ``local``           one device (the default)
    ``sync``            data-parallel minibatch, summed gradients
    ``strata``          the paper's Fig.-2 stratified rotation (LHC schedule)
    ``strata_overlap``  strata in chunks, the rotations issued ahead of use

The mesh strategies run on ``launch.mesh.make_host_mesh()``: M workers,
``$REPRO_FORCE_HOST_DEVICES`` of them or one a visible card, placed
round-robin over the cards (on one card they share it).  ``--strategy``
defaults to ``$REPRO_DIST_STRATEGY``, then ``local``; ``--mode`` is its
deprecated alias.
Held-out RMSE/MAE through ``predict`` before training, every
``--eval-every`` steps and at the end.  It logs steps/s and nnz/s over the
training intervals (evals and checkpoints excluded, each interval closed
by a device synchronize), the bytes the rotations moved a step, and the
peak device bytes (``torch.cuda.max_memory_allocated``).

The step flags are the reference's: ``--phase-split``,
``--sorted-batches``, ``--dtype`` and ``--accum-dtype`` (``update_order``
stays config-only, as there); ``--compress`` runs the int8 error-feedback
gradient round trip under every strategy.  ``--ckpt-dir`` saves the
strategy state (parameters in the reference's global layout, step, the
sampling generators' states and the EF residuals) at every evaluation
through ``checkpoint.manager.CheckpointManager``; ``--resume`` restores its
latest committed step and continues, drawing the same batches the
uninterrupted run draws, so a resumed run ends on its bits.

``--out-of-core`` (strata flavors) feeds the schedule from a
``data.pipeline.NonzeroStore`` built at the mesh's worker count
(``--spill-dir`` memory-maps its chunks to disk) through the
``StratumPrefetcher``, which places each stratum's block on the workers'
devices ``--prefetch-depth`` strata ahead of use: the trajectory is the
resident run's bit for bit.

``--warm-start`` replaces the cold init with the sketched warm start
(``core.sketch``; ``--sketch-*`` and ``--warm-step-offset`` are its
knobs), drawn from a generator of its own seeded from ``--seed``: the
batch generator still draws the cold init first, so a warm run and a cold
run of one seed draw the same batches.  The record's
``warm_start_seconds`` has each stage's seconds.  ``--adaptive-rank``
runs the plateau rank controller (``core.adaptive``): at a transition
the core factors are padded (from the warm start's generator) or
truncated, ``--refine als|ccd`` polishes the factors over 65,536 sampled
nonzeros, and the strategy is prepared again at the new rank and carries
on from the same step and batch streams; ``rank_history`` records each
transition.  On ``"cuda"`` a sketch width (max J + oversample) or a
``--max-core-rank`` above 64 is refused at the start, as is
``--adaptive-rank`` with ``--ckpt-dir`` or ``--out-of-core``.  The
reference's ``--donate`` has no PyTorch meaning: argparse refuses it.

    PYTHONPATH=src python -m repro_torch.launch.std_train \\
        --dims 1000,800,600 --nnz 200000 --steps 300 --batch 4096 \\
        [--strategy sync|strata|strata_overlap [--out-of-core \\
        --spill-dir DIR --prefetch-depth 2]] \\
        --sorted-batches --phase-split [--dtype bfloat16] [--compress] \\
        [--ckpt-dir DIR [--resume]] [--warm-start] \\
        [--adaptive-rank --max-core-rank 16 --refine als]

Runs on the CUDA card with the ``"cuda"`` kernels by default; ``--device
cpu --backend torch`` runs the plain path on the CPU
(``REPRO_FORCE_HOST_DEVICES=4`` gives the mesh strategies four workers
there).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from functools import partial

import torch

from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.core import fasttucker as ft
from repro_torch.core.adaptive import (RankController, refine_factors,
                                       resize_core_rank)
from repro_torch.core.metrics import rmse_mae
from repro_torch.core.sampling import sample_batch_arrays
from repro_torch.core.sketch import sketched_init_params
from repro_torch.core.sptensor import SparseTensor
from repro_torch.data.pipeline import NonzeroStore
from repro_torch.data.synthetic import planted_tensor
from repro_torch.device import resolve_device
from repro_torch.distributed import available_strategies, get_strategy
from repro_torch.kernels import dispatch
from repro_torch.kernels.kruskal_grad import MAX_WIDTH
from repro_torch.launch.mesh import make_host_mesh

log = logging.getLogger("repro_torch.std")
REFINE_SAMPLES = 65_536   # nonzeros a post-transition refinement reads


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--strategy", default=None,
                    help="training strategy: local | sync | strata | "
                         "strata_overlap (default: $REPRO_DIST_STRATEGY or "
                         "local)")
    ap.add_argument("--mode", default=None,
                    choices=["local", "sync", "strata"],
                    help="DEPRECATED: alias for --strategy")
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
    ap.add_argument("--out-of-core", action="store_true",
                    help="feed the strata strategies from a NonzeroStore "
                         "through the stratum prefetcher instead of resident "
                         "buckets (the same trajectory)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="strata placed on the devices ahead of use "
                         "(0 = a synchronous load a step)")
    ap.add_argument("--spill-dir", default="",
                    help="spill the nonzero store to memory-mapped .npy "
                         "chunks in this directory (default: in memory)")
    ap.add_argument("--ckpt-dir", default="",
                    help="save the strategy state here at every evaluation")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir (the "
                         "dir must belong to a run with the same config and "
                         "strategy)")
    ap.add_argument("--warm-start", action="store_true",
                    help="sketched randomized warm start (core.sketch) "
                         "instead of the cold uniform init")
    ap.add_argument("--sketch-passes", type=int, default=2,
                    help="sample passes feeding the range finder")
    ap.add_argument("--sketch-oversample", type=int, default=4,
                    help="sketch width = rank + oversample")
    ap.add_argument("--sketch-batch", type=int, default=0,
                    help="sketch samples per pass (0 → --batch)")
    ap.add_argument("--sketch-refine-passes", type=int, default=4,
                    help="alternating ALS/core-LS polish passes")
    ap.add_argument("--warm-step-offset", type=int, default=0,
                    help="start the decaying LR schedule at this step "
                         "after a warm start (0 = cold schedule)")
    ap.add_argument("--adaptive-rank", action="store_true",
                    help="grow/shrink the Kruskal core rank on "
                         "validation-RMSE plateaus (core.adaptive)")
    ap.add_argument("--max-core-rank", type=int, default=0,
                    help="adaptive-rank growth cap (0 → 4x --core-rank)")
    ap.add_argument("--plateau-tol", type=float, default=0.01,
                    help="relative RMSE improvement below this counts "
                         "as a plateau observation")
    ap.add_argument("--plateau-patience", type=int, default=2,
                    help="consecutive plateau observations before a "
                         "rank transition")
    ap.add_argument("--refine", default="", choices=["", "als", "ccd"],
                    help="polish factors with exact baseline epochs "
                         "after each rank transition")
    ap.add_argument("--refine-passes", type=int, default=1,
                    help="epochs per post-transition refinement")
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
    # fail fast on strategy typos, before the data (--mode maps through
    # with a DeprecationWarning)
    strategy = get_strategy(args.strategy, mode=args.mode)
    dims = tuple(int(x) for x in args.dims.split(","))
    # fail fast on bad options, before the data is made
    cfg = ft.FastTuckerConfig(
        dims=dims, ranks=(args.rank,) * len(dims), core_rank=args.core_rank,
        batch_size=args.batch, backend=backend,
        phase_split=args.phase_split, sorted_batches=args.sorted_batches,
        dtype=args.dtype, accum_dtype=args.accum_dtype,
        init="sketched" if args.warm_start else "random",
        sketch_passes=args.sketch_passes,
        sketch_oversample=args.sketch_oversample,
        sketch_batch=args.sketch_batch,
        sketch_refine_passes=args.sketch_refine_passes,
        warm_step_offset=args.warm_step_offset)
    if args.out_of_core and strategy.name not in ("strata", "strata_overlap"):
        raise SystemExit(
            "--out-of-core streams per-stratum chunks and therefore "
            f"requires a strata strategy (got {strategy.name!r}); run with "
            "--strategy strata or strata_overlap")
    controller = None
    if args.adaptive_rank:
        if args.out_of_core:
            raise SystemExit(
                "--adaptive-rank rebuilds the strategy plan at each rank "
                "transition, which the out-of-core prefetcher does not "
                "support; drop --out-of-core")
        if args.ckpt_dir:
            raise SystemExit(
                "--adaptive-rank changes the config mid-run; checkpoints "
                "assume one config per run — drop --ckpt-dir")
        max_rank = args.max_core_rank or 4 * args.core_rank
        if backend == "cuda" and max_rank > MAX_WIDTH:
            raise SystemExit(
                f"--max-core-rank {max_rank} is above {MAX_WIDTH}, the "
                "widest core rank the 'cuda' kernels take; lower it (the "
                "default is 4x --core-rank)")
        controller = RankController(args.core_rank, max_rank,
                                    tol=args.plateau_tol,
                                    patience=args.plateau_patience)
    log.info("strategy %s (available: %s), device %s, kernel backend %s, "
             "dims %s, nnz %d, J=%d, R=%d, batch %d, phase_split %s, "
             "sorted_batches %s, dtype %s, accum_dtype %s, compress %s, "
             "init %s, adaptive rank %s",
             strategy.name, "/".join(available_strategies()), device,
             backend, dims, args.nnz, args.rank, args.core_rank, args.batch,
             cfg.phase_split, cfg.sorted_batches, cfg.dtype, cfg.accum_dtype,
             args.compress, cfg.init,
             f"up to {controller.max_rank}" if controller else "off")

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

    mesh = make_host_mesh(device=device) if strategy.needs_mesh else None
    store, store_s, prepare_kw = None, None, {}
    if args.out_of_core:
        t_st = time.perf_counter()
        store = NonzeroStore.build(train_t, mesh.size,
                                   spill_dir=args.spill_dir or None)
        store_s = time.perf_counter() - t_st
        log.info("out-of-core store: %d strata x %d workers x chunk %d "
                 "(%.1f MiB total, %.2f MiB/stratum, %s) in %.2fs, prefetch "
                 "depth %d", store.num_strata, store.num_workers,
                 store.chunk_len, store.nbytes / 2**20,
                 store.stratum_nbytes / 2**20,
                 f"spilled to {store.path}" if store.spilled
                 else "in memory", store_s, args.prefetch_depth)
        prepare_kw = {"store": store, "prefetch_depth": args.prefetch_depth}
    if mesh is not None:
        log.info("mesh: %d workers on %s", mesh.size,
                 ", ".join(str(d) for d in mesh.devices))
    t_prep = time.perf_counter()
    plan = strategy.prepare(train_t, cfg, mesh, compress=args.compress,
                            seed=args.seed, **prepare_kw)
    _sync(device)
    prepare_s = time.perf_counter() - t_prep
    log.info("%s plan prepared in %.2fs", strategy.name, prepare_s)
    # one generator draws the cold init, then every batch; a warm start
    # still draws the cold init from it, so both arms draw the same batches
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state0 = ft.init_state(
        gen, dataclasses.replace(cfg, init="random"), device)
    # the warm start's and the rank transitions' own stream
    init_gen = torch.Generator(device=device).manual_seed(args.seed)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    resuming = bool(ckpt and args.resume and ckpt.latest_step() is not None)
    warm_s = None
    if args.warm_start and not resuming:
        warm_s = {}
        t_w = time.perf_counter()
        state0 = ft.TrainState(
            sketched_init_params(init_gen, cfg, train_t.indices,
                                 train_t.values, timings=warm_s),
            cfg.warm_step_offset)
        warm_s["total"] = time.perf_counter() - t_w
        log.info("sketched warm start in %.2fs (%s; LR schedule from step "
                 "%d)", warm_s["total"], ", ".join(
                     f"{k} {v:.3f}s" for k, v in warm_s.items()
                     if k != "total"), state0.step)
    dstate = strategy.init(plan, state0, gen)
    resumed_from = None
    if resuming:
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
        log.info("step %d rmse %.4f mae %.4f (core rank %d)", rec["step"],
                 rec["rmse"], rec["mae"], cfg.core_rank)
        return rec

    step_fn = strategy.make_step(plan)
    nnz_step = strategy.nnz_per_step(plan)
    history = [evaluate()]
    rank_history = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    start = last = dstate.step
    train_s = ckpt_s = 0.0
    ckpt_bytes = None
    rotated = 0
    t_int = time.perf_counter()
    try:
        while dstate.step < args.steps:
            dstate = step_fn(dstate)
            i = dstate.step
            # crossing an --eval-every boundary (a strategy may advance
            # more than one step a call)
            if (i // args.eval_every > last // args.eval_every
                    or i >= args.steps):
                _sync(device)
                dt = time.perf_counter() - t_int
                train_s += dt
                sps = (i - last) / dt
                log.info("throughput: %.1f steps/s, %.4g nnz/s", sps,
                         sps * nnz_step)
                history.append(evaluate())
                last = i
                traffic = getattr(step_fn, "traffic", None)
                if traffic is not None:
                    rotated += traffic.rotated_bytes
                    traffic.rotated_bytes = 0
                if ckpt:
                    t_ck = time.perf_counter()
                    strategy.save(plan, ckpt, dstate)
                    ckpt_s += time.perf_counter() - t_ck
                    leaves = flatten(strategy.checkpoint_tree(plan,
                                                              dstate)).values()
                    ckpt_bytes = sum(t.numel() * t.element_size()
                                     for t in leaves)
                decision = (controller.observe(history[-1]["rmse"])
                            if controller else None)
                if decision is not None and i < args.steps:
                    params, cfg = resize_core_rank(
                        strategy.eval_params(plan, dstate), cfg,
                        decision.new_rank, init_gen)
                    if args.refine:
                        ridx, rval = sample_batch_arrays(
                            init_gen, train_t.indices, train_t.values,
                            min(train_t.nnz, REFINE_SAMPLES))
                        params = refine_factors(
                            params, cfg, SparseTensor(ridx, rval, dims),
                            method=args.refine, passes=args.refine_passes)
                    log.info("rank %s -> %d at step %d (%s)",
                             decision.action, decision.new_rank, i,
                             decision.reason)
                    rank_history.append({"step": i,
                                         "action": decision.action,
                                         "rank": decision.new_rank})
                    plan = strategy.prepare(train_t, cfg, mesh,
                                            compress=args.compress,
                                            seed=args.seed)
                    # go on with the same batch streams from the same step
                    dstate = strategy.init(plan, ft.TrainState(params, i),
                                           gen)._replace(rng=dstate.rng)
                    step_fn = strategy.make_step(plan)
                    nnz_step = strategy.nnz_per_step(plan)
                t_int = time.perf_counter()
    finally:
        fetch = getattr(step_fn, "prefetcher", None)
        if fetch is not None:
            fetch.close()
    steps_done = dstate.step - start
    steps_per_s = steps_done / train_s if train_s > 0 else float("nan")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    rotated_per_step = rotated / steps_done if steps_done else 0.0
    log.info("done: %d steps, %.1f steps/s, %.4g nnz/s, %.0f bytes rotated "
             "a step, peak device bytes %s", steps_done, steps_per_s,
             steps_per_s * nnz_step, rotated_per_step,
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
        "workers": mesh.size if mesh is not None else 1,
        "prepare_seconds": prepare_s,
        "store_seconds": store_s,
        "store_bytes": store.nbytes if store is not None else None,
        "rotated_bytes_per_step": rotated_per_step,
        "resumed_from": resumed_from,
        "ckpt_seconds": ckpt_s,
        "ckpt_bytes": ckpt_bytes,
        "init": cfg.init,
        "warm_start_seconds": warm_s,
        "rank_history": rank_history,
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
