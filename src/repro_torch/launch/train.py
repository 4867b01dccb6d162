"""LM training driver: state + supervisor + checkpoints, on one device.

Counterpart of ``repro.launch.train`` (language-model configs).  It keeps
the reference's flags except the mesh ones (``--mesh``, ``--policy``,
``--model-parallel``: sharded training is not ported yet, ROADMAP.md) and
adds ``--tucker-rank`` (Tucker-compress every FFN at that rank),
``--device`` and ``--backend``, as ``launch/serve.py`` has them:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_14b \\
        --reduced --steps 20 --batch 8 --seq 128 --tucker-rank 8 \\
        --ckpt-dir /tmp/ckpt --device cpu --backend torch

Runs on the CUDA card with the ``"cuda"`` kernels by default (backend:
``--backend`` > ``$REPRO_TORCH_KERNEL_BACKEND`` > ``cuda``); without CUDA
it raises unless ``--device cpu`` is given.  Weights come from
``init_model`` with a ``torch.Generator`` on the device seeded 0; batches
from the reference's ``TokenPipeline`` (the same tokens for the same
step).  The ``Supervisor`` checkpoints every ``--ckpt-every`` steps
(asynchronously) and, when a step raises, restores the latest checkpoint
and replays from there; ``--resume`` starts from the latest checkpoint in
``--ckpt-dir``.  ``run(cfg, ...)`` is the same driver for a config built
in code: at full width the f32 AdamW state of Qwen3-14B's 40 layers
(88 GB) does not fit one 80 GB card, so the card trains a config with
``num_layers`` cut (8 fit).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, require_ported
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.launch import steps as S
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (FailureInjector, Supervisor,
                                       SupervisorConfig)

log = logging.getLogger("repro_torch.train")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="LM training (language-model configs only).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt "
                         "in the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tucker-rank", type=int, default=None,
                    help="Tucker-compress every FFN at this rank (default: "
                         "the config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; "
                         "cpu must be asked for)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_batch(batch: dict, device: torch.device) -> dict:
    """The pipeline's numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128,
        lr: float = 3e-4, ckpt_dir: str | None = None, ckpt_every: int = 50,
        log_every: int = 10, resume: bool = False, device=None,
        backend: str | None = None,
        injector: FailureInjector | None = None) -> dict:
    """Train ``steps`` steps (from the latest checkpoint with ``resume``).

    Returns ``history`` (step → its metrics as floats, with ``seconds``,
    the step's wall time closed by a device synchronize; a replayed step
    keeps its last run), the wall ``seconds`` of the loop, ``steps_per_s``
    and ``tokens_per_s`` over the steps run, the peak device bytes (None on
    the CPU), the supervisor's ``stats``, the step it ``started`` from and
    the final ``state``.  ``injector`` raises at chosen steps, before they
    run (the supervisor's restart path).
    """
    require_ported(cfg)
    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    dispatch.get_backend(backend)  # unknown names raise here
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=steps)
    train_step = S.make_train_step(cfg, opt_cfg, backend)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = S.init_train_state(cfg, gen, device)

    ckpt = CheckpointManager(ckpt_dir or os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    sup = Supervisor(ckpt, SupervisorConfig(checkpoint_every=ckpt_every))
    start = 0
    if resume and ckpt.latest_step() is not None:
        state, start = ckpt.restore(state)
        log.info("resumed from step %d", start)

    history: dict[int, dict] = {}

    def step_fn(state, i):
        if injector is not None:
            injector.maybe_fail(i)
        t0 = time.perf_counter()
        state, metrics = train_step(state, device_batch(
            pipe.global_batch(i), device))
        m = {k: float(v) for k, v in metrics.items()}   # synchronizes
        m["seconds"] = time.perf_counter() - t0
        history[i + 1] = m
        if (i + 1) % log_every == 0:
            log.info("step %d loss %.4f gnorm %.3f", i + 1, m["loss"],
                     m["grad_norm"])
        return state

    _sync(device)
    t0 = time.perf_counter()
    state = sup.run(state, step_fn, steps, start_step=start)
    _sync(device)
    secs = time.perf_counter() - t0
    ran = max(steps - start, 0)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    log.info("done: %d steps in %.1fs; restarts=%d stragglers=%d",
             ran, secs, sup.stats.restarts, sup.stats.straggler_steps)
    if history:
        first, last = min(history), max(history)
        log.info("first loss %.4f → last loss %.4f",
                 history[first]["loss"], history[last]["loss"])
    log.info("peak device bytes %s",
             "not measured (CPU)" if peak is None else f"{peak:,}")
    return {"history": history, "seconds": secs,
            "steps_per_s": ran / max(secs, 1e-9),
            "tokens_per_s": ran * batch * seq / max(secs, 1e-9),
            "peak_device_bytes": peak, "stats": sup.stats, "started": start,
            "state": state, "backend": backend, "device": str(device)}


def main(argv: list[str] | None = None,
         injector: FailureInjector | None = None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.tucker_rank is not None:
        cfg = dataclasses.replace(cfg, tucker_rank=args.tucker_rank)
    return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every, log_every=args.log_every,
               resume=args.resume, device=args.device, backend=args.backend,
               injector=injector)


if __name__ == "__main__":
    main()
