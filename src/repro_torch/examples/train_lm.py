"""Train a language model with Tucker-compressed FFNs (the paper's stated
DNN-compression application) and compare it with the uncompressed model.

Counterpart of ``examples/train_lm.py``, with its flags and behaviour: the
same architecture is trained twice from the same seed on the reference's
``TokenPipeline`` batches, dense and with every FFN Tucker-compressed at
``--tucker-rank``, both in f32, AdamW at lr 1e-3; it prints the loss every
fifth of the run, the parameter counts and the compression ratio, and
asserts that both variants learn (the last logged loss below the first
step's).  The default is the reduced ``qwen3_14b`` (the reference's
docstring speaks of a CPU-sized xLSTM, but its ``--arch`` default is
``qwen3_14b``, reduced unless ``--full``); ``--arch`` takes any
architecture of ``configs.PORTED_ARCHS`` but the audio one (HuBERT-XLarge
takes frames, which the token pipeline does not feed: it is refused).
Runs on the CUDA card with the ``"cuda"`` kernels unless ``--device
cpu``:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \\
        [--device cpu] [--backend torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.launch.train import device_batch
from repro_torch.optim import adamw


def run_one(cfg, steps: int, batch: int, seq: int, tag: str, device,
            backend: str | None) -> tuple[float, float, int]:
    """(first step's loss, last logged loss, parameter count)."""
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    state = S.init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(p.numel() for p in state.params.parameters())
    step = S.make_train_step(
        cfg, adamw.AdamWConfig(lr=1e-3, total_steps=steps), backend)
    t0 = time.time()
    first = last = None
    for i in range(steps):
        state, metrics = step(state, device_batch(pipe.global_batch(i),
                                                  device))
        if i == 0:
            first = float(metrics["loss"])
        if (i + 1) % max(steps // 5, 1) == 0:
            last = float(metrics["loss"])
            print(f"[{tag}] step {i + 1:4d} loss {last:.4f}")
    print(f"[{tag}] {n_params / 1e6:.1f}M params, {steps} steps in "
          f"{time.time() - t0:.1f}s, loss {first:.3f} → {last:.3f}")
    return first, last, n_params


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_14b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--tucker-rank", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = get_config(args.arch, reduced=not args.full)
    if base.frontend == "audio":
        raise SystemExit(f"{args.arch} takes frames; the token pipeline "
                         "feeds tokens only")
    dense_cfg = dataclasses.replace(base, dtype="float32")
    tucker_cfg = dataclasses.replace(base, tucker_rank=args.tucker_rank,
                                     dtype="float32")
    f1, l1, n1 = run_one(dense_cfg, args.steps, args.batch, args.seq,
                         "dense", device, args.backend)
    f2, l2, n2 = run_one(tucker_cfg, args.steps, args.batch, args.seq,
                         f"tucker[r={args.tucker_rank}]", device,
                         args.backend)
    print(f"\ncompression: {n1 / 1e6:.2f}M → {n2 / 1e6:.2f}M params "
          f"({n1 / n2:.2f}×); final loss dense {l1:.3f} vs tucker {l2:.3f}")
    assert l1 < f1 and l2 < f2, "both variants must learn"
    return {"dense": (f1, l1, n1), "tucker": (f2, l2, n2)}


if __name__ == "__main__":
    main()
