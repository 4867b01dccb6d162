"""LM side: train-step wall time of every ported architecture, reduced config.

Counterpart of ``benchmarks/bench_lm_step.py`` for the names in
``configs.PORTED_ARCHS`` (Qwen3-14B, DeepSeek-V2-Lite with MLA and MoE,
Qwen3-MoE, Qwen2.5-14B, DeepSeek-67B, StarCoder2-15B, InternVL2-2B and
HuBERT-XLarge), in that order: one ``loss → grad → AdamW`` step
(``launch.steps.make_train_step``) at batch 4 × 64 positions, one warm-up
call and the median of three.  The batch is the reference's train cell
(``launch.steps.input_specs`` and ``concretize``): the vision config's
``num_patches`` patches and 64 − P tokens with labels on the text, the
audio config's 64 frames; every label taken into the vocabulary.  Not a
paper table:
it shows that each ported architecture runs a whole training step, and
gives a relative cost.  At 64 tokens attention takes the dense block
(Sq·Sk ≤ 1024², the reference's branch rule), and the reduced configs have
no Tucker FFN, so the step launches none of the package's kernels; the
flash kernels come in above 1024 tokens (``chip_smoke.py`` phases 11–13).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_lm_step \\
        [--device cpu] [--backend torch]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch

from .common import row, time_call

B, SEQ = 4, 64


def run(device: str | torch.device | None = None,
        backend: str | None = None) -> list[str]:
    from repro_torch.configs import PORTED_ARCHS, ShapeCell, get_config
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw

    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    out = []
    for arch in PORTED_ARCHS:
        cfg = get_config(arch, reduced=True)
        step = S.make_train_step(cfg, adamw.AdamWConfig(), backend)
        state = S.init_train_state(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        batch = S.concretize(
            S.input_specs(cfg, ShapeCell("lm_step", SEQ, B, "train")),
            torch.Generator(device=device).manual_seed(1), device)
        batch["labels"] %= cfg.vocab_size   # HuBERT's reduced head has 64
        us = time_call(lambda: step(state, batch), warmup=1, iters=3)
        out.append(row(f"lm_step/{arch}", us, f"reduced_cfg_B{B}_S{SEQ}"))
    return out


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: cuda | torch (default: "
                         "$REPRO_TORCH_KERNEL_BACKEND or cuda)")
    args = ap.parse_args(argv)
    return run(args.device, args.backend)


if __name__ == "__main__":
    main()
