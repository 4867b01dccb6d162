"""LM serving driver: prefill a batch of prompts, then greedy decode.

Counterpart of ``repro.launch.serve`` (language-model configs only: the
dense Qwen3-14B, Qwen2.5-14B, DeepSeek-67B and StarCoder2-15B, the MoE
models DeepSeek-V2-Lite-16B, with MLA, and Qwen3-MoE-30B-A3B, and
InternVL2-2B on text prompts, as the reference's ``launch/serve.py``
serves it; it does not serve Tucker decompositions).  An encoder-only
config (HuBERT-XLarge) has no decode path and is refused, in the
reference's words; its forward is ``launch.steps.make_encoder_step``, and
a vision prefill with patches is ``make_prefill_step`` on an
``input_specs`` batch.  It keeps the
reference's flags and adds ``--tucker-rank`` (Tucker-compress every FFN
at that rank, as ``examples/train_lm.py`` does), ``--device`` and
``--backend``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --tucker-rank 8 \\
        --device cpu --backend torch

Runs on the CUDA card with the ``"cuda"`` kernels by default (backend:
``--backend`` > ``$REPRO_TORCH_KERNEL_BACKEND`` > ``cuda``); without CUDA
it raises unless ``--device cpu`` is given.  Weights and prompts are
random, drawn on the device from seed 0 (``run(seed=)``); the KV cache is
f32, as in the reference (MLA's is the compressed ``c_kv`` and ``k_pe``).
``run(cfg, ...)`` is the same driver for a config built in code, e.g. one
with ``num_layers`` cut to fit the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import torch

from repro_torch.configs import get_config, require_ported
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.launch import steps as S
from repro_torch.models import init_cache, init_model

log = logging.getLogger("repro_torch.serve")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="LM prefill+decode serving (language-model configs "
                    "only).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
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


def run(cfg, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
        seed: int = 0, device=None, backend: str | None = None,
        params=None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    greedy-decode ``gen`` tokens each (the first from the prefill).

    Returns the timings, the peak device bytes, the generated tokens
    (B, gen), the prefill's last-position logits and whether every logit
    was finite.  ``params`` reuses an already-built model.
    """
    require_ported(cfg)
    if not cfg.has_decode:
        raise ValueError(f"{cfg.arch_id} is encoder-only — no decode path")
    if gen < 1 or prompt_len < 1:
        raise ValueError("--gen and --prompt-len must be >= 1")
    device = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend)
    dispatch.get_backend(backend)  # unknown names raise here
    gen_t = torch.Generator(device=device).manual_seed(seed)
    # prompts first: the same seed gives the same prompts with new or
    # reused weights
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen_t, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if params is None:
        params = init_model(cfg, gen_t, device)
    _sync(device)
    init_s = time.perf_counter() - t0
    caches = init_cache(cfg, batch, prompt_len + gen, dtype=torch.float32,
                        device=device)
    prefill = S.make_prefill_step(cfg, backend)
    decode = S.make_decode_step(cfg, backend)

    t0 = time.perf_counter()
    last_logits, caches = prefill(params, {"tokens": prompts}, caches)
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(last_logits).all())
    log.info("prefill %d×%d in %.3fs", batch, prompt_len, prefill_s)

    out = [tok]
    index = prompt_len
    t1 = time.perf_counter()
    for _ in range(gen - 1):
        tok, caches, index = decode(params, caches, index, {"tokens": tok})
        out.append(tok)
    generated = torch.cat(out, dim=1)
    _sync(device)
    decode_s = time.perf_counter() - t1
    tok_s = batch * (gen - 1) / max(decode_s, 1e-9)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    log.info("decoded %d tokens/seq × %d seqs in %.3fs (%.1f tok/s)",
             gen, batch, decode_s, tok_s)
    log.info("peak device bytes %s; logits finite %s",
             "not measured (CPU)" if peak is None else f"{peak:,}", finite)
    log.info("sample generation: %s", generated[0][:16].tolist())
    return {"init_seconds": init_s, "prefill_seconds": prefill_s,
            "decode_seconds": decode_s, "decode_tokens_per_s": tok_s,
            "peak_device_bytes": peak, "generated": generated.cpu(),
            "last_logits": last_logits, "finite": finite,
            "backend": backend, "device": str(device), "params": params}


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.tucker_rank is not None:
        cfg = dataclasses.replace(cfg, tucker_rank=args.tucker_rank)
    return run(cfg, batch=args.batch, prompt_len=args.prompt_len,
               gen=args.gen, device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
