#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FastTucker on one CUDA card and check it.

    python3 chip_smoke.py [--steps 600] [--nnz 99072112] [--lm-layers 40]
                          [--report PATH]

Phases (each failure ends the run with a non-zero exit code):

1. Environment: the card's name and power limit (``nvidia-smi``), torch and
   nvcc versions, and the parallel ``nvcc`` build of the seven kernel
   sources in ``src/repro_torch/kernels/csrc`` (with ptxas' register
   report).
2. Each kernel against its plain PyTorch version on the card, over
   N ∈ {3, 4}, J = R ∈ {4, 16, 32, 48, 64}, B ∈ {4096, 4099, 262144},
   with masked rows, ``pred_coef = 0``, every phase flag of
   ``kruskal_grad``, bf16 storage, ``kruskal_contract`` with and without
   ``pexc`` (the same ``pred`` bits), and scatter ids outside
   ``[0, rows)``.  Both scatters must match exactly: ``segment_reduce``
   over sorted ids with long runs (rows = 64) and short ones, twice with
   the same bits; ``scatter_accum`` (unsorted) at the three Netflix modes
   (J = 4 and 64), with every id equal, twice with the same bits, and
   equal to ``segment_reduce`` of the stable-sorted batch.  A core pass fed
   the emitted mode products must give the joint core gradient exactly.
   Both scatters also write into memory that last held NaN and must match
   exactly.
3. Three training paths at the paper's size, through
   ``repro_torch.launch.std_train`` on the ``"cuda"`` backend, over one
   planted tensor of the Netflix tensor's published shape (480,189 ×
   17,770 × 2,182, 99,072,112 nonzeros), J_n = R = 4, 10 % held out,
   ``--steps`` SGD steps at batch 4096 each: the unsorted joint step,
   ``--sorted-batches --phase-split``, and ``--sorted-batches --dtype
   bfloat16``.  Held-out RMSE/MAE before and after.  The launch counts are
   set to 0 just before each path and read just after: each path must
   launch the kernels it names and not the scatter it does not use.
   Then two short runs at the reference's wider ranks, over a tensor of
   the same shape cut to ``WIDE_NNZ`` nonzeros: ``--rank 48 --core-rank
   48`` (unsorted) and ``--rank 64 --core-rank 64 --sorted-batches
   --phase-split``, each with finite RMSE/MAE and its kernels launched.
4. Parity on the card: 20 fed-batch steps on ``"cuda"`` against
   ``"torch"`` from the same parameters, for every {jacobi, gauss_seidel}
   × {joint, phase-split} × {unsorted, sorted}, for bf16, and at
   J = R = 64; the sorted jacobi phase-split step must equal the sorted
   joint step bitwise, the unsorted f32 step the sorted one for every
   {order × phase}, and the unsorted step itself when run again.
5. Times at the path's shapes (B = 4096 for the gradient passes and the
   scatters, B = 262,144 for the contraction): median device time per call
   (CUDA events, calls queued behind a sleep so the host's launch latency
   is not in them), the plain version's, ``zeros`` + ``index_add_`` for
   the scatters, and the bound (larger of bytes at 3.35 TB/s and f32 flops
   at 67 TFLOP/s, the H100 SXM's published peaks), for the joint,
   factor-phase, core-phase, Gauss–Seidel and bf16 variants, for the
   scatters at each of the three modes, for the contraction in f32 and
   bf16, each with and without ``pexc`` (``torch.einsum`` of the rows and
   factors as the library call of ``pred`` alone), and for
   ``kruskal_grad`` and ``kruskal_contract`` at J = R = 64.  Beside each,
   the launch floor (the same event-pair time of an empty kernel launched
   through the same ctypes path, ``repro_noop``) and the kernel's own
   device duration from ``torch.profiler``, with the share of the bound
   read from it.
6. ``torch.profiler`` traces of steady training steps of each of the three
   paths: device time per kernel, device operations per step and the
   device's busy share.  Each wrapper launch must be exactly one device
   kernel (``kruskal_grad``, ``segment_reduce`` and ``scatter_accum``
   counted against their wrappers' counts), no ``core_reduce_kernel`` may
   run, and the unsorted path runs no fill kernel at all.
7. The LM's two kernels against their plain versions at the serving
   path's shapes: ``tucker_matmul`` for M ∈ {8192, 4, 8191}, both FFN
   directions (5120 → 17408 and back), x in bf16 and f32 against f32
   factors, ragged K and N at M = 8191; ``flash_attention`` at B·H = 160
   heads over 32 KV heads (G = 5), D = 128, S ∈ {2048, 2047}, causal and
   not, with ``kv_len < Sk`` and ``q_offset > 0``.  Also the training
   backward's dx call, ``tucker_matmul(ȳ, U2, Gᵀ, U1)`` with a random
   (not symmetric) core, at M = 4096 in both FFN directions, ȳ in bf16
   and f32.
8. LM serving at full width: ``repro_torch.launch.serve.run`` on
   Qwen3-14B with every FFN Tucker-compressed at rank 512, ``--lm-layers``
   layers (the published 40 by default; a cut is printed), batch 4, a
   2048-token prompt, 32 greedy tokens, random weights drawn on the card.
   A warm-up request first, then the measured one: prefill seconds,
   decode tokens/s, peak device bytes, finite logits, and launch counts
   that must be 3·L ``tucker_matmul`` per forward call and L
   ``flash_attention`` per prefill.  ``torch.profiler`` traces of one
   prefill and of three decode steps: device time per kernel, device
   operations and the busy share of each window.
9. LM parity at full width and 2 layers (batch 2, prompt 2048, 4 decode
   steps on the same fed tokens): ``"cuda"`` against ``"torch"`` from the
   same weights, prefill and decode logits.
10. The LM kernels' times at the path's shapes, as in phase 5, beside
   their bounds, their plain versions and one library call each (three
   ``torch.matmul``; ``scaled_dot_product_attention`` in f32).  Each
   shape's ``tucker_matmul.plan()`` is printed.  The decode shapes rotate
   over ``COLD_SETS`` distinct factor sets (236 MB, past the 50 MB L2),
   for the kernel, the plain version and the library call alike, so each
   call finds its factors cold as a 40-layer decode step does.  Each
   call's bound is that of the units its kernel runs on: per product, the
   plan's tensor-core passes times its operations at 495 TFLOP/s (3xTF32:
   3 passes, 2 with a bf16 side; flash_attention 3 in both products), or
   its operations at 67 TFLOP/s where the plan streams in f32 fmaf.  The
   f32 bound (all operations at 67 TFLOP/s) is printed beside it; each
   share names the bound it is taken against.  The launch floor is
   measured again beside these rows.
11. The flash backward (``flash_attention_bwd``, 3xTF32 tensor cores)
   against its plain version at the training shape (B = 2, H = 40 over 8
   KV heads, S = 2048, D = 128, causal), at S = 2047, G = 1, D = 64, and
   non-causal with ``kv_len < Sk``: dq, dk and dv each within 2e-5 of that
   output's largest magnitude, two calls bitwise equal, the forward's lse
   within 2e-5 of the plain one.  Its time at the training shape beside
   its bound on the units it runs on (bytes, and the five products'
   operations as 3xTF32 at 495 TFLOP/s, ``bound_ms``) and the f32 bound
   (the same products at the 67 TFLOP/s f32 peak, ``f32_bound_ms``), with
   its share of each; the device time of each of its three kernels (Di,
   dK/dV, dQ) from a short profile; its plain version and the backward of
   ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` in
   f32; the forward with the lse at the same shape.
12. LM training at full width: ``repro_torch.launch.train.run`` on
   Qwen3-14B with rank-512 Tucker FFNs, 8 layers (f32 AdamW state for 40
   layers does not fit 80 GB), batch 2, seq 2048, 20 steps, a checkpoint
   every 16 (asynchronous, the full state: 26.2 GiB at 8 layers, so one
   fits the machine's disk).  Loss and grad norm finite on every step,
   the loss at step 20 below step 1, peak device bytes under 80 GB,
   steps/s and tokens/s, and
   launch counts of exactly 6·L ``tucker_matmul`` (3·L forward, 3·L dx),
   L ``flash_attention`` and L ``flash_attention_bwd`` per step.  One more
   step under ``torch.profiler``: device busy share and the largest
   device items.  Then the resume check: the step-16 checkpoint restored
   into a fresh state, four more steps, losses within 1e-5 relative of
   the uninterrupted run's steps 17–20.
13. Training parity at full width, 2 layers, batch 1, seq 2048:
   ``"cuda"`` against ``"torch"`` from the same state — the loss within
   2⁻⁷ relative, each gradient leaf within 2⁻⁵ of its largest magnitude;
   then one AdamW step from each (lr 1e-3, warmup 1): m and v within 2⁻⁵
   of each leaf's largest, and the parameters within 2⁻⁵ of the lr where
   |g| is past a quarter of its leaf's largest (Adam's first step is
   lr·sign(g) plus weight decay, so a flipped sign fails by 2 and a zero
   gradient by 1).
14. The single-device driver over phase 3's tensor: ``std_train.run``
   with ``--strategy local`` on the unsorted f32 path, ``--steps`` steps
   with a checkpoint at every third of the run (``--ckpt-dir``); a second
   run into another directory stops at two thirds (a kill after its
   second commit), and a fresh ``run`` with ``--resume`` restores that
   and finishes.  Its factors, core factors and generator state must
   equal the uninterrupted run's bitwise, and the uninterrupted run's
   parameters phase 3's unsorted run's.  Then three uncompressed and
   three ``--compress`` (int8 error feedback) runs, alternating: each
   kind repeats its bits, the compressed RMSE is finite and falls at
   every evaluation, its residuals are finite and not all zero, and its
   final RMSE is within ``COMPRESS_GAP`` (relative) of the uncompressed
   run's; the steps/s of each run and the medians' ratio are printed.
   Each run's launch counts (the unsorted path's kernels, no
   ``segment_reduce``), steps/s, and the checkpoints' bytes and seconds.
15. The paper's baselines over the same tensor from one cold init: cuTucker
   SGD (the full core, ``einsum``) for ``--steps`` steps at batch 4096
   (exactly N ``scatter_accum`` launches a step and no other kernel), one
   ALS epoch and one CCD epoch (no kernel; run twice, and whether the two
   epochs give the same bits is printed): seconds, held-out RMSE/MAE
   before and after (must fall) and peak device bytes of each.  Then
   ``bench_accuracy`` at ``FULL`` through the ``"cuda"`` backend, whose
   validator must pass (the paper's two accuracy claims), and cuTucker on
   ``"cuda"`` against ``"torch"``: 20 fed-batch steps from the same
   parameters within the 1e-4 relative of phase 4.
16. Tucker serving (``repro_torch.serve``) of phase 3's unsorted model
   (J = R = 4) and of the rank-64 model of phase 3's wide run, no new
   training: ``predict`` on ``"cuda"`` against a ``"torch"`` server
   (2e-5 of the largest), a request's bits alone and inside a full 2048
   bucket, exactly one ``kruskal_contract`` per bucket chunk and no kernel
   from ``top_k``, ``reconstruct_rows``, ``update_rows`` or
   ``refresh_tables``; ``top_k(mode 0 -> 1, k = 10)`` against a dense f32
   recompute (ids equal where the k-th and (k+1)-th scores differ by more
   than 1e-5) and ``reconstruct_rows`` of four 17,770 x 2,182 slices
   against ``dense_reconstruct`` (2e-5); the reference's FULL closed-loop
   traffic (``benchmarks/bench_serve.py:44-47``: predict at 4,000, 16,000
   and 64,000 q/s offered, top_k at 2,000; 16 clients, microbatch 256,
   3 s each), achieved QPS, p50/p95/p99 and sheds, every admitted request
   answered.  Then a ``RefreshSupervisor`` over the paper's model with
   ``LocalStrategy`` on phase 3's tensor: 4 rounds of 65,536 held-out
   arrivals, K = 4 steps at batch 4096 each, beside a query thread;
   exactly K ``kruskal_grad`` and 3K ``scatter_accum`` a round; the
   patched tables bitwise a fresh server's from the refreshed params; a
   second run under ``FaultPlan.parse("refresh@0:1:2,publish@0")``
   degrades, recovers and ends on the first run's tables, factors and
   generator state bitwise; ``update_rows`` against ``refresh_tables``
   seconds, dirty rows per round and the staleness the queries saw.
   ``kruskal_contract`` (pred only) at B in {256, 2048}, J = R in {4, 64}
   by phase 5's method beside its byte bound and ``torch.einsum``; peak
   device bytes; one profiled closed-loop second (busy share, device
   operations per flush).

It prints a ``{"kernels": [...]}`` line (with ``floor_ms``, the launch
floor, and ``device_ms``, the profiler's device duration where phase 5
took it, beside each kernel), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  ``--report PATH`` also writes the full
record there as JSON.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12   # H100 SXM dense TF32 on the tensor cores
COLD_SETS = 5               # factor sets rotated at decode (5 x 47 MB > L2)
NETFLIX_DIMS = (480_189, 17_770, 2_182)
NETFLIX_NNZ = 99_072_112
TRAIN_BATCH = 4096
EVAL_CHUNK = 262_144
WIDE_NNZ = 2_000_000   # nonzeros of the short runs at ranks 48 and 64
WIDE_STEPS = 20
TOL = {  # max |kernel − plain| / max |plain|, f32, sums in another order
    "kruskal_contract": 2e-5,
    "kruskal_grad.rows": 2e-5,   # pred, err, row grads, emitted c
    "kruskal_grad.core": 1e-4,   # sums over up to 262,144 samples
    "scatter_accum": 0.0,        # ordered fold, no atomics: exact
    "segment_reduce": 0.0,       # ordered fold, no atomics: exact
    "trajectory": 1e-4,          # 20 steps, each op within the above
    "trajectory.bf16": 2.0 ** -6,  # four bf16 ulps (2^-8) at the max
    # 3xTF32 tensor-core tiles (prefill) and f32 streams (decode): f32
    # accuracy, ~1e-6 measured; one pass of TF32 would give ~3e-4 and fail
    "tucker_matmul": 2e-5,
    "flash_attention": 2e-5,     # online against dense softmax, f32
    # bf16 logits: the residual stream rounds to bf16 after every sublayer,
    # so last-bit f32 differences flip roundings; a few ulps of the max
    "lm.logits": 2.0 ** -5,
    # the flash backward: 3xTF32 tensor cores against a dense f32
    # recompute, each of dq, dk, dv against its own largest magnitude
    # (~5e-6 measured; one TF32 pass emulates to ~4e-4 on the CPU)
    "flash_attention_bwd": 2e-5,
    # training, cuda against torch: the loss (f32 log-softmax of bf16
    # logits), each gradient leaf, m and v after one AdamW step against
    # the leaf's largest (a few bf16 ulps, as lm.logits), and the
    # parameters' change against the step's lr
    "lm.loss": 2.0 ** -7,
    "lm.grads": 2.0 ** -5,
    # resumed against uninterrupted losses: the embedding's backward adds
    # with atomics on the card, so not bitwise there
    "lm.resume": 1e-5,
}
LM_RANK = 512        # the largest rank tucker_matmul.py designs for
LM_SERVE = dict(batch=4, prompt_len=2048, gen=32)
LM_PARITY = dict(layers=2, batch=2, prompt_len=2048, gen=4)
# one checkpoint (at step 16): the full f32 state of 8 layers is 26.2 GiB,
# and the GPU machine takes at most 45 GiB of disk writes per call
LM_TRAIN = dict(layers=8, batch=2, seq=2048, steps=20, ckpt_every=16,
                resume_steps=4)
LM_TRAIN_PARITY = dict(layers=2, batch=1, seq=2048)
LM_TRAIN_PARITY_OPT = dict(lr=1e-3, warmup_steps=1)  # the step at full lr
LM_SETTLED = 0.25   # |g| past this share of its leaf's largest: sign settled
BF16_BAND = (1.6, 0.02)  # bf16 RMSE <= 1.6·f32 + 0.02 (the reference's band)
# int8 error feedback: final RMSE within this share of the uncompressed
# run's at the Netflix tensor and 600 steps.  Both trajectories repeat
# their bits on the card; they ended 6.7e-8 apart (H100 80GB HBM3, 700 W),
# and the bound is about 4.5 times that
COMPRESS_GAP = 3e-7
REPLACES = {
    "kruskal_contract": "src/repro/kernels/kruskal_contract.py:30",
    "kruskal_grad": "src/repro/kernels/kruskal_grad.py:83",
    "scatter_accum": "src/repro/kernels/scatter_accum.py:26",
    "segment_reduce": "src/repro/kernels/segment_reduce.py:34",
    "tucker_matmul": "src/repro/kernels/tucker_matmul.py:26",
    "flash_attention": "src/repro/kernels/flash_attention.py:28",
    # no Pallas kernel: the reference's jnp custom-VJP backward
    "flash_attention_bwd": "src/repro/models/flash.py:103",
}
LM_KERNELS = ("tucker_matmul", "flash_attention", "flash_attention_bwd")
# phase 16: the reference's FULL closed-loop traffic
# (benchmarks/bench_serve.py:44-47)
SERVE_LOAD = dict(predict_qps=(4_000.0, 16_000.0, 64_000.0),
                  top_k_qps=2_000.0, concurrency=16, microbatch=256,
                  max_request=64, duration_s=3.0, k=10)
SERVE_POOL = 1_000_000        # held-out tuples the clients draw from
SERVE_REFRESH = dict(rounds=4, arrivals=65_536, steps=4)
SERVE_FAULTS = "refresh@0:1:2,publish@0"
SERVE_TIME_SHAPES = ((256, 4), (2048, 4), (256, 64), (2048, 64))
SERVE_TOP_IDS = 16            # top_k entities checked against dense slices
SERVE_SLICE_IDS = 4           # reconstruct_rows ids (17,770 x 2,182 each)
FLAGS = [
    # (consume c, row_modes, want_core, emit_c) of kruskal_grad
    (False, None, True, False),     # the joint pass
    (False, None, False, True),     # factor phase: emit the mode products
    (True, (), True, False),        # core phase: consume them
    (True, (1,), False, False),     # Gauss-Seidel: one mode's rows
    (False, (2, 0), True, True),
    (True, (0, 1, 2), False, True),
]
# name -> (std_train flags, kernels it must launch, kernels it must not)
WIDE_PATHS = {
    "rank48": (["--rank", "48", "--core-rank", "48"],
               ("kruskal_contract", "kruskal_grad", "scatter_accum"),
               ("segment_reduce",)),
    "rank64_sorted_phase_split": (
        ["--rank", "64", "--core-rank", "64", "--sorted-batches",
         "--phase-split"],
        ("kruskal_contract", "kruskal_grad", "segment_reduce"),
        ("scatter_accum",)),
}
# name -> (extra std_train flags, kernels it must launch, kernels it must not)
PATHS = {
    "unsorted": ([], ("kruskal_contract", "kruskal_grad", "scatter_accum"),
                 ("segment_reduce",)),
    "sorted_phase_split": (
        ["--sorted-batches", "--phase-split"],
        ("kruskal_contract", "kruskal_grad", "segment_reduce"),
        ("scatter_accum",)),
    "sorted_bf16": (
        ["--sorted-batches", "--dtype", "bfloat16"],
        ("kruskal_contract", "kruskal_grad", "segment_reduce"),
        ("scatter_accum",)),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> tuple[float, float]:
    """(max |got − want|, that over max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err, err / scale if scale > 0 else err


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_environment(torch, build) -> dict:
    smi = nvidia_smi_line()
    log(smi)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    import numpy

    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc}; "
        f"numpy {numpy.__version__}")
    log(f"card: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    secs = build.build()
    wall = time.perf_counter() - t0
    log(f"kernel build (one nvcc per source, in parallel): {wall:.1f}s wall; "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    ptxas = {}
    for name in build.SOURCES:
        logf = build.library_path(name).with_suffix(".log")
        lines = [ln.strip() for ln in logf.read_text().splitlines()
                 if "registers" in ln or "spill" in ln] if logf.exists() \
            else []
        ptxas[name] = lines
        for ln in lines:
            log(f"  ptxas {name}: {ln}")
    return {"nvidia_smi": smi, "nvcc": nvcc, "torch": torch.__version__,
            "build_seconds": secs, "build_wall_seconds": wall,
            "ptxas": ptxas}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase_kernels_vs_plain(torch, K) -> dict:
    ref = K.ref
    kc = K.kruskal_contract.kruskal_contract
    kg = K.kruskal_grad.kruskal_grad
    sa = K.scatter_accum.scatter_accum
    sr = K.segment_reduce.segment_reduce
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = {k: [0.0, 0.0] for k in TOL
             if k.split(".")[0] in ("kruskal_contract", "kruskal_grad",
                                    "scatter_accum", "segment_reduce")}

    def record(key, got, want, what):
        e, r = rel_err(got, want)
        worst[key][0] = max(worst[key][0], e)
        worst[key][1] = max(worst[key][1], r)
        if not r <= TOL[key]:
            raise AssertionError(f"{key} {what}: max abs err {e:.3g}, "
                                 f"relative {r:.3g} > {TOL[key]}")

    def record_grad(got, want, tag):
        for i, part in enumerate(("pred", "err", "row grads", "core grads",
                                  "c")):
            if (got[i] is None) != (want[i] is None):
                raise AssertionError(f"kruskal_grad {tag}: {part} is "
                                     "missing on one side")
            if got[i] is not None:
                if got[i].dtype != torch.float32:
                    raise AssertionError(f"kruskal_grad {tag}: {part} is "
                                         f"{got[i].dtype}")
                key = "kruskal_grad.core" if i == 3 else "kruskal_grad.rows"
                record(key, got[i], want[i], f"{tag} {part}")

    cases = 0
    for N in (3, 4):
        for JR in (4, 16, 32, 48, 64):
            for B in (4096, 4099, 262_144):
                what = f"N={N} J=R={JR} B={B}"
                a = 0.5 * torch.randn((N, B, JR), generator=gen, device=dev)
                b = 0.5 * torch.randn((N, JR, JR), generator=gen, device=dev)
                a16, b16 = a.bfloat16(), b.bfloat16()
                for x, y, st in ((a, b, "f32"), (a16, b16, "bf16")):
                    pred, pexc = kc(x, y)
                    pred_r, pexc_r = ref.kruskal_contract_ref(x, y)
                    record("kruskal_contract", pred, pred_r,
                           f"{what} {st} pred")
                    record("kruskal_contract", pexc, pexc_r,
                           f"{what} {st} pexc")
                    only, none = kc(x, y, want_pexc=False)
                    if none is not None or not torch.equal(only, pred):
                        raise AssertionError(f"kruskal_contract {what} {st}:"
                                             " pred differs without pexc")

                val = torch.randn((B,), generator=gen, device=dev)
                mask = (torch.rand((B,), generator=gen, device=dev)
                        > 0.1).float()                  # masked rows
                for pred_coef in (1.0, 0.0):            # 0: autograd pass
                    scal = torch.tensor(
                        [1.0, 1.0 / max(mask.sum().item(), 1.0), 0.01, 0.02,
                         pred_coef], dtype=torch.float32, device=dev)
                    record_grad(kg(a, b, val, mask, scal),
                                ref.kruskal_grad_ref(a, b, val, mask, scal),
                                f"{what} pred_coef={pred_coef}")
                # every phase flag, f32 and bf16 storage
                for consume, row_modes, want_core, emit_c in FLAGS[1:]:
                    for x, y, st in ((a, b, "f32"), (a16, b16, "bf16")):
                        flags = dict(row_modes=row_modes, want_core=want_core,
                                     emit_c=emit_c)
                        cc = (torch.bmm(x.float(), y.float())
                              if consume else None)
                        record_grad(kg(x, y, val, mask, scal, cc, **flags),
                                    ref.kruskal_grad_ref(x, y, val, mask,
                                                         scal, cc, **flags),
                                    f"{what} {st} flags={flags} "
                                    f"c={'in' if consume else 'none'}")
                record_grad(kg(a16, b16, val, mask, scal),
                            ref.kruskal_grad_ref(a16, b16, val, mask, scal),
                            f"{what} bf16 joint")
                # a core pass fed the emitted c is the joint one, exactly
                joint = kg(a, b, val, mask, scal)
                fac = kg(a, b, val, mask, scal, want_core=False, emit_c=True)
                core = kg(a, b, val, mask, scal, fac.c, row_modes=())
                if not (torch.equal(core.core_grads, joint.core_grads)
                        and torch.equal(fac.row_grads, joint.row_grads)):
                    raise AssertionError(f"{what}: the phase passes differ "
                                         "from the joint pass")

                rows = max(64, B // 8)
                g = torch.randn((B, JR), generator=gen, device=dev)
                idx = torch.randint(-5, rows + 5, (B,), generator=gen,
                                    device=dev, dtype=torch.int32)
                record("scatter_accum", sa(g, idx, rows),
                       ref.scatter_accum_ref(g, idx, rows),
                       f"{what} rows={rows} (ids outside [0, rows))")
                for srows in (64, B):     # long runs, then short ones
                    sidx = torch.randint(-5, srows + 5, (B,), generator=gen,
                                         device=dev, dtype=torch.int32)
                    sidx = torch.sort(sidx, stable=True).values
                    got = sr(g, sidx, srows)
                    again = sr(g, sidx, srows)
                    record("segment_reduce", got,
                           ref.segment_reduce_ref(g, sidx, srows),
                           f"{what} rows={srows}")
                    if not torch.equal(got, again):
                        raise AssertionError(f"segment_reduce {what}: two "
                                             "launches gave other bits")
                cases += 1
    # the training path's scatters at the three Netflix modes: the unsorted
    # kernel exact, twice the same bits, and equal to the sorted kernel
    # over the stable-sorted batch (what makes the two steps equal)
    for rows_n in NETFLIX_DIMS:
        for J in (4, 64):
            what = f"Netflix mode rows={rows_n} J={J}"
            g = torch.randn((TRAIN_BATCH, J), generator=gen, device=dev)
            for tag, idx in (
                    ("", torch.randint(0, rows_n, (TRAIN_BATCH,),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)),
                    (" ids outside [0, rows)",
                     torch.randint(-5, rows_n + 5, (TRAIN_BATCH,),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)),
                    (" every id equal",
                     torch.full((TRAIN_BATCH,), rows_n // 2, device=dev,
                                dtype=torch.int32))):
                got = sa(g, idx, rows_n)
                record("scatter_accum", got,
                       ref.scatter_accum_ref(g, idx, rows_n), what + tag)
                if not torch.equal(sa(g, idx, rows_n), got):
                    raise AssertionError(f"scatter_accum {what}{tag}: two "
                                         "launches gave other bits")
                sidx, perm = torch.sort(idx, stable=True)
                gp = g[perm]
                record("segment_reduce", sr(gp, sidx, rows_n),
                       ref.segment_reduce_ref(gp, sidx, rows_n), what + tag)
                if not torch.equal(sr(gp, sidx, rows_n), got):
                    raise AssertionError(f"{what}{tag}: the unsorted and "
                                         "the sorted scatter differ")
    # both kernels write every row themselves: memory that held NaN shows
    # none (mode 0 of the Netflix shape)
    g = torch.randn((TRAIN_BATCH, 4), generator=gen, device=dev)
    idx = torch.randint(0, NETFLIX_DIMS[0], (TRAIN_BATCH,), generator=gen,
                        device=dev, dtype=torch.int32)
    sidx, perm = torch.sort(idx, stable=True)
    gp = g[perm]
    for key, fn, want in (
            ("segment_reduce", lambda: sr(gp, sidx, NETFLIX_DIMS[0]),
             ref.segment_reduce_ref(gp, sidx, NETFLIX_DIMS[0])),
            ("scatter_accum", lambda: sa(g, idx, NETFLIX_DIMS[0]),
             ref.scatter_accum_ref(g, idx, NETFLIX_DIMS[0]))):
        nan = torch.full((NETFLIX_DIMS[0], 4), math.nan, device=dev)
        nan_ptr = nan.data_ptr()
        del nan
        got = fn()
        if got.data_ptr() != nan_ptr:
            raise AssertionError(f"{key}: the output did not reuse the NaN "
                                 "block, so the check would not test it")
        record(key, got, want, "Netflix mode 0 into NaN memory")
        del got
    torch.cuda.synchronize()
    for key, (e, r) in worst.items():
        log(f"{key}: max abs err {e:.3g}, max relative err {r:.3g} "
            f"(tolerance {TOL[key]}) over {cases} shapes")
    log(f"kruskal_grad: {len(FLAGS)} flag combinations x f32/bf16; the core "
        "pass fed emitted c equals the joint core gradient bitwise")
    log("kruskal_contract: pred the same bits with and without pexc")
    log("segment_reduce, scatter_accum: into memory that held NaN (the same "
        "block), equal to the plain version bitwise; scatter_accum equal to "
        "segment_reduce of the stable-sorted batch at the Netflix modes")
    return {k: {"max_abs_err": e, "max_rel_err": r, "tol": TOL[k]}
            for k, (e, r) in worst.items()}


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_slice(torch, K, std_train, steps: int, nnz: int) -> dict:
    if nnz != NETFLIX_NNZ:
        log(f"CUT: {nnz:,} nonzeros instead of the Netflix tensor's "
            f"{NETFLIX_NNZ:,}")
    base = ["--dims", ",".join(map(str, NETFLIX_DIMS)), "--nnz", str(nnz),
            "--rank", "4", "--core-rank", "4", "--steps", str(steps),
            "--batch", str(TRAIN_BATCH), "--eval-every",
            str(max(steps // 2, 1)), "--seed", "0", "--backend", "cuda",
            "--device", "cuda"]
    out = {}
    data = None
    for name, (flags, must, must_not) in PATHS.items():
        args = std_train.parse_args(base + flags)
        K.reset_launch_counts()
        res = std_train.run(args, data)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        data = (res["train"], res["test"])
        hist = res["history"]
        log(f"path {name} ({' '.join(flags) or 'defaults'}): data "
            f"{res['data_seconds']:.1f}s, {steps} steps at "
            f"{res['steps_per_s']:.1f} steps/s = {res['nnz_per_s']:.4g} "
            f"nnz/s, peak device bytes {res['peak_device_bytes']:,}")
        log(f"path {name}: rmse " + " -> ".join(
            f"{h['rmse']:.5f}@{h['step']}" for h in hist))
        log(f"path {name}: launch counts {counts}")
        if not all(math.isfinite(h["rmse"]) and math.isfinite(h["mae"])
                   for h in hist):
            raise AssertionError(f"{name}: non-finite RMSE/MAE: {hist}")
        if not hist[-1]["rmse"] < hist[0]["rmse"]:
            raise AssertionError(f"{name}: RMSE did not drop: {hist}")
        missing = [k for k in must if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched on the "
                                 f"path: {missing}")
        stray = [k for k in must_not if counts[k] != 0]
        if stray:
            raise AssertionError(f"{name}: launched {stray}, which this "
                                 "path does not use")
        out[name] = {"result": res, "counts": counts}
    r16 = out["sorted_bf16"]["result"]["history"][-1]["rmse"]
    r32 = out["sorted_phase_split"]["result"]["history"][-1]["rmse"]
    scale, shift = BF16_BAND
    log(f"bf16 band: final rmse {r16:.5f} (bf16) against {r32:.5f} (f32); "
        f"band {scale} x f32 + {shift} = {scale * r32 + shift:.5f}")
    if not r16 <= scale * r32 + shift:
        raise AssertionError(f"bf16 RMSE {r16} outside the band of the f32 "
                             f"run {r32}")
    return out


def phase_wide(torch, K, std_train) -> tuple[dict, object]:
    """Short runs at ranks 48 and 64 on the card (the reference's workloads
    use N = 3 at those ranks): finite RMSE/MAE, and the kernels of each
    path launched at that width.  Returns the record and the rank-64 run's
    final parameters, which phase 16 serves."""
    log(f"CUT: {WIDE_NNZ:,} nonzeros and {WIDE_STEPS} steps for the runs at "
        "ranks 48 and 64")
    base = ["--dims", ",".join(map(str, NETFLIX_DIMS)), "--nnz",
            str(WIDE_NNZ), "--steps", str(WIDE_STEPS), "--batch",
            str(TRAIN_BATCH), "--eval-every", str(WIDE_STEPS // 2), "--seed",
            "0", "--backend", "cuda", "--device", "cuda"]
    out = {}
    for name, (flags, must, must_not) in WIDE_PATHS.items():
        args = std_train.parse_args(base + flags)
        K.reset_launch_counts()
        res = std_train.run(args)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        hist = res["history"]
        log(f"wide {name} ({' '.join(flags)}): {WIDE_STEPS} steps at "
            f"{res['steps_per_s']:.1f} steps/s; rmse " + " -> ".join(
                f"{h['rmse']:.5f}@{h['step']}" for h in hist)
            + f"; launch counts {counts}")
        if not all(math.isfinite(h["rmse"]) and math.isfinite(h["mae"])
                   for h in hist):
            raise AssertionError(f"wide {name}: non-finite RMSE/MAE: {hist}")
        missing = [k for k in must if counts[k] <= 0]
        stray = [k for k in must_not if counts[k] != 0]
        if missing or stray:
            raise AssertionError(f"wide {name}: not launched {missing}, "
                                 f"launched but not on the path {stray}")
        out[name] = {"history": hist, "steps_per_s": res["steps_per_s"],
                     "launch_counts": counts,
                     "peak_device_bytes": res["peak_device_bytes"]}
        if name == "rank64_sorted_phase_split":
            kept = res["state"].params
        del res
        torch.cuda.empty_cache()
    return out, kept


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def phase_parity(torch, ft, res) -> dict:
    from repro_torch.core.sampling import sample_batch_arrays

    train_t = res["train"]
    start = res["state"]
    cfg0 = res["cfg"]
    gen = torch.Generator(device="cuda").manual_seed(99)
    batches = [sample_batch_arrays(gen, train_t.indices, train_t.values,
                                   TRAIN_BATCH) for _ in range(20)]
    combos = [dict(update_order=o, phase_split=p, sorted_batches=s)
              for o in ("jacobi", "gauss_seidel") for p in (False, True)
              for s in (False, True)]
    combos += [dict(dtype="bfloat16"),
               dict(dtype="bfloat16", sorted_batches=True, phase_split=True)]
    out = {}
    finals = {}
    for kw in combos:
        dtype = kw.get("dtype", "float32")
        runs = {}
        for backend in ("cuda", "torch"):
            cfg = ft.FastTuckerConfig(
                dims=cfg0.dims, ranks=cfg0.ranks, core_rank=cfg0.core_rank,
                batch_size=TRAIN_BATCH, backend=backend, **kw)
            st = ft.TrainState(ft.FastTuckerParams(
                tuple(t.to(cfg.param_dtype) for t in start.params.factors),
                tuple(t.to(cfg.param_dtype)
                      for t in start.params.core_factors)), 0)
            for idx, val in batches:
                st = ft.sgd_step_batch(st, idx, val, cfg)
            runs[backend] = st.params
        torch.cuda.synchronize()
        worst = worst_abs = 0.0
        for got, want in zip(runs["cuda"].factors + runs["cuda"].core_factors,
                             runs["torch"].factors
                             + runs["torch"].core_factors):
            e, r = rel_err(got, want)
            worst, worst_abs = max(worst, r), max(worst_abs, e)
        tol = TOL["trajectory.bf16" if dtype == "bfloat16" else "trajectory"]
        tag = ",".join(f"{k}={v}" for k, v in kw.items())
        log(f"parity {tag}: 20 fed-batch steps cuda vs torch: max abs diff "
            f"{worst_abs:.3g}, max relative diff {worst:.3g} "
            f"(tolerance {tol:.3g})")
        if not worst <= tol:
            raise AssertionError(f"trajectory {tag} differs: {worst:.3g}")
        out[tag] = {"max_rel_diff": worst, "max_abs_diff": worst_abs}
        finals[tag] = runs["cuda"]

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(
            x.factors + x.core_factors, y.factors + y.core_factors))

    split = finals["update_order=jacobi,phase_split=True,sorted_batches=True"]
    joint = finals["update_order=jacobi,phase_split=False,sorted_batches=True"]
    if not same(split, joint):
        raise AssertionError("sorted phase-split differs from sorted joint "
                             "on the card")
    gs_same = same(
        finals["update_order=gauss_seidel,phase_split=True,"
               "sorted_batches=True"],
        finals["update_order=gauss_seidel,phase_split=False,"
               "sorted_batches=True"])
    log("parity: on cuda, sorted jacobi phase-split == sorted joint bitwise; "
        f"sorted gauss_seidel phase-split == joint bitwise: {gs_same}")
    out["sorted_split_equals_joint_bitwise"] = True
    out["sorted_gauss_seidel_split_equals_joint_bitwise"] = gs_same
    # the unsorted f32 step is the sorted one, bit for bit, in every form
    for o in ("jacobi", "gauss_seidel"):
        for p in (False, True):
            tag = f"update_order={o},phase_split={p}"
            if not same(finals[f"{tag},sorted_batches=False"],
                        finals[f"{tag},sorted_batches=True"]):
                raise AssertionError(f"{tag}: the unsorted step differs "
                                     "from the sorted one on the card")
    # and repeats itself
    cfg = ft.FastTuckerConfig(dims=cfg0.dims, ranks=cfg0.ranks,
                              core_rank=cfg0.core_rank,
                              batch_size=TRAIN_BATCH, backend="cuda")
    st = ft.TrainState(start.params, 0)
    for idx, val in batches:
        st = ft.sgd_step_batch(st, idx, val, cfg)
    if not same(st.params, finals["update_order=jacobi,phase_split=False,"
                                  "sorted_batches=False"]):
        raise AssertionError("the unsorted step gave other bits when run "
                             "again")
    log("parity: on cuda, the unsorted f32 step == the sorted one bitwise "
        "for every {jacobi, gauss_seidel} x {joint, phase-split}, over 20 "
        "fed batches; the unsorted step repeats itself bitwise")
    out["unsorted_equals_sorted_bitwise"] = True
    out["unsorted_repeats_bitwise"] = True
    # cuda against torch at J = R = 64 from one fresh start
    wide = {}
    for backend in ("cuda", "torch"):
        cfg = ft.FastTuckerConfig(dims=cfg0.dims, ranks=(64,) * cfg0.order,
                                  core_rank=64, batch_size=TRAIN_BATCH,
                                  backend=backend)
        st = ft.TrainState(ft.init_params(
            torch.Generator(device="cuda").manual_seed(64), cfg, "cuda"), 0)
        for idx, val in batches:
            st = ft.sgd_step_batch(st, idx, val, cfg)
        wide[backend] = st.params
    torch.cuda.synchronize()
    worst = worst_abs = 0.0
    for got, want in zip(wide["cuda"].factors + wide["cuda"].core_factors,
                         wide["torch"].factors + wide["torch"].core_factors):
        e, r = rel_err(got, want)
        worst, worst_abs = max(worst, r), max(worst_abs, e)
    log(f"parity J=R=64: 20 fed-batch steps cuda vs torch: max abs diff "
        f"{worst_abs:.3g}, max relative diff {worst:.3g} (tolerance "
        f"{TOL['trajectory']:.3g})")
    if not worst <= TOL["trajectory"]:
        raise AssertionError(f"trajectory at J=R=64 differs: {worst:.3g}")
    out["J=R=64"] = {"max_rel_diff": worst, "max_abs_diff": worst_abs}
    return out


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def host_ms(torch, fn, iters: int = 20) -> float:
    """Host time to issue one ``fn()`` call, in ms (the device drained
    before and after; a call that waits for the device includes that)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def device_ms(torch, fn, iters: int = 100) -> float:
    """Median device time of one ``fn()`` call, in ms.

    All calls and their event pairs are queued behind a device-side sleep
    long enough to cover the host's time to issue them all (twice the
    measured issue time, at least ~0.1 s), so the card runs them back to
    back and an event pair spans only the call's own kernels, not the
    host's launch latency (unless ``fn`` itself waits for the device, as
    the plain ``segment_reduce`` does).
    """
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    issue_s = host_ms(torch, fn, 5) * 1e-3 * iters
    torch.cuda._sleep(int(min(max(2e8, 2 * issue_s * 2e9), 4e10)))
    for s, e in evs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def floor_ms(torch, build) -> float:
    """The launch floor: ``device_ms`` of an empty kernel launched through
    the same ctypes path as the kernels (``repro_noop`` in common.cuh)."""
    fn = build.function("segment_reduce", "repro_noop", [ctypes.c_void_p])

    def call():
        with torch.cuda.device(0):
            build.check("segment_reduce",
                        fn(torch.cuda.current_stream().cuda_stream))
    return device_ms(torch, call)


# the flash backward's three device kernels (Di, dK/dV, dQ), as
# torch.profiler names them (not cuBLAS's dot_kernel)
BWD_KERNELS = ("namespace)::dot_kernel", "namespace)::dkdv_kernel",
               "namespace)::dq_kernel")
# the device kernel of each wrapper, as torch.profiler names it
DEVICE_KERNEL = {
    "kruskal_grad": "kruskal_grad_kernel",
    "scatter_accum": "scatter_accum_kernel",
    "segment_reduce": "segment_reduce_kernel",
    "kruskal_contract": "contract_",
}


def profiled_ms(torch, fn, key: str, calls: int = 20) -> float | None:
    """Median device duration of the kernel named ``key`` over ``calls``
    calls of ``fn``, from ``torch.profiler`` (the kernel alone, without the
    launch floor the event method includes).  A trace that did not record
    one such kernel per call is taken again, three times at most; None
    where none did."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        durs = [ev.time_range.elapsed_us() for ev in prof.events()
                if "CUDA" in str(ev.device_type) and key in ev.name]
        if len(durs) == calls:
            return statistics.median(durs) * 1e-3
    return None


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bound(bytes_moved: float,
             products: list[tuple[int, float]]) -> tuple[float, str]:
    """The bound of f32-accurate work as the kernel lays it out: each
    product's (passes, operations), where ``passes`` tensor-core TF32
    products stand for one f32 product at the 495 TFLOP/s TF32 peak, and
    0 passes means f32 fmaf at the 67 TFLOP/s f32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n * f / TF32_FLOPS_PER_S if n else f / F32_FLOPS_PER_S
                for n, f in products) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grad_cost(N, B, J, R, st, nrow, core, c_in, c_out) -> tuple[int, int]:
    """(bytes, flops) one kruskal_grad call must move and do: inputs read
    once (rows and factors in ``st`` bytes), outputs written once."""
    nbytes = st * (N * B * J + N * J * R) + 4 * (2 * B + 5) + 4 * 2 * B
    flops = 3 * N * B * R + 2 * B * R + 4 * B   # chains, pred, err
    if c_in:
        nbytes += 4 * N * B * R
    else:
        flops += 2 * N * B * J * R              # the N mode dots
    if c_out:
        nbytes += 4 * N * B * R
    nbytes += 4 * nrow * B * J
    flops += nrow * B * (2 * J * R + 4 * J)     # Eq. 13 rows
    if core:
        nbytes += 4 * N * J * R
        flops += N * B * (2 * J * R + R) + 2 * N * J * R  # Eq. 17 + seed
    return nbytes, flops


def phase_times(torch, K, ft, res, counts) -> list[dict]:
    from repro_torch.core.sampling import (sample_batch_arrays,
                                           sorted_batch_order)
    from repro_torch.kernels.dispatch import (_kernel_scalars,
                                              _stack_padded_factors,
                                              _stack_padded_rows)

    ref = K.ref
    kg = K.kruskal_grad.kruskal_grad
    params = res["state"].params
    train_t, test_t = res["train"], res["test"]
    cfg = res["cfg"]
    N, J, R = cfg.order, cfg.ranks[0], cfg.core_rank
    gen = torch.Generator(device="cuda").manual_seed(7)
    idx, val = sample_batch_arrays(gen, train_t.indices, train_t.values,
                                   TRAIN_BATCH)
    a = _stack_padded_rows(ft.gather_rows(params.factors, idx))
    b = _stack_padded_factors(params.core_factors)
    a16, b16 = a.bfloat16(), b.bfloat16()
    mask = torch.ones_like(val)
    scal = _kernel_scalars(TRAIN_BATCH, None, False, True, cfg.lambda_a,
                           cfg.lambda_b, 1.0, val.device)
    eidx = test_t.indices[:EVAL_CHUNK]
    ea = _stack_padded_rows(ft.gather_rows(params.factors, eidx))
    Be = ea.shape[1]
    joint = kg(a, b, val, mask, scal)
    c = kg(a, b, val, mask, scal, want_core=False, emit_c=True).c
    cols = idx.t().contiguous()
    lay = sorted_batch_order(idx)
    torch.cuda.synchronize()
    B = TRAIN_BATCH
    out = []
    floor = floor_ms(torch, K.build)

    # kruskal_grad: the joint pass first (the row the kernels line takes)
    variants = [
        ("joint", dict(), a, b, None, N, True, False,
         "1 per unsorted or sorted joint step; 1 per autograd backward"),
        ("factor phase (want_core=False, emit_c)",
         dict(want_core=False, emit_c=True), a, b, None, N, False, True,
         "1 per phase-split step"),
        ("core phase (c=, row_modes=())", dict(row_modes=()), a, b, c, 0,
         True, False, "1 per phase-split step"),
        ("Gauss-Seidel mode (c=, row_modes=(0,), want_core=False)",
         dict(row_modes=(0,), want_core=False), a, b, c, 1, False, False,
         "N per Gauss-Seidel phase-split step"),
        ("joint, bf16 storage", dict(), a16, b16, None, N, True, False,
         "1 per bf16 step"),
    ]
    for tag, flags, x, y, cc, nrow, core, emit, per in variants:
        ms = device_ms(torch, lambda: kg(x, y, val, mask, scal, cc, **flags))
        plain = device_ms(torch, lambda: ref.kruskal_grad_ref(
            x, y, val, mask, scal, cc, **flags))
        t_b, by = bound(*grad_cost(N, B, J, R, x.element_size(), nrow, core,
                                   cc is not None, emit))
        dev_ms = profiled_ms(torch, lambda: kg(x, y, val, mask, scal, cc,
                                               **flags),
                             DEVICE_KERNEL["kruskal_grad"])
        out.append(("kruskal_grad", tag, ms, plain, None, t_b, by, per,
                    dev_ms))

    # scatter_accum and segment_reduce at every mode, mode 0 (the widest:
    # 480,189 rows) first, the row the kernels line takes
    for n in range(N):
        rows_n = cfg.dims[n]
        gn = joint.row_grads[n].contiguous()
        gsn = gn.index_select(0, lay.perm[n])
        t_b, by = bound(4 * (B * J + B + rows_n * J), B * J)
        for name, kernel, plain_fn, g_, ids, plain_iters, per in (
                ("scatter_accum", K.scatter_accum.scatter_accum,
                 ref.scatter_accum_ref, gn, cols[n], 30, "unsorted"),
                ("segment_reduce", K.segment_reduce.segment_reduce,
                 ref.segment_reduce_ref, gsn, lay.sorted_rows[n], 30,
                 "sorted")):
            ms = device_ms(torch, lambda: kernel(g_, ids, rows_n))
            plain = device_ms(torch, lambda: plain_fn(g_, ids, rows_n),
                              iters=plain_iters)
            long_ids = ids.long()
            lib = device_ms(torch, lambda: torch.zeros(
                (rows_n, J), device="cuda").index_add_(0, long_ids, g_))
            dev_ms = profiled_ms(torch, lambda: kernel(g_, ids, rows_n),
                                 DEVICE_KERNEL[name])
            out.append((name, f"mode {n}, {rows_n:,} rows", ms, plain, lib,
                        t_b, by, f"1 per mode per {per} step", dev_ms))

    # kruskal_contract at the evaluation chunk, f32 and bf16, pred alone
    # (what evaluation and predict ask for: the row the kernels line
    # takes) and with pexc; one torch.einsum of the rows and factors is the
    # library call of pred alone (no one call returns pred and pexc)
    per_eval = (f"{math.ceil(test_t.nnz / EVAL_CHUNK)} per evaluation (one "
                "per 262,144-row chunk)")
    letters = "ijklmnopq"[:N]
    expr = (",".join(f"b{c}" for c in letters) + ","
            + ",".join(f"{c}r" for c in letters) + "->b")
    for tag, x, y in (("f32, pred only", ea, b),
                      ("f32, with pexc", ea, b),
                      ("bf16 storage, pred only", ea.bfloat16(), b16),
                      ("bf16 storage, with pexc", ea.bfloat16(), b16)):
        want_pexc = "pexc" in tag
        ms = device_ms(torch, lambda: K.kruskal_contract.kruskal_contract(
            x, y, want_pexc))
        plain = device_ms(torch, lambda: ref.kruskal_contract_ref(x, y))
        lib = None
        if not want_pexc:
            xs = [x[n].float() for n in range(N)]
            ys = [y[n].float() for n in range(N)]
            lib = device_ms(torch, lambda: torch.einsum(expr, *xs, *ys),
                            iters=30)
        st = x.element_size()
        nbytes = st * (N * Be * J + N * J * R) + 4 * Be
        if want_pexc:
            nbytes += 4 * N * Be * R
        t_b, by = bound(nbytes,
                        2 * N * Be * J * R + 3 * N * Be * R + 2 * Be * R)
        dev_ms = profiled_ms(torch, lambda: K.kruskal_contract
                             .kruskal_contract(x, y, want_pexc),
                             DEVICE_KERNEL["kruskal_contract"])
        out.append(("kruskal_contract", tag, ms, plain, lib, t_b, by,
                    per_eval + (" (evaluation and predict ask for pred "
                                "alone)" if not want_pexc else
                                "; not on the paths"), dev_ms))

    # kruskal_grad and kruskal_contract at J = R = 64 (the reference's
    # widest workload rank), N = 3
    JW = 64
    aw = 0.5 * torch.randn((N, B, JW), generator=gen, device="cuda")
    bw = torch.randn((N, JW, JW), generator=gen, device="cuda") / JW
    ms = device_ms(torch, lambda: kg(aw, bw, val, mask, scal))
    plain = device_ms(torch, lambda: ref.kruskal_grad_ref(aw, bw, val, mask,
                                                          scal))
    t_b, by = bound(*grad_cost(N, B, JW, JW, 4, N, True, False, False))
    dev_ms = profiled_ms(torch, lambda: kg(aw, bw, val, mask, scal),
                         DEVICE_KERNEL["kruskal_grad"])
    out.append(("kruskal_grad", f"joint, J = R = {JW}", ms, plain, None,
                t_b, by, "1 per step at --rank 64; not on the paths", dev_ms))
    aw = 0.5 * torch.randn((N, Be, JW), generator=gen, device="cuda")
    ms = device_ms(torch, lambda: K.kruskal_contract.kruskal_contract(
        aw, bw))
    plain = device_ms(torch, lambda: ref.kruskal_contract_ref(aw, bw))
    t_b, by = bound(4 * (N * Be * JW + N * JW * JW) + 4 * (Be + N * Be * JW),
                    2 * N * Be * JW * JW + 3 * N * Be * JW + 2 * Be * JW)
    dev_ms = profiled_ms(torch, lambda: K.kruskal_contract.kruskal_contract(
        aw, bw), DEVICE_KERNEL["kruskal_contract"])
    out.append(("kruskal_contract", f"f32, with pexc, J = R = {JW}", ms,
                plain, None, t_b, by, "not on the paths", dev_ms))
    del aw, bw

    rows_out = []
    log(f"launch floor (an empty kernel through ctypes): "
        f"{floor * 1e3:.2f} us")
    for name, tag, ms, plain, lib, t_b, by, per, dev_ms in out:
        library = ("torch.einsum" if name == "kruskal_contract"
                   else "zeros + index_add_")
        log(f"{name} [{tag}]: {ms * 1e3:.2f} us/call (plain "
            f"{plain * 1e3:.2f} us"
            + (f", {library} {lib * 1e3:.2f} us" if lib is not None else "")
            + f"), bound {t_b * 1e3:.3f} us by {by} ({t_b / ms:.1%} of the "
            "event time), launch floor "
            f"{floor * 1e3:.2f} us; profiler device duration "
            + (f"{dev_ms * 1e3:.2f} us ({t_b / dev_ms:.1%} of it is the "
               "bound)" if dev_ms else "not measured")
            + f"; launches on the paths {counts[name]}; {per}")
        rows_out.append({"name": name, "variant": tag, "ms": ms,
                         "plain_ms": plain, "library_ms": lib,
                         "bound_ms": t_b, "bound_by": by, "floor_ms": floor,
                         "device_ms": dev_ms, "launches_note": per})
    return rows_out


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

def phase_profile(torch, K, ft, res, cfg, steps: int = 50) -> dict:
    from torch.profiler import ProfilerActivity, profile

    train_t = res["train"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    st = res["state"]
    for _ in range(10):
        st = ft.sgd_step(st, gen, train_t.indices, train_t.values, cfg)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            st = ft.sgd_step(st, gen, train_t.indices, train_t.values, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = K.launch_counts()
    kernels = {}
    for ev in prof.events():
        if "CUDA" in str(ev.device_type):   # a kernel or copy on the card
            kernels.setdefault(ev.name, [0, 0.0])
            kernels[ev.name][0] += 1
            kernels[ev.name][1] += ev.time_range.elapsed_us()
    busy_us = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:14]
    tag = (f"phase_split={cfg.phase_split}, "
           f"sorted_batches={cfg.sorted_batches}, dtype={cfg.dtype}")
    if not kernels:
        log(f"profile [{tag}]: the profiler recorded no device time "
            "(not measured)")
        return {"measured": False, "wall_ms_per_step": wall / steps * 1e3}
    log(f"profile [{tag}]: {steps} steps, {wall / steps * 1e3:.3f} ms/step "
        f"under the profiler; device busy {busy_us / steps:.1f} us/step = "
        f"{busy_us / (wall * 1e6):.1%} of wall; "
        f"{sum(v[0] for v in kernels.values()) / steps:.1f} device "
        "operations/step")
    for name, (cnt, us) in top:
        log(f"  {us / steps:8.2f} us/step  {cnt / steps:5.1f}/step  "
            f"{name[:90]}")
    # one device kernel per wrapper launch, and no second reduction kernel
    per_call = {}
    for k in ("kruskal_grad", "segment_reduce", "scatter_accum"):
        found = sum(c for n, (c, _) in kernels.items()
                    if f"{k}_kernel" in n)
        if found != launches[k]:
            raise AssertionError(f"profile [{tag}]: {found} {k} device "
                                 f"kernels for {launches[k]} launches")
        per_call[k] = {"launches": launches[k], "device_kernels": found}
    stray = [n for n in kernels if "core_reduce" in n]
    if stray:
        raise AssertionError(f"profile [{tag}]: {stray} ran")
    fills = sum(c for n, (c, _) in kernels.items() if "FillFunctor" in n)
    log(f"profile [{tag}]: device kernels per wrapper launch: "
        + ", ".join(f"{k} {v['device_kernels']}/{v['launches']}"
                    for k, v in per_call.items())
        + f"; no core_reduce_kernel; {fills / steps:.1f} FillFunctor "
        "kernels/step")
    if not cfg.sorted_batches and fills:
        raise AssertionError(f"profile [{tag}]: {fills} fill kernels on the "
                             "unsorted path")
    if not cfg.sorted_batches:
        # the step's scatter call, alone: its one kernel and no fill
        g = torch.randn((cfg.batch_size, cfg.ranks[0]), generator=gen,
                        device="cuda")
        ids = train_t.indices[:cfg.batch_size, 0].contiguous()
        bk = K.dispatch.get_backend(cfg.backend)
        for _ in range(3):   # a window the profiler saw no kernel in: again
            _, alone = _profile_window(torch, lambda: [
                bk.scatter_accum(g, ids, cfg.dims[0]) for _ in range(3)])
            if alone:
                break
        calls = sum(c for c, _ in alone.values())
        if calls != 3 or not all("scatter_accum_kernel" in n
                                 for n in alone):
            raise AssertionError(f"profile [{tag}]: three scatter_accum "
                                 f"calls issued {alone}")
        log(f"profile [{tag}]: three scatter_accum calls through the "
            "backend: three scatter_accum_kernel, no fill")
    return {"measured": True, "steps": steps, "config": tag,
            "wall_ms_per_step": wall / steps * 1e3,
            "device_busy_us_per_step": busy_us / steps,
            "device_ops_per_step": sum(v[0] for v in kernels.values())
            / steps,
            "fills_per_step": fills / steps,
            "kernels_per_launch": per_call,
            "top_kernels": [{"name": n, "calls_per_step": c / steps,
                             "us_per_step": us / steps}
                            for n, (c, us) in top]}


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

def _tucker_inputs(torch, gen, M, K, N, xdt, R=LM_RANK):
    """x (M, K) and f32 factors scaled like the model's init."""
    dev = torch.device("cuda")
    x = torch.randn((M, K), generator=gen, device=dev).to(xdt)
    u1 = torch.randn((K, R), generator=gen, device=dev) / math.sqrt(K)
    g = torch.randn((R, R), generator=gen, device=dev) / math.sqrt(R)
    u2 = torch.randn((N, R), generator=gen, device=dev) / math.sqrt(N)
    return x, u1, g, u2


def _flash_inputs(torch, gen, Sq, Sk, B=4, H=40, Hk=8, D=128):
    dev = torch.device("cuda")
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
    k = torch.randn((B, Sk, Hk, D), generator=gen, device=dev)
    v = torch.randn((B, Sk, Hk, D), generator=gen, device=dev)
    return q, k, v


def phase_lm_kernels_vs_plain(torch, K, cfg) -> dict:
    ref = K.ref
    tm = K.tucker_matmul.tucker_matmul
    fa = K.flash_attention.flash_attention
    gen = torch.Generator(device="cuda").manual_seed(4321)
    worst = {k: [0.0, 0.0] for k in LM_KERNELS}

    def record(key, got, want, what):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{key} {what}: {got.dtype} "
                                 f"{tuple(got.shape)} against the plain "
                                 f"version's {want.dtype} "
                                 f"{tuple(want.shape)}")
        e, r = rel_err(got, want)
        worst[key][0] = max(worst[key][0], e)
        worst[key][1] = max(worst[key][1], r)
        log(f"  {key} {what}: max abs err {e:.3g}, relative {r:.3g}")
        if not r <= TOL[key]:
            raise AssertionError(f"{key} {what}: max abs err {e:.3g}, "
                                 f"relative {r:.3g} > {TOL[key]}")

    d, f = cfg.d_model, cfg.d_ff
    for M in (8192, 4, 8191):
        for name, (Kd, N) in (("up/gate", (d, f)), ("down", (f, d))):
            if M == 8191:                      # ragged K and N as well
                Kd, N = Kd - 1, N - 3
            for xdt in (torch.bfloat16, torch.float32):
                x, u1, g, u2 = _tucker_inputs(torch, gen, M, Kd, N, xdt)
                record("tucker_matmul", tm(x, u1, g, u2),
                       ref.tucker_matmul_ref(x, u1, g, u2),
                       f"{name} M={M} K={Kd} N={N} x {str(xdt)[6:]}")
    # the training backward's dx = tucker_matmul(ȳ, U2, Gᵀ, U1) at the
    # training shape (B·S = 4096), Gᵀ made contiguous as the backend does
    for name, (Kd, N) in (("up/gate", (d, f)), ("down", (f, d))):
        for xdt in (torch.bfloat16, torch.float32):
            gy, u2, g, u1 = _tucker_inputs(torch, gen, 4096, N, Kd, xdt)
            gt = g.t().contiguous()
            record("tucker_matmul", tm(gy, u2, gt, u1),
                   ref.tucker_matmul_ref(gy, u2, gt, u1),
                   f"{name} dx M=4096 {N}->{Kd} Gᵀ ȳ {str(xdt)[6:]}")
    cases = [  # (Sq, Sk, causal, kv_len, q_offset)
        (2048, 2048, True, 2048, 0),     # the no-cache forward
        (2048, 2080, True, 2048, 0),     # prefill into the serving cache
        (2047, 2047, False, 2047, 0),
        (2047, 2080, True, 2064, 17),    # a chunk behind 17 cached keys
        (2047, 2080, False, 1999, 17),
    ]
    for Sq, Sk, causal, kv_len, q_offset in cases:
        q, k, v = _flash_inputs(torch, gen, Sq, Sk)
        record("flash_attention",
               fa(q, k, v, causal=causal, kv_len=kv_len, q_offset=q_offset),
               ref.flash_attention_ref(q, k, v, causal, kv_len=kv_len,
                                       q_offset=q_offset),
               f"B*H=160 G=5 Sq={Sq} Sk={Sk} causal={causal} "
               f"kv_len={kv_len} q_offset={q_offset}")
        del q, k, v
    torch.cuda.synchronize()
    for key, (e, r) in worst.items():
        log(f"{key}: max abs err {e:.3g}, max relative err {r:.3g} "
            f"(tolerance {TOL[key]})")
    return {k: {"max_abs_err": e, "max_rel_err": r, "tol": TOL[k]}
            for k, (e, r) in worst.items()}


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

def phase_lm_serve(torch, K, serve, cfg) -> dict:
    from repro_torch.models import init_model

    if cfg.num_layers != 40:
        log(f"CUT: {cfg.num_layers} layers instead of Qwen3-14B's 40")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"LM: qwen3_14b, tucker_rank {cfg.tucker_rank}, {cfg.num_layers} "
        f"layers, {n_params:,} f32 parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    warm = serve.run(cfg, batch=LM_SERVE["batch"],
                     prompt_len=LM_SERVE["prompt_len"], gen=2, seed=1,
                     device="cuda", backend="cuda", params=params)
    log(f"LM warm-up request: prefill {warm['prefill_seconds']:.3f}s")
    del warm
    K.reset_launch_counts()
    res = serve.run(cfg, **LM_SERVE, seed=0, device="cuda", backend="cuda",
                    params=params)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    L, G = cfg.num_layers, LM_SERVE["gen"]
    want = {"tucker_matmul": 3 * L * G, "flash_attention": L}
    log(f"LM serve: batch {LM_SERVE['batch']}, prompt "
        f"{LM_SERVE['prompt_len']}, {G} tokens: prefill "
        f"{res['prefill_seconds']:.4f}s, decode "
        f"{res['decode_tokens_per_s']:.2f} tokens/s "
        f"({res['decode_seconds']:.4f}s for {G - 1} steps), peak device "
        f"bytes {res['peak_device_bytes']:,}, logits finite "
        f"{res['finite']}")
    log(f"LM serve: sample generation {res['generated'][0].tolist()}")
    log(f"LM serve: launch counts {counts} (want {want}: 3·L per forward "
        f"call × {G} calls, L per prefill)")
    if not res["finite"]:
        raise AssertionError("LM serve: non-finite prefill logits")
    if res["generated"].shape != (LM_SERVE["batch"], G):
        raise AssertionError(f"LM serve: generated {res['generated'].shape}")
    for k, n in want.items():
        if counts[k] != n:
            raise AssertionError(f"LM serve: {k} launched {counts[k]} "
                                 f"times, want {n}")
    for k in REPLACES:
        if k not in want and counts[k] != 0:
            raise AssertionError(f"LM serve: launched {k}, which the LM "
                                 "path does not use")
    prof = phase_lm_profile(torch, serve, cfg, params)
    out = {k: res[k] for k in ("init_seconds", "prefill_seconds",
                               "decode_seconds", "decode_tokens_per_s",
                               "peak_device_bytes", "finite")}
    out.update(layers=L, tucker_rank=cfg.tucker_rank, params=n_params,
               launch_counts=counts, profile=prof,
               generated=res["generated"].tolist())
    del params, res
    torch.cuda.empty_cache()
    return out


def _profile_window(torch, fn) -> tuple[float, dict]:
    """(wall seconds, {device op name: [calls, us]}) of ``fn()`` under the
    profiler, closed by a device synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict = {}
    for ev in prof.events():
        if "CUDA" in str(ev.device_type):   # a kernel or copy on the card
            kernels.setdefault(ev.name, [0, 0.0])
            kernels[ev.name][0] += 1
            kernels[ev.name][1] += ev.time_range.elapsed_us()
    return wall, kernels


def phase_lm_profile(torch, serve, cfg, params, steps: int = 3) -> dict:
    """One prefill, then ``steps`` decode steps, each window profiled."""
    from repro_torch.launch import steps as S
    from repro_torch.models import init_cache

    B, P = LM_SERVE["batch"], LM_SERVE["prompt_len"]
    caches = init_cache(cfg, B, P + steps + 1, dtype=torch.float32,
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device="cuda")
    prefill = S.make_prefill_step(cfg, "cuda")
    decode = S.make_decode_step(cfg, "cuda")
    state = {}

    def run_prefill():
        last, state["caches"] = prefill(params, {"tokens": prompts}, caches)
        state["tok"] = torch.argmax(last, dim=-1).to(torch.int32)[:, None]

    def run_decode():
        tok, c, index = state["tok"], state["caches"], P
        for _ in range(steps):
            tok, c, index = decode(params, c, index, {"tokens": tok})

    out = {}
    for name, fn, n in (("prefill", run_prefill, 1),
                        ("decode", run_decode, steps)):
        wall, kernels = _profile_window(torch, fn)
        if not kernels:
            log(f"LM profile [{name}]: the profiler recorded no device "
                "time (not measured)")
            out[name] = {"measured": False, "wall_ms": wall * 1e3 / n}
            continue
        busy = sum(v[1] for v in kernels.values())
        ops = sum(v[0] for v in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
        log(f"LM profile [{name}]: {n} call(s), {wall * 1e3 / n:.2f} ms "
            f"wall per call under the profiler; device busy "
            f"{busy / 1e3 / n:.2f} ms per call = {busy / (wall * 1e6):.1%} "
            f"of wall; {ops / n:.0f} device operations per call")
        for kname, (cnt, us) in top:
            log(f"  {us / 1e3 / n:9.3f} ms/call  {cnt / n:7.1f}/call  "
                f"{kname[:90]}")
        out[name] = {"measured": True, "calls": n,
                     "wall_ms_per_call": wall * 1e3 / n,
                     "device_busy_ms_per_call": busy / 1e3 / n,
                     "device_ops_per_call": ops / n,
                     "top_kernels": [{"name": k, "per_call": c / n,
                                      "ms_per_call": us / 1e3 / n}
                                     for k, (c, us) in top]}
    del caches, state
    return out


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

def phase_lm_parity(torch, cfg) -> dict:
    from repro_torch.models import decode_step, init_cache, init_model

    cfg2 = dataclasses.replace(cfg, num_layers=LM_PARITY["layers"])
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = init_model(cfg2, gen, "cuda")
    B, P, G = LM_PARITY["batch"], LM_PARITY["prompt_len"], LM_PARITY["gen"]
    prompts = torch.randint(0, cfg2.vocab_size, (B, P), generator=gen,
                            device="cuda")
    caches = {bk: init_cache(cfg2, B, P + G, dtype=torch.float32,
                             device="cuda") for bk in ("cuda", "torch")}
    out = {"prefill": None, "decode": [], "tokens_agree": []}
    logits = {bk: decode_step(params, cfg2, {"tokens": prompts}, caches[bk],
                              0, backend=bk)[0] for bk in caches}
    worst = 0.0
    e, r = rel_err(logits["cuda"], logits["torch"])
    out["prefill"] = {"max_abs_diff": e, "max_rel_diff": r}
    worst = max(worst, r)
    log(f"LM parity prefill ({cfg2.num_layers} layers, batch {B}, prompt "
        f"{P}): cuda vs torch logits max abs diff {e:.4g}, relative "
        f"{r:.4g} (tolerance {TOL['lm.logits']:.4g})")
    for i in range(G):
        toks = {bk: l[:, -1].float().argmax(-1) for bk, l in logits.items()}
        agree = bool(torch.equal(toks["cuda"], toks["torch"]))
        out["tokens_agree"].append(agree)
        fed = toks["cuda"].to(torch.int32)[:, None]   # both get the same
        logits = {bk: decode_step(params, cfg2, {"tokens": fed}, caches[bk],
                                  P + i, backend=bk)[0] for bk in caches}
        e, r = rel_err(logits["cuda"], logits["torch"])
        worst = max(worst, r)
        out["decode"].append({"max_abs_diff": e, "max_rel_diff": r})
        log(f"LM parity decode step {i}: max abs diff {e:.4g}, relative "
            f"{r:.4g}; greedy tokens before it agree: {agree}")
    torch.cuda.synchronize()
    for l in logits.values():
        if not torch.isfinite(l).all():
            raise AssertionError("LM parity: non-finite logits")
    if not worst <= TOL["lm.logits"]:
        raise AssertionError(f"LM parity: cuda vs torch logits differ by "
                             f"{worst:.4g} of the largest")
    out["max_rel_diff"] = worst
    del params, caches, logits
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

def phase_lm_times(torch, K, cfg) -> list[dict]:
    import torch.nn.functional as F

    ref = K.ref
    tm = K.tucker_matmul.tucker_matmul
    fa = K.flash_attention.flash_attention
    gen = torch.Generator(device="cuda").manual_seed(77)
    d, f = cfg.d_model, cfg.d_ff
    R = cfg.tucker_rank
    B, P = LM_SERVE["batch"], LM_SERVE["prompt_len"]
    rows = []
    floor = floor_ms(torch, K.build)
    log(f"launch floor (an empty kernel through ctypes): "
        f"{floor * 1e3:.2f} us")
    # tucker_matmul: prefill M = B·P first (the row the kernels line takes)
    variants = [
        ("prefill up/gate, x bf16", B * P, d, f, torch.bfloat16,
         "2 per layer per forward call"),
        ("prefill down, x f32", B * P, f, d, torch.float32,
         "1 per layer per forward call"),
        ("decode up/gate, x bf16", B, d, f, torch.bfloat16,
         "2 per layer per decode step"),
        ("decode down, x f32", B, f, d, torch.float32,
         "1 per layer per decode step"),
    ]
    for tag, M, Kd, N, xdt, per in variants:
        cold = M <= 64                      # decode: factors cold in L2
        sets = [_tucker_inputs(torch, gen, M, Kd, N, xdt, R)
                for _ in range(COLD_SETS if cold else 1)]
        sets = [(x, x.float(), u1, g, u2) for x, u1, g, u2 in sets]
        p = K.tucker_matmul.plan(M, Kd, R, R, N, xdt)
        log(f"tucker_matmul [{tag}] plan: {p}"
            + (f"; {len(sets)} factor sets rotated" if cold else ""))
        it = 30 if M > 64 else 200

        def rotating(f):
            state = {"i": 0}

            def call():
                x, x32, u1, g, u2 = sets[state["i"] % len(sets)]
                state["i"] += 1
                return f(x, x32, u1, g, u2)
            return call

        calls = (
            rotating(lambda x, x32, u1, g, u2: tm(x, u1, g, u2)),
            rotating(lambda x, x32, u1, g, u2:
                     ref.tucker_matmul_ref(x, u1, g, u2)),
            rotating(lambda x, x32, u1, g, u2: torch.matmul(
                torch.matmul(torch.matmul(x32, u1), g), u2.T)))
        ms, plain, lib = (device_ms(torch, c, iters=it) for c in calls)
        host = tuple(host_ms(torch, c) for c in calls)
        nbytes = sets[0][0].element_size() * M * Kd \
            + 4 * (Kd * R + R * R + N * R) + 4 * M * N
        flops = [2 * M * Kd * R, 2 * M * R * R, 2 * M * R * N]
        rows.append(("tucker_matmul", tag, ms, plain, lib,
                     tc_bound(nbytes, list(zip(p.passes, flops))), per,
                     host, bound(nbytes, sum(flops)),
                     dataclasses.asdict(p)))
        del sets
    # flash_attention: the prefill call (B·H = 160, G = 5, into the cache)
    Sk = P + LM_SERVE["gen"]
    q, k, v = _flash_inputs(torch, gen, P, Sk, B=B, H=cfg.num_heads,
                            Hk=cfg.num_kv_heads, D=cfg.head_dim)
    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kernel_call = lambda: fa(q, k, v, causal=True, kv_len=P)  # noqa: E731
    plain_call = lambda: ref.flash_attention_ref(  # noqa: E731
        q, k, v, True, kv_len=P)
    ms = device_ms(torch, kernel_call, iters=30)
    plain = device_ms(torch, plain_call, iters=10)
    host = (host_ms(torch, kernel_call), host_ms(torch, plain_call, 5), None)
    qt = q.transpose(1, 2)
    kt, vt = (t[:, :P].transpose(1, 2) for t in (k, v))
    try:
        lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=30)
    except TypeError as exc:   # a torch without enable_gqa
        log(f"scaled_dot_product_attention(enable_gqa=True): {exc}")
        lib = None
    pairs = P * (P + 1) // 2          # causal (i, j ≤ i), all below kv_len
    nbytes = 4 * (2 * B * P * H * D + 2 * B * P * Hk * D)
    flops = 4 * D * pairs * B * H     # Q Kᵀ and P V, 3xTF32 in both
    rows.append(("flash_attention", f"prefill B={B} H={H} Kv={Hk} S={P} "
                 f"D={D} causal, cache {Sk}", ms, plain, lib,
                 tc_bound(nbytes, [(3, flops)]), "1 per layer per prefill",
                 host, bound(nbytes, flops), None))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    out = []
    for name, tag, ms, plain, lib, (t_b, by), per, host, f32, p in rows:
        log(f"{name} [{tag}]: {ms:.4f} ms/call (plain {plain:.4f} ms"
            + (f", library {lib:.4f} ms" if lib is not None else "")
            + f"), bound on the kernel's units {t_b:.4f} ms by {by} "
            f"({t_b / ms:.1%} of it), launch floor {floor:.4f} ms, f32 "
            f"bound {f32[0]:.4f} ms by "
            f"{f32[1]} ({f32[0] / ms:.1%} of the f32 bound); {per}; host "
            "time to issue one call: "
            + ", ".join(f"{k} {h:.4f} ms" for k, h in
                        zip(("kernel", "plain", "library"), host)
                        if h is not None))
        out.append({"name": name, "variant": tag, "ms": ms,
                    "plain_ms": plain, "library_ms": lib, "bound_ms": t_b,
                    "bound_by": by, "floor_ms": floor,
                    "f32_bound_ms": f32[0],
                    "f32_bound_by": f32[1], "plan": p, "launches_note": per,
                    "host_ms": {"kernel": host[0], "plain": host[1],
                                "library": host[2]}})
    return out


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------

def phase_flash_bwd(torch, K, cfg) -> tuple[dict, list[dict]]:
    """The flash backward against its plain version, its parts checked
    separately, the forward's lse, and its time beside the bound, the plain
    version and the backward of ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    ref = K.ref
    fa = K.flash_attention.flash_attention
    fb = K.flash_attention_bwd.flash_attention_bwd
    gen = torch.Generator(device="cuda").manual_seed(99)
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cases = [  # (tag, Sq, Sk, H, Hk, D, causal, kv_len)
        ("training shape", S, S, H, Hk, D, True, S),
        ("S = 2047", S - 1, S - 1, H, Hk, D, True, S - 1),
        ("G = 1", S, S, Hk, Hk, D, True, S),
        ("D = 64", S, S, H, Hk, 64, True, S),
        ("non-causal, kv_len < Sk", S - 1, S, H, Hk, D, False, S - 77),
    ]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0, "lse": 0.0}
    worst_abs = 0.0
    out = {"cases": []}
    for tag, Sq, Sk, h, hk, d, causal, kv_len in cases:
        q = torch.randn((B, Sq, h, d), generator=gen, device="cuda")
        k, v = (torch.randn((B, Sk, hk, d), generator=gen, device="cuda")
                for _ in range(2))
        dout = torch.randn((B, Sq, h, d), generator=gen, device="cuda")
        kw = dict(causal=causal, kv_len=kv_len)
        o, lse = fa(q, k, v, return_lse=True, **kw)
        o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal,
                                                 kv_len=kv_len,
                                                 return_lse=True)
        got = fb(q, k, v, o, lse, dout, **kw)
        again = fb(q, k, v, o, lse, dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, causal,
                                           kv_len=kv_len)
        torch.cuda.synchronize()
        rec = {"case": tag, "shape": [B, Sq, Sk, h, hk, d],
               "causal": causal, "kv_len": kv_len}
        e, r = rel_err(lse, lse_ref)
        rec["lse"] = {"max_abs_err": e, "max_rel_err": r}
        worst["lse"] = max(worst["lse"], r)
        if not r <= TOL["flash_attention"]:
            raise AssertionError(f"flash forward lse [{tag}]: {r:.3g} of "
                                 f"the scale > {TOL['flash_attention']}")
        e_o, r_o = rel_err(o, o_ref)
        if not r_o <= TOL["flash_attention"]:
            raise AssertionError(f"flash forward with lse [{tag}]: output "
                                 f"{r_o:.3g} of the scale")
        msg = []
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            e, r = rel_err(g, w)
            rec[name] = {"max_abs_err": e, "max_rel_err": r,
                         "bitwise_repeat": bool(torch.equal(g, a))}
            worst[name] = max(worst[name], r)
            worst_abs = max(worst_abs, e)
            msg.append(f"{name} {e:.3g} ({r:.3g} of its largest)")
            if not r <= TOL["flash_attention_bwd"]:
                raise AssertionError(
                    f"flash backward [{tag}]: {name} max abs err {e:.3g}, "
                    f"{r:.3g} of its largest > {TOL['flash_attention_bwd']}")
            if not rec[name]["bitwise_repeat"]:
                raise AssertionError(f"flash backward [{tag}]: two calls "
                                     f"gave different {name} bits")
        log(f"  flash_attention_bwd [{tag}: B={B} Sq={Sq} Sk={Sk} H={h} "
            f"Kv={hk} D={d} causal={causal} kv_len={kv_len}]: "
            + ", ".join(msg) + f"; two calls bitwise equal; forward lse "
            f"{rec['lse']['max_abs_err']:.3g} "
            f"({rec['lse']['max_rel_err']:.3g} of its largest)")
        out["cases"].append(rec)
        del q, k, v, dout, o, lse, o_ref, lse_ref, got, again, want
    torch.cuda.empty_cache()
    out.update(worst_rel=worst, max_abs_err=worst_abs,
               tol=TOL["flash_attention_bwd"])
    log(f"flash_attention_bwd: max relative err dq {worst['dq']:.3g}, dk "
        f"{worst['dk']:.3g}, dv {worst['dv']:.3g} (tolerance "
        f"{TOL['flash_attention_bwd']} of each output's largest); forward "
        f"lse {worst['lse']:.3g} (tolerance {TOL['flash_attention']})")

    # times at the training shape
    q = torch.randn((B, S, H, D), generator=gen, device="cuda")
    k, v = (torch.randn((B, S, Hk, D), generator=gen, device="cuda")
            for _ in range(2))
    dout = torch.randn((B, S, H, D), generator=gen, device="cuda")
    o, lse = fa(q, k, v, return_lse=True)
    floor = floor_ms(torch, K.build)
    kernel = lambda: fb(q, k, v, o, lse, dout)            # noqa: E731
    plain = lambda: ref.flash_attention_bwd_ref(          # noqa: E731
        q, k, v, o, lse, dout)
    ms = device_ms(torch, kernel, iters=20)
    plain_ms = device_ms(torch, plain, iters=5)
    host = (host_ms(torch, kernel, 5), host_ms(torch, plain, 3), None)
    lib = None
    try:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
        gt = dout.transpose(1, 2)
        lib = device_ms(torch, lambda: torch.autograd.grad(
            sd, (qt, kt, vt), gt, retain_graph=True), iters=10)
        del sd
    except (TypeError, RuntimeError) as exc:
        log(f"scaled_dot_product_attention backward: {exc}")
    pairs = S * (S + 1) // 2
    nbytes = 4 * (4 * B * S * H * D + 4 * B * S * Hk * D + B * H * S)
    # the function's five products (Qkᵀ, dO vᵀ, Pᵀ dO, dS k, dSᵀ q), each
    # as 3xTF32 on the tensor cores (the plan's passes) at 495 TFLOP/s:
    # the units the kernel runs them on (its dQ pass recomputes two of
    # them, which the bound does not count); beside it the same products
    # at the 67 TFLOP/s f32 SIMT peak
    flops = 5 * 2 * D * pairs * B * H
    bplan = K.flash_attention_bwd.plan(B, S, S, H, Hk, D)
    t_tc, by_tc = tc_bound(nbytes, [(n, flops / 5) for n in bplan.passes])
    t_b, by = bound(nbytes, flops)
    # each of the call's three kernels, from a short profile of 5 calls:
    # the mean over the launches the trace recorded (it may miss the
    # first), taken again, three times at most, if it missed a kernel
    keys = tuple(zip(("Di", "dK/dV", "dQ"), BWD_KERNELS))
    for _ in range(3):
        _, prof = _profile_window(torch,
                                  lambda: [kernel() for _ in range(5)])
        hits = {part: [(n, us) for name, (n, us) in prof.items()
                       if key in name] for part, key in keys}
        if all(len(h) == 1 for h in hits.values()):
            break
    else:
        raise AssertionError("flash_attention_bwd profile: want one device "
                             f"kernel of each part, recorded {hits}")
    parts = {part: h[0][1] / h[0][0] * 1e-3 for part, h in hits.items()}
    dev = sum(parts.values())
    rows = [{"name": "flash_attention_bwd",
             "variant": f"training B={B} H={H} Kv={Hk} S={S} D={D} causal",
             "ms": ms, "plain_ms": plain_ms, "library_ms": lib,
             "bound_ms": t_tc, "bound_by": by_tc, "floor_ms": floor,
             "f32_bound_ms": t_b, "f32_bound_by": by, "device_ms": dev,
             "kernel_ms": parts, "plan": dataclasses.asdict(bplan),
             "launches_note": "1 per layer per training step",
             "host_ms": {"kernel": host[0], "plain": host[1],
                         "library": None}}]
    log(f"flash_attention_bwd [{rows[0]['variant']}]: {ms:.4f} ms/call "
        f"(plain {plain_ms:.4f} ms"
        + (f", scaled_dot_product_attention backward {lib:.4f} ms"
           if lib is not None else "")
        + f"), bound on the tensor cores {t_tc:.4f} ms by {by_tc} (3xTF32, "
        f"the units it runs on; {t_tc / ms:.1%} of it), f32 bound "
        f"{t_b:.4f} ms by {by} ({t_b / ms:.1%} of it), launch floor "
        f"{floor:.4f} ms; device time by kernel "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
        + f" (sum {dev:.4f} ms); {rows[0]['launches_note']}")
    # the forward as training calls it: with the lse, B = 2
    fwd = lambda: fa(q, k, v, return_lse=True)            # noqa: E731
    fwd_plain = lambda: ref.flash_attention_ref(          # noqa: E731
        q, k, v, True, return_lse=True)
    f_ms = device_ms(torch, fwd, iters=20)
    f_plain = device_ms(torch, fwd_plain, iters=5)
    f_nbytes = 4 * (2 * B * S * H * D + 2 * B * S * Hk * D + B * H * S)
    f_flops = 4 * D * pairs * B * H
    f_tb, f_by = tc_bound(f_nbytes, [(3, f_flops)])
    rows.append({"name": "flash_attention",
                 "variant": f"training forward with lse B={B} S={S}",
                 "ms": f_ms, "plain_ms": f_plain, "library_ms": None,
                 "bound_ms": f_tb, "bound_by": f_by, "floor_ms": floor,
                 "f32_bound_ms": bound(f_nbytes, f_flops)[0],
                 "f32_bound_by": bound(f_nbytes, f_flops)[1], "plan": None,
                 "launches_note": "1 per layer per training step",
                 "host_ms": None})
    log(f"flash_attention [{rows[1]['variant']}]: {f_ms:.4f} ms/call "
        f"(plain {f_plain:.4f} ms), bound on the tensor cores {f_tb:.4f} "
        f"ms ({f_tb / f_ms:.1%} of it)")
    del q, k, v, dout, o, lse
    torch.cuda.empty_cache()
    return out, rows


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------

def phase_lm_train(torch, K, train, cfg) -> dict:
    """The training slice through ``launch/train.run``, one step profiled,
    then the resume check from its checkpoint."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw

    L = cfg.num_layers
    B, T, N = LM_TRAIN["batch"], LM_TRAIN["seq"], LM_TRAIN["steps"]
    every = LM_TRAIN["ckpt_every"]
    ckpt_dir = ROOT / "build" / "train_ckpt"   # git-ignored
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    K.reset_launch_counts()
    res = train.run(cfg, steps=N, batch=B, seq=T, ckpt_dir=str(ckpt_dir),
                    ckpt_every=every, log_every=5, device="cuda",
                    backend="cuda")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    hist = res["history"]
    n_params = sum(p.numel() for p in res["state"].params.parameters())
    want = {"tucker_matmul": 6 * L * N, "flash_attention": L * N,
            "flash_attention_bwd": L * N}
    losses = [hist[i]["loss"] for i in range(1, N + 1)]
    gnorms = [hist[i]["grad_norm"] for i in range(1, N + 1)]
    step_s = sorted(hist[i]["seconds"] for i in range(2, N + 1))
    med = statistics.median(step_s)
    log(f"LM train: qwen3_14b, tucker_rank {cfg.tucker_rank}, {L} layers, "
        f"{n_params:,} f32 parameters, batch {B} × seq {T}, {N} steps, "
        f"checkpoint every {every}: {res['seconds']:.2f}s in all, "
        f"{res['steps_per_s']:.3f} steps/s, {res['tokens_per_s']:.1f} "
        f"tokens/s (checkpoints included); median step {med:.4f}s = "
        f"{B * T / med:.1f} tokens/s; peak device bytes "
        f"{res['peak_device_bytes']:,}")
    log("LM train: loss per step " + ", ".join(f"{x:.4f}" for x in losses))
    log("LM train: grad norm per step "
        + ", ".join(f"{x:.4f}" for x in gnorms))
    log(f"LM train: launch counts {counts} (want {want}: per step 6·L "
        "tucker_matmul — 3·L forward, 3·L dx — and L of each flash kernel)")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError("LM train: a non-finite loss or grad norm")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"LM train: loss did not fall ({losses[0]:.4f} "
                             f"→ {losses[-1]:.4f})")
    if not res["peak_device_bytes"] < 80e9:
        raise AssertionError("LM train: peak device bytes "
                             f"{res['peak_device_bytes']:,} ≥ 80 GB")
    for k, n in want.items():
        if counts[k] != n:
            raise AssertionError(f"LM train: {k} launched {counts[k]} "
                                 f"times, want {n}")
    for k in REPLACES:
        if k not in want and counts[k] != 0:
            raise AssertionError(f"LM train: launched {k}, which the LM "
                                 "path does not use")
    ckpt = CheckpointManager(ckpt_dir)
    if ckpt.all_steps() != list(range(every, N + 1, every)):
        raise AssertionError(f"LM train: checkpoints {ckpt.all_steps()}")

    # one more step, profiled
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=T, global_batch=B))
    opt_cfg = adamw.AdamWConfig(total_steps=N)
    step = S.make_train_step(cfg, opt_cfg, "cuda")
    state = res["state"]
    box = {}

    def one_step():
        box["state"], box["m"] = step(state, train.device_batch(
            pipe.global_batch(N), "cuda"))
        float(box["m"]["loss"])

    K.reset_launch_counts()
    wall, kernels = _profile_window(torch, one_step)
    per_step = K.launch_counts()
    prof = {"measured": bool(kernels), "wall_ms": wall * 1e3,
            "launch_counts": per_step}
    if kernels:
        busy = sum(v[1] for v in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:14]
        log(f"LM train profile [one step]: {wall * 1e3:.1f} ms wall under "
            f"the profiler; device busy {busy / 1e3:.1f} ms = "
            f"{busy / (wall * 1e6):.1%} of wall; "
            f"{sum(v[0] for v in kernels.values())} device operations")
        for kname, (cnt, us) in top:
            log(f"  {us / 1e3:9.3f} ms  {cnt:5d}x  {kname[:90]}")
        # the flash backward's three kernels (Di, dK/dV, dQ) in this step
        bwd = {key: [sum(v[i] for k, v in kernels.items() if key in k)
                     for i in (0, 1)]
               for key in BWD_KERNELS}
        log("LM train profile: flash_attention_bwd's kernels "
            + ", ".join(f"{k} {n}x {us / 1e3:.3f} ms"
                        for k, (n, us) in bwd.items())
            + f" (of {busy / 1e3:.1f} ms busy)")
        prof.update(device_busy_ms=busy / 1e3,
                    device_ops=sum(v[0] for v in kernels.values()),
                    top_kernels=[{"name": k, "calls": c, "ms": us / 1e3}
                                 for k, (c, us) in top],
                    flash_bwd_kernels={k: {"calls": n, "ms": us / 1e3}
                                       for k, (n, us) in bwd.items()})
    else:
        log("LM train profile: the profiler recorded no device time "
            "(not measured)")
    one = {"tucker_matmul": 6 * L, "flash_attention": L,
           "flash_attention_bwd": L}
    log(f"LM train profile: launch counts of one step {per_step} (want "
        f"{one})")
    for k, n in one.items():
        if per_step[k] != n:
            raise AssertionError(f"LM train: one step launched {k} "
                                 f"{per_step[k]} times, want {n}")
    out = {"layers": L, "tucker_rank": cfg.tucker_rank, "params": n_params,
           "batch": B, "seq": T, "steps": N, "losses": losses,
           "grad_norms": gnorms, "seconds": res["seconds"],
           "steps_per_s": res["steps_per_s"],
           "tokens_per_s": res["tokens_per_s"],
           "median_step_s": med, "median_tokens_per_s": B * T / med,
           "step_seconds": [hist[i]["seconds"] for i in range(1, N + 1)],
           "peak_device_bytes": res["peak_device_bytes"],
           "launch_counts": counts, "profile": prof}
    del state, box, res
    torch.cuda.empty_cache()

    # resume: the checkpoint into a fresh state, four more steps
    t0 = time.perf_counter()
    fresh = S.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    fresh, at = ckpt.restore(fresh, step=every)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = []
    for i in range(at, at + LM_TRAIN["resume_steps"]):
        fresh, m = step(fresh, train.device_batch(pipe.global_batch(i),
                                                  "cuda"))
        got.append(float(m["loss"]))
    wantl = losses[at:at + LM_TRAIN["resume_steps"]]
    worst = max(abs(g - w) / abs(w) for g, w in zip(got, wantl))
    log(f"LM train resume: restored step {at} into a fresh state in "
        f"{restore_s:.2f}s; losses of steps {at + 1}..{at + len(got)} "
        f"{[f'{x:.6f}' for x in got]} against the uninterrupted run's "
        f"{[f'{x:.6f}' for x in wantl]}: max relative diff {worst:.3g} "
        f"(tolerance {TOL['lm.resume']})")
    if not worst <= TOL["lm.resume"]:
        raise AssertionError(f"LM train resume: losses differ by {worst:.3g}")
    out["resume"] = {"restored_step": at, "restore_seconds": restore_s,
                     "losses": got, "want": wantl, "max_rel_diff": worst}
    del fresh
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------------

def phase_lm_train_parity(torch, train, cfg) -> dict:
    """``"cuda"`` against ``"torch"`` from the same state: the loss, every
    gradient leaf, and the parameters after one AdamW step."""
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import loss_fn
    from repro_torch.optim import adamw

    P = LM_TRAIN_PARITY
    cfg2 = dataclasses.replace(cfg, num_layers=P["layers"])
    state = S.init_train_state(
        cfg2, torch.Generator(device="cuda").manual_seed(11), "cuda")
    params = adamw.named(state.params)
    batch = train.device_batch(TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg2.vocab_size, seq_len=P["seq"],
        global_batch=P["batch"])).global_batch(0), "cuda")
    loss, grads = {}, {}
    for bk in ("cuda", "torch"):
        lo = loss_fn(state.params, cfg2, batch, backend=bk)
        grads[bk] = dict(zip(params, torch.autograd.grad(
            lo, list(params.values()))))
        loss[bk] = float(lo.detach())
        del lo
    rel_loss = abs(loss["cuda"] - loss["torch"]) / abs(loss["torch"])
    worst_g, worst_name = 0.0, ""
    for name in params:
        _, r = rel_err(grads["cuda"][name], grads["torch"][name])
        if r > worst_g:
            worst_g, worst_name = r, name
    log(f"LM train parity ({cfg2.num_layers} layers, batch {P['batch']}, "
        f"seq {P['seq']}): loss cuda {loss['cuda']:.6f}, torch "
        f"{loss['torch']:.6f}, relative diff {rel_loss:.3g} (tolerance "
        f"{TOL['lm.loss']:.4g}); worst gradient leaf {worst_name}: "
        f"{worst_g:.3g} of its largest (tolerance {TOL['lm.grads']:.4g})")
    if not (math.isfinite(loss["cuda"]) and rel_loss <= TOL["lm.loss"]):
        raise AssertionError(f"LM train parity: loss {loss}")
    if not worst_g <= TOL["lm.grads"]:
        raise AssertionError(f"LM train parity: gradient {worst_name} "
                             f"differs by {worst_g:.3g} of its largest")

    # one AdamW step from each backend's gradients, from the same state.
    # Adam's first step is lr·g/(|g| + eps) plus weight decay: the moments
    # carry the magnitudes (m = (1 − b1)·s·g and v = (1 − b2)·(s·g)², s
    # the clip factor from each backend's own global norm), the parameters
    # only the signs.  So m and v are held against each leaf's largest, and
    # the parameters where |g| is past a quarter of its leaf's largest
    # (eight times the gradient band, so the sign is the same on both
    # backends) against the step's lr, which warmup 1 puts at 1e-3 (the
    # default's 3e-6 at step 1 would be lost in f32 rounding).
    opt_cfg = adamw.AdamWConfig(**LM_TRAIN_PARITY_OPT)
    after = {n: p.detach().clone() for n, p in params.items()}
    _, opt_c, _ = adamw.update(grads["cuda"], adamw.init(after), after,
                               opt_cfg)
    del grads["cuda"]
    _, opt_t, met = adamw.update(grads["torch"], state.opt, params, opt_cfg)
    lr = float(met["lr"])
    worst = {k: [0.0, ""] for k in ("m", "v", "params")}
    held = 0
    for name, p in params.items():
        for key, a, b in (("m", opt_c.m[name], opt_t.m[name]),
                          ("v", opt_c.v[name], opt_t.v[name])):
            r = rel_err(a, b)[1]
            if r > worst[key][0]:
                worst[key] = [r, name]
        g = grads["torch"][name].abs()
        settled = g > LM_SETTLED * g.max()
        del g
        d = (after[name] - p.detach())[settled]
        held += d.numel()
        r = d.abs().max().item() / lr if d.numel() else 0.0
        if r > worst["params"][0]:
            worst["params"] = [r, name]
        del settled, d
    del grads
    torch.cuda.synchronize()
    n_all = sum(p.numel() for p in params.values())
    log(f"LM train parity: one AdamW step (lr {lr:.3g}, warmup 1): worst "
        f"m leaf {worst['m'][1]}: {worst['m'][0]:.3g} of its largest, worst "
        f"v leaf {worst['v'][1]}: {worst['v'][0]:.3g} (tolerance "
        f"{TOL['lm.grads']:.4g}); parameters where |g| > "
        f"{LM_SETTLED:g} of its leaf's largest ({held:,} of {n_all:,}): "
        f"worst leaf {worst['params'][1]}: {worst['params'][0]:.3g} of the "
        f"lr (tolerance {TOL['lm.grads']:.4g}; a flipped sign gives 2, a "
        f"zero gradient 1)")
    for key, (r, name) in worst.items():
        if not r <= TOL["lm.grads"]:
            raise AssertionError(f"LM train parity: {key} of {name} differs "
                                 f"by {r:.3g} after one AdamW step")
    del state, params, after, opt_c, opt_t
    torch.cuda.empty_cache()
    return {"layers": cfg2.num_layers, "loss": loss, "loss_rel_diff": rel_loss,
            "worst_grad": {"leaf": worst_name, "rel_diff": worst_g},
            "adamw_step": {"lr": lr, "settled_entries": held,
                           "entries": n_all,
                           **{f"worst_{k}": {"leaf": n, "rel_diff": r}
                              for k, (r, n) in worst.items()}}}


# ---------------------------------------------------------------------------
# phase 14
# ---------------------------------------------------------------------------

def _same_bits(x, y) -> bool:
    return len(x) == len(y) and all(a.equal(b) for a, b in zip(x, y))


def _params(res) -> tuple:
    p = res["state"].params
    return tuple(p.factors) + tuple(p.core_factors)


def _check_path(name, counts, must, must_not) -> None:
    missing = [k for k in must if counts[k] <= 0]
    stray = [k for k in must_not if counts[k] != 0]
    if missing or stray:
        raise AssertionError(f"{name}: not launched {missing}, launched but "
                             f"not on the path {stray}")


def phase_driver(torch, K, std_train, base_res, steps: int) -> dict:
    """``std_train --strategy local`` over phase 3's tensor: checkpoints,
    a bitwise resume, the int8 error-feedback run against the uncompressed
    one in alternating runs, launches and costs."""
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager

    data = (base_res["train"], base_res["test"])
    third = max(steps // 3, 1)
    base = ["--strategy", "local", "--dims",
            ",".join(map(str, NETFLIX_DIMS)), "--rank", "4", "--core-rank",
            "4", "--batch", str(TRAIN_BATCH), "--eval-every", str(third),
            "--seed", "0", "--backend", "cuda", "--device", "cuda"]
    must, must_not = PATHS["unsorted"][1:]
    runs, run_counts, committed = {}, {}, {}
    (ROOT / "build").mkdir(exist_ok=True)   # git-ignored
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        whole_ck, cut_ck = str(Path(tmp) / "whole"), str(Path(tmp) / "cut")
        # the interrupted run stops after its second commit, as a kill
        # there would; then the compression pair alternates, u c c u u c
        order = [("uninterrupted", steps, ["--ckpt-dir", whole_ck]),
                 ("interrupted", 2 * third, ["--ckpt-dir", cut_ck]),
                 ("resumed", steps, ["--ckpt-dir", cut_ck, "--resume"])]
        order += [(f"{kind} {i}", steps, flags) for i, kind, flags in (
            (1, "uncompressed", []), (1, "compressed", ["--compress"]),
            (2, "compressed", ["--compress"]), (2, "uncompressed", []),
            (3, "uncompressed", []), (3, "compressed", ["--compress"]))]
        for name, n, flags in order:
            K.reset_launch_counts()
            res = std_train.run(
                std_train.parse_args(base + ["--steps", str(n)] + flags),
                data)
            torch.cuda.synchronize()
            counts = K.launch_counts()
            hist = res["history"]
            log(f"driver {name} ({' '.join(flags) or 'no checkpoint'}): "
                f"{hist[-1]['step'] - hist[0]['step']} steps at "
                f"{res['steps_per_s']:.1f} steps/s = "
                f"{res['nnz_per_s']:.4g} nnz/s, peak device bytes "
                f"{res['peak_device_bytes']:,}; rmse " + " -> ".join(
                    f"{h['rmse']:.7f}@{h['step']}" for h in hist))
            log(f"driver {name}: launch counts {counts}")
            if res["ckpt_bytes"] is not None:
                log(f"driver {name}: {len(hist) - 1} checkpoints of "
                    f"{res['ckpt_bytes']:,} bytes, {res['ckpt_seconds']:.4f}s "
                    f"in all ({res['ckpt_seconds'] / (len(hist) - 1):.4f}s "
                    "each)")
            if not all(math.isfinite(h["rmse"]) and math.isfinite(h["mae"])
                       for h in hist):
                raise AssertionError(f"driver {name}: non-finite RMSE/MAE: "
                                     f"{hist}")
            _check_path(f"driver {name}", counts, must, must_not)
            runs[name], run_counts[name] = res, counts
            if name in ("uninterrupted", "interrupted"):
                committed[name] = CheckpointManager(flags[1]).all_steps()
    want = {"uninterrupted": sorted({*range(third, steps + 1, third),
                                     steps}),
            "interrupted": [third, 2 * third]}
    if committed["interrupted"] != want["interrupted"] or (
            committed["uninterrupted"] != want["uninterrupted"]):
        raise AssertionError(f"driver: checkpoints {committed}, want {want}")
    whole, resumed = runs["uninterrupted"], runs["resumed"]
    if resumed["resumed_from"] != 2 * third:
        raise AssertionError(f"driver: resumed from "
                             f"{resumed['resumed_from']}, want {2 * third}")
    if not (_same_bits(_params(whole), _params(resumed))
            and whole["dstate"].rng.equal(resumed["dstate"].rng)):
        raise AssertionError("driver: the resumed run's parameters differ "
                             "from the uninterrupted run's")
    if not _same_bits(_params(whole), _params(base_res)):
        raise AssertionError("driver: the uninterrupted local run differs "
                             "from phase 3's unsorted run")
    log(f"driver: resumed at step {2 * third} and finished bitwise equal to "
        "the uninterrupted run (factors, core factors, generator state); "
        "the uninterrupted run bitwise equal to phase 3's unsorted run")

    plain = [runs[f"uncompressed {i}"] for i in (1, 2, 3)]
    comp = [runs[f"compressed {i}"] for i in (1, 2, 3)]
    if not all(_same_bits(_params(r), _params(whole)) for r in plain):
        raise AssertionError("driver: an uncompressed run differs from the "
                             "uninterrupted run")
    if not all(_same_bits(_params(r) + r["dstate"].ef,
                          _params(comp[0]) + comp[0]["dstate"].ef)
               for r in comp[1:]):
        raise AssertionError("driver: the compressed runs differ")
    ef = comp[0]["dstate"].ef
    if not all(bool(torch.isfinite(e).all()) and float(e.abs().max()) > 0
               for e in ef):
        raise AssertionError("driver compressed: error-feedback residuals "
                             "zero or not finite")
    sps_u = [r["steps_per_s"] for r in plain]
    sps_c = [r["steps_per_s"] for r in comp]
    med_u, med_c = statistics.median(sps_u), statistics.median(sps_c)
    log(f"driver: steps/s uncompressed {[round(x, 1) for x in sps_u]} "
        f"(max/min {max(sps_u) / min(sps_u):.3f}), compressed "
        f"{[round(x, 1) for x in sps_c]} (max/min "
        f"{max(sps_c) / min(sps_c):.3f}); medians {med_u:.1f} / "
        f"{med_c:.1f}, compressed/uncompressed {med_c / med_u:.3f}")
    hist = comp[0]["history"]
    r_c, r_u = hist[-1]["rmse"], whole["history"][-1]["rmse"]
    gap = abs(r_c - r_u) / r_u
    log(f"driver compressed: final rmse {r_c:.9f} against {r_u:.9f} "
        f"uncompressed: {gap:.3e} relative, bound {COMPRESS_GAP:g}; the "
        "three compressed runs bitwise equal, the three uncompressed runs "
        "bitwise the uninterrupted run")
    if not all(b["rmse"] < a["rmse"] for a, b in zip(hist, hist[1:])):
        raise AssertionError(f"driver compressed: RMSE did not fall: {hist}")
    if not gap <= COMPRESS_GAP:
        raise AssertionError(f"driver compressed: RMSE {r_c} is {gap:.3e} "
                             f"from the uncompressed run's {r_u}, past "
                             f"{COMPRESS_GAP:g}")
    out = {"runs": {}}
    for name, res in runs.items():
        out["runs"][name] = {k: res[k] for k in (
            "history", "steps_per_s", "nnz_per_s", "peak_device_bytes",
            "train_seconds", "ckpt_seconds", "ckpt_bytes", "resumed_from")}
        out["runs"][name]["launch_counts"] = run_counts[name]
    out.update(resume_bitwise=True, equals_phase3_bitwise=True,
               compressed_gap=gap, steps_per_s_median={
                   "uncompressed": med_u, "compressed": med_c})
    return out


# ---------------------------------------------------------------------------
# phase 15
# ---------------------------------------------------------------------------

def _rmse(torch, params, test_t, predict) -> tuple[float, float]:
    from repro_torch.core.metrics import rmse_mae

    r, m = rmse_mae(params, test_t, predict)
    return float(r), float(m)


def phase_baselines(torch, K, base_res, steps: int) -> dict:
    """cuTucker SGD, one ALS epoch and one CCD epoch over phase 3's tensor
    from one cold init; ``bench_accuracy`` at FULL on the card; cuTucker
    ``"cuda"`` against ``"torch"`` on 20 fed batches."""
    from repro_torch.benchmarks import bench_accuracy
    from repro_torch.core import als, ccd
    from repro_torch.core import cutucker as cu
    from repro_torch.core.sampling import sample_batch_arrays

    train_t, test_t = base_res["train"], base_res["test"]
    dims = train_t.dims
    J = base_res["cfg"].ranks[0]
    ccfg = cu.CuTuckerConfig(dims=dims, ranks=(J,) * len(dims),
                             batch_size=TRAIN_BATCH, backend="cuda")
    params0 = cu.init_params(torch.Generator(device="cuda").manual_seed(0),
                             ccfg, "cuda")
    before = _rmse(torch, params0, test_t, cu.predict)
    out = {"init": {"rmse": before[0], "mae": before[1]}}

    def measured(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        return res, dt, counts, peak

    def run_cu():
        gen = torch.Generator(device="cuda").manual_seed(1)
        st = cu.CuState(params0, 0)
        for _ in range(steps):
            st = cu.sgd_step(st, gen, train_t.indices, train_t.values, ccfg)
        return st.params

    rows = {}
    cu_params, dt, counts, peak = measured(run_cu)
    rows["cutucker"] = dict(params=cu_params, seconds=dt, counts=counts,
                            peak=peak, rate=f"{steps / dt:.1f} steps/s "
                            f"({steps} steps at batch {TRAIN_BATCH})")
    want_cu = {k: (len(dims) * steps if k == "scatter_accum" else 0)
               for k in REPLACES}
    if counts != want_cu:
        raise AssertionError(f"cuTucker: launch counts {counts}, want "
                             f"{want_cu}")
    for name, mod, cfg_cls in (("als", als, als.ALSConfig),
                               ("ccd", ccd, ccd.CCDConfig)):
        epoch = getattr(mod, f"{name}_epoch")
        cfg = cfg_cls(dims=dims, ranks=(J,) * len(dims))
        p, dt, counts, peak = measured(lambda: epoch(params0, train_t, cfg))
        p2, dt2, _, _ = measured(lambda: epoch(params0, train_t, cfg))
        repeats = _same_bits(tuple(p.factors), tuple(p2.factors))
        rows[name] = dict(params=p, seconds=dt, counts=counts, peak=peak,
                          rate=f"{dt:.4f} s an epoch ({dt2:.4f} s again; "
                          f"the two epochs' bits equal: {repeats})",
                          repeats_bitwise=repeats, seconds_again=dt2)
        if any(counts.values()):
            raise AssertionError(f"{name}: launched kernels {counts}; its "
                                 "segment sums are index_add_")
    for name, row in rows.items():
        r, m = _rmse(torch, row.pop("params"), test_t, cu.predict)
        log(f"baseline {name}: {row['rate']}; held-out rmse {before[0]:.5f} "
            f"-> {r:.5f}, mae {before[1]:.5f} -> {m:.5f}; peak device "
            f"bytes {row['peak']:,}; launch counts {row['counts']}")
        if not (math.isfinite(r) and math.isfinite(m) and r < before[0]):
            raise AssertionError(f"baseline {name}: rmse {before[0]} -> {r}")
        out[name] = dict(row, rmse=r, mae=m)
    fast = base_res["steps_per_s"]
    log(f"baseline cutucker: {steps / out['cutucker']['seconds']:.1f} steps/s "
        f"against FastTucker's unsorted {fast:.1f} (phase 3)")

    # Fig. 3-4 at FULL through the "cuda" backend
    K.reset_launch_counts()
    t0 = time.perf_counter()
    doc = bench_accuracy.run(smoke=False, device="cuda", backend="cuda")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    log(f"bench_accuracy FULL on {doc['platform']}: "
        f"{time.perf_counter() - t0:.1f}s, validator passed; launch counts "
        f"{counts}")
    for r in doc["results"]:
        log(f"bench_accuracy {r['model']}/{r['variant']} J={r['rank']}: "
            f"rmse {r['rmse']:.5f} mae {r['mae']:.5f} ({r['train_s']:.2f}s)")
    _check_path("bench_accuracy", counts,
                ("kruskal_contract", "kruskal_grad", "scatter_accum"),
                ("segment_reduce",))
    out["bench_accuracy"] = {"doc": doc, "launch_counts": counts}

    # cuTucker "cuda" against "torch": 20 fed batches from params0
    gen = torch.Generator(device="cuda").manual_seed(99)
    batches = [sample_batch_arrays(gen, train_t.indices, train_t.values,
                                   TRAIN_BATCH) for _ in range(20)]
    finals = {}
    for backend in ("cuda", "torch"):
        cfg = dataclasses.replace(ccfg, backend=backend)
        st = cu.CuState(params0, 0)
        for idx, val in batches:
            st = cu.sgd_step_batch(st, idx, val, cfg)
        finals[backend] = tuple(st.params.factors) + (st.params.core,)
    torch.cuda.synchronize()
    worst = worst_abs = 0.0
    for got, want in zip(finals["cuda"], finals["torch"]):
        e, r = rel_err(got, want)
        worst, worst_abs = max(worst, r), max(worst_abs, e)
    log(f"baseline parity: cuTucker 20 fed-batch steps cuda vs torch: max "
        f"abs diff {worst_abs:.3g}, max relative diff {worst:.3g} "
        f"(tolerance {TOL['trajectory']:.3g})")
    if not worst <= TOL["trajectory"]:
        raise AssertionError(f"cuTucker cuda vs torch differs: {worst:.3g}")
    out["parity"] = {"max_rel_diff": worst, "max_abs_diff": worst_abs}
    return out


# ---------------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------------

def _counts_are(what, counts, want) -> None:
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, want {want}")


def _serve_queries(torch, K, name, srv, plain, params, pool) -> dict:
    """One server: predict against the plain backend, bucket invariance,
    launch counts of every entry point, top-k and slices against dense
    slices of the tensor."""
    import numpy as np

    from repro_torch.core.kruskal import dense_reconstruct
    from repro_torch.serve import split_batch

    zero = {k: 0 for k in REPLACES}
    q = pool[:65_536]
    K.reset_launch_counts()
    got = srv.predict(q)
    torch.cuda.synchronize()
    chunks = len(split_batch(len(q), srv.ladder))
    _counts_are(f"serving [{name}] predict of {len(q):,} tuples",
                K.launch_counts(), dict(zero, kruskal_contract=chunks))
    err, rel = rel_err(got, plain.predict(q))
    alone, inside = srv.predict(q[:37]), srv.predict(q[:2048])
    same = bool(torch.equal(alone, inside[:37]))
    log(f"serving [{name}]: predict of {len(q):,} tuples in {chunks} bucket "
        f"chunks, {chunks} kruskal_contract launches; cuda vs torch max abs "
        f"diff {err:.3g}, {rel:.3g} of the largest (tolerance "
        f"{TOL['kruskal_contract']:g}); 37 tuples alone and inside a full "
        f"2048 bucket: same bits {same}")
    if not rel <= TOL["kruskal_contract"]:
        raise AssertionError(f"serving [{name}]: cuda predict differs from "
                             f"torch by {rel:.3g}")
    if not same:
        raise AssertionError(f"serving [{name}]: a request's predictions "
                             "depend on its bucket")

    k = SERVE_LOAD["k"]
    ids = pool[:SERVE_TOP_IDS, 0].copy()
    K.reset_launch_counts()
    scores, items = srv.top_k(0, ids, k)          # target 1, sums mode 2
    slices = srv.reconstruct_rows(0, ids[:SERVE_SLICE_IDS])
    uid = np.unique(ids)
    rows = srv.params.factors[0].index_select(
        0, torch.from_numpy(uid).long().cuda())
    srv.update_rows(0, uid, rows)
    srv.refresh_tables()
    torch.cuda.synchronize()
    _counts_are(f"serving [{name}] top_k, reconstruct_rows, update_rows, "
                "refresh_tables", K.launch_counts(), zero)
    ids_t = torch.from_numpy(ids).long().cuda()
    checked = 0
    worst_score = worst_slice = 0.0
    for c in range(0, len(ids), SERVE_SLICE_IDS):
        sel = ids_t[c:c + SERVE_SLICE_IDS]
        dense = dense_reconstruct(
            (params.factors[0].index_select(0, sel),) + tuple(
                params.factors[1:]), params.core_factors)
        if c == 0:
            worst_slice = rel_err(slices, dense)[1]
        dsc = dense.sum(dim=2)                     # (4, I_1), f32
        del dense
        for b in range(len(sel)):
            d, scale = dsc[b], dsc[b].abs().max().item()
            got_ids = items[c + b].long()
            worst_score = max(worst_score, (
                scores[c + b] - d[got_ids]).abs().max().item() / scale)
            top = torch.topk(d, k + 1)
            gap = (top.values[k - 1] - top.values[k]).item() / scale
            if gap > 1e-5:
                checked += 1
                if set(got_ids.tolist()) != set(top.indices[:k].tolist()):
                    raise AssertionError(
                        f"serving [{name}]: top_k ids of entity {ids[c + b]}"
                        f" {sorted(got_ids.tolist())} differ from the dense "
                        f"recompute's {sorted(top.indices[:k].tolist())}")
    log(f"serving [{name}]: top_k(mode 0 -> 1, k = {k}) of {len(ids)} "
        f"entities, mode 2 marginalized: ids equal to a dense f32 recompute "
        f"on the {checked} rows whose k-th and (k+1)-th scores differ by "
        f"more than 1e-5; scores within {worst_score:.3g} of the largest; "
        f"reconstruct_rows(mode 0, {SERVE_SLICE_IDS} ids) of "
        f"{tuple(slices.shape)} within {worst_slice:.3g} of dense_reconstruct"
        f" (tolerance {TOL['kruskal_contract']:g}); top_k, reconstruct_rows, "
        "update_rows and refresh_tables launched no kernel")
    if not (worst_score <= TOL["kruskal_contract"]
            and worst_slice <= TOL["kruskal_contract"]):
        raise AssertionError(f"serving [{name}]: top-k scores {worst_score}"
                             f" or slices {worst_slice} off the dense tensor")
    return {"predict_max_abs_err": err, "predict_rel_err": rel,
            "bucket_invariant": same, "top_k_rows_checked": checked,
            "top_k_score_rel_err": worst_score,
            "slice_rel_err": worst_slice}


def _serve_closed_loop(torch, K, name, srv, pool) -> tuple[list, dict]:
    """The reference's FULL closed-loop traffic on one server; the launch
    counts of these runs are the phase's main path."""
    from repro_torch.serve import AdmissionConfig, run_closed_loop

    L = SERVE_LOAD
    runs = [("predict", q) for q in L["predict_qps"]] + [
        ("top_k", L["top_k_qps"])]
    rows = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for i, (query, qps) in enumerate(runs):
        rep = run_closed_loop(
            srv, qps=qps, duration_s=L["duration_s"],
            concurrency=L["concurrency"], max_request=L["max_request"],
            admission=AdmissionConfig(microbatch=L["microbatch"]),
            query=query,
            top_k_args=(0, L["k"]) if query == "top_k" else None,
            request_pool=pool if query == "predict" else None, seed=i)
        lat = rep["latency_ms"]
        admitted = rep["requests"] - rep["shed_queue_full"]
        log(f"serving [{name}] closed loop, {query} at {qps:,.0f} q/s "
            f"offered: achieved {rep['achieved_qps']:,.1f} q/s over "
            f"{rep['duration_s']:.2f} s; latency p50 {lat['p50']:.3f} / p95 "
            f"{lat['p95']:.3f} / p99 {lat['p99']:.3f} ms; "
            f"{rep['served_requests']} of {admitted} admitted requests "
            f"answered, shed {rep['shed_queue_full']} at the queue and "
            f"{rep['shed_deadline']} at the deadline; {rep['flushes']} "
            "flushes")
        if rep["served_requests"] != admitted or rep["shed_deadline"]:
            raise AssertionError(f"serving [{name}]: {query} at {qps}: an "
                                 f"admitted request went unanswered: {rep}")
        rows.append({"query": query, **rep})
    torch.cuda.synchronize()
    counts = K.launch_counts()
    _counts_are(f"serving [{name}] closed loop", counts, dict(
        {k: 0 for k in REPLACES},
        kruskal_contract=max(counts["kruskal_contract"], 1)))
    return rows, counts


def _serve_refresh(torch, K, base_res, pool) -> tuple[dict, dict]:
    """The refresh supervisor over the paper's model on phase 3's tensor,
    with a query thread: patch equals rebuild, a faulted run equals the
    unfaulted one; update_rows against refresh_tables; staleness."""
    import threading

    from repro_torch.distributed import get_strategy
    from repro_torch.runtime.fault import FaultPlan
    from repro_torch.serve import (RefreshSupervisor, SupervisorConfig,
                                   TuckerServer)

    R = SERVE_REFRESH
    test_t = base_res["test"]
    n_arr = R["rounds"] * R["arrivals"]
    arr_idx = test_t.indices[-n_arr:].cpu().numpy()
    arr_val = test_t.values[-n_arr:].cpu().numpy()
    strategy = get_strategy("local")
    plan = strategy.prepare(base_res["train"], base_res["cfg"], None, seed=0)
    dstate = base_res["dstate"]
    params = strategy.eval_params(plan, dstate)
    scfg = SupervisorConfig(refresh_steps=R["steps"], window=R["arrivals"],
                            backoff_base_s=1e-3, backoff_cap_s=5e-3,
                            degraded_retry_s=5e-3, poll_interval_s=1e-3)
    probe = pool[:256]
    want = dict({k: 0 for k in REPLACES},
                kruskal_grad=R["rounds"] * R["steps"],
                scatter_accum=3 * R["rounds"] * R["steps"])

    def run(faults: str):
        srv = TuckerServer(params, backend="cuda")
        sup = RefreshSupervisor(
            srv, strategy, plan, dstate, config=scfg,
            fault_plan=FaultPlan.parse(faults) if faults else None)
        seen, errors, rounds = [], [], []
        stop = threading.Event()

        def queries():
            while not stop.is_set():
                try:
                    srv.predict(probe).cpu()
                    h = sup.health()
                    seen.append((h["generation"], h["staleness_s"]))
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)
                    return

        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        sup.start()
        qt = threading.Thread(target=queries, daemon=True)
        qt.start()
        try:
            for r in range(R["rounds"]):
                lo = r * R["arrivals"]
                sup.submit(arr_idx[lo:lo + R["arrivals"]],
                           arr_val[lo:lo + R["arrivals"]])
                if not sup.drain(timeout=300):
                    raise AssertionError(
                        f"serving refresh ({faults or 'no faults'}): round "
                        f"{r} did not publish: {sup.health()}")
                h = sup.health()
                rounds.append({"dirty_rows": h["last_dirty"],
                               "publish": h["last_publish"]["kind"],
                               "generation": h["generation"]})
        finally:
            stop.set()
            qt.join(timeout=60)
            sup.stop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        if errors or qt.is_alive():
            raise AssertionError(f"serving refresh: the query thread failed:"
                                 f" {errors[:3]}")
        if counts != dict(want, kruskal_contract=counts["kruskal_contract"]) \
                or counts["kruskal_contract"] < 1:
            raise AssertionError(f"serving refresh: launch counts {counts}, "
                                 f"want {want} and queries")
        stale = [st for _, st in seen]
        log(f"serving refresh ({faults or 'no faults'}): {R['rounds']} rounds"
            f" of {R['arrivals']:,} arrivals, K = {R['steps']} steps at batch"
            f" {base_res['cfg'].batch_size} each, {wall:.3f} s with "
            f"{len(seen)} queries beside them; per round dirty rows / "
            f"publish: " + "; ".join(
                f"{r['dirty_rows']} {r['publish']}" for r in rounds)
            + f"; staleness seen by the queries: median "
            f"{statistics.median(stale):.4f} s, max {max(stale):.4f} s over "
            f"{len({g for g, _ in seen})} generations; launch counts {counts}")
        return srv, sup, rounds, seen, counts, wall

    srv, sup, rounds, seen, counts, wall = run("")
    fresh = TuckerServer(sup.dstate.params, backend="cuda")
    patched_ok = all(torch.equal(a, b) for a, b in zip(srv._tables,
                                                       fresh._tables))
    synced_ok = all(torch.equal(a, b) for a, b in zip(
        srv.params.factors, sup.dstate.params.factors))
    log(f"serving refresh: the patched server's f32 tables equal a fresh "
        f"server's from the refreshed params bitwise: {patched_ok}; the "
        f"served factors equal the refreshed ones: {synced_ok}")
    if not (patched_ok and synced_ok):
        raise AssertionError("serving refresh: patched tables or factors "
                             "differ from a rebuild")
    srv2, sup2, rounds2, seen2, counts2, wall2 = run(SERVE_FAULTS)
    h = sup2.health()
    same = (all(torch.equal(a, b) for a, b in zip(srv._tables, srv2._tables))
            and all(torch.equal(a, b) for a, b in zip(
                sup.dstate.params.factors, sup2.dstate.params.factors))
            and torch.equal(sup.dstate.rng, sup2.dstate.rng))
    log(f"serving refresh with faults {SERVE_FAULTS!r}: {h['faults_injected']}"
        f" injected, {h['retries']} retries, {h['breaker_trips']} breaker "
        f"trips, {h['recoveries']} recoveries, {h['rounds_ok']} rounds "
        f"published; tables, "
        f"factors and generator state equal the unfaulted run's bitwise: "
        f"{same}")
    if not (same and h["breaker_trips"] >= 1 and h["recoveries"] >= 1
            and h["faults_injected"] == 4
            and h["rounds_ok"] == R["rounds"]):
        raise AssertionError(f"serving refresh: the faulted run did not "
                             f"degrade, recover and end on the unfaulted "
                             f"run's bits: {h}")

    # a patch of one refresh's dirty rows against a rebuild, on run 1's server
    _, dirty = strategy.refresh_steps(plan, sup.dstate, arr_idx[-R["arrivals"]:],
                                      arr_val[-R["arrivals"]:], R["steps"])
    cur = srv.params.factors

    def timed(fn, reps=5) -> float:
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    patch_s = [timed(lambda n=n: srv.update_rows(
        n, dirty[n], cur[n].index_select(0, torch.from_numpy(dirty[n])
                                         .long().cuda())))
               for n in range(len(dirty))]
    rebuild_s = timed(srv.refresh_tables)
    log(f"serving refresh: update_rows of one refresh's dirty rows "
        f"{[len(d) for d in dirty]}: " + " / ".join(
            f"{t * 1e3:.3f}" for t in patch_s) + " ms per mode, against "
        f"refresh_tables (all {sum(srv.dims):,} rows) {rebuild_s * 1e3:.3f} ms"
        " (host clock, closed by a synchronize; medians of 5)")
    profiles = {}
    for what, fn in (("update_rows, mode 0", lambda: srv.update_rows(
            0, dirty[0], cur[0].index_select(
                0, torch.from_numpy(dirty[0]).long().cuda()))),
                     ("refresh_tables", srv.refresh_tables)):
        wall, kernels = _profile_window(torch, fn)
        busy = sum(v[1] for v in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
        log(f"serving refresh profile [{what}]: {wall * 1e3:.3f} ms wall "
            f"under the profiler, device busy {busy / 1e3:.3f} ms in "
            f"{sum(v[0] for v in kernels.values())} device operations; "
            "largest: " + "; ".join(f"{n[:50]} {c}x {us:.1f} us"
                                    for n, (c, us) in top))
        profiles[what] = {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
                          "device_ops": sum(v[0] for v in kernels.values())}
    stale = [st for _, st in seen]
    rec = {"rounds": rounds, "wall_s": wall, "queries": len(seen),
           "staleness_median_s": statistics.median(stale),
           "staleness_max_s": max(stale), "launch_counts": counts,
           "patch_equals_rebuild": True, "faulted": {
               "rounds": rounds2, "wall_s": wall2, "health": h,
               "launch_counts": counts2, "equals_unfaulted": True},
           "update_rows_s": patch_s, "refresh_tables_s": rebuild_s,
           "profiles": profiles,
           "dirty_rows_timed": [len(d) for d in dirty]}
    main = {k: counts[k] + counts2[k] for k in REPLACES}
    return rec, main


def _serve_times(torch, K, servers, pool) -> list[dict]:
    """``kruskal_contract`` (pred only) at serving's shapes, by phase 5's
    method, beside its byte bound, its plain version and torch.einsum."""
    ref = K.ref
    kc = K.kruskal_contract.kruskal_contract
    floor = floor_ms(torch, K.build)
    out = []
    for B, R in SERVE_TIME_SHAPES:
        srv = servers[R]
        N = srv.order
        idx = torch.from_numpy(pool[:B]).cuda()
        a = torch.stack([t.index_select(0, idx[:, n])
                         for n, t in enumerate(srv._tables)])
        b = torch.stack(srv._eyes)
        letters = "ijklmnopq"[:N]
        expr = (",".join(f"b{c}" for c in letters) + ","
                + ",".join(f"{c}r" for c in letters) + "->b")
        xs, ys = list(a), list(b)
        ms = device_ms(torch, lambda: kc(a, b, False))
        plain = device_ms(torch, lambda: ref.kruskal_contract_ref(a, b))
        lib = device_ms(torch, lambda: torch.einsum(expr, *xs, *ys),
                        iters=30)
        t_b, by = bound(4 * (N * B * R + N * R * R) + 4 * B,
                        2 * N * B * R * R + 3 * N * B * R + 2 * B * R)
        dev = profiled_ms(torch, lambda: kc(a, b, False),
                          DEVICE_KERNEL["kruskal_contract"])
        tag = f"serving predict, B = {B}, J = R = {R}"
        log(f"kruskal_contract [{tag}]: {ms * 1e3:.2f} us/call (plain "
            f"{plain * 1e3:.2f} us, torch.einsum {lib * 1e3:.2f} us), bound "
            f"{t_b * 1e3:.3f} us by {by}, launch floor {floor * 1e3:.2f} us;"
            " profiler device duration " + (
                f"{dev * 1e3:.2f} us" if dev else "not measured"))
        out.append({"name": "kruskal_contract", "variant": tag, "ms": ms,
                    "plain_ms": plain, "library_ms": lib, "bound_ms": t_b,
                    "bound_by": by, "floor_ms": floor, "device_ms": dev,
                    "launches_note": "1 per predict bucket chunk"})
    return out


def phase_serving(torch, K, base_res, wide_params
                  ) -> tuple[dict, list[dict], dict]:
    """Tucker serving of phase 3's unsorted model and of the rank-64 model
    of phase 3's wide run: queries, launch counts, the closed loop, the
    refresh supervisor, kernel times, peak bytes, one profiled second."""
    from repro_torch.serve import AdmissionConfig, TuckerServer, \
        run_closed_loop

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pool = base_res["test"].indices[:SERVE_POOL].cpu().numpy()
    models = {"paper, J = R = 4": base_res["state"].params,
              "rank 64": wide_params}
    rec = {"models": {}}
    main = {k: 0 for k in REPLACES}
    servers = {}
    for name, params in models.items():
        srv = TuckerServer(params, backend="cuda")
        plain = TuckerServer(params, backend="torch")
        servers[srv.core_rank] = srv
        m = _serve_queries(torch, K, name, srv, plain, params, pool)
        del plain
        m["closed_loop"], counts = _serve_closed_loop(torch, K, name, srv,
                                                      pool)
        for k, v in counts.items():
            main[k] += v
        rec["models"][name] = m
    rec["refresh"], counts = _serve_refresh(torch, K, base_res, pool)
    for k, v in counts.items():
        main[k] += v
    times = _serve_times(torch, K, servers, pool)
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    log(f"serving: peak device bytes {rec['peak_device_bytes']:,} (two "
        "models' tables, their plain twins and phase 3's tensor resident)")

    L = SERVE_LOAD
    srv = servers[4]
    held = {}
    wall, kernels = _profile_window(torch, lambda: held.update(rep=(
        run_closed_loop(srv, qps=L["predict_qps"][1], duration_s=1.0,
                        concurrency=L["concurrency"],
                        max_request=L["max_request"],
                        admission=AdmissionConfig(microbatch=L["microbatch"]),
                        request_pool=pool, seed=9))))
    flushes = held["rep"]["flushes"]
    if kernels:
        busy = sum(v[1] for v in kernels.values())
        ops = sum(v[0] for v in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
        log(f"serving profile (paper model, predict at "
            f"{L['predict_qps'][1]:,.0f} q/s offered, 1 s): device busy "
            f"{busy / 1e3:.2f} ms of {wall * 1e3:.1f} ms wall = "
            f"{busy / (wall * 1e6):.2%}; {ops} device operations over "
            f"{flushes} flushes = {ops / max(flushes, 1):.1f} per flush; "
            "largest: " + "; ".join(f"{n[:40]} {c}x {us / 1e3:.2f} ms"
                                    for n, (c, us) in top))
        rec["profile"] = {"measured": True, "wall_s": wall,
                          "device_busy_ms": busy / 1e3,
                          "busy_share": busy / (wall * 1e6),
                          "device_ops": ops, "flushes": flushes,
                          "ops_per_flush": ops / max(flushes, 1)}
    else:
        log("serving profile: the profiler recorded no device time (not "
            "measured)")
        rec["profile"] = {"measured": False, "wall_s": wall}
    return rec, times, main


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on the card.")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--nnz", type=int, default=NETFLIX_NNZ,
                    help="nonzeros of the Netflix-shaped tensor (a cut is "
                         "printed)")
    ap.add_argument("--lm-layers", type=int, default=40,
                    help="layers of the served Qwen3-14B (a cut is "
                         "printed)")
    ap.add_argument("--report", default="",
                    help="also write the full record as JSON to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels as K
    from repro_torch.core import fasttucker as ft
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve, std_train, train

    t_start = time.perf_counter()
    report = {"environment": phase_environment(torch, build)}
    report["kernels_vs_plain"] = phase_kernels_vs_plain(torch, K)
    paths = phase_slice(torch, K, std_train, args.steps, args.nnz)
    report["paths"] = {}
    counts = {k: 0 for k in REPLACES}
    for name, p in paths.items():
        res = p["result"]
        report["paths"][name] = {k: v for k, v in res.items()
                                 if k in ("history", "steps_per_s",
                                          "nnz_per_s", "peak_device_bytes",
                                          "data_seconds", "train_seconds")}
        report["paths"][name]["launch_counts"] = p["counts"]
        for k, v in p["counts"].items():
            counts[k] += v
    report["nnz"] = args.nnz
    report["wide"], wide_params = phase_wide(torch, K, std_train)
    base = paths["unsorted"]["result"]
    report["parity"] = phase_parity(torch, ft, base)
    times = phase_times(torch, K, ft, base, counts)
    report["times"] = times
    report["profile"] = {
        name: phase_profile(torch, K, ft, paths[name]["result"],
                            paths[name]["result"]["cfg"])
        for name in PATHS}
    lm_cfg = dataclasses.replace(get_config("qwen3_14b"),
                                 tucker_rank=LM_RANK,
                                 num_layers=args.lm_layers)
    report["lm_kernels_vs_plain"] = phase_lm_kernels_vs_plain(torch, K,
                                                              lm_cfg)
    report["lm_serve"] = phase_lm_serve(torch, K, serve, lm_cfg)
    report["lm_parity"] = phase_lm_parity(torch, lm_cfg)
    times += phase_lm_times(torch, K, lm_cfg)
    t_train = time.perf_counter()
    report["flash_bwd"], bwd_times = phase_flash_bwd(torch, K, lm_cfg)
    times += bwd_times
    train_cfg = dataclasses.replace(lm_cfg, num_layers=LM_TRAIN["layers"])
    report["lm_train"] = phase_lm_train(torch, K, train, train_cfg)
    report["lm_train_parity"] = phase_lm_train_parity(torch, train,
                                                      train_cfg)
    report["train_phases_seconds"] = time.perf_counter() - t_train
    log(f"phases 11-13 (LM training): {report['train_phases_seconds']:.1f}s")
    for k in LM_KERNELS:   # the serve request and the training run
        counts[k] = sum(report[p]["launch_counts"].get(k, 0)
                        for p in ("lm_serve", "lm_train"))
    t_new = time.perf_counter()
    report["driver"] = phase_driver(torch, K, std_train, base, args.steps)
    report["baselines"] = phase_baselines(torch, K, base, args.steps)
    report["driver_baselines_seconds"] = time.perf_counter() - t_new
    log(f"phases 14-15 (driver, baselines): "
        f"{report['driver_baselines_seconds']:.1f}s")
    t_serve = time.perf_counter()
    report["serving"], serve_times, serve_counts = phase_serving(
        torch, K, base, wide_params)
    times += serve_times
    report["serving_seconds"] = time.perf_counter() - t_serve
    log(f"phase 16 (Tucker serving): {report['serving_seconds']:.1f}s")
    for run in report["driver"]["runs"].values():
        for k, v in run["launch_counts"].items():
            counts[k] += v
    for part in (report["baselines"]["cutucker"]["counts"],
                 report["baselines"]["bench_accuracy"]["launch_counts"],
                 serve_counts):
        for k, v in part.items():
            counts[k] += v
    report["seconds"] = time.perf_counter() - t_start

    errs = report["kernels_vs_plain"]
    lm_errs = report["lm_kernels_vs_plain"]
    max_err = {
        "kruskal_contract": errs["kruskal_contract"]["max_abs_err"],
        "kruskal_grad": max(errs["kruskal_grad.rows"]["max_abs_err"],
                            errs["kruskal_grad.core"]["max_abs_err"]),
        "scatter_accum": errs["scatter_accum"]["max_abs_err"],
        "segment_reduce": errs["segment_reduce"]["max_abs_err"],
        "tucker_matmul": lm_errs["tucker_matmul"]["max_abs_err"],
        "flash_attention": lm_errs["flash_attention"]["max_abs_err"],
        "flash_attention_bwd": report["flash_bwd"]["max_abs_err"],
    }
    kernels = []
    for name in sorted(REPLACES):
        t = next(t for t in times if t["name"] == name)  # the path's main
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "floor_ms": t["floor_ms"], "device_ms": t.get("device_ms")})
    report["kernels"] = kernels
    if args.report:
        path = Path(args.report)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1, default=str))
    log(f"launches on the main paths (the three training paths, the "
        f"phase 14's nine runs, cuTucker's SGD run, bench_accuracy, and "
        f"phase 16's closed loops and refresh rounds; the LM serve request "
        f"and the LM training run for {', '.join(LM_KERNELS)}): {counts}")
    log(f"total {report['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
