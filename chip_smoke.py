#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FastTucker on one CUDA card and check it.

    python3 chip_smoke.py [--steps 600] [--nnz 99072112] [--lm-layers 40]
                          [--report PATH] [--bench-out build/bench]

Phases (each failure ends the run with a non-zero exit code):

1. Environment: the card's name and power limit (``nvidia-smi``), torch and
   nvcc versions, and the parallel ``nvcc`` build of the eight kernel
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
   exactly.  ``segment_reduce``'s walk route at the ALS and CCD shapes
   (2^22 x 16 over 85 of mode 2's rows and over all of mode 0's; 2^23 x 1
   over mode 2) must match exactly too.
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
   ALS epoch and one CCD epoch, each twice: the two epochs' bits must be
   equal (ordered segment sums), and they launch exactly the
   ``segment_reduce`` calls the code implies and no other kernel (ALS:
   modes x chunks x (Gram slices + 1); CCD: modes x 2J); seconds,
   held-out RMSE/MAE before and after (must fall) and peak device bytes
   of each, and the seconds of the same epochs with ``segment_reduce``'s
   staged route forced and with ``index_add_`` in place of the fold.  Then
   ``bench_accuracy`` at ``FULL`` through the ``"cuda"`` backend, whose
   validator must pass (the paper's two accuracy claims), and cuTucker on
   ``"cuda"`` against ``"torch"``: 20 fed-batch steps from the same
   parameters within the 1e-4 relative of phase 4.
16. Tucker serving (``repro_torch.serve``) of phase 3's unsorted model
   (J = R = 4) and of the rank-64 model of phase 3's wide run, no new
   training: ``predict`` on ``"cuda"`` against a ``"torch"`` server
   (2e-5 of the largest), a request's bits alone and inside a full 2048
   bucket, exactly one ``kruskal_contract`` per bucket chunk, no kernel
   from ``top_k`` or ``reconstruct_rows``, one ``patch_table_rows`` from
   ``update_rows`` and one ``mode_product_rows`` a mode from
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
   exactly K ``kruskal_grad`` and 3K ``scatter_accum`` a round, and one
   ``patch_table_rows`` a patched mode (one ``mode_product_rows`` a mode
   in a rebuild round); the
   patched tables bitwise a fresh server's from the refreshed params; a
   second run under ``FaultPlan.parse("refresh@0:1:2,publish@0")``
   degrades, recovers and ends on the first run's tables, factors and
   generator state bitwise; ``update_rows`` against ``refresh_tables``
   seconds (the new rows gathered before the clock starts, and again with
   each call's gather in the window as the refresh supervisor pays it: an
   ``index_select`` by the refresh's ids on the device, no host-to-device
   copy; mode 0's patch, alone and gathered, medians of 7 in turns with
   the rebuild, must each beat the rebuild; in the same turns the
   supervisor's whole publish of a patch round, every mode gathered and
   patched between its drift check's colsum reads, is recorded beside the
   rebuild, not asserted) and, over 20 profiled calls,
   each one's host and device time by operation; one
   ``update_rows`` call's host time split by stage (``patch_host_split``);
   dirty rows per round and the staleness the queries saw.
   ``kruskal_contract`` (pred only) at B in {256, 2048}, J = R in {4, 64}
   by phase 5's method beside its byte bound and ``torch.einsum``; peak
   device bytes; one profiled closed-loop second (busy share, device
   operations per flush).
17. The sketched warm start and the adaptive rank over phase 3's tensor
   with the reference's sketch defaults (sketch batch = 4096, 2 passes,
   R_s = 8, 2 core sweeps, 4 refine passes over every training nonzero):
   the warm start twice and once in 3 shards, bitwise equal, with each
   stage's seconds, peak bytes and exactly ``num_shards`` ``kruskal_grad``,
   N ``scatter_accum`` and the ALS refinement's ``segment_reduce``
   launches; the warm arm (``std_train --warm-start``, ``--steps`` steps)
   against phase 3's cold unsorted run: the same batches (the generator
   states equal), both trajectories finite, step 0 and final RMSE beside
   the cold arm's and the zero predictor's, the steps and seconds to the
   cold arm's final RMSE; the whole warm start on ``"cuda"`` against
   ``"torch"`` at ``bench_convergence``'s FULL shape (each leaf within
   2e-3 of its largest); ``bench_convergence`` FULL with its validator
   (both configs since PR 27; phase 22 writes its document);
   ``std_train --adaptive-rank --refine als`` (core rank 4 up to 16, an
   evaluation every 100 steps: each transition and the RMSE after it);
   the range finder's ``kruskal_grad`` call and an ALS chunk's
   ``segment_reduce`` by phase 5's method beside their bounds, plain
   versions and ``zeros`` + ``index_add_``.
18. The port's benchmarks (``repro_torch.benchmarks``) at FULL on
   ``"cuda"``.  First the serving tables' kernels against their plain
   versions: ``mode_product_rows`` bitwise at M ∈ {1, 600, 60,000} and
   J = R ∈ {4, 64}, at every table the main paths build and on both
   sides of each route's tile edge at J = R ∈ {1, 3, 5, 8, 9, 33, 63, 64}
   (``MPR_SHAPES``), in f32 and bf16; ``patch_table_rows`` at 1, 600 and
   6,000 dirty rows of 60,000, at ``bench_refresh``'s fractions, at a
   phase-16 refresh round's modes and at the patch tiles' edges
   (``PATCH_SHAPES``): table and mirror bitwise the plain patch and the
   patched table bitwise a rebuild, the colsum within 1e-5; the largest
   absolute errors measured go on the kernels line; their times by phase
   5's method, and again with the inputs rotated over sets past the 50 MB
   L2 (``cold``: what a refresh's rebuild sees), beside plain versions, ``torch.matmul`` and bounds that
   count (2J − 1)·M·R separate f32 instructions at half the FMA rate
   (33.5 T/s: no FMA, so a patched row is bitwise a rebuilt one), the
   FMA-rate figure logged beside; ``update_rows`` (1 % and 10 % of mode
   0, each with its host split by stage) and ``refresh_tables`` at
   ``bench_refresh``'s FULL shape (rank 64),
   each operation's host and device time a call, on ``"cuda"`` and on
   the plain path (``"torch"`` on the card: the operations the server ran
   before the kernels), and ``bench_refresh`` FULL on that plain path,
   recorded beside the kernels' run with its validator's verdict (logged,
   not a failure: the contract is the kernels' path).  Then, each with
   its launch counts: Fig. 5
   (``bench_param_sweep``) and Fig. 7a (``bench_order_scaling``), each
   point's wall time and growth factor and its device time a step from a
   short profile; Table 13 (``bench_sota_time.run``) and the step sweep
   (``run_step_sweep``, ``validate_bench_step``); ``bench_refresh
   --supervised`` at rank 64,
   whose validator holds the patch to beating the rebuild at every dirty
   fraction ≤ 10 %; ``bench_lm_step``; the fusion compare
   (``bench_kernel_blocks``: ``batch_gradients`` exactly one
   ``kruskal_grad`` launch); the examples ``decompose_ratings`` (stopped
   at 400 steps, resumed to 800: bitwise an uninterrupted run) and
   ``serve_batched``.  Their documents go to ``--bench-out``
   (``BENCH_torch_step.json``, ``BENCH_torch_refresh.json``; phase 21
   adds ``BENCH_torch_serve.json``).
19. Online training and the data layer over phase 3's tensor, through
   ``repro_torch.launch.online_train.run``: ``--steps`` warm-up steps at
   batch 4096, then 4 rounds of 65,536 arrivals (``--stream-fraction
   0.00294`` of the training nonzeros; window one round), K = 4 refresh
   steps a round.  Run A spills its ``NonzeroStore`` under ``build/``
   (``--spill-dir --verify``): the patched f32 tables bitwise a fresh
   server's, the spilled store reopened equal to ``NonzeroStore.build`` in
   memory of the warm set and every arrival, array for array, and each
   round's launches exactly K ``kruskal_grad``, 3K ``scatter_accum`` and
   one ``patch_table_rows`` a patched mode (one ``mode_product_rows`` a
   mode in a rebuild round); per round the ingest, transfer, refresh and
   publish seconds, dirty rows, store bytes and held-out RMSE, and each
   run's publish seconds split by kind (patch rounds, rebuild rounds).
   Run B keeps
   its store in memory under ``--inject-faults
   refresh@0:1:2,publish@0,ingest@1 --expect-breaker --verify``: it
   degrades, recovers and ends on run A's tables, factors and generator
   state bitwise, with run A's store arrays.  Then ``StratumPrefetcher``
   over an in-memory ``NonzeroStore.build(train, 4)`` (16 strata; its L,
   sized by the counting pass on the card, must be the one the host
   digits' bucket fills give, and the mask's fills those fills), one
   epoch at depth 0 and at depth 2 and once under
   ``FaultPlan.parse("transfer@3")`` (absorbed by one retry): every block
   bitwise the store's chunk, at most depth + 1 sets of pinned staging
   buffers allocated over the walk,
   seconds a block and H2D GB/s.  Every phase's disk writes are reckoned
   (the LM checkpoint, phase 14's checkpoints, the store and its
   appends, ...) and their total is printed and must stay under the
   machine's 45 GiB.
20. The multi-device strategies over phase 3's tensor on
   ``STRAT_WORKERS`` = 4 workers sharing the card
   (``make_host_mesh``, ``$REPRO_FORCE_HOST_DEVICES`` = 4), each run
   ``std_train.run`` for ``STRAT_STEPS`` steps (``--steps`` where fewer)
   at batch 4096 a worker, an
   evaluation every third of the run: ``--strategy sync``, ``strata``
   (checkpointed), ``strata_overlap``, ``strata --sorted-batches``,
   ``strata --out-of-core --spill-dir build/... --prefetch-depth 2``,
   ``sync --compress``, ``strata --compress``, and a strata run stopped
   after its second checkpoint then resumed with ``--resume``.  Each run:
   held-out RMSE/MAE before and after (must fall), steps/s and nonzeros/s
   (4 x 4096 a step), bytes rotated a step, peak device bytes, the plan's
   (layout build's) and the store's seconds, and its launches held
   exactly to 4 ``kruskal_grad`` and 12 ``scatter_accum`` (12
   ``segment_reduce`` sorted) a step and one ``kruskal_contract`` an
   evaluation chunk.  The overlapped, sorted, out-of-core and resumed
   runs must equal the plain strata run bitwise (every worker's shards,
   core replicas and generator state); the compressed runs' residuals
   finite and not all zero.  Then 20 fed-pick steps of sync, strata and
   strata_overlap on ``"cuda"`` against ``"torch"`` (phase 4's 1e-4); four
   steps of each (one ``strata_overlap`` chunk) under ``torch.profiler``:
   wall time a step, the device's busy share, device operations a step,
   and the side-stream copies' time beside a compute-stream kernel
   (reported, not asserted);
   and ``online_train --strategy strata`` at M = 4 (``STRAT_STEPS`` warm-up
   steps, 2 rounds of 65,536 arrivals, the store in memory, ``--verify``:
   the tables bitwise a fresh server's, each round's launches as phase
   19's).
21. Sharded Tucker serving on ``SHARD_WORKERS`` = 4 workers sharing the
   card (``make_host_mesh(num_workers=4)``): for phase 16's two models
   (the paper's J = R = 4 and the rank-64 one) a row-sharded and a
   batch-sharded server against the unsharded ``"cuda"`` server and the
   ``"torch"`` one: ``predict`` of 65,536 tuples bitwise the unsharded
   server's (2e-5 of the plain one), exactly one ``kruskal_contract`` a
   bucket chunk (row) or four (batch), the bytes its row-owner gather
   copied equal to the count of rows off worker 0 (batch: none);
   ``top_k`` (mode 0 -> 1, and mode 1 -> 0 whose last block ends in
   padding rows) and ``reconstruct_rows`` within 2e-5, ids equal where
   the k-th and (k+1)-th scores differ by more than 1e-5, no launch.  A
   ``RefreshSupervisor`` over a row-sharded server of the paper's model:
   4 patch rounds and a rebuild round of 65,536 arrivals, each round
   exactly K ``kruskal_grad``, 3K ``scatter_accum`` and one
   ``patch_table_rows`` a worker holding a mode's dirty rows (12
   ``mode_product_rows`` in the rebuild); the joined tables bitwise a
   fresh unsharded server's, colsums within 1e-5; then the sharded
   ``update_rows`` of the last round's mode-0 rows against the sharded
   rebuild (medians of 7 in turns, recorded).  ``auto``: batch at 16,000
   q/s declared, row with no rate, row for the rank-64 tables under a 64
   MiB ceiling.  ``serve_tucker --sharded --shard-mode row`` and
   ``online_train --strategy strata --serve-shard-mode row`` at phase
   20's online settings (``--verify``: every worker's block bitwise a
   fresh sharded server's).  ``bench_serve`` FULL at devices 4
   (``validate_bench_serve``: the collectives' reduction > 1, the
   crossover) into ``--bench-out``.
22. The multi-device benchmarks at FULL on workers sharing the card.
   ``bench_multidev`` (Fig. 7b/c: 1024 x 768 x 512, 100,000 nonzeros,
   J = R = 8, global batch 8192) at M = 2 and 4, every strategy one
   untimed and one timed epoch of M^2 steps: ``coll_no_worse`` and
   ``rotation_hidden`` over the epoch at both M, sync's psum a step equal
   to the shapes' 74,496 / 111,744 bytes, every ``work_scaling_eff``
   within 1 % of 1, exactly M ``kruskal_grad`` and 3M ``scatter_accum`` a
   step (1 and 3 for local); each row beside the reference's figures
   (``REF_FIG7BC``); the side copies' share beside compute (reported).
   ``bench_ingest`` FULL (10^6 and 10^7 nonzeros, 4 workers, stores
   spilled under ``build/``): the resident run where the store fits the
   128 MiB budget, store-fed states bitwise it, skipped at 10^7; attached
   to phase 18's ``BENCH_torch_step.json`` through ``validate_bench_step``.
   ``bench_convergence`` FULL with ``planted_local`` and ``planted_strata``
   (2 workers) through its validator into ``BENCH_torch_convergence.json``.
   The multipod example
   (``strata_overlap``, 8 workers, 200 steps): RMSE finite and falling.
23. Sharded LM training, M = 4 workers sharing the card, full width
   (``SHARDED_LM``): ``tucker_matmul`` (forward and dx, x bf16 and f32)
   and the flash forward and backward against their plain versions at
   the per-worker shapes of every (c) run, within phase 11's bounds;
   (a) a (1, 1) mesh's 3 fed steps at 2 layers within
   1e-5 of ``make_train_step`` (loss, params, m, v); (b) fsdp_tp (2, 2),
   zero3 (4, 1), tp (1, 4) and zero3_dp (2, 2), 3 fed steps at 2 layers,
   global batch 4, the residual stream in f32 (``SHARDED_LM``'s note),
   against the unsharded ``"cuda"`` step under phase 13's bounds (loss
   2⁻⁷, each moment 2⁻⁵ of its largest, the parameters where the
   reference's |g| is past a quarter of its leaf's largest at every step
   within 2⁻⁵ of the summed lr: each step moves a parameter by about
   lr·sign, so one flipped sign costs 2 lr), and in the config's bf16
   one step of tp (1, 4) and of zero3 (4, 1) with the ``"cuda"`` backend
   against ``"torch"`` on the same mesh, as phase 13 holds them; (c) each
   pair 6 steps at 4 layers in bf16 through ``launch/train.run --mesh``:
   steps/s, tokens/s, peak device bytes, state bytes a worker (equal to the
   layouts' count) and the collective bytes a step; loss finite and falling;
   (d) exactly 6·L·W ``tucker_matmul``, L·W of each flash kernel a step
   (W = 4); (e) a failure at step 7 of 8 replayed from the step-5
   checkpoint within 1e-5 of the uninterrupted (2, 2) fsdp_tp run, and
   that checkpoint restored into (4, 1) zero3 and into one device, every leaf bitwise (2 layers,
   vocab cut to 32,768: phase 12's checkpoint leaves no room under the
   machine's 45 GiB of writes for a full-vocab one).
24. MoE and MLA serving at full width.  (a) The flash kernel at MLA's
   (D, Dv) = (192, 128) against its plain version at the prefill's shapes
   (B = 4, H = Kv = 16 into the 2,080 cache: Sq = 2,048 with kv_len
   2,048; Sq = 2,047; Sq = 1,024 behind ``q_offset`` 1,024) and at
   Qwen3-MoE's prefill (B = 4, H = 32 over Kv = 4, D = 128, Sq = 2,048
   into the 2,056 cache), with and without the lse, within 2e-5 (phase
   7's bound), two calls bitwise
   equal; its time by phase 5's method beside the bound (3xTF32 at 495
   TFLOP/s), the plain version and ``scaled_dot_product_attention`` in
   f32, the kernel and SDPA timed in turns (``alternate_ms``: ``ROUNDS``
   rounds, the medians).  (b) DeepSeek-V2-Lite (``MOE_SERVE``: the
   published 27 layers, 15.7 B f32 parameters drawn on the card) through
   ``launch/serve.run``: batch 4, prompt 2,048, 32 greedy tokens, a
   warm-up request then the measured one; init, prefill and decode times,
   peak device bytes (under 80 GB; 76 GB is the aim), finite logits,
   exactly L ``flash_attention`` launches a prefill, none in decode and no
   other kernel; ``torch.profiler`` windows of a prefill and of three
   decode steps, as phase 8's.  The warm-up prints the share of picks the
   capacity dropped at prefill and at decode, and fails if the first MoE
   layer's routed output (less the shared experts') is all zero, which
   the reference's dispatch fault would give (ROADMAP.md, Queue 3).
   (c) Parity at 2 layers (the dense one and one MoE layer), batch 2,
   prompt 2,048, 4 fed decode steps, the residual stream in f32:
   ``"cuda"`` against ``"torch"``, the logits within 1e-4 on the tokens
   whose routes agree, the routes recomputed from every MoE call's input;
   a pick that differs must lie within ``ROUTE_MARGIN`` of another of the
   token's best router logits; and the absorbed decode
   (``mla_absorb=True``) against the decompressing one within the
   reference's 3e-3.  (d) Qwen3-MoE-30B-A3B at full width and 8 of its 48
   layers (``MOE_SERVE``), batch 4, prompt 2,048, 8 tokens: finite logits,
   L flash launches a prefill (D = 128, G = 8), times, peak and drops.
25. MoE and MLA training at full width.  (a) The flash backward at MLA's
   (D, Dv) = (192, 128) (16-row ring tiles) against its plain version at
   the training shape (B = 2, H = Kv = 16, S = 2,048, causal), at
   S = 2,047, at Sq = 1,024 behind ``q_offset`` 1,024 and non-causal with
   kv_len < Sk: dq, dk, dv each within 2e-5 of its largest, two calls
   bitwise, and the forward with the lse that feeds it within 2e-5; the
   backward's time beside the bound (3xTF32 at 495 TFLOP/s), the plain
   version and the f32 backward of ``scaled_dot_product_attention``, and
   the forward's with the lse (row 6d) beside
   ``_scaled_dot_product_efficient_attention(compute_log_sumexp=True)``
   in f32, the one PyTorch call that returns the output and the lse (or
   why it refuses, logged), each in turns with its yardstick.
   bf16 q, k, v (o and dO in the backward) into both kernels at every
   width (``BF16_SHAPES``: Qwen3-14B's G = 5 and Qwen3-MoE's G = 8 at 128,
   MLA's (192, 128)): the forward with and without the lse and the
   backward give the f32 kernels' bits on the inputs widened to f32 (the
   forward's output rounded to bf16), or within 2e-5 where not (logged);
   their times at MLA's shape beside bf16 SDPA, in turns, and the bf16
   forward's time against the f32 one's; their bound prices each product
   at the 989 TFLOP/s bf16 peak, one pass for bf16 × bf16 and three where
   a side is f32 (``bf16_bound``).  (b) DeepSeek-V2-Lite and
   (c) Qwen3-MoE at full width and 4 layers (``MOE_TRAIN``; the cut is
   logged) through ``launch/train.run``: batch 2 × 2,048, 20 steps, no
   checkpoint; steps/s, tokens/s, peak (under 80 GB), finite and falling
   loss, exactly L ``flash_attention`` and L ``flash_attention_bwd``
   launches a step and no other kernel, the capacity's drop share over
   one batch; one more DeepSeek step under the profiler.  (d) ``"cuda"``
   against ``"torch"`` at 2 layers of DeepSeek-V2-Lite in f32 with phase
   13's bounds, both runs' picks recorded through ``models.moe.route``
   (wrapped here), each differing pick within ``ROUTE_MARGIN`` and the
   ``"torch"`` run then fed the ``"cuda"`` run's picks.  (e)
   ``mixed_precision``: DeepSeek-V2-Lite at 4 layers for 10 steps, every
   flash call bf16 at (192, 128), loss finite and falling, and (d) again
   in mixed precision within 2⁻⁵ (picks within ``MIXED_ROUTE_MARGIN``).
26. Sharded MoE and MLA training on four workers sharing the card
   (``phase_sharded_moe``).
27. The last five attention-only configs at full width
   (``phase_attention_archs``).  (a) Both flash kernels at HuBERT-XLarge's
   head width (``HUBERT``: D = Dv = 80, B = 4, H = Kv = 16, non-causal) at
   S = 1,500 and at S = 1,499 with kv_len 1,421 against their plain
   versions within 2e-5, the forward's output the same bits with and
   without the lse, two backward calls bitwise, bf16 bitwise the f32
   kernels on the widened inputs; five routes' times beside bounds, plain
   versions and ``scaled_dot_product_attention(is_causal=False)`` in
   turns.  Both f32 kernels at D = 128, causal, at the head groupings the
   dense and vision main paths bring (StarCoder2-15B 48/4, DeepSeek-67B
   64/8, InternVL2-2B 16/8) within 2e-5 of their plain versions: the
   forward at the serving batch, the forward with the lse and the
   backward at the training batch.  (b) Serving: Qwen2.5-14B (48 layers) and StarCoder2-15B (40)
   through ``launch/serve.run`` as phase 8 (no warm-up request: the
   kernels are warm), DeepSeek-67B likewise at the depth whose f32
   weights fit under 76 GB (``P27_SERVE``, a ``CUT:`` line), InternVL2-2B
   (24) through ``make_prefill_step`` on an ``input_specs`` batch of 256
   patches and 1,792 tokens then text decode from index 2,048, HuBERT
   (48) through ``make_encoder_step`` over 4 × 1,500 frames: finite
   logits, exactly L ``flash_attention`` launches a prefill or encoder
   step and none in decode, peak under 80 GB.  (c) Training, 8 steps
   each (``P27_TRAIN``): Qwen2.5 and StarCoder2 at 4 layers,
   DeepSeek-67B at 2 (a ``CUT:`` line), InternVL2 (24, text alone)
   through ``train.run``, HuBERT (48) through ``make_train_step`` on
   ``concretize``d ``input_specs`` batches in f32 and in
   ``mixed_precision``: loss finite and falling, exactly L forward and L
   backward flash launches a step, peak under 80 GB.  (d) ``"cuda"``
   against ``"torch"`` at 2 layers of HuBERT and Qwen2.5 under
   ``mixed_precision`` (every cuda flash call bf16) under phase 13's
   bounds.  Each run's flash calls are checked to take one route
   (``_flash_calls``), under which its launch counts are summed.

It prints a ``{"kernels": [...]}`` line (with ``floor_ms``, the launch
floor, and ``device_ms``, the profiler's device duration where phase 5
took it, beside each kernel; ``flash_attention_mla`` is the flash
kernel's (192, 128) route, its launches DeepSeek-V2-Lite's serve
request's and training run's; ``flash_attention_bwd_mla`` the backward's
(192, 128) route, its launches that training run's;
``flash_attention_bf16`` and ``flash_attention_bwd_bf16`` the bf16
routes, their launches the mixed-precision run's; the ``_d80`` rows the
two kernels' D = 80 routes, their launches phase 27's HuBERT runs'), the
``nvidia-smi``
line, and last
``{"ok": true, "device": {...}}``.  ``--report PATH`` also writes the full
record there as JSON.  ``--refresh-host`` runs only the patch's host
split, the refresh contract at J = R = 4 and ``bench_refresh`` FULL on
both paths (``refresh_host``), for comparing two trees in one call (copy
this script to each tree's root and run it there in turns).  It imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import itertools
import json
import math
import statistics
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
# separate f32 multiplies and adds (no FMA): one instruction an operation,
# half the FMA rate
F32_NO_FMA_PER_S = F32_FLOPS_PER_S / 2
TF32_FLOPS_PER_S = 495e12   # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 on the tensor cores
# bf16 passes of a product with one f32 side: its 24 significand bits in
# three bf16 pieces of 8, each product exact and summed in f32 (3 passes
# at 989 TFLOP/s take less time than the 2 TF32 passes at 495)
F32_SIDE_BF16_PASSES = 3
COLD_SETS = 5               # factor sets rotated at decode (5 x 47 MB > L2)
L2_BYTES = 50 * 2**20       # H100 SXM's L2
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
    # the whole warm start, cuda against torch, each leaf against its
    # largest entry: ALS's bound against the reference (Gram condition
    # numbers ~5e3), which the four refine passes' row solves dominate
    "sketch": 2e-3,
    # phase 24: MoE serving parity in f32, cuda against torch, on the
    # tokens whose routes agree (phase 9's f32 bound of the card tests)
    "moe.logits": 1e-4,
    # the absorbed MLA decode against the decompressing one: the
    # reference's own bound (tests/test_models.py:228-252)
    "mla.absorb": 3e-3,
}
LM_RANK = 512        # the largest rank tucker_matmul.py designs for
LM_SERVE = dict(batch=4, prompt_len=2048, gen=32)
# phase 24: DeepSeek-V2-Lite serves at its published 27 layers (62.8 GB of
# f32 weights); Qwen3-MoE at 8 of its 48 layers and 8 tokens (22 GB of f32
# weights; the cut keeps the phase short); the parity runs at 2 layers
# of DeepSeek-V2-Lite (its dense layer and one MoE layer), f32; a pick that
# differs between two runs must lie this close to the next-best router
# logit; DeepSeek-V2-Lite's peak is held under this (its 62.8 GB of f32
# weights included)
MOE_SERVE = dict(ds_layers=27, qm_layers=8, qm_gen=8)
MOE_PARITY = dict(layers=2, batch=2, prompt_len=2048, gen=4)
ROUTE_MARGIN = 1e-5
MOE_PEAK = 76e9
# phase 25: DeepSeek-V2-Lite and Qwen3-MoE train at 4 of their 27 and 48
# layers (DeepSeek's dense first layer and 3 MoE layers).  Reckoned, one
# MoE layer's f32 parameters, gradients and AdamW m and v take 9.36 GB
# (DeepSeek-V2-Lite) and 9.97 GB (Qwen3-MoE), the embedding and head 6.71
# and 9.96 GB: 36.1 and 49.8 GB at 4 layers before activations.  The
# mixed_precision run takes mixed_steps; the parity runs parity_layers
# (phase 13's batch and sequence); a pick that differs between "cuda" and
# "torch" under mixed_precision (a bf16 stream) must lie this close to
# the next-best router logit (about 8 bf16 ulps of a logit of 2)
MOE_TRAIN = dict(layers=4, batch=2, seq=2048, steps=20, mixed_steps=10,
                 parity_layers=2)
MIXED_ROUTE_MARGIN = 2.0 ** -4
# phase 25 (a): bf16 into both flash kernels at every width, (tag, H, Kv,
# D, Dv), B and S of MOE_TRAIN; the paths' shapes where a path takes the
# width (MLA's last: its times are taken there)
BF16_SHAPES = (("D = 16", 8, 2, 16, 16), ("D = 32", 8, 2, 32, 32),
               ("D = 64", 8, 2, 64, 64),
               ("Qwen3-14B, G = 5", 40, 8, 128, 128),
               ("Qwen3-MoE, G = 8", 32, 4, 128, 128),
               ("MLA", 16, 16, 192, 128))
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
    # no Pallas kernel: the reference's jnp mode products of the serving
    # tables and its jitted row patch
    "mode_product_rows": "src/repro/core/kruskal.py:81",
    "patch_table_rows": "src/repro/serve/engine.py:369",
}
# the CUDA source of each wrapper where it is not <name>.cu
SOURCE = {"patch_table_rows": "mode_product_rows"}
# phase 27: HuBERT-XLarge's attention (30 s of audio at 50 frames/s, 16
# heads of 1280 / 16 = 80) and a kv_len inside the last 32-key tile
HUBERT = dict(batch=4, frames=1500, kv_len=1421, heads=16, head_dim=80)
# DeepSeek-67B serves at the depth whose f32 weights fit under `aim` with
# `reserve` kept for the cache, the prompt's logits and the activations
P27_SERVE = dict(aim=76e9, reserve=10e9)
# training: 8 steps at batch 2 x 2,048 (HuBERT: HUBERT's batch of frames),
# the dense configs cut to `layers` (16 bytes a parameter with the
# gradients and AdamW moments), the parity at 2 layers
P27_TRAIN = dict(steps=8, batch=2, seq=2048, audio_warmup=1,
                 layers={"qwen2_5_14b": 4, "starcoder2_15b": 4,
                         "deepseek_67b": 2}, parity_layers=2)
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
# phase 18: the table kernels' checks, as (rows, J = R): the ISSUE's grid,
# then every table the main paths build: the Netflix modes at J = R = 4
# and 64 (phases 3 and 16 serve them), bench_refresh FULL's modes at 64
# (src/repro_torch/benchmarks/bench_refresh.py), bench_serve FULL's and
# serve_batched's at 8
MPR_ROWS = (1, 600, 60_000)
MPR_WIDTHS = (4, 64)
MPR_SHAPES = (tuple((M, J) for J in MPR_WIDTHS for M in MPR_ROWS)
              + tuple((M, J) for J in (4, 64) for M in NETFLIX_DIMS)
              + ((40_000, 64), (20_000, 64))
              + tuple((M, 8) for M in (2_000, 1_200, 150, 400, 250, 30)))
# patches as (table rows, J = R, dirty rows): 1, 600 and 6,000 of 60,000
# at J = R = 4 and 64; bench_refresh FULL's fractions of mode 0 at 64; a
# refresh round's mode 0 in phase 16 (14,294 dirty rows), and its modes 1
# and 2 at J = R = 4
PATCH_SHAPES = (tuple((60_000, J, K) for J in MPR_WIDTHS
                      for K in (1, 600, 6_000))
                + tuple((60_000, 64, K) for K in (1_200, 3_000, 15_000))
                + ((NETFLIX_DIMS[0], 4, 14_294), (NETFLIX_DIMS[1], 4, 9_000),
                   (NETFLIX_DIMS[2], 4, 2_000)))
# the redesigned routes' tile edges (mode_product_rows.plan: a narrow build
# tile is 256 rows, a wide one 128; a narrow patch tile 128 rows, a wide
# one 32) at the card tests' widths
EDGE_WIDTHS = (1, 3, 5, 8, 9, 33, 63, 64)
MPR_SHAPES += tuple((tile + d, JR) for JR in EDGE_WIDTHS
                    for tile in ((256,) if JR <= 8 else (128,))
                    for d in (-1, 0, 1))
PATCH_SHAPES += tuple((60_000, JR, tile + d) for JR in EDGE_WIDTHS
                      for tile in ((128,) if JR <= 8 else (32,))
                      for d in (-1, 0, 1))
REFRESH_SHAPE = (60_000, 64)
# the decompose example's default steps
EXAMPLE_STEPS = 800
# phase 17: the warm start with the reference's sketch defaults on phase 3's
# tensor, twice and then in 3 shards; the warm arm's evaluation cadence;
# cuda against torch at bench_convergence's FULL shape
# (benchmarks/bench_convergence.py:38-42; Netflix's mode 2 would take the
# plain segment_reduce ~49,000 passes a call); the adaptive run's rank cap
# (4 times the paper's rank 4) and cadence
CONV_SHARDS = (1, 1, 3)
CONV_WARM_EVAL = 50
CONV_PARITY = dict(dims=(400, 300, 200), nnz=150_000, rank=8, batch=2048,
                   sketch_batch=16_384)
CONV_ADAPTIVE = dict(max_core_rank=16, eval_every=100)
# phase 19: online training over phase 3's tensor (the reference's
# launch/online_train.py): 0.00294 of the training nonzeros (262,144)
# arrive in 4 rounds of 65,536, phase 16's refresh traffic; window = one
# round.  Run B repeats it in memory under these faults.  The prefetcher
# walks an in-memory store of M = 4 (16 strata) at each depth.
ONLINE = dict(rounds=4, refresh_steps=4, stream_fraction=0.00294)
ONLINE_FAULTS = "refresh@0:1:2,publish@0,ingest@1"
PREFETCH_WORKERS = 4
PREFETCH_DEPTHS = (0, 2)
PREFETCH_FAULT = "transfer@3"
STORE_ENTRY_BYTES = 17       # 12 of indices, 4 of value, 1 of mask
# phase 20: the multi-device strategies on 4 workers sharing the card over
# phase 3's tensor; the parity steps; online training with strata, 2 rounds
# of 65,536 arrivals (0.00147 of the 89,164,901 training nonzeros)
STRAT_WORKERS = 4
# the strategy runs' steps: 200 of --steps' 600 (a depth cut, logged;
# with phase 27 the script took 1,100.7 s, and the out-of-core run alone,
# 13.33 steps/s, spent 45 s on 600 steps; NVIDIA H100 80GB HBM3, 700 W)
STRAT_STEPS = 200
STRAT_PARITY_STEPS = 20
STRAT_ONLINE = dict(rounds=2, stream_fraction=0.00147)
# phase 22: sync's per-step psum at bench_multidev's shapes, b = the dense
# factor and core gradients of a worker, ((1024 + 768 + 512)·8 + 3·8·8)·4
# bytes, moved 2·b·(M − 1)/M; and the reference's figures a step and device
# (benchmarks.bench_multidev._run_for(M) under JAX 0.9 on a CPU: HLO FLOPs,
# collective bytes, permutes, hidden FLOPs), printed beside the port's
SYNC_PSUM_BYTES = ((1024 + 768 + 512) * 8 + 3 * 8 * 8) * 4
REF_FIG7BC = {
    2: {"local": (6_886_907.5, 0, 0, 0), "sync": (7_730_993.5, 74_496, 0, 0),
        "strata": (7_878_593, 768, 0, 0),
        "strata_overlap": (7_878_595, 11_008, 1.0, 4_099.5)},
    4: {"local": (3_462_651.5, 0, 0, 0),
        "sync": (3_884_849.5, 111_744, 0, 0),
        "strata": (3_940_256, 1_152, 0, 0),
        "strata_overlap": (3_940_257.5, 7_296, 1.25, 4_102.75)},
}
# phase 23: sharded LM training on 4 workers sharing the card, full width.
# The parity runs (a), (b) at 2 layers, 3 fed steps (global batch 4), with
# the residual stream in f32: in the config's bf16 the sharded runs' f32
# sums, in another order than the unsharded step's (zero3 computes one
# batch row a worker, and the kernels split 2,048 rows otherwise than
# 8,192), flip bf16 roundings, and the worst moment read 0.030 of its
# largest against phase 13's 2⁻⁵ (NVIDIA H100 80GB HBM3, 700.00 W) — a
# margin too thin to tell the sharding's faults from them.  The training
# runs (c) at 4 layers in bf16, 6 steps (10 before phase 27 was added; cut,
# logged, for the script's time, with the loss falling from step 2); (e)'s
# runs and checkpoint at 2 layers with the vocab cut to 32,768: a full-vocab
# state is at least 19.8 GB, and phase 12's 28.1 GB checkpoint leaves no
# room for another under the machine's 45 GiB of disk writes
SHARDED_LM = dict(batch=4, seq=2048, parity_layers=2, parity_steps=3,
                  layers=4, steps=6, lr=1e-3, elastic_vocab=32_768,
                  elastic=dict(steps=8, ckpt_at=5, fail_at=7))
SHARDED_LM_PAIRS = [((2, 2), "fsdp_tp"), ((4, 1), "zero3"), ((1, 4), "tp"),
                    ((2, 2), "zero3_dp")]
SHARDED_LM_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
# (b) in the config's bf16: "cuda" against "torch" on one mesh, one step as
# phase 13 takes, for the tensor-parallel route (vocab-parallel head, H/mp
# heads, d_ff/mp rows) and the gathered one (every weight all-gathered)
SHARDED_LM_BACKEND_PAIRS = [((1, 4), "tp"), ((4, 1), "zero3")]
# phase 26: sharded MoE/MLA training on 4 workers sharing the card, full
# width.  (b) parity at 2 layers with the residual stream in f32, phase
# 23's global batch 4 (every policy splits it) and 3 fed steps, against
# the unsharded "cuda" step; (c) 6 steps a run (10 before phase 27 was
# added; cut, logged, for the script's time) through launch/train.run
# at MOE_TRAIN's batch (or the least multiple of it that the policy's
# batch shards divide: zero3_dp's 4), at 4 layers where the reckoned peak
# stays under MOE_PEAK, else fewer.  The reckoning: the bytes held by
# earlier phases, the state (parameters, gradients, AdamW m and v, 16
# bytes a held element, every worker's parts), the activations of a layer
# and a batch row of 2048 tokens (below) times the layers and every
# worker's rows (a batch slice counts once a worker that holds it), and
# the gathered copies and their gradients of the largest layer and of the
# head, every worker's (the zero3 policies gather whole leaves).  The
# activations are fitted to this phase's own peaks, the largest of each
# arch's runs: (peak − held − state − copies) / (layers × rows), at
# DeepSeek-V2-Lite zero3_dp, batch 4, 4 layers, 4 rows: (79,181,748,224 −
# 67,108,864 − 39,141,900,288 − 25,358,909,440) / 16; at Qwen3-MoE tp,
# 3 layers, 8 rows: (50,816,028,672 − 1,690,034,176 − 39,905,574,912) / 24
# (NVIDIA H100 80GB HBM3, 700 W; the other runs' fits 0.16e9–0.32e9: a
# worker holds a slice of the heads and experts, and a replicated batch
# row that never reaches the loss keeps no graph)
SHARDED_MOE = dict(parity_layers=2, parity_batch=4, parity_steps=3,
                   steps=6)
SHARDED_MOE_PARITY = [("deepseek_v2_lite_16b", (2, 2), "fsdp_tp"),
                      ("deepseek_v2_lite_16b", (1, 4), "tp"),
                      ("deepseek_v2_lite_16b", (2, 2), "fsdp_tp_v2"),
                      ("deepseek_v2_lite_16b", (2, 2), "zero3_dp"),
                      ("qwen3_moe_30b_a3b", (1, 4), "tp")]
SHARDED_MOE_RUNS = [("deepseek_v2_lite_16b", (2, 2), "fsdp_tp", {}),
                    ("deepseek_v2_lite_16b", (1, 4), "tp", {}),
                    ("deepseek_v2_lite_16b", (2, 2), "fsdp_tp_v2", {}),
                    ("deepseek_v2_lite_16b", (2, 2), "zero3_dp", {}),
                    ("qwen3_moe_30b_a3b", (1, 4), "tp", {}),
                    ("deepseek_v2_lite_16b", (2, 2), "fsdp_tp",
                     {"moe_sharded": True}),
                    ("deepseek_v2_lite_16b", (2, 2), "fsdp_tp",
                     {"mixed_precision": True, "dtype": "bfloat16"})]
ACT_BYTES = {"deepseek_v2_lite_16b": 913_364_352,
             "qwen3_moe_30b_a3b": 384_184_150}
# (b)'s flips: phase 25's rule, a fed pick's own pick may differ only where
# the fed run's closest two of the K + 1 best router logits lie within
# this.  ROUTE_MARGIN (1e-5) is set for two runs of one shape; a sharded
# run splits the batch and the heads, so its f32 sums run in other orders
# than the unsharded step's, and its router logits differ by more: up to
# 8.05e-5 (DeepSeek-V2-Lite) and 3.35e-4 (Qwen3-MoE), flips at margins to
# 1.22e-5 and 5.48e-5 (NVIDIA H100 80GB HBM3, 700 W); each run logs its
# max |Δ|
SHARDED_ROUTE_MARGIN = 5e-4
# the GPU machine stops a call past this many bytes written to its disk
SHARD_WORKERS = 4            # phase 21's serving workers, sharing the card
SHARD_QUERIES = 65_536       # predict tuples checked a layout
SHARD_TIME_ROUNDS = 7        # update_rows / refresh_tables turns
DISK_LIMIT = 45 * 2**30
WRITTEN: dict[str, int] = {}  # reckoned disk bytes, by phase
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


def tree_bytes(path: Path) -> int:
    """Bytes of the files under ``path`` (0 where there is none)."""
    path = Path(path)
    if path.is_file():
        return path.stat().st_size
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def note_written(phase: str, nbytes: int) -> None:
    """Add ``nbytes`` written to the disk to ``phase``'s reckoning."""
    WRITTEN[phase] = WRITTEN.get(phase, 0) + int(nbytes)


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
    note_written("1 (kernel build)", tree_bytes(build.BUILD_DIR))
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
    # segment_reduce's walk route at the ALS and CCD shapes (a 2^22-entry
    # chunk of a mode's sorted nonzeros; the whole mode at width 1): runs
    # of ~49,000 (85 of mode 2's rows in one chunk), ~9 (all of mode 0's
    # rows) and ~3,800 (width 1 over mode 2): exact, twice the same bits
    for B, J, rows, lo, hi in ((1 << 22, 16, NETFLIX_DIMS[2], 1000, 1085),
                               (1 << 22, 16, NETFLIX_DIMS[0], 0,
                                NETFLIX_DIMS[0]),
                               (1 << 23, 1, NETFLIX_DIMS[2], -5,
                                NETFLIX_DIMS[2] + 5)):
        what = f"walk B={B} J={J} rows={rows} ids in [{lo}, {hi})"
        g = torch.randn((B, J), generator=gen, device=dev)
        sidx = torch.sort(torch.randint(lo, hi, (B,), generator=gen,
                                        device=dev, dtype=torch.int32),
                          stable=True).values
        assert K.segment_reduce.plan(rows, J, B).route == "walk"
        got = sr(g, sidx, rows)
        record("segment_reduce", got, ref.segment_reduce_ref(g, sidx, rows),
               what)
        if not torch.equal(got, sr(g, sidx, rows)):
            raise AssertionError(f"segment_reduce {what}: two launches gave "
                                 "other bits")
        del g, sidx, got
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


# rounds of the kernel-against-yardstick timings (alternate_ms)
ROUNDS = 5


def alternate_ms(torch, fns: dict, iters: int = 20, rounds: int = ROUNDS
                 ) -> dict:
    """Each call's ``device_ms`` taken in turns, ``rounds`` times (the
    order rotated each round, so a drift of the card's clock reaches every
    call alike), and the median over the rounds; a call given as None
    stays None."""
    names = [n for n, fn in fns.items() if fn is not None]
    got: dict = {n: [] for n in names}
    for r in range(rounds):
        for n in names[r % len(names):] + names[:r % len(names)]:
            got[n].append(device_ms(torch, fns[n], iters=iters))
    return {n: statistics.median(got[n]) if n in got else None for n in fns}


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
    "mode_product_rows": "mode_product_rows_kernel",
    "patch_table_rows": "patch_rows_kernel",
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


def bound_no_fma(bytes_moved: float, instructions: float
                 ) -> tuple[float, str]:
    """The bound of f32 work that may not fuse a multiply and an add:
    ``instructions`` separate multiplies and adds at half the FMA rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = instructions / F32_NO_FMA_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cold_sets(set_bytes: int) -> int:
    """How many sets of ``set_bytes`` each, rotated call by call, span four
    times the L2, so that no call finds its inputs there."""
    return max(2, -(-4 * L2_BYTES // set_bytes))


def mpr_route(K, M: int, J: int, R: int) -> str:
    """The table build's route and grid at (M, J, R), from its plan."""
    pl = K.mode_product_rows.plan(M, J, R)
    return (f"{pl.route} route, {pl.tiles:,} tiles of {pl.rows_per_tile} "
            f"rows, {pl.blocks} blocks")


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


def bf16_bound(bytes_moved: float,
               products: list[tuple[int, float]]) -> tuple[float, str]:
    """The bound of f32-accurate work on bf16 operands: each product's
    (bf16 passes, operations) at the 989 TFLOP/s bf16 peak — 1 pass for
    bf16 × bf16 (exact, summed in f32), ``F32_SIDE_BF16_PASSES`` where one
    side is f32."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n * f for n, f in products) / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(torch, K, ft, res, counts) -> list[dict]:
    from repro_torch.core.cost import kruskal_grad_cost
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
        t_b, by = bound(*kruskal_grad_cost(N, B, J, R, x.element_size(),
                                           nrow, core, cc is not None, emit))
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
    t_b, by = bound(*kruskal_grad_cost(N, B, JW, JW, 4, N, True, False,
                                       False))
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
    tag = (f"phase_split={cfg.phase_split}, "
           f"sorted_batches={cfg.sorted_batches}, dtype={cfg.dtype}")
    wrappers = ("kruskal_grad", "segment_reduce", "scatter_accum")
    # one device kernel per wrapper launch.  The trace may miss a kernel
    # (flash_attention_bwd's profile sees the same): a window that recorded
    # fewer kernels than launches, and none more, is taken again, three
    # times at most; a surplus fails at once
    for window in range(3):
        K.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                st = ft.sgd_step(st, gen, train_t.indices, train_t.values,
                                 cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = K.launch_counts()
        kernels = {}
        for ev in prof.events():
            if "CUDA" in str(ev.device_type):   # a kernel or copy on the card
                kernels.setdefault(ev.name, [0, 0.0])
                kernels[ev.name][0] += 1
                kernels[ev.name][1] += ev.time_range.elapsed_us()
        if not kernels:
            log(f"profile [{tag}]: the profiler recorded no device time "
                "(not measured)")
            return {"measured": False,
                    "wall_ms_per_step": wall / steps * 1e3}
        found = {k: sum(c for n, (c, _) in kernels.items()
                        if f"{k}_kernel" in n) for k in wrappers}
        extra = [k for k in wrappers if found[k] > launches[k]]
        if extra:
            raise AssertionError(
                f"profile [{tag}]: " + ", ".join(
                    f"{found[k]} {k} device kernels for {launches[k]} "
                    "launches" for k in extra))
        short = [k for k in wrappers if found[k] < launches[k]]
        if not short:
            break
        log(f"profile [{tag}]: window {window + 1} recorded "
            + ", ".join(f"{found[k]} {k} device kernels for {launches[k]} "
                        "launches" for k in short)
            + ("; taken again" if window < 2 else ""))
    else:
        raise AssertionError(f"profile [{tag}]: three windows each recorded "
                             f"fewer device kernels than launches: {short}")
    busy_us = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:14]
    log(f"profile [{tag}]: {steps} steps, {wall / steps * 1e3:.3f} ms/step "
        f"under the profiler; device busy {busy_us / steps:.1f} us/step = "
        f"{busy_us / (wall * 1e6):.1%} of wall; "
        f"{sum(v[0] for v in kernels.values()) / steps:.1f} device "
        "operations/step")
    for name, (cnt, us) in top:
        log(f"  {us / steps:8.2f} us/step  {cnt / steps:5.1f}/step  "
            f"{name[:90]}")
    # and no second reduction kernel
    per_call = {k: {"launches": launches[k], "device_kernels": found[k]}
                for k in wrappers}
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
            "windows": window + 1,
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


def _held(worst: dict, key: str, got, want, what: str) -> None:
    """A kernel's output against its plain version's, within ``TOL[key]``
    of the plain one's largest; the worst (abs, relative) into
    ``worst[key]``."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{key} {what}: {got.dtype} "
                             f"{tuple(got.shape)} against the plain "
                             f"version's {want.dtype} {tuple(want.shape)}")
    e, r = rel_err(got, want)
    w = worst.setdefault(key, [0.0, 0.0])
    w[0], w[1] = max(w[0], e), max(w[1], r)
    log(f"  {key} {what}: max abs err {e:.3g}, relative {r:.3g}")
    if not r <= TOL[key]:
        raise AssertionError(f"{key} {what}: max abs err {e:.3g}, "
                             f"relative {r:.3g} > {TOL[key]}")


def phase_lm_kernels_vs_plain(torch, K, cfg) -> dict:
    ref = K.ref
    tm = K.tucker_matmul.tucker_matmul
    fa = K.flash_attention.flash_attention
    gen = torch.Generator(device="cuda").manual_seed(4321)
    worst = {k: [0.0, 0.0] for k in LM_KERNELS}
    record = functools.partial(_held, worst)

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


def op_profile(torch, fn, calls: int = 20) -> dict:
    """``calls`` calls of ``fn`` under the profiler, each closed by a
    synchronize: per call, the wall time, the host's self time of each
    host operation (runtime calls such as ``cudaMemcpyAsync`` and
    ``cudaLaunchKernel`` included; the profiler's one-time buffer request
    left out) and the device time and count of each device operation."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host: dict = {}
    dev: dict = {}
    for ev in prof.events():
        if "CUDA" in str(ev.device_type):
            d = dev.setdefault(ev.name, [0, 0.0])
            d[0] += 1
            d[1] += ev.time_range.elapsed_us()
        elif ev.name != "Activity Buffer Request":
            host[ev.name] = host.get(ev.name, 0.0) + ev.self_cpu_time_total
    return {"wall_ms": wall / calls * 1e3,
            "host_us": {k: v / calls for k, v in sorted(
                host.items(), key=lambda kv: -kv[1])[:8]},
            "device_us": sum(v[1] for v in dev.values()) / calls,
            "device_ops": sum(v[0] for v in dev.values()) / calls,
            "device": {k: [c / calls, us / calls] for k, (c, us) in sorted(
                dev.items(), key=lambda kv: -kv[1][1])[:6]}}


def log_op_profile(what: str, prof: dict) -> None:
    log(f"{what}: {prof['wall_ms']:.3f} ms a call under the profiler; "
        f"device {prof['device_us']:.1f} us in {prof['device_ops']:.1f} "
        "operations (" + "; ".join(f"{n[:48]} {c:g}x {us:.1f} us"
                                   for n, (c, us) in prof["device"].items())
        + "); host self time a call: " + ", ".join(
            f"{n[:32]} {us:.1f} us" for n, us in prof["host_us"].items()))


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
    note_written("12 (LM checkpoint)", tree_bytes(ckpt_dir))
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
    rec = _backend_parity(torch, state, params, loss, grads,
                          f"LM train parity ({cfg2.num_layers} layers, "
                          f"batch {P['batch']}, seq {P['seq']})")
    del state, params
    torch.cuda.empty_cache()
    return {"layers": cfg2.num_layers, **rec}


def _backend_parity(torch, state, params, loss: dict, grads: dict, what: str,
                    loss_tol: str = "lm.loss") -> dict:
    """Phase 13's comparison of ``"cuda"`` against ``"torch"`` from one
    ``state``: their losses and gradients (``loss``, ``grads``: each by
    backend; ``loss_tol`` the loss's key of ``TOL``), then m, v and the
    parameters after one AdamW step from each backend's gradients;
    ``grads`` is emptied and the step taken in ``state``."""
    from repro_torch.optim import adamw

    rel_loss = abs(loss["cuda"] - loss["torch"]) / abs(loss["torch"])
    worst_g, worst_name = 0.0, ""
    for name in params:
        _, r = rel_err(grads["cuda"][name], grads["torch"][name])
        if r > worst_g:
            worst_g, worst_name = r, name
    log(f"{what}: loss cuda {loss['cuda']:.6f}, torch "
        f"{loss['torch']:.6f}, relative diff {rel_loss:.3g} (tolerance "
        f"{TOL[loss_tol]:.4g}); worst gradient leaf {worst_name}: "
        f"{worst_g:.3g} of its largest (tolerance {TOL['lm.grads']:.4g})")
    if not (math.isfinite(loss["cuda"]) and rel_loss <= TOL[loss_tol]):
        raise AssertionError(f"{what}: loss {loss}")
    if not worst_g <= TOL["lm.grads"]:
        raise AssertionError(f"{what}: gradient {worst_name} "
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
    log(f"{what}: one AdamW step (lr {lr:.3g}, warmup 1): worst "
        f"m leaf {worst['m'][1]}: {worst['m'][0]:.3g} of its largest, worst "
        f"v leaf {worst['v'][1]}: {worst['v'][0]:.3g} (tolerance "
        f"{TOL['lm.grads']:.4g}); parameters where |g| > "
        f"{LM_SETTLED:g} of its leaf's largest ({held:,} of {n_all:,}): "
        f"worst leaf {worst['params'][1]}: {worst['params'][0]:.3g} of the "
        f"lr (tolerance {TOL['lm.grads']:.4g}; a flipped sign gives 2, a "
        f"zero gradient 1)")
    for key, (r, name) in worst.items():
        if not r <= TOL["lm.grads"]:
            raise AssertionError(f"{what}: {key} of {name} differs "
                                 f"by {r:.3g} after one AdamW step")
    del after, opt_c, opt_t
    return {"loss": loss, "loss_rel_diff": rel_loss,
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
        note_written("14 (std_train checkpoints)", tree_bytes(tmp))
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
    from repro_torch.core.als import ordered_fold
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
    # ordered segment sums: ALS folds each chunk's Gram in slices of at
    # most FOLD_WIDTH columns plus its right-hand side, CCD 2 sums a column
    chunks = math.ceil(train_t.nnz / als.DEFAULT_CHUNK)
    want_sr = {"als": len(dims) * chunks * (math.ceil(J * J / als.FOLD_WIDTH)
                                            + 1),
               "ccd": len(dims) * 2 * J}
    for name, mod, cfg_cls in (("als", als, als.ALSConfig),
                               ("ccd", ccd, ccd.CCDConfig)):
        epoch = getattr(mod, f"{name}_epoch")
        cfg = cfg_cls(dims=dims, ranks=(J,) * len(dims))
        p, dt, counts, peak = measured(
            lambda: epoch(params0, train_t, cfg, backend="cuda"))
        p2, dt2, _, _ = measured(
            lambda: epoch(params0, train_t, cfg, backend="cuda"))
        repeats = _same_bits(tuple(p.factors), tuple(p2.factors))
        rows[name] = dict(params=p, seconds=dt, counts=counts, peak=peak,
                          rate=f"{dt:.4f} s an epoch ({dt2:.4f} s again; "
                          f"the two epochs' bits equal: {repeats})",
                          repeats_bitwise=repeats, seconds_again=dt2)
        _counts_are(name, counts, dict({k: 0 for k in REPLACES},
                                       segment_reduce=want_sr[name]))
        if not repeats:
            raise AssertionError(f"{name}: two epochs from the same "
                                 "parameters differ in their bits")
    # what the ordered fold costs: the same epochs with segment_reduce's
    # staged route forced, and with index_add_ (float atomics, no fixed
    # order: the sums before the fold) in place of the fold
    def atomic_fold(bk, x, seg, num_rows, out):
        out.index_add_(0, seg, x)

    for name, mod, cfg_cls in (("als", als, als.ALSConfig),
                               ("ccd", ccd, ccd.CCDConfig)):
        epoch = getattr(mod, f"{name}_epoch")
        cfg = cfg_cls(dims=dims, ranks=(J,) * len(dims))
        walk_min = K.segment_reduce.WALK_MIN_RUN
        K.segment_reduce.WALK_MIN_RUN = 1 << 62
        try:
            _, staged, _, _ = measured(
                lambda: epoch(params0, train_t, cfg, backend="cuda"))
        finally:
            K.segment_reduce.WALK_MIN_RUN = walk_min
        als.ordered_fold = ccd.ordered_fold = atomic_fold
        try:
            _, atomic, _, _ = measured(
                lambda: epoch(params0, train_t, cfg, backend="cuda"))
        finally:
            als.ordered_fold = ccd.ordered_fold = ordered_fold
        rows[name].update(seconds_staged=staged, seconds_index_add=atomic)
        rows[name]["rate"] += (f"; {staged:.4f} s with segment_reduce's "
                               f"staged route, {atomic:.4f} s with "
                               "index_add_ in place of the ordered fold")
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
                "refresh_tables", K.launch_counts(),
                dict(zero, patch_table_rows=1, mode_product_rows=srv.order))
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
        f" (tolerance {TOL['kruskal_contract']:g}); top_k and "
        "reconstruct_rows launched no kernel, update_rows one "
        "patch_table_rows, refresh_tables one mode_product_rows a mode")
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

    import numpy as np

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
        # a patch round: one patch_table_rows a mode with dirty rows; a
        # rebuild round: one mode_product_rows a mode
        tables = dict(
            patch_table_rows=sum(sum(1 for d in r["dirty_rows"] if d)
                                 for r in rounds if r["publish"] == "patch"),
            mode_product_rows=sum(len(r["dirty_rows"]) for r in rounds
                                  if r["publish"] == "rebuild"))
        if counts != dict(want, kruskal_contract=counts["kruskal_contract"],
                          **tables) \
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

    # a patch of one refresh's dirty rows against a rebuild, on run 1's
    # server; the refresh's ids on the device are what the supervisor
    # gathers the new rows with
    _, dirty, dirty_dev = strategy.refresh_steps(
        plan, sup.dstate, arr_idx[-R["arrivals"]:], arr_val[-R["arrivals"]:],
        R["steps"])
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

    # the new rows gathered first: the time of update_rows alone, as
    # bench_refresh times it; then with each call's gather in the window
    # too, as the refresh supervisor pays it on every patch (an
    # index_select by the refresh's device ids: no host-to-device copy of
    # the ids, no sync)
    rows_of = [cur[n].index_select(0, dirty_dev[n])
               for n in range(len(dirty))]

    def alone(n):
        return lambda: srv.update_rows(n, dirty[n], rows_of[n])

    def gathered(n):
        return lambda: srv.update_rows(
            n, dirty[n], cur[n].index_select(0, dirty_dev[n]))

    def round_publish():
        # the supervisor's whole publish of a patch round: every mode's
        # gather and patch, each between the two colsum reads of its drift
        # check
        for n in range(len(dirty)):
            if len(dirty[n]):
                before = srv._colsums[n].float().cpu().numpy()
                gathered(n)()
                after = srv._colsums[n].float().cpu().numpy()
                float(np.abs(after - before).sum())
                float(np.abs(after).sum())

    patch_s = [timed(alone(n)) for n in range(len(dirty))]
    gathered_s = [timed(gathered(n)) for n in range(len(dirty))]
    # mode 0's patch, alone and gathered, the round's whole publish and the
    # rebuild in turns, so all see the same host (7 turns: a host stall in
    # one call moves a median of 7 less)
    turns = [(timed(alone(0), 1), timed(gathered(0), 1),
              timed(round_publish, 1), timed(srv.refresh_tables, 1))
             for _ in range(7)]
    patch_s[0] = statistics.median(t[0] for t in turns)
    gathered_s[0] = statistics.median(t[1] for t in turns)
    round_s = statistics.median(t[2] for t in turns)
    rebuild_s = statistics.median(t[3] for t in turns)
    log(f"serving refresh: update_rows of one refresh's dirty rows "
        f"{[len(d) for d in dirty]}: " + " / ".join(
            f"{t * 1e3:.3f}" for t in patch_s) + " ms per mode (with each "
        "call's gather of the rows by the refresh's device ids: "
        + " / ".join(f"{t * 1e3:.3f}" for t in gathered_s) + " ms), against "
        f"refresh_tables (all {sum(srv.dims):,} rows) {rebuild_s * 1e3:.3f} ms"
        " (host clock, closed by a synchronize; medians of 5, mode 0's and "
        "the rebuild's of 7 taken in turns): the patch of mode 0 "
        + ("beats" if patch_s[0] < rebuild_s else "does not beat")
        + " the rebuild; with the gather (the supervisor's cost) it "
        + ("beats" if gathered_s[0] < rebuild_s else "does not beat") + " it"
        + f"; the supervisor's whole patch publish (every mode gathered and "
        f"patched, the drift check's colsum reads) {round_s * 1e3:.3f} ms "
        + ("beats" if round_s < rebuild_s else "does not beat")
        + " it (recorded, not asserted)"
        + "; turns (alone, gathered, round, rebuild) ms: " + "; ".join(
            " ".join(f"{x * 1e3:.4f}" for x in t) for t in turns))
    for what, t in (("alone", patch_s[0]), ("with the supervisor's gather",
                                            gathered_s[0])):
        if not t < rebuild_s:
            raise AssertionError(
                f"serving refresh: update_rows of mode 0's "
                f"{len(dirty[0]):,} dirty rows, {what} ({t * 1e3:.3f} ms), "
                f"does not beat refresh_tables ({rebuild_s * 1e3:.3f} ms)")
    rows0 = rows_of[0]
    profiles = {}
    for what, fn in (("update_rows, mode 0",
                      lambda: srv.update_rows(0, dirty[0], rows0)),
                     ("refresh_tables", srv.refresh_tables)):
        profiles[what] = op_profile(torch, fn)
        log_op_profile(f"serving refresh profile [{what}]", profiles[what])
    split = patch_host_split(torch, srv, 0, dirty[0], rows0)
    log_host_split(f"phase 16, J = R = {srv.core_rank}, mode 0, "
                   f"{len(dirty[0]):,} of {srv.dims[0]:,} rows", split)
    stale = [st for _, st in seen]
    rec = {"rounds": rounds, "wall_s": wall, "queries": len(seen),
           "staleness_median_s": statistics.median(stale),
           "staleness_max_s": max(stale), "launch_counts": counts,
           "patch_equals_rebuild": True, "faulted": {
               "rounds": rounds2, "wall_s": wall2, "health": h,
               "launch_counts": counts2, "equals_unfaulted": True},
           "update_rows_s": patch_s, "update_rows_gathered_s": gathered_s,
           "round_publish_s": round_s,
           "refresh_tables_s": rebuild_s, "turns_s": turns,
           "patch_beats_rebuild": patch_s[0] < rebuild_s,
           "gathered_patch_beats_rebuild": gathered_s[0] < rebuild_s,
           "round_publish_beats_rebuild": round_s < rebuild_s,
           "profiles": profiles, "update_rows_host_split_us": split,
           "dirty_rows_timed": [len(d) for d in dirty]}
    main = {k: counts[k] + counts2[k] for k in REPLACES}
    return rec, main


def patch_host_split(torch, srv, mode: int, ids, rows, reps: int = 50
                     ) -> dict:
    """Host time of one ``srv.update_rows(mode, ids, rows)`` split by
    stage, µs.  Medians of ``reps`` calls on the host clock, the device idle
    before each: the whole call, its ``_check_rows``, the backend lookup,
    the kernel wrapper; alone, what the wrapper's candidate stages cost
    (numpy's ``ascontiguousarray`` of the ids, four device allocations of
    the patch's sizes, a ``torch.cuda.device`` context, an empty kernel
    through the same ctypes path); then, under the profiler (20 wrapper
    calls), the host self time a call of each runtime call and allocation
    (``cudaMemcpyAsync`` with its count a call)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, dispatch

    def med(fn) -> float:
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return statistics.median(out) * 1e6

    ids_c, rows_c = srv._check_rows(mode, ids, rows, "update_rows")
    be = dispatch.get_backend(srv.backend)
    live = srv._live
    args = (live.tables[mode], live.colsums[mode], srv._factors[mode],
            srv._core[mode], ids_c, rows_c)
    dev, R, K_ = srv.device, srv.core_rank, len(ids_c)
    noop = build.function("segment_reduce", "repro_noop", [ctypes.c_void_p])

    def context():
        with torch.cuda.device(dev):
            pass

    def allocations():
        torch.empty((K_,), dtype=torch.int32, device=dev)
        torch.empty_like(args[0])
        torch.empty_like(args[1])
        torch.empty((512, R), dtype=torch.float32, device=dev)

    split = {
        "update_rows": med(lambda: srv.update_rows(mode, ids, rows)),
        "_check_rows": med(lambda: srv._check_rows(mode, ids, rows,
                                                   "update_rows")),
        "dispatch": med(lambda: dispatch.get_backend(
            srv.backend).patch_table_rows),
        "patch_table_rows": med(lambda: be.patch_table_rows(*args)),
        "alone: ascontiguousarray": med(
            lambda: np.ascontiguousarray(ids_c, dtype=np.int32)),
        "alone: four allocations": med(allocations),
        "alone: device context": med(context),
        "alone: empty kernel through ctypes": med(
            lambda: noop(torch.cuda.current_stream().cuda_stream)),
    }
    calls = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            be.patch_table_rows(*args)
            torch.cuda.synchronize()
    host, counts = {}, {}
    for ev in prof.events():
        if "CUDA" in str(ev.device_type) or ev.name in (
                "Activity Buffer Request", "cudaDeviceSynchronize"):
            continue
        host[ev.name] = host.get(ev.name, 0.0) + ev.self_cpu_time_total
        counts[ev.name] = counts.get(ev.name, 0) + 1
    for name, us in sorted(host.items(), key=lambda kv: -kv[1])[:8]:
        split[f"profiled: {name} ({counts[name] / calls:g} a call)"] = \
            us / calls
    return split


def refresh_host(torch) -> dict:
    """``--refresh-host``: the patch's host cost and the refresh contract
    alone, through the entry points a tree has had since the serving
    tables' kernels came (so that two trees compare in one call).  At
    phase 16's shape (the Netflix dims at J = R = 4, random factors, 14,294
    of mode 0's rows): one ``update_rows`` call's host split, and mode 0's
    patch against ``refresh_tables`` in turns, with and without the rows'
    gather in the window (medians of 5, 7 times); at ``bench_refresh``'s
    FULL shape: the host split at 1 % and 10 % (``_refresh_ops``), the
    patch of 6,000 of 60,000 rows by phase 5's method, and
    ``bench_refresh`` FULL on "cuda" and on the plain path, each with its
    validator's verdict."""
    import numpy as np

    from repro_torch.benchmarks import bench_refresh
    from repro_torch.core.fasttucker import FastTuckerParams
    from repro_torch.kernels.mode_product_rows import (mode_product_rows,
                                                       patch_table_rows)
    from repro_torch.serve import TuckerServer

    gen = torch.Generator(device="cuda").manual_seed(16)
    srv = TuckerServer(FastTuckerParams(
        tuple(torch.randn((d, 4), generator=gen, device="cuda")
              for d in NETFLIX_DIMS),
        tuple(torch.randn((4, 4), generator=gen, device="cuda")
              for _ in NETFLIX_DIMS)), backend="cuda")
    ids = np.sort(np.random.default_rng(16).permutation(NETFLIX_DIMS[0])
                  [:14_294]).astype(np.int32)
    cur = torch.randn((NETFLIX_DIMS[0], 4), generator=gen, device="cuda")
    ids_dev = torch.from_numpy(ids).long().cuda()
    rows = cur.index_select(0, ids_dev)

    def timed(fn, reps=5) -> float:
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    turns = []
    for _ in range(7):
        turns.append({
            "update_rows_ms": timed(lambda: srv.update_rows(0, ids, rows))
            * 1e3,
            "gathered_ms": timed(lambda: srv.update_rows(
                0, ids, cur.index_select(0, ids_dev))) * 1e3,
            "refresh_tables_ms": timed(srv.refresh_tables) * 1e3})
    rec = {"phase16_turns": turns,
           "phase16_host_split_us": patch_host_split(torch, srv, 0, ids,
                                                     rows),
           "bench_refresh_ops": _refresh_ops(torch, "cuda")}
    log_host_split("phase 16 shape, mode 0", rec["phase16_host_split_us"])
    log("phase 16 shape, mode 0 against refresh_tables, ms (alone, "
        "gathered, rebuild): " + "; ".join(
            f"{t['update_rows_ms']:.4f} {t['gathered_ms']:.4f} "
            f"{t['refresh_tables_ms']:.4f}" for t in turns))
    I, JR = REFRESH_SHAPE
    mirror = torch.randn((I, JR), generator=gen, device="cuda")
    core = torch.randn((JR, JR), generator=gen, device="cuda")
    table = mode_product_rows(mirror, core)
    colsum = table.sum(0)
    pids = np.sort(np.random.default_rng(0).permutation(I)[:I // 10]
                   ).astype(np.int32)
    new = torch.randn((I // 10, JR), generator=gen, device="cuda")
    rec["patch_ms"] = device_ms(torch, lambda: patch_table_rows(
        table, colsum, mirror, core, pids, new))
    log(f"patch_table_rows, {I // 10:,} of {I:,} rows, J = R = {JR}: "
        f"{rec['patch_ms'] * 1e3:.2f} us/call")
    for backend in ("cuda", "torch"):
        doc = bench_refresh.measure(smoke=False, device="cuda",
                                    backend=backend)
        try:
            bench_refresh.validate(doc)
            verdict = "held"
        except ValueError as e:
            verdict = str(e)
        rec[f"bench_refresh_{backend}"] = {"rows": doc["rows"],
                                           "contract": verdict}
        log(f"bench_refresh FULL on {backend}: " + "; ".join(
            f"{r['dirty_fraction']:g}: patch {r['patch_ms']:.4f} ms, "
            f"rebuild {r['rebuild_ms']:.4f} ms, x{r['speedup']:.2f}"
            for r in doc["rows"]) + f"; contract: {verdict}")
    return rec


def log_host_split(what: str, split: dict) -> None:
    log(f"update_rows host split [{what}], us a call: " + "; ".join(
        f"{k} {v:.1f}" for k, v in split.items()))


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
# phase 17
# ---------------------------------------------------------------------------

def phase_convergence(torch, K, std_train, base_res,
                      steps: int) -> tuple[dict, list[dict], dict]:
    """The sketched warm start and the adaptive rank on the card: the warm
    start's determinism, shard invariance and launches over phase 3's
    tensor; the warm arm against phase 3's cold unsorted run (the same
    batches); cuda against torch at bench_convergence's FULL shape;
    bench_convergence FULL; the adaptive run; the sketch's kruskal_grad
    and an ALS chunk's segment_reduce timed.  Returns the record, the time
    rows and the main path's launch counts."""
    from repro_torch.benchmarks import bench_convergence
    from repro_torch.core import als, sketch
    from repro_torch.core import fasttucker as ft
    from repro_torch.core.cost import kruskal_grad_cost
    from repro_torch.data.synthetic import planted_tensor
    from repro_torch.kernels.dispatch import _kernel_scalars

    train_t, test_t = base_res["train"], base_res["test"]
    data = (train_t, test_t)
    cfg = dataclasses.replace(base_res["cfg"], init="sketched")
    N, J = cfg.order, cfg.ranks[0]
    predict = lambda q, i: ft.predict(q, i, "cuda")  # noqa: E731
    main_counts = {k: 0 for k in REPLACES}
    out = {}

    def add(counts):
        for k, v in counts.items():
            main_counts[k] += v

    # 17.1: the warm start twice, then in 3 shards: bitwise equal
    chunks = math.ceil(train_t.nnz / als.DEFAULT_CHUNK)
    als_sr = (cfg.sketch_refine_passes * N * chunks
              * (math.ceil(J * J / als.FOLD_WIDTH) + 1))
    leaves, warm_runs = [], []
    for shards in CONV_SHARDS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        tm = {}
        t0 = time.perf_counter()
        p = sketch.sketched_init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg,
            train_t.indices, train_t.values, num_shards=shards, timings=tm)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"warm start ({shards} shard{'s' if shards > 1 else ''}): "
            f"{total:.3f}s (" + ", ".join(f"{k} {v:.4f}s"
                                           for k, v in tm.items())
            + f"), peak device bytes {peak:,}; launch counts {counts}")
        _counts_are(f"warm start ({shards} shards)", counts, dict(
            {k: 0 for k in REPLACES}, kruskal_grad=shards,
            scatter_accum=N, segment_reduce=als_sr))
        add(counts)
        leaves.append(tuple(p.factors) + tuple(p.core_factors))
        warm_runs.append({"num_shards": shards, "seconds": total,
                          "stages": tm, "peak_device_bytes": peak,
                          "launch_counts": counts})
    if not all(_same_bits(leaves[0], q) for q in leaves[1:]):
        raise AssertionError("warm start: the three runs differ in their "
                             "bits")
    warm_rmse = _rmse(torch, ft.FastTuckerParams(leaves[0][:N],
                                                 leaves[0][N:]),
                      test_t, predict)
    log(f"warm start: the two runs and the 3-shard run bitwise equal; "
        f"launches: {CONV_SHARDS} kruskal_grad (one a shard), {N} "
        f"scatter_accum, {als_sr} segment_reduce ({cfg.sketch_refine_passes} "
        f"refine passes x {N} modes x {chunks} chunks x (Gram + rhs)); "
        f"held-out rmse {warm_rmse[0]:.5f}, mae {warm_rmse[1]:.5f}")
    out["warm_start"] = {"runs": warm_runs, "bitwise": True,
                         "rmse": warm_rmse[0], "mae": warm_rmse[1]}
    del leaves

    # 17.2: the warm arm against phase 3's cold unsorted run
    base = ["--dims", ",".join(map(str, NETFLIX_DIMS)), "--rank", "4",
            "--core-rank", "4", "--steps", str(steps), "--batch",
            str(TRAIN_BATCH), "--seed", "0", "--backend", "cuda", "--device",
            "cuda"]
    K.reset_launch_counts()
    res = std_train.run(std_train.parse_args(
        base + ["--warm-start", "--eval-every", str(CONV_WARM_EVAL)]), data)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    add(counts)
    cold, warm = base_res["history"], res["history"]
    ws = res["warm_start_seconds"]
    log("warm arm: warm start " + ", ".join(f"{k} {v:.4f}s"
                                             for k, v in ws.items())
        + f"; {steps} steps at {res['steps_per_s']:.1f} steps/s; "
        f"launch counts {counts}")
    log("warm arm rmse " + " -> ".join(f"{h['rmse']:.5f}@{h['step']}"
                                       for h in warm))
    log("cold arm rmse (phase 3, unsorted) " + " -> ".join(
        f"{h['rmse']:.5f}@{h['step']}" for h in cold))
    want = dict({k: 0 for k in REPLACES}, kruskal_grad=steps + 1,
                scatter_accum=N * (steps + 1), segment_reduce=als_sr,
                kruskal_contract=counts["kruskal_contract"])
    _counts_are("warm arm", counts, want)
    if not counts["kruskal_contract"]:
        raise AssertionError("warm arm: no kruskal_contract launched")
    if not all(math.isfinite(h["rmse"]) and math.isfinite(h["mae"])
               for h in cold + warm):
        raise AssertionError("warm/cold arm: non-finite RMSE/MAE")
    if not res["dstate"].rng.equal(base_res["dstate"].rng):
        raise AssertionError("warm arm: its batch generator ended elsewhere "
                             "than the cold arm's: not the same batches")
    target = cold[-1]["rmse"]
    zero_rms = float(test_t.values.double().pow(2).mean().sqrt())
    hit = next((h for h in warm if h["rmse"] <= target), None)
    per_step = res["train_seconds"] / steps
    to_target = (None if hit is None
                 else ws["total"] + hit["step"] * per_step)
    log(f"warm arm: step-0 rmse {warm[0]['rmse']:.5f} against the cold "
        f"arm's {cold[0]['rmse']:.5f}@0 and {target:.5f}@{cold[-1]['step']}"
        f"; reaches the cold arm's final rmse at step "
        f"{None if hit is None else hit['step']}, "
        + (f"{to_target:.3f}s with the warm start (training seconds "
           "prorated)" if hit else "never")
        + f", against the cold arm's {base_res['train_seconds']:.3f}s for "
        f"{steps} steps; final rmse warm {warm[-1]['rmse']:.5f}, cold "
        f"{target:.5f} (the warm arm "
        f"{'no worse' if warm[-1]['rmse'] <= target else 'worse'}; the "
        f"zero predictor {zero_rms:.5f}); both arms drew the same "
        "batches (generator states equal)")
    out["warm_arm"] = {
        "history": warm, "cold_history": cold, "warm_start_seconds": ws,
        "steps_per_s": res["steps_per_s"],
        "train_seconds": res["train_seconds"],
        "cold_train_seconds": base_res["train_seconds"],
        "steps_to_cold_final": None if hit is None else hit["step"],
        "seconds_to_cold_final": to_target, "zero_predictor_rmse": zero_rms,
        "warm_no_worse": warm[-1]["rmse"] <= target,
        "launch_counts": counts}
    del res

    # 17.3: cuda against torch at bench_convergence's FULL shape
    P = CONV_PARITY
    t = planted_tensor(P["dims"], P["nnz"], rank=P["rank"],
                       core_rank=P["rank"], noise=0.05, seed=0, device="cuda")
    tr, te = t.split(0.1)
    pcfg = ft.FastTuckerConfig(
        dims=P["dims"], ranks=(P["rank"],) * 3, core_rank=P["rank"],
        batch_size=P["batch"], backend="cuda",
        sketch_batch=P["sketch_batch"], init="sketched")
    draws = sketch.draw_sketch(torch.Generator(device="cuda").manual_seed(0),
                               pcfg, tr.indices, tr.values)
    got = sketch.sketched_init_from_draws(draws, pcfg, tr.indices, tr.values)
    plain = sketch.sketched_init_from_draws(
        draws, dataclasses.replace(pcfg, backend="torch"), tr.indices,
        tr.values)
    errs = [rel_err(g, w) for g, w in zip(
        got.factors + got.core_factors, plain.factors + plain.core_factors)]
    worst = max(r for _, r in errs)
    r_c = _rmse(torch, got, te, predict)
    r_t = _rmse(torch, plain, te, predict)
    log(f"warm start cuda vs torch at {P['dims']} ({tr.nnz:,} training "
        f"nonzeros, J = R = {P['rank']}, R_s = {sketch.sketch_width(pcfg)}):"
        f" per leaf relative {[f'{r:.3g}' for _, r in errs]}, worst "
        f"{worst:.3g} (tolerance {TOL['sketch']:g}); held-out rmse "
        f"{r_c[0]:.6f} / {r_t[0]:.6f}")
    if not worst <= TOL["sketch"]:
        raise AssertionError(f"warm start cuda vs torch differs: {worst:.3g}")
    out["parity"] = {"per_leaf_rel": [r for _, r in errs],
                     "max_rel": worst, "rmse_cuda": r_c[0],
                     "rmse_torch": r_t[0]}
    del t, tr, te, got, plain, draws

    # 17.4: bench_convergence FULL with its validator
    K.reset_launch_counts()
    t0 = time.perf_counter()
    doc = bench_convergence.run(smoke=False, device="cuda", backend="cuda")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    add(counts)
    for c in doc["configs"]:
        log(f"bench_convergence {c['name']} on {doc['platform']}: cold "
            f"{c['cold']['steps_to_target']} steps / "
            f"{c['cold']['wallclock_s_to_target']:.3f}s (reached "
            f"{c['cold']['reached']}, final {c['cold']['final_rmse']:.5f}); "
            f"warm {c['sketched']['steps_to_target']} steps / "
            f"{c['sketched']['wallclock_s_to_target']:.3f}s (sketch "
            f"{c['sketched']['init_s']:.3f}s, final "
            f"{c['sketched']['final_rmse']:.5f}); speedup steps "
            f"{c['speedup_vs_cold']:.1f}, wall "
            f"{c['wallclock_speedup_vs_cold']:.3f}")
        log(f"bench_convergence cold trajectory {c['cold']['trajectory']}")
    log(f"bench_convergence FULL: {time.perf_counter() - t0:.1f}s, "
        f"validator passed; launch counts {counts}")
    out["bench_convergence"] = {"doc": doc, "launch_counts": counts}

    # 17.5: the adaptive rank with ALS refinement after each transition
    A = CONV_ADAPTIVE
    K.reset_launch_counts()
    res = std_train.run(std_train.parse_args(
        base + ["--adaptive-rank", "--refine", "als", "--max-core-rank",
                str(A["max_core_rank"]), "--eval-every",
                str(A["eval_every"])]), data)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    add(counts)
    hist, ranks = res["history"], res["rank_history"]
    log("adaptive rmse " + " -> ".join(f"{h['rmse']:.5f}@{h['step']}"
                                       for h in hist)
        + f"; {res['steps_per_s']:.1f} steps/s; launch counts {counts}")
    for tr_ in ranks:
        after = next((h for h in hist if h["step"] > tr_["step"]), None)
        log(f"adaptive: rank {tr_['action']} -> {tr_['rank']} at step "
            f"{tr_['step']}; next rmse "
            + (f"{after['rmse']:.5f}@{after['step']}" if after else "none"))
    if not ranks:
        log("adaptive: no transition in this run")
    if any(tr_["rank"] > 64 for tr_ in ranks):
        raise AssertionError(f"adaptive: a rank past the kernels' 64: "
                             f"{ranks}")
    if not all(math.isfinite(h["rmse"]) for h in hist):
        raise AssertionError(f"adaptive: non-finite RMSE: {hist}")
    _check_path("adaptive", counts, ("kruskal_contract", "kruskal_grad",
                                     "scatter_accum"), LM_KERNELS)
    if ranks and not counts["segment_reduce"]:
        raise AssertionError("adaptive: a transition's ALS refinement "
                             "launched no segment_reduce")
    out["adaptive"] = {"history": hist, "rank_history": ranks,
                       "steps_per_s": res["steps_per_s"],
                       "launch_counts": counts}
    del res

    # 17.6: the sketch's kruskal_grad and an ALS chunk's segment_reduce
    rows_out = []
    floor = floor_ms(torch, K.build)
    gen = torch.Generator(device="cuda").manual_seed(17)
    # the range finder's one call: R_s wide, over all its passes' samples
    Js = sketch.sketch_width(cfg)
    B = cfg.sketch_passes * cfg.sketch_batch_size
    a = torch.randn((N, B, Js), generator=gen, device="cuda")
    eye = torch.eye(Js, device="cuda").expand(N, Js, Js).contiguous()
    val = torch.randn((B,), generator=gen, device="cuda")
    mask = torch.ones_like(val)
    scal = _kernel_scalars(B, None, False, False, 0.0, 0.0, 0.0, val.device)
    kg = K.kruskal_grad.kruskal_grad
    call = lambda: kg(a, eye, -val, mask, scal, want_core=False)  # noqa
    ms = device_ms(torch, call)
    plain = device_ms(torch, lambda: K.ref.kruskal_grad_ref(
        a, eye, -val, mask, scal, want_core=False))
    t_b, by = bound(*kruskal_grad_cost(N, B, Js, Js, 4, N, False, False,
                                       False))
    dev_ms = profiled_ms(torch, call, DEVICE_KERNEL["kruskal_grad"])
    rows_out.append(("kruskal_grad", f"sketch range finder (N = {N}, J = R "
                     f"= {Js}, B = {B}, err_override, no core)", ms, plain,
                     None, t_b, by, "one a shard per warm start", dev_ms))
    Bc, W = als.DEFAULT_CHUNK, J * J      # one ALS chunk's Gram rows
    rows0 = train_t.dims[0]
    # the first chunk of ALS's stable sort of mode 0
    ids = torch.sort(train_t.indices[:, 0], stable=True).values[:Bc]
    g = torch.randn((ids.shape[0], W), generator=gen, device="cuda")
    sr = K.segment_reduce.segment_reduce
    ms = device_ms(torch, lambda: sr(g, ids, rows0))
    plain = device_ms(torch, lambda: K.ref.segment_reduce_ref(g, ids, rows0),
                      iters=10)
    long_ids = ids.long()
    lib = device_ms(torch, lambda: torch.zeros(
        (rows0, W), device="cuda").index_add_(0, long_ids, g))
    t_b, by = bound(4 * (ids.shape[0] * (W + 1) + rows0 * W),
                    ids.shape[0] * W)
    dev_ms = profiled_ms(torch, lambda: sr(g, ids, rows0),
                         DEVICE_KERNEL["segment_reduce"])
    rows_out.append(("segment_reduce", f"ALS chunk ({ids.shape[0]:,} x {W}, "
                     f"mode 0, {rows0:,} rows)", ms, plain, lib, t_b, by,
                     "Gram slices + 1 a mode and chunk of an ALS epoch",
                     dev_ms))
    times = []
    for name, tag, ms, plain, lib, t_b, by, per, dev_ms in rows_out:
        log(f"{name} [{tag}]: {ms * 1e3:.2f} us/call (plain "
            f"{plain * 1e3:.2f} us"
            + (f", zeros + index_add_ {lib * 1e3:.2f} us" if lib else "")
            + f"), bound {t_b * 1e3:.3f} us by {by} ({t_b / ms:.1%} of the "
            f"event time), launch floor {floor * 1e3:.2f} us; profiler "
            "device duration "
            + (f"{dev_ms * 1e3:.2f} us" if dev_ms else "not measured")
            + f"; {per}")
        times.append({"name": name, "variant": tag, "ms": ms,
                      "plain_ms": plain, "library_ms": lib, "bound_ms": t_b,
                      "bound_by": by, "floor_ms": floor, "device_ms": dev_ms,
                      "launches_note": per})
    out["times"] = times
    out["launch_counts"] = main_counts
    return out, times, main_counts


# ---------------------------------------------------------------------------
# phase 18
# ---------------------------------------------------------------------------

def _rows(lines: list[str]) -> dict[str, tuple[float, str]]:
    """A benchmark's CSV rows as {name: (us, derived)} (a name may hold a
    comma, a parsed derived column does not)."""
    out = {}
    for ln in lines:
        name, us, derived = ln.rsplit(",", 2)
        out[name] = (float(us), derived)
    return out


def _device_per_call(torch, fn, calls: int = 10) -> tuple:
    """(device-busy µs, device operations) a call of ``fn`` under the
    profiler, as phase 6 reads a step; (None, None) where it recorded no
    device time."""
    fn()
    _, kernels = _profile_window(torch, lambda: [fn() for _ in range(calls)])
    if not kernels:
        return None, None
    return (sum(v[1] for v in kernels.values()) / calls,
            sum(v[0] for v in kernels.values()) / calls)


def _table_kernels(torch, K) -> tuple[dict, list[dict]]:
    """The serving tables' kernels against their plain versions (bitwise
    rows, a patched row equal to the same row rebuilt), then their times
    beside bounds, plain versions and torch.matmul."""
    import numpy as np

    mpr = K.mode_product_rows.mode_product_rows
    ptr = K.mode_product_rows.patch_table_rows
    gen = torch.Generator(device="cuda").manual_seed(18)
    errs = {"mode_product_rows": 0.0, "patch_table_rows": 0.0}

    def abs_err(got, want) -> float:
        return float((got.float() - want.float()).abs().max())

    cores = {}
    for M, JR in MPR_SHAPES:
        if JR not in cores:
            cores[JR] = torch.randn((JR, JR), generator=gen, device="cuda")
        rows = torch.randn((M, JR), generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            a, b = rows.to(dt), cores[JR].to(dt)
            got, want = mpr(a, b), K.ref.mode_product_rows_ref(a, b)
            err = abs_err(got, want)
            errs["mode_product_rows"] = max(errs["mode_product_rows"], err)
            if not torch.equal(got, want):
                raise AssertionError(f"mode_product_rows differs from its "
                                     f"plain version at M = {M}, J = R = "
                                     f"{JR}, {dt}: max abs error {err:.3g}")
    for I, JR, K_ in PATCH_SHAPES:
        core = cores[JR]
        mirror = torch.randn((I, JR), generator=gen, device="cuda")
        table = mpr(mirror, core)
        colsum = table.sum(0)
        ids = np.sort(np.random.default_rng(K_).permutation(I)[:K_]
                      ).astype(np.int32)
        new = torch.randn((K_, JR), generator=gen, device="cuda")
        m_k, m_p = mirror.clone(), mirror.clone()
        t_k, c_k = ptr(table, colsum, m_k, core, ids, new)
        t_p, c_p = K.ref.patch_table_rows_ref(table, colsum, m_p, core, ids,
                                              new)
        rebuilt = mpr(m_k, core)
        _, rel = rel_err(c_k, c_p)
        err = max(abs_err(t_k, t_p), abs_err(c_k, c_p))
        errs["patch_table_rows"] = max(errs["patch_table_rows"], err)
        if not (torch.equal(t_k, t_p) and torch.equal(m_k, m_p)
                and torch.equal(t_k, rebuilt) and rel <= 1e-5):
            raise AssertionError(
                f"patch_table_rows at K = {K_} of {I:,}, J = R = {JR}: "
                f"table {torch.equal(t_k, t_p)}, mirror "
                f"{torch.equal(m_k, m_p)}, rebuilt "
                f"{torch.equal(t_k, rebuilt)}, colsum {rel:.3g}")
    log(f"mode_product_rows: bitwise its plain version at (M, J = R) in "
        f"{list(MPR_SHAPES)} (f32 and bf16); patch_table_rows at (rows, "
        f"J = R, dirty rows) in {list(PATCH_SHAPES)}: table and mirror "
        f"bitwise the plain patch and the patched table bitwise a rebuild "
        f"from the patched factor; colsum within 1e-5 relative, largest "
        f"absolute error {errs['patch_table_rows']:.3g}")

    floor = floor_ms(torch, K.build)
    times = []
    I, JR = REFRESH_SHAPE
    core = torch.randn((JR, JR), generator=gen, device="cuda")
    for M, J in ((I, JR), (NETFLIX_DIMS[0], 4)):
        a = torch.randn((M, J), generator=gen, device="cuda")
        b = core[:J, :J].contiguous()
        ms = device_ms(torch, lambda: mpr(a, b))
        # the same call with its rows rotated over sets past the L2 (each
        # set's rows read and its table written): what a rebuild sees
        sets = itertools.cycle([a] + [
            torch.randn((M, J), generator=gen, device="cuda")
            for _ in range(cold_sets(4 * (M * J + M * J)) - 1)])
        cold = device_ms(torch, lambda: mpr(next(sets), b))
        plain = device_ms(torch, lambda: K.ref.mode_product_rows_ref(a, b),
                          iters=20)
        lib = device_ms(torch, lambda: torch.matmul(a, b))
        # no FMA: (2J - 1)·M·R separate instructions at half the FMA rate
        t_b, by = bound_no_fma(4 * (M * J + J * J + M * J),
                               (2 * J - 1) * M * J)
        fma = 2 * M * J * J / F32_FLOPS_PER_S * 1e3
        dev = profiled_ms(torch, lambda: mpr(a, b),
                          DEVICE_KERNEL["mode_product_rows"])
        times.append(("mode_product_rows", f"table build, M = {M:,}, J = R "
                      f"= {J}, {mpr_route(K, M, J, J)}", ms, cold, plain, lib,
                      t_b, by, dev, fma))
    mirror = torch.randn((I, JR), generator=gen, device="cuda")
    table = mpr(mirror, core)
    colsum = table.sum(0)
    Kd = I // 10
    ids = np.sort(np.random.default_rng(0).permutation(I)[:Kd]).astype(
        np.int32)
    new = torch.randn((Kd, JR), generator=gen, device="cuda")
    call = lambda: ptr(table, colsum, mirror, core, ids, new)  # noqa: E731
    ms = device_ms(torch, call)
    psets = [(table, colsum, mirror, new)]
    for _ in range(cold_sets(4 * (3 * I * JR + Kd * JR)) - 1):
        m = torch.randn((I, JR), generator=gen, device="cuda")
        t = mpr(m, core)
        psets.append((t, t.sum(0), m, torch.randn(
            (Kd, JR), generator=gen, device="cuda")))
    psets = itertools.cycle(psets)

    def cold_call():
        t, c, m, n = next(psets)
        return ptr(t, c, m, core, ids, n)
    cold = device_ms(torch, cold_call)
    plain = device_ms(torch, lambda: K.ref.patch_table_rows_ref(
        table, colsum, mirror, core, ids, new), iters=20)
    # bytes: the clean rows read and every row of the new table written
    # (the dirty rows' products land in it), the old and new factor rows
    # read and the new ones written, B, the ids, the bit map of the dirty
    # rows and both colsums
    t_b, by = bound_no_fma(
        4 * (2 * I * JR - Kd * JR + 3 * Kd * JR + JR * JR + Kd + 2 * JR
             + -(-I // 32)),
        2 * (2 * JR - 1) * Kd * JR + 2 * Kd * JR)
    fma = (4 * Kd * JR * JR + 2 * Kd * JR) / F32_FLOPS_PER_S * 1e3
    dev = profiled_ms(torch, call, DEVICE_KERNEL["patch_table_rows"])
    times.append(("patch_table_rows", f"row patch, {Kd:,} of {I:,} rows, "
                  f"J = R = {JR} (the table copy included)", ms, cold, plain,
                  None, t_b, by, dev, fma))
    out = []
    for name, tag, ms, cold, plain, lib, t_b, by, dev, fma in times:
        log(f"{name} [{tag}]: {ms * 1e3:.2f} us/call, cold {cold * 1e3:.2f} "
            f"us (inputs rotated past the L2; the bound is {t_b / cold:.1%} "
            "of it) (plain "
            f"{plain * 1e3:.2f} us"
            + (f", torch.matmul {lib * 1e3:.2f} us" if lib else
               ", no single PyTorch call")
            + f"), bound {t_b * 1e3:.3f} us by {by} without FMA "
            f"({t_b / ms:.1%} of the event time; at the FMA rate "
            f"{fma * 1e3:.3f} us), launch floor {floor * 1e3:.2f} us; "
            "profiler device duration "
            + (f"{dev * 1e3:.2f} us (the bound is {t_b / dev:.1%} of it)" if dev
               else "not measured"))
        out.append({"name": name, "variant": tag, "ms": ms, "cold_ms": cold,
                    "plain_ms": plain,
                    "library_ms": lib, "bound_ms": t_b, "bound_by": by,
                    "fma_rate_ops_ms": fma, "floor_ms": floor,
                    "device_ms": dev})
    return errs, out


def _refresh_ops(torch, backend: str) -> dict:
    """``update_rows`` of mode 0's dirty rows (1 % and 10 %) and
    ``refresh_tables`` at ``bench_refresh``'s FULL shape (rank 64) on
    ``backend``, each operation's host and device time a call."""
    import numpy as np

    from repro_torch.benchmarks.bench_refresh import FULL
    from repro_torch.core.fasttucker import FastTuckerParams
    from repro_torch.serve import TuckerServer

    dims, J = FULL["dims"], FULL["rank"]
    gen = torch.Generator(device="cuda").manual_seed(22)
    srv = TuckerServer(FastTuckerParams(
        tuple(torch.randn((d, J), generator=gen, device="cuda")
              for d in dims),
        tuple(torch.randn((J, J), generator=gen, device="cuda")
              for _ in dims)), backend=backend)
    rng = np.random.default_rng(22)
    out = {}
    for frac in (0.01, 0.10):
        k = int(dims[0] * frac)
        ids = np.sort(rng.permutation(dims[0])[:k]).astype(np.int32)
        rows = torch.randn((k, J), generator=gen, device="cuda")
        what = f"update_rows, {k:,} of {dims[0]:,} rows, rank {J}"
        out[what] = op_profile(torch, lambda: srv.update_rows(0, ids, rows))
        log_op_profile(f"refresh operations on {backend} [{what}]",
                       out[what])
        if backend == "cuda":
            out[f"{what}, host split"] = split = patch_host_split(
                torch, srv, 0, ids, rows)
            log_host_split(f"bench_refresh FULL, {what}", split)
    what = f"refresh_tables, {sum(dims):,} rows, rank {J}"
    out[what] = op_profile(torch, srv.refresh_tables)
    log_op_profile(f"refresh operations on {backend} [{what}]", out[what])
    return out


def phase_benchmarks(torch, K, out_dir: Path) -> tuple[dict, list, dict,
                                                        dict]:
    """The port's benchmarks at FULL on "cuda", each through its validator
    where it has one, with each one's launches; the serving tables'
    kernels checked and timed first.  Returns the record, the kernel time
    rows, the main path's launch counts and the kernels' errors."""
    from repro_torch.benchmarks import (bench_kernel_blocks, bench_lm_step,
                                        bench_order_scaling,
                                        bench_param_sweep, bench_refresh,
                                        bench_sota_time)
    from repro_torch.benchmarks.common import validate_bench_step
    from repro_torch.examples import decompose_ratings, serve_batched

    out_dir.mkdir(parents=True, exist_ok=True)
    errs, times = _table_kernels(torch, K)
    rec = {"tables_times": times,
           "refresh_ops": {b: _refresh_ops(torch, b)
                           for b in ("cuda", "torch")}}
    # bench_refresh FULL on the plain path, off the counts: what the
    # contract reads without the table kernels, with its validator's
    # verdict recorded (a miss is logged, not a failure: the contract is
    # the kernels' path, validated below)
    plain = bench_refresh.measure(smoke=False, device="cuda",
                                  backend="torch")
    try:
        bench_refresh.validate(plain)
        plain["contract"] = "held"
    except ValueError as e:
        plain["contract"] = str(e)
    log("bench_refresh FULL (rank 64) on the plain path (torch): " + "; "
        .join(f"{r['dirty_fraction']:g}: patch {r['patch_ms']:.4f} ms, "
              f"rebuild {r['rebuild_ms']:.4f} ms, x{r['speedup']:.2f}"
              for r in plain["rows"]) + f"; contract: {plain['contract']}")
    rec["bench_refresh_plain"] = plain
    main_counts = {k: 0 for k in REPLACES}
    secs = {}

    def drive(name, fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts = K.launch_counts()
        for k, v in counts.items():
            main_counts[k] += v
        log(f"{name}: {secs[name]:.1f}s; launch counts "
            f"{ {k: v for k, v in counts.items() if v} }")
        return res, counts

    # 18.1 Fig. 5 and Fig. 7a: the wall rows, then each point's device time
    for fig, bench, tag in (("fig5", bench_param_sweep, "vs_prev"),
                            ("fig7a", bench_order_scaling,
                             "vs_prev_order")):
        lines, counts = drive(fig, lambda b=bench: b.run(device="cuda",
                                                         backend="cuda"))
        _check_path(fig, counts, ("kruskal_grad", "scatter_accum"),
                    LM_KERNELS)
        # the rows come in the points' order (a name may repeat: Fig. 5's
        # J = R = 8 point closes one sweep and opens the other)
        pts = bench.points(device="cuda", backend="cuda")
        dev, prev = [], {}
        for (sweep, name, fn), ln in zip(pts, lines):
            _, us, wall_growth = ln.rsplit(",", 2)
            busy, ops = _device_per_call(torch, fn)
            growth = (busy / prev[sweep] if busy and prev.get(sweep)
                      else None)
            dev.append({"sweep": sweep, "name": name, "device_us": busy,
                        "device_ops": ops, "device_growth": growth,
                        "wall_us": float(us), "wall_growth": wall_growth})
            prev[sweep] = busy
            log(f"{name} ({sweep} sweep): wall {float(us):.1f} us/step "
                f"({wall_growth or 'first'}); device "
                + (f"{busy:.1f} us/step in {ops:.1f} operations"
                   + (f" (x{growth:.2f} vs prev)" if growth else "")
                   if busy else "not measured"))
        rec[fig] = {"rows": dev, "launch_counts": counts}

    # 18.2 Table 13 and the step sweep (bench_step/v3)
    lines, counts = drive("table13", lambda: bench_sota_time.run(
        device="cuda", backend="cuda"))
    t13 = _rows(lines)
    rec["table13"] = {"rows": {k: {"us": v[0], "derived": v[1]}
                               for k, v in t13.items()},
                      "launch_counts": counts}
    for J in bench_sota_time.TABLE13_J:
        log(f"table13 J = {J}: cuTucker / FastTucker "
            f"{t13[f'table13/cuTucker_J{J}'][1]} (paper at J = 4: 3.62x)")
    doc, counts = drive("step_sweep", lambda: bench_sota_time.run_step_sweep(
        smoke=False, out_path=str(out_dir / "BENCH_torch_step.json"),
        device="cuda"))
    validate_bench_step(doc)
    log(f"step sweep: validate_bench_step passed; derived {doc['derived']}")
    rec["step_sweep"] = {"doc": doc, "launch_counts": counts}

    # 18.3 the refresh contract (bench_serve runs at devices 4 in phase 21)
    doc, counts = drive("bench_refresh", lambda: bench_refresh.run(
        smoke=False, supervised=True,
        out_path=str(out_dir / "BENCH_torch_refresh.json"), device="cuda",
        backend="cuda"))
    bench_refresh.validate(doc)
    if not counts["patch_table_rows"] or not counts["mode_product_rows"]:
        raise AssertionError(f"bench_refresh: the table kernels did not "
                             f"launch: {counts}")
    log("bench_refresh FULL (rank 64): validate passed (the patch beats the "
        "rebuild at every dirty fraction <= 10 %); " + "; ".join(
            f"{r['dirty_fraction']:g}: patch {r['patch_ms']:.4f} ms, rebuild "
            f"{r['rebuild_ms']:.4f} ms, x{r['speedup']:.2f}"
            for r in doc["rows"])
        + f"; supervised {doc['supervised']}")
    rec["bench_refresh"] = {"doc": doc, "launch_counts": counts}

    # 18.4 the LM step and the fusion compare
    lines, counts = drive("lm_step", lambda: bench_lm_step.run(
        device="cuda", backend="cuda"))
    rec["lm_step"] = {"rows": _rows(lines), "launch_counts": counts}
    lines, counts = drive("fusion", lambda: bench_kernel_blocks.run(
        device="cuda"))
    fusion = _rows(lines)
    bg = bench_kernel_blocks.batch_gradients_launches(torch.device("cuda"))
    if bg != dict({k: 0 for k in bg}, kruskal_grad=1):
        raise AssertionError(f"batch_gradients on cuda: launches {bg}, want "
                             "exactly one kruskal_grad")
    log(f"fusion: unfused {fusion['fusion/unfused_contract+torch_grads'][0]}"
        f" us, fused {fusion['fusion/fused_kruskal_grad'][0]} us "
        f"({fusion['fusion/fused_kruskal_grad'][1]}); batch_gradients on "
        "cuda: exactly one kruskal_grad launch and nothing else")
    rec["fusion"] = {"rows": fusion, "launch_counts": counts,
                     "batch_gradients_launches": bg}

    # 18.5 the examples at their default sizes; the decompose example
    # stopped at half its steps and resumed equals an uninterrupted run
    half = str(EXAMPLE_STEPS // 2)
    ck1, ck2 = out_dir / "example_ckpt_a", out_dir / "example_ckpt_b"
    for d in (ck1, ck2):
        shutil.rmtree(d, ignore_errors=True)
    _, c1 = drive("decompose_ratings (stopped)", lambda: decompose_ratings
                  .main(["--steps", half, "--ckpt-dir", str(ck1)]))
    res, c2 = drive("decompose_ratings (resumed)", lambda: decompose_ratings
                    .main(["--ckpt-dir", str(ck1)]))
    whole, c3 = drive("decompose_ratings (whole)", lambda: decompose_ratings
                      .main(["--ckpt-dir", str(ck2)]))
    if res["start"] != int(half) or not _same_bits(_params(res),
                                                   _params(whole)):
        raise AssertionError(f"decompose_ratings: resumed at "
                             f"{res['start']}, or its final parameters "
                             "differ from the uninterrupted run's")
    log(f"decompose_ratings: resumed from step {res['start']}, final "
        f"parameters bitwise the uninterrupted run's; FastTucker rmse "
        f"{whole['fasttucker_rmse']:.4f}, cuTucker "
        f"{whole['cutucker_rmse']:.4f}")
    sb, c4 = drive("serve_batched", lambda: serve_batched.main([]))
    for d in (ck1, ck2):
        note_written("18 (example checkpoints)", tree_bytes(d))
        shutil.rmtree(d, ignore_errors=True)
    rec["examples"] = {
        "decompose_ratings": {
            "history": whole["history"], "resumed_at": res["start"],
            "fasttucker_rmse": whole["fasttucker_rmse"],
            "cutucker_rmse": whole["cutucker_rmse"],
            "launch_counts": [c1, c2, c3]},
        "serve_batched": {"rmse": sb["rmse"], "zero_rmse": sb["zero_rmse"],
                          "launch_counts": c4}}
    rec["seconds"] = secs
    rec["launch_counts"] = main_counts
    return rec, times, main_counts, errs


# ---------------------------------------------------------------------------
# phase 19
# ---------------------------------------------------------------------------

def _online_round_launches(refresh_steps: int, r: dict, srv=None) -> dict:
    """What one supervised round must launch: K ``kruskal_grad`` and 3K
    ``scatter_accum``, then one ``patch_table_rows`` a patched mode or one
    ``mode_product_rows`` a mode in a rebuild, and nothing else.  A
    sharded server ``srv`` patches on each worker holding a mode's dirty
    rows (row mode: between one and min(dirty, M) a dirty mode, read from
    the round) or on every replica (batch), and rebuilds on every worker
    holding rows."""
    want = dict({k: 0 for k in REPLACES}, kruskal_grad=refresh_steps,
                scatter_accum=3 * refresh_steps)
    dirty = [d for d in r["dirty"] if d]
    if srv is None or srv.mesh is None:
        if r["publish"] == "patch":
            want["patch_table_rows"] = len(dirty)
        else:
            want["mode_product_rows"] = len(r["dirty"])
        return want
    M = len(srv._workers.devices)
    if r["publish"] == "patch":
        got = r["launches"]["patch_table_rows"]
        if srv.shard_mode == "batch":
            want["patch_table_rows"] = M * len(dirty)
        elif len(dirty) <= got <= sum(min(d, M) for d in dirty):
            want["patch_table_rows"] = got
        else:
            want["patch_table_rows"] = len(dirty)      # reported as wrong
    else:
        want["mode_product_rows"] = sum(hi > lo for s in srv._spans
                                        for lo, hi in s)
    return want


def _publish_by_kind(rounds) -> dict:
    """Each round's publish seconds, under its publish kind."""
    out: dict = {}
    for r in rounds:
        out.setdefault(r["publish"], []).append(r["stage_seconds"]["publish"])
    return out


def _online_run(torch, K, online_train, name, flags, data) -> tuple:
    """One ``online_train.run`` over ``data``, its launch counts read just
    after it, each round's launches held to ``_online_round_launches``."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = online_train.run(online_train.parse_args(flags), data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    w = res["warmup"]
    log(f"online [{name}]: warm-up {w['steps']} steps in {w['seconds']:.3f}"
        f" s (rmse {w['rmse']:.6f}), store of {res['n_warm']:,} nonzeros "
        f"({res['store_build_bytes']:,} bytes) built in "
        f"{res['store_build_seconds']:.3f} s, {len(res['rounds'])} rounds "
        f"of {res['n_stream'] // len(res['rounds']):,} arrivals (window "
        f"{res['window']:,}), {wall:.3f} s in all")
    for r in res["rounds"]:
        st = r["stage_seconds"]
        log(f"online [{name}] round {r['round']}: +{r['arrivals']:,} "
            f"arrivals, store {r['store_nnz']:,} nonzeros / "
            f"{r['store_bytes']:,} bytes; ingest {st['ingest']:.4f} s, "
            f"transfer {st['transfer']:.4f} s, refresh {st['refresh']:.4f} "
            f"s, publish {st['publish']:.4f} s ({r['publish']}, generation "
            f"{r['generation']}, state {r['state']}); dirty rows "
            f"{r['dirty']}; probe |x̂| {r['probe_abs_mean']:.5f}; held-out "
            f"rmse {r['rmse']:.7f} mae {r['mae']:.7f}; {r['round_ms']:.1f} "
            f"ms; launches {r['launches']}")
        _counts_are(f"online [{name}] round {r['round']}", r["launches"],
                    _online_round_launches(ONLINE["refresh_steps"], r,
                                           res["server"]))
        if not (math.isfinite(r["rmse"]) and math.isfinite(
                r["probe_abs_mean"])):
            raise AssertionError(f"online [{name}]: non-finite round {r}")
    by_kind = _publish_by_kind(res["rounds"])
    log(f"online [{name}]: publish seconds by kind: " + "; ".join(
        f"{k} {len(v)} rounds, median {statistics.median(v) * 1e3:.3f} ms ("
        + ", ".join(f"{x * 1e3:.3f}" for x in v) + ")"
        for k, v in by_kind.items()))
    health = {k: res["health"][k] for k in (
        "state", "rounds_ok", "retries", "breaker_trips", "recoveries",
        "faults_injected", "rebuilds")}
    log(f"online [{name}]: launch counts {counts}; health {health}; verify "
        f"{res['verify']}")
    _check_path(f"online [{name}]", counts,
                ("kruskal_contract", "kruskal_grad", "scatter_accum",
                 "mode_product_rows"), ("segment_reduce",) + LM_KERNELS)
    if not (res["verify"] and res["verify"]["exact"]):
        raise AssertionError(f"online [{name}]: verify {res['verify']}")
    if not all(torch.equal(a, b) for a, b in zip(
            res["server"].params.factors, res["params"].factors)):
        raise AssertionError(f"online [{name}]: the served factors differ "
                             "from the refreshed ones")
    return res, counts, wall


def _store_equal(a, b) -> bool:
    import numpy as np

    return a.meta == b.meta and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("indices", "values", "mask"))


def _prefetch_walks(torch, store) -> dict:
    """One epoch of ``store``'s strata through ``StratumPrefetcher`` onto
    the card at each of ``PREFETCH_DEPTHS`` and once more under
    ``PREFETCH_FAULT``: every block bitwise the store's chunk, seconds a
    block and H2D GB/s (the blocks' bytes over the walk's wall time, each
    take followed by nothing: the walk alone), the sets of pinned staging
    buffers allocated over the walk."""
    import numpy as np

    from repro_torch.data import StratumPrefetcher
    from repro_torch.runtime.fault import FaultPlan

    S = store.num_strata
    fields = ("indices", "values", "mask")
    out = {}
    runs = [(f"depth {d}", d, None) for d in PREFETCH_DEPTHS]
    runs.append((f"depth 2 under {PREFETCH_FAULT}", 2, PREFETCH_FAULT))
    for name, depth, fault in runs:
        plan = FaultPlan.parse(fault) if fault else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf = StratumPrefetcher(store.stratum, lambda p: (p + 1) % S,
                               depth=depth, device="cuda", fault_plan=plan,
                               retry_base_s=1e-3, retry_cap_s=1e-2)
        try:
            blocks = [pf.take(p, timeout=300) for p in range(S)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            slots = pf._placer.pinned_sets
        finally:
            pf.close()
        same = all(np.array_equal(b[i].cpu().numpy(),
                                  getattr(store, fields[i])[p])
                   for p, b in enumerate(blocks) for i in range(3))
        del blocks
        gbps = store.nbytes / wall / 1e9
        rec = {"seconds": wall, "seconds_per_block": wall / S,
               "h2d_gb_per_s": gbps, "bitwise": same, "pinned_sets": slots,
               "retried": pf.retried,
               "faults_fired": plan.fired if plan else 0}
        log(f"prefetch [{name}]: {S} blocks of {store.stratum_nbytes:,} "
            f"bytes in {wall:.4f} s = {wall / S * 1e3:.3f} ms a block, "
            f"{gbps:.3f} GB/s host to device; {slots} sets of pinned "
            f"staging buffers allocated (at most depth + 1 = {depth + 1}); "
            f"{pf.retried} retries, "
            f"{rec['faults_fired']} faults fired; every block bitwise the "
            f"store's chunk: {same}")
        if not (same and slots <= depth + 1):
            raise AssertionError(f"prefetch [{name}]: {rec}")
        if fault and not (rec["faults_fired"] == 1 and pf.retried == 1):
            raise AssertionError(f"prefetch [{name}]: the fault was not "
                                 f"absorbed by one retry: {rec}")
        out[name] = rec
    return out


def phase_online(torch, K, online_train, base_res, steps: int
                 ) -> tuple[dict, dict]:
    """Online training over phase 3's tensor through ``online_train.run``
    (run A spilled, run B in memory under faults), the stores against an
    in-memory rebuild, and the stratum prefetcher onto the card."""
    import numpy as np

    from repro_torch.data import NonzeroStore

    data = (base_res["train"], base_res["test"])
    spill = ROOT / "build" / "online_store"   # git-ignored
    shutil.rmtree(spill, ignore_errors=True)
    flags = ["--strategy", "local", "--dims", ",".join(map(str, NETFLIX_DIMS)),
             "--rank", "4", "--core-rank", "4", "--batch", str(TRAIN_BATCH),
             "--warmup-steps", str(steps), "--rounds", str(ONLINE["rounds"]),
             "--refresh-steps", str(ONLINE["refresh_steps"]),
             "--stream-fraction", str(ONLINE["stream_fraction"]),
             "--seed", "0", "--backend", "cuda", "--device", "cuda",
             "--verify"]
    main = {k: 0 for k in REPLACES}
    rec = {}

    a, counts_a, wall_a = _online_run(
        torch, K, online_train, "A, spilled", flags + ["--spill-dir",
                                                       str(spill)], data)
    # reckoned writes: the built store, then each round's append (a grown
    # store is written whole through .tmp; else only its entries)
    written = a["store_build_bytes"]
    prev = written
    for r in a["rounds"]:
        written += (r["store_bytes"] if r["store_bytes"] != prev
                    else r["arrivals"] * STORE_ENTRY_BYTES)
        prev = r["store_bytes"]
    note_written("19 (online store)", written)
    t0 = time.perf_counter()
    rebuilt = NonzeroStore.build(data[0], 1)
    rebuild_s = time.perf_counter() - t0
    reopened = NonzeroStore.open(str(spill))
    same_store = _store_equal(reopened, rebuilt)
    log(f"online [A]: the spilled store reopened ({reopened.nnz:,} "
        f"nonzeros, {reopened.nbytes:,} bytes) equals NonzeroStore.build in "
        f"memory of the warm set and every arrival ({rebuild_s:.3f} s) array "
        f"for array: {same_store}; reckoned disk writes {written:,} bytes")
    if not same_store:
        raise AssertionError("online [A]: the spilled store differs from an "
                             "in-memory rebuild")
    del reopened

    b, counts_b, wall_b = _online_run(
        torch, K, online_train, "B, in memory, faults",
        flags + ["--inject-faults", ONLINE_FAULTS, "--expect-breaker"], data)
    h = b["health"]
    same = (all(torch.equal(x, y) for x, y in zip(a["server"]._tables,
                                                  b["server"]._tables))
            and all(torch.equal(x, y) for x, y in zip(
                a["dstate"].params.factors, b["dstate"].params.factors))
            and torch.equal(a["dstate"].rng, b["dstate"].rng))
    same_b = _store_equal(b["store"], rebuilt) and not b["store"].spilled
    log(f"online [B]: faults {ONLINE_FAULTS!r}: {h['faults_injected']} "
        f"fired, {h['retries']} retries, {h['breaker_trips']} breaker trips,"
        f" {h['recoveries']} recoveries, {h['rounds_ok']} rounds published;"
        f" tables, factors and generator state bitwise run A's: {same}; its "
        f"in-memory store equals run A's arrays: {same_b}")
    if not (same and same_b and h["breaker_trips"] >= 1
            and h["recoveries"] >= 1 and h["faults_injected"] == 5
            and h["rounds_ok"] == ONLINE["rounds"]):
        raise AssertionError(f"online [B]: did not degrade, recover and end "
                             f"on run A's bits: {h}")
    del rebuilt
    for k in REPLACES:
        main[k] += counts_a[k] + counts_b[k]
    for name, r, c, w in (("A", a, counts_a, wall_a),
                          ("B", b, counts_b, wall_b)):
        rec[name] = {"wall_s": w, "warmup": r["warmup"],
                     "rounds": r["rounds"], "launch_counts": c,
                     "publish_s_by_kind": _publish_by_kind(r["rounds"]),
                     "store_build_seconds": r["store_build_seconds"],
                     "store_build_bytes": r["store_build_bytes"],
                     "verify": r["verify"],
                     "health": {k: v for k, v in r["health"].items()
                                if k != "staleness_s"}}
    rec["A"].update(disk_bytes_reckoned=written,
                    store_equals_rebuild=True, rebuild_seconds=rebuild_s)
    rec["B"]["equals_run_a"] = True
    both = _publish_by_kind(a["rounds"] + b["rounds"])
    rec["publish_ms_median_by_kind"] = {
        k: statistics.median(v) * 1e3 for k, v in both.items()}
    log("online [A + B]: publish median by kind: " + "; ".join(
        f"{k} {statistics.median(v) * 1e3:.3f} ms over {len(v)} rounds"
        for k, v in both.items()))
    del a, b
    shutil.rmtree(spill, ignore_errors=True)

    t0 = time.perf_counter()
    store = NonzeroStore.build(data[0], PREFETCH_WORKERS)
    build_s = time.perf_counter() - t0
    # L was sized by the counting pass on the card; the host digits of the
    # scatter pass (BlockPartition.assign, the reference's) filled the
    # buckets, and the mask is read back: all three must agree
    fill = store.fill()
    pad = store.meta["pad_multiple"]
    host_L = -(-int(fill.max()) // pad) * pad
    mask_fill = store.mask.reshape(store.num_strata * PREFETCH_WORKERS,
                                   -1).sum(axis=1)
    sized = (host_L == store.chunk_len and int(fill.sum()) == store.nnz
             and np.array_equal(mask_fill, fill))
    log(f"prefetch: NonzeroStore.build of the training set at M = "
        f"{PREFETCH_WORKERS} in memory from the tensor on the card: "
        f"{store.num_strata} strata of {store.stratum_nbytes:,} bytes (L = "
        f"{store.chunk_len:,}) in {build_s:.3f} s; L from the host digits' "
        f"bucket fills {host_L:,}, fills sum {int(fill.sum()):,} of "
        f"{store.nnz:,}, mask fills equal: {sized}")
    if not sized:
        raise AssertionError("prefetch: the store's L differs from the host "
                             "path's bucket counts")
    rec["prefetch"] = _prefetch_walks(torch, store)
    rec["prefetch_store"] = {"workers": PREFETCH_WORKERS,
                             "strata": store.num_strata,
                             "stratum_bytes": store.stratum_nbytes,
                             "chunk_len": store.chunk_len,
                             "chunk_len_host_counts": host_L}
    return rec, main


# ---------------------------------------------------------------------------
# phase 20
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    """The tensors of a (nested tuple) state, in order; a DistState's
    step is compared with them as a 0-dim tensor."""
    if hasattr(tree, "shape"):
        return [tree]
    if isinstance(tree, int):
        import torch

        return [torch.tensor(tree)]
    out = []
    for t in tree:
        out += _leaves(t)
    return out


def _strategy_launches(M: int, steps: int, evals: int, eval_chunks: int,
                       sorted_batches: bool) -> dict:
    """What a run of a mesh strategy must launch: M ``kruskal_grad`` and
    M·N of its scatter a step, one ``kruskal_contract`` an evaluation
    chunk, nothing else."""
    scatter = "segment_reduce" if sorted_batches else "scatter_accum"
    return dict({k: 0 for k in REPLACES}, kruskal_grad=M * steps,
                kruskal_contract=evals * eval_chunks,
                **{scatter: M * 3 * steps})


def _strategy_parity(torch, ft, data) -> dict:
    """``STRAT_PARITY_STEPS`` fed-pick steps of sync, strata and
    strata_overlap at M workers, ``"cuda"`` against ``"torch"`` from the
    same state and picks: every leaf within phase 4's 1e-4 relative."""
    from repro_torch.distributed import get_strategy
    from repro_torch.distributed.overlap import OverlapPlan
    from repro_torch.launch.mesh import make_host_mesh

    train = data[0]
    M = STRAT_WORKERS
    mesh = make_host_mesh(num_workers=M, device="cuda")
    cfg = ft.FastTuckerConfig(dims=NETFLIX_DIMS, ranks=(4,) * 3,
                              core_rank=4, batch_size=TRAIN_BATCH,
                              backend="cuda")
    tcfg = dataclasses.replace(cfg, backend="torch")
    out = {}
    t0 = time.perf_counter()
    strata_plan = get_strategy("strata").prepare(train, cfg, mesh, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"strategies parity: strata layout built in {build_s:.3f} s")
    plans = {
        "sync": get_strategy("sync").prepare(train, cfg, mesh),
        "strata": strata_plan,
        "strata_overlap": OverlapPlan(**{
            f.name: getattr(strata_plan, f.name)
            for f in dataclasses.fields(strata_plan)}, chunk=4)}
    for name, plan in plans.items():
        st = get_strategy(name)
        gen = torch.Generator(device="cuda").manual_seed(0)
        ds = st.init(plan, ft.init_state(gen, cfg, "cuda"), gen)
        tplan = dataclasses.replace(plan, cfg=tcfg)
        ts = ds
        high = (plan.val_shards[0].shape[0] if name == "sync"
                else plan.layout.chunk_len)
        pg = torch.Generator(device="cuda").manual_seed(1)

        def draw():
            return [torch.randint(0, high, (TRAIN_BATCH,), generator=pg,
                                  device="cuda") for _ in range(M)]

        while ds.step < STRAT_PARITY_STEPS:
            picks = ([draw() for _ in range(plan.chunk)]
                     if name == "strata_overlap" else draw())
            ds = st.step_batch(plan, ds, picks)
            ts = st.step_batch(tplan, ts, picks)
        torch.cuda.synchronize()
        got, want = st.eval_params(plan, ds), st.eval_params(tplan, ts)
        worst = max(rel_err(a, b)[1] for a, b in zip(
            got.factors + got.core_factors, want.factors + want.core_factors))
        log(f"strategies parity [{name}]: {ds.step} fed-pick steps at M = "
            f"{M}, cuda against torch: largest leaf error {worst:.3e} of "
            "its largest entry (bound 1e-4)")
        if not worst <= 1e-4:
            raise AssertionError(f"strategies parity [{name}]: {worst}")
        out[name] = worst
    profiles = {name: _strategy_profile(torch, ft, name, plan)
                for name, plan in plans.items()}
    del plans, strata_plan
    torch.cuda.empty_cache()
    return {"max_rel_err": out, "layout_seconds": build_s,
            "profiles": profiles}


def _strategy_profile(torch, ft, name: str, plan) -> dict:
    """Four steps of ``name`` (one ``strata_overlap`` chunk) under
    ``torch.profiler`` after four unprofiled ones: the wall time a step,
    the device's busy share (the union of its kernels' and copies'
    intervals over the window's host wall time; the rest is host time),
    device operations a step, and the side-stream copies' time beside a
    compute-stream kernel (reported, not asserted)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed import get_strategy

    st = get_strategy(name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ds = st.init(plan, ft.init_state(gen, plan.cfg, "cuda"), gen)
    step = st.make_step(plan)
    while ds.step < 4:
        ds = step(ds)
    torch.cuda.synchronize()
    trace = ROOT / "build" / f"{name}_steps_trace.json"   # git-ignored
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while ds.step < 8:
            ds = step(ds)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    note_written("20 (profiler traces)", trace.stat().st_size)
    trace.unlink()
    kern = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy",
                                                    "gpu_memset")]
    compute = {e["args"].get("stream") for e in kern}
    side = [e for e in copies if e["args"].get("stream") not in compute]

    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))

    busy_spans = sorted(span(e) for e in kern)
    union, end = 0.0, -1.0
    for a, b in sorted(span(e) for e in kern + copies):
        if b > end:
            union += b - max(a, end)
            end = b
    hidden = 0.0
    for e in side:
        a, b = span(e)
        hidden += sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy_spans)
    side_us = sum(float(e.get("dur", 0.0)) for e in side)
    rec = {"steps": 4, "wall_us_per_step": wall_us / 4,
           "device_busy_share": union / wall_us,
           "device_ops_per_step": (len(kern) + len(copies)) / 4,
           "kernels": len(kern), "copies": len(copies),
           "side_stream_copies": len(side), "side_copy_us": side_us,
           "side_copy_us_beside_compute": hidden,
           "streams": sorted({str(e["args"].get("stream"))
                              for e in kern + copies})}
    log(f"strategies profile [{name}]: 4 steps, {wall_us / 4:.1f} us a "
        f"step on the host clock under the profiler, device busy "
        f"{union / 4:.1f} us a step ({union / wall_us:.1%}; the rest is "
        f"host time), {rec['device_ops_per_step']:.1f} device operations a "
        f"step ({len(kern)} kernels, {len(copies)} copies and fills); "
        f"{len(side)} copies on a side stream ({side_us:.1f} us), "
        f"{hidden:.1f} us of them beside a compute-stream kernel; streams "
        f"{rec['streams']} (reported, not asserted)")
    return rec


def phase_strategies(torch, K, ft, std_train, online_train, base_res,
                     steps: int) -> tuple[dict, dict]:
    """The multi-device strategies at the Netflix size on
    ``STRAT_WORKERS`` workers sharing the card, through ``std_train.run``
    and ``online_train.run`` over phase 3's tensor."""
    import os

    from repro_torch.launch.mesh import FORCE_ENV_VAR

    data = (base_res["train"], base_res["test"])
    M = STRAT_WORKERS
    chunks = math.ceil(data[1].nnz / EVAL_CHUNK)
    third = max(steps // 3, 1)
    root = ROOT / "build" / "strategies"   # git-ignored
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    whole, cut, spill = (str(root / "whole"), str(root / "cut"),
                         str(root / "spill"))
    base = ["--dims", ",".join(map(str, NETFLIX_DIMS)), "--rank", "4",
            "--core-rank", "4", "--batch", str(TRAIN_BATCH), "--eval-every",
            str(third), "--seed", "0", "--backend", "cuda", "--device",
            "cuda"]
    order = [
        ("sync", ["--strategy", "sync"], steps),
        ("strata", ["--strategy", "strata", "--ckpt-dir", whole], steps),
        ("strata_overlap", ["--strategy", "strata_overlap"], steps),
        ("strata sorted", ["--strategy", "strata", "--sorted-batches"],
         steps),
        ("strata out-of-core", ["--strategy", "strata", "--out-of-core",
                                "--spill-dir", spill, "--prefetch-depth",
                                "2"], steps),
        ("sync compressed", ["--strategy", "sync", "--compress"], steps),
        ("strata compressed", ["--strategy", "strata", "--compress"], steps),
        ("strata interrupted", ["--strategy", "strata", "--ckpt-dir", cut],
         2 * third),
        ("strata resumed", ["--strategy", "strata", "--ckpt-dir", cut,
                            "--resume"], steps),
    ]
    old_env = os.environ.get(FORCE_ENV_VAR)
    os.environ[FORCE_ENV_VAR] = str(M)
    runs, rec, main = {}, {"runs": {}}, {k: 0 for k in REPLACES}
    try:
        for name, flags, n in order:
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            res = std_train.run(
                std_train.parse_args(base + ["--steps", str(n)] + flags),
                data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = K.launch_counts()
            hist = res["history"]
            done = hist[-1]["step"] - hist[0]["step"]
            want = _strategy_launches(M, done, len(hist), chunks,
                                      "--sorted-batches" in flags)
            log(f"strategies [{name}] ({' '.join(flags)}): {res['workers']} "
                f"workers, plan {res['prepare_seconds']:.3f} s"
                + (f", store {res['store_seconds']:.3f} s "
                   f"({res['store_bytes']:,} bytes)"
                   if res["store_seconds"] is not None else "")
                + f"; {done} steps at {res['steps_per_s']:.2f} steps/s = "
                f"{res['nnz_per_s']:.4g} nnz/s ({M} x {TRAIN_BATCH} a "
                f"step); {res['rotated_bytes_per_step']:,.0f} bytes rotated "
                f"a step; peak device bytes {res['peak_device_bytes']:,}; "
                f"{wall:.1f} s in all; rmse/mae " + " -> ".join(
                    f"{h['rmse']:.7f}/{h['mae']:.7f}@{h['step']}"
                    for h in hist))
            log(f"strategies [{name}]: launch counts {counts}, a step "
                f"{ {k: v / done for k, v in counts.items() if v} }")
            _counts_are(f"strategies [{name}]", counts, want)
            if not all(math.isfinite(h["rmse"]) and math.isfinite(h["mae"])
                       for h in hist):
                raise AssertionError(f"strategies [{name}]: non-finite "
                                     f"RMSE/MAE {hist}")
            if not hist[-1]["rmse"] < hist[0]["rmse"]:
                raise AssertionError(f"strategies [{name}]: RMSE did not "
                                     f"fall {hist}")
            if res["workers"] != M:
                raise AssertionError(f"strategies [{name}]: "
                                     f"{res['workers']} workers, want {M}")
            runs[name] = res
            rec["runs"][name] = {k: res[k] for k in (
                "history", "steps_per_s", "nnz_per_s", "peak_device_bytes",
                "train_seconds", "prepare_seconds", "store_seconds",
                "store_bytes", "rotated_bytes_per_step", "resumed_from",
                "ckpt_bytes", "ckpt_seconds")}
            rec["runs"][name].update(launch_counts=counts, wall_s=wall)
            if name != "strata interrupted":
                for k in REPLACES:
                    main[k] += counts[k]
        note_written("20 (strategies: store and checkpoints)",
                     tree_bytes(root))
        ref = runs["strata"]["dstate"]
        for name in ("strata_overlap", "strata sorted", "strata out-of-core",
                     "strata resumed"):
            same = _same_bits(_leaves(runs[name]["dstate"]), _leaves(ref))
            log(f"strategies: [{name}] bitwise [strata] (every worker's "
                f"shards, core replicas and generator state): {same}")
            if not same:
                raise AssertionError(f"strategies: [{name}] differs from "
                                     "[strata]")
        if runs["strata resumed"]["resumed_from"] != 2 * third:
            raise AssertionError("strategies: resumed from "
                                 f"{runs['strata resumed']['resumed_from']}")
        for name in ("sync compressed", "strata compressed"):
            ef = _leaves(runs[name]["dstate"].ef)
            ok = bool(ef) and all(bool(torch.isfinite(e).all())
                                  and float(e.abs().max()) > 0 for e in ef)
            log(f"strategies [{name}]: {len(ef)} error-feedback residual "
                f"tensors, finite and not all zero: {ok}")
            if not ok:
                raise AssertionError(f"strategies [{name}]: residuals")
        del runs, ref
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
        rec["parity"] = _strategy_parity(torch, ft, data)
        t0 = time.perf_counter()
        res, counts, wall = _online_run(
            torch, K, online_train, f"strata, M = {M}, in memory",
            ["--strategy", "strata", "--dims",
             ",".join(map(str, NETFLIX_DIMS)), "--rank", "4", "--core-rank",
             "4", "--batch", str(TRAIN_BATCH), "--warmup-steps", str(steps),
             "--rounds", str(STRAT_ONLINE["rounds"]), "--refresh-steps",
             str(ONLINE["refresh_steps"]), "--stream-fraction",
             str(STRAT_ONLINE["stream_fraction"]), "--seed", "0",
             "--backend", "cuda", "--device", "cuda", "--verify"], data)
        log(f"strategies online: {res['workers']} workers, warm-up plan "
            f"{res['warmup']['prepare_seconds']:.3f} s, store at M = "
            f"{res['store'].num_workers}; the patched tables bitwise a fresh "
            f"server's: {res['verify']['exact']}")
        if res["workers"] != M or res["store"].num_workers != M:
            raise AssertionError(f"strategies online: {res['workers']} "
                                 "workers")
        for k in REPLACES:
            main[k] += counts[k]
        rec["online"] = {"wall_s": wall, "warmup": res["warmup"],
                         "rounds": res["rounds"], "launch_counts": counts,
                         "store_build_seconds": res["store_build_seconds"],
                         "store_build_bytes": res["store_build_bytes"],
                         "verify": res["verify"]}
        del res
    finally:
        if old_env is None:
            os.environ.pop(FORCE_ENV_VAR, None)
        else:
            os.environ[FORCE_ENV_VAR] = old_env
        shutil.rmtree(root, ignore_errors=True)
    return rec, main


# ---------------------------------------------------------------------------
# phase 21
# ---------------------------------------------------------------------------

def _top_k_vs(s, i, ref_s, ref_i, k) -> tuple[int, float]:
    """``top_k`` (k columns) against a reference's top k + 1: scores within
    the kernel tolerance of each row's largest, ids equal on the rows whose
    k-th and (k+1)-th reference scores differ by more than 1e-5 of it.
    Returns (rows whose ids were checked, worst score error)."""
    checked, worst = 0, 0.0
    for b in range(len(ref_s)):
        scale = max(ref_s[b].abs().max().item(), 1e-30)
        worst = max(worst, (s[b] - ref_s[b, :k]).abs().max().item() / scale)
        if (ref_s[b, k - 1] - ref_s[b, k]).item() / scale > 1e-5:
            checked += 1
            if i[b].tolist() != ref_i[b, :k].tolist():
                raise AssertionError(f"sharded top_k ids {i[b].tolist()} "
                                     f"differ from {ref_i[b, :k].tolist()}")
    return checked, worst


def _gather_bytes(srv, q) -> int:
    """What row-mode ``predict`` of ``q`` must copy between workers: each
    bucket chunk's (index-0 padded) rows of every mode that live off
    worker 0, R table entries each."""
    import numpy as np

    from repro_torch.serve import split_batch

    R, item = srv.core_rank, srv._live.tables[0][0].element_size()
    total = 0
    for start, bucket in split_batch(len(q), srv.ladder):
        chunk = np.zeros((bucket, q.shape[1]), np.int64)
        part = q[start:start + bucket]
        chunk[:len(part)] = part
        for n, b in enumerate(srv._block_rows):
            total += int(np.count_nonzero(chunk[:, n] // b)) * R * item
    return total


def _shard_queries(torch, K, name, params, pool, mesh) -> dict:
    """One model's row and batch servers against the unsharded ``"cuda"``
    server and the plain ``"torch"`` one: predict bits, launches, bytes;
    top_k (mode 0 -> 1, and mode 1 -> 0, whose last block is padded) and
    reconstruct_rows within tolerance, launching nothing."""
    from repro_torch.serve import TuckerServer, split_batch

    zero = {k: 0 for k in REPLACES}
    M = mesh.size
    k = SERVE_LOAD["k"]
    q = pool[:SHARD_QUERIES]
    ids = {0: pool[:SERVE_TOP_IDS, 0].copy(), 1: pool[:SERVE_TOP_IDS, 1]
           .copy()}
    refs = {}
    for what, srv in (("cuda", TuckerServer(params, backend="cuda")),
                      ("torch", TuckerServer(params, backend="torch"))):
        refs[what] = {
            "predict": srv.predict(q),
            "top_k": {m: srv.top_k(m, ids[m], k + 1, target_mode=1 - m)
                      for m in (0, 1)},
            "slices": srv.reconstruct_rows(0, ids[0][:SERVE_SLICE_IDS])}
        del srv
    rec = {}
    for mode in ("row", "batch"):
        srv = TuckerServer(params, backend="cuda", mesh=mesh,
                           shard_mode=mode)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        got = srv.predict(q)
        torch.cuda.synchronize()
        chunks = len(split_batch(len(q), srv.ladder))
        per = 1 if mode == "row" else M
        _counts_are(f"sharded serving [{name}, {mode}] predict", K
                    .launch_counts(), dict(zero, kruskal_contract=chunks * per))
        same = bool(torch.equal(got, refs["cuda"]["predict"]))
        _, rel = rel_err(got, refs["torch"]["predict"])
        moved = srv.traffic["predict"]
        want_moved = _gather_bytes(srv, q) if mode == "row" else 0
        if not (same and rel <= TOL["kruskal_contract"]
                and moved == want_moved):
            raise AssertionError(
                f"sharded serving [{name}, {mode}]: predict bitwise the "
                f"unsharded cuda server {same}, {rel:.3g} off torch, "
                f"{moved} bytes moved (want {want_moved})")
        K.reset_launch_counts()
        srv.traffic.clear()
        tops = {m: srv.top_k(m, ids[m], k, target_mode=1 - m)
                for m in (0, 1)}
        slices = srv.reconstruct_rows(0, ids[0][:SERVE_SLICE_IDS])
        torch.cuda.synchronize()
        _counts_are(f"sharded serving [{name}, {mode}] top_k, "
                    "reconstruct_rows", K.launch_counts(), zero)
        checks = {}
        for what in ("cuda", "torch"):
            for m in (0, 1):
                s, i = tops[m]
                checks[f"top_k {m}->{1 - m} vs {what}"] = _top_k_vs(
                    s, i, *refs[what]["top_k"][m], k)
            checks[f"slices vs {what}"] = rel_err(slices,
                                                  refs[what]["slices"])[1]
        bad = [c for c, v in checks.items()
               if (v[1] if isinstance(v, tuple) else v)
               > TOL["kruskal_contract"]]
        if bad or tuple(slices.shape) != tuple(
                refs["cuda"]["slices"].shape):
            raise AssertionError(f"sharded serving [{name}, {mode}]: "
                                 f"{bad} off: {checks}")
        log(f"sharded serving [{name}, {mode}, M = {M}]: predict of "
            f"{len(q):,} tuples in {chunks} chunks, {chunks * per} "
            f"kruskal_contract launches, bitwise the unsharded cuda server: "
            f"{same}; {rel:.3g} of the largest off the torch server; "
            f"{moved:,} bytes copied between workers ({moved / len(q):.1f} "
            f"a query); top_k (k = {k}, {len(ids[0])} entities) and "
            f"reconstruct_rows launched nothing and copied "
            f"{dict(srv.traffic)} bytes; " + "; ".join(
                f"{c}: ids checked on {v[0]} rows, scores within {v[1]:.3g}"
                if isinstance(v, tuple) else f"{c} within {v:.3g}"
                for c, v in checks.items()))
        rec[mode] = {"predict_bitwise": same, "predict_rel_err_torch": rel,
                     "predict_bytes": moved,
                     "predict_bytes_per_query": moved / len(q),
                     "chunks": chunks, "checks": {
                         c: list(v) if isinstance(v, tuple) else v
                         for c, v in checks.items()},
                     "query_bytes": dict(srv.traffic)}
        del srv
    return rec


def _shard_refresh(torch, K, base_res, pool, mesh) -> tuple[dict, dict]:
    """``RefreshSupervisor`` over a row-sharded server of the paper's
    model: 4 patch rounds and a rebuild round of 65,536 arrivals, exact
    launches a round, the tables bitwise a fresh unsharded server's; then
    a sharded ``update_rows`` against a sharded ``refresh_tables``."""
    import numpy as np

    from repro_torch.distributed import get_strategy
    from repro_torch.serve import (RefreshSupervisor, SupervisorConfig,
                                   TuckerServer)

    R = SERVE_REFRESH
    rounds_n = R["rounds"] + 1
    test_t = base_res["test"]
    n_arr = rounds_n * R["arrivals"]
    arr_idx = test_t.indices[-n_arr:].cpu().numpy()
    arr_val = test_t.values[-n_arr:].cpu().numpy()
    strategy = get_strategy("local")
    plan = strategy.prepare(base_res["train"], base_res["cfg"], None, seed=0)
    dstate = base_res["dstate"]
    srv = TuckerServer(strategy.eval_params(plan, dstate), backend="cuda",
                       mesh=mesh, shard_mode="row")
    spans = sum(hi > lo for s in srv._spans for lo, hi in s)
    owners: list[int] = []
    last_ids: dict[int, np.ndarray] = {}
    real = srv.update_rows

    def recording(mode, ids, rows):
        last_ids[mode] = np.asarray(ids)
        owners.append(len(np.unique(last_ids[mode] //
                                    srv._block_rows[mode])))
        return real(mode, ids, rows)

    srv.update_rows = recording
    # every round patches until the last, which the drift limit sends to
    # a rebuild
    scfg = SupervisorConfig(refresh_steps=R["steps"], window=R["arrivals"],
                            backoff_base_s=1e-3, backoff_cap_s=5e-3,
                            degraded_retry_s=5e-3, poll_interval_s=1e-3,
                            max_patched_fraction=math.inf,
                            max_colsum_drift=math.inf)
    sup = RefreshSupervisor(srv, strategy, plan, dstate, config=scfg)
    main = {k: 0 for k in REPLACES}
    rounds = []
    sup.start()
    try:
        for r in range(rounds_n):
            if r == rounds_n - 1:
                scfg.max_patched_fraction = 0.0
            owners.clear()
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            lo = r * R["arrivals"]
            sup.submit(arr_idx[lo:lo + R["arrivals"]],
                       arr_val[lo:lo + R["arrivals"]])
            if not sup.drain(timeout=300):
                raise AssertionError(f"sharded refresh: round {r} did not "
                                     f"publish: {sup.health()}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = K.launch_counts()
            h = sup.health()
            kind = h["last_publish"]["kind"]
            want = dict({k: 0 for k in REPLACES}, kruskal_grad=R["steps"],
                        scatter_accum=3 * R["steps"])
            if kind == "patch":
                want["patch_table_rows"] = sum(owners)
            else:
                want["mode_product_rows"] = spans
            _counts_are(f"sharded refresh round {r} ({kind})", counts, want)
            if kind != ("rebuild" if r == rounds_n - 1 else "patch"):
                raise AssertionError(f"sharded refresh: round {r} published "
                                     f"a {kind}")
            for k_, v in counts.items():
                main[k_] += v
            rounds.append({"dirty_rows": h["last_dirty"], "publish": kind,
                           "workers_patched": list(owners), "wall_s": wall,
                           "publish_s": h["stage_seconds"]["publish"],
                           "launch_counts": counts})
            log(f"sharded refresh round {r}: dirty rows {h['last_dirty']}, "
                f"{kind}" + (f" on {owners} workers a mode" if owners else "")
                + f", publish {h['stage_seconds']['publish'] * 1e3:.3f} ms, "
                f"round {wall * 1e3:.1f} ms; launches "
                f"{ {k_: v for k_, v in counts.items() if v} }")
    finally:
        sup.stop()
    srv.update_rows = real
    fresh = TuckerServer(sup.dstate.params, backend="cuda")
    exact = all(torch.equal(a, b) for a, b in zip(srv._tables,
                                                  fresh._tables))
    cols = max(rel_err(a, b)[1] for a, b in zip(srv._colsums,
                                                fresh._colsums))
    log(f"sharded refresh: after {R['rounds']} patch rounds and a rebuild "
        f"round, the joined row-sharded tables bitwise a fresh unsharded "
        f"server's: {exact}; colsums within {cols:.3g}; "
        f"{dict(srv.traffic)} bytes copied between workers")
    if not (exact and cols <= 1e-5):
        raise AssertionError("sharded refresh: tables or colsums differ")

    # a sharded patch of mode 0's dirty rows (the last patch round's)
    # against a sharded rebuild (host clock, medians of 7 in turns; the
    # rows gathered first)
    ids = last_ids[0].astype(np.int32)
    rows = srv.params.factors[0].index_select(
        0, torch.from_numpy(ids).long().cuda())
    times = {"update_rows": [], "refresh_tables": []}
    for _ in range(SHARD_TIME_ROUNDS):
        for what, fn in (("update_rows",
                          lambda: srv.update_rows(0, ids, rows)),
                         ("refresh_tables", srv.refresh_tables)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[what].append(time.perf_counter() - t0)
    med = {k_: statistics.median(v) * 1e3 for k_, v in times.items()}
    log(f"sharded refresh times (row mode, M = {mesh.size}, J = R = 4): "
        f"update_rows of mode 0's {len(ids):,} dirty rows "
        f"{med['update_rows']:.4f} ms against refresh_tables "
        f"{med['refresh_tables']:.4f} ms, x"
        f"{med['refresh_tables'] / med['update_rows']:.2f} (medians of "
        f"{SHARD_TIME_ROUNDS} in turns; recorded, not asserted)")
    return {"rounds": rounds, "tables_bitwise": exact,
            "colsum_rel_err": cols, "traffic": dict(srv.traffic),
            "update_rows_ms": med["update_rows"],
            "refresh_tables_ms": med["refresh_tables"],
            "times_ms": {k_: [x * 1e3 for x in v]
                         for k_, v in times.items()},
            "dirty_rows": len(ids)}, main


def phase_sharded_serving(torch, K, serve_tucker, online_train, base_res,
                          wide_params, steps: int, out_dir: Path
                          ) -> tuple[dict, dict]:
    """Sharded Tucker serving on ``SHARD_WORKERS`` workers sharing the
    card: both models' row and batch servers against the unsharded ones,
    the supervised refresh on a row-sharded server, the ``auto`` policy,
    ``serve_tucker --sharded`` and ``online_train --serve-shard-mode
    row``, and ``bench_serve`` FULL at devices 4."""
    import os

    from repro_torch.benchmarks import bench_serve
    from repro_torch.benchmarks.common import validate_bench_serve
    from repro_torch.launch.mesh import FORCE_ENV_VAR, make_host_mesh
    from repro_torch.serve import ShardPolicy, TuckerServer

    M = SHARD_WORKERS
    mesh = make_host_mesh(num_workers=M, device="cuda")
    out_dir.mkdir(parents=True, exist_ok=True)
    pool = base_res["test"].indices[:SERVE_POOL].cpu().numpy()
    paper = base_res["state"].params
    rec = {"models": {}}
    main = {k: 0 for k in REPLACES}
    t0 = time.perf_counter()
    for name, params in (("paper, J = R = 4", paper),
                         ("rank 64", wide_params)):
        rec["models"][name] = _shard_queries(torch, K, name, params, pool,
                                             mesh)
    rec["queries_seconds"] = time.perf_counter() - t0
    rec["refresh"], counts = _shard_refresh(torch, K, base_res, pool, mesh)
    for k, v in counts.items():
        main[k] += v

    # the "auto" policy
    hi = TuckerServer(paper, backend="cuda", mesh=mesh, expected_qps=16_000)
    lo = TuckerServer(paper, backend="cuda", mesh=mesh)
    wide = TuckerServer(wide_params, backend="cuda", mesh=mesh,
                        expected_qps=16_000,
                        policy=ShardPolicy(replicate_bytes_ceiling=64 << 20))
    rec["auto"] = {n: str(s.shard_decision) for n, s in (
        ("paper at 16,000 q/s", hi), ("paper, no rate", lo),
        ("rank 64, 64 MiB ceiling", wide))}
    for n, d in rec["auto"].items():
        log(f"sharded serving auto [{n}]: {d}")
    if (hi.shard_mode, lo.shard_mode, wide.shard_mode) != ("batch", "row",
                                                           "row") \
            or "ceiling" not in wide.shard_decision.reason:
        raise AssertionError(f"sharded serving auto: {rec['auto']}")
    del hi, lo, wide

    old_env = os.environ.get(FORCE_ENV_VAR)
    os.environ[FORCE_ENV_VAR] = str(M)
    try:
        # serve_tucker --sharded --shard-mode row
        torch.cuda.synchronize()
        K.reset_launch_counts()
        rep = serve_tucker.main(["--sharded", "--shard-mode", "row",
                                 "--device", "cuda", "--backend", "cuda"])
        torch.cuda.synchronize()
        counts = K.launch_counts()
        log(f"serve_tucker --sharded --shard-mode row: {rep['shard_mode']}"
            f", {rep['served_queries']:,} queries in {rep['flushes']} "
            f"flushes, {rep['qps']:,.1f} q/s, flush p50 "
            f"{rep['flush_ms']['p50']:.3f} ms; rmse {rep['rmse']:.4f}; "
            f"launch counts { {k: v for k, v in counts.items() if v} }")
        _check_path("serve_tucker --sharded", counts,
                    ("kruskal_contract", "kruskal_grad", "scatter_accum",
                     "mode_product_rows"), ("segment_reduce",) + LM_KERNELS)
        if rep["shard_mode"] != "row" or not all(
                math.isfinite(x) for row in rep["top_k"]["scores"]
                for x in row):
            raise AssertionError(f"serve_tucker --sharded: {rep}")
        for k, v in counts.items():
            main[k] += v
        rec["serve_tucker"] = {k: rep[k] for k in (
            "shard_mode", "served_queries", "flushes", "qps", "flush_ms",
            "rmse")}
        rec["serve_tucker"]["launch_counts"] = counts

        # online_train --strategy strata --serve-shard-mode row
        res, counts, wall = _online_run(
            torch, K, online_train, f"strata, M = {M}, row-sharded serving",
            ["--strategy", "strata", "--serve-shard-mode", "row", "--dims",
             ",".join(map(str, NETFLIX_DIMS)), "--rank", "4", "--core-rank",
             "4", "--batch", str(TRAIN_BATCH), "--warmup-steps", str(steps),
             "--rounds", str(STRAT_ONLINE["rounds"]), "--refresh-steps",
             str(ONLINE["refresh_steps"]), "--stream-fraction",
             str(STRAT_ONLINE["stream_fraction"]), "--seed", "0",
             "--backend", "cuda", "--device", "cuda", "--verify"],
            (base_res["train"], base_res["test"]))
        if res["server"].shard_mode != "row" or res["serve_workers"] != M:
            raise AssertionError("online sharded: served "
                                 f"{res['server'].shard_mode} on "
                                 f"{res['serve_workers']} workers")
        for k, v in counts.items():
            main[k] += v
        rec["online"] = {"wall_s": wall, "rounds": res["rounds"],
                         "launch_counts": counts, "verify": res["verify"]}
        del res
    finally:
        if old_env is None:
            os.environ.pop(FORCE_ENV_VAR, None)
        else:
            os.environ[FORCE_ENV_VAR] = old_env

    # bench_serve FULL at devices 4 (bench_serve/v1)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    doc = bench_serve.run(smoke=False,
                          out_path=str(out_dir / "BENCH_torch_serve.json"),
                          device="cuda", backend="cuda", devices=M)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    validate_bench_serve(doc)
    note_written("21 (bench_serve document)",
                 (out_dir / "BENCH_torch_serve.json").stat().st_size)
    thr, col, x = doc["throughput"], doc["collectives"], doc["crossover"]
    log(f"bench_serve FULL at devices {M}: validate_bench_serve passed; "
        f"per-query {thr['per_query_qps']:,.1f} q/s, bucketed "
        f"{thr['bucketed_qps']:,.1f} q/s, speedup {thr['speedup']:.1f}; "
        f"{thr['sweep_compiles']} bucket lengths launched (bound "
        f"{thr['ladder_bound']}); top_k bytes a bucket of {col['bucket']} "
        f"at k = {col['k']}: shard-local merge {col['sharded_operand_bytes']:,}"
        f", score gather {col['gspmd_operand_bytes']:,}, reduction "
        f"x{col['reduction']:.2f}; crossover row {x['row_max_qps']:,.1f} / "
        f"batch {x['batch_max_qps']:,.1f} q/s, batch_vs_row "
        f"{x['batch_vs_row']:.3f}; {secs:.1f} s; launch counts "
        f"{ {k: v for k, v in counts.items() if v} }")
    for r in doc["closed_loop"]["rows"]:
        log(f"bench_serve closed loop [{r['shard_mode']} {r['query']} at "
            f"{r['offered_qps']:,.0f} q/s offered]: achieved "
            f"{r['achieved_qps']:,.1f} q/s, p50 {r['p50_ms']:.3f} ms, p99 "
            f"{r['p99_ms']:.3f} ms, {r['served_requests']} requests, shed "
            f"{r['shed']}")
    _check_path("bench_serve", counts, ("kruskal_contract",),
                ("kruskal_grad", "segment_reduce") + LM_KERNELS)
    for k, v in counts.items():
        main[k] += v
    rec["bench_serve"] = {"doc": doc, "launch_counts": counts,
                          "seconds": secs}
    rec["launch_counts"] = main
    return rec, main


# ---------------------------------------------------------------------------
# 22. the multi-device benchmarks
# ---------------------------------------------------------------------------

def _fig7bc(torch, K) -> tuple[dict, dict]:
    """``bench_multidev`` FULL on the card: the counts held to the shapes
    and the launches to M (1 for local) ``kruskal_grad`` and 3M
    ``scatter_accum`` a step; each row printed beside the reference's
    figure."""
    from repro_torch.benchmarks import bench_multidev

    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = bench_multidev.sweep(device="cuda", backend="cuda")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    seconds = time.perf_counter() - t0
    bench_multidev.rows(res)
    b = SYNC_PSUM_BYTES
    for M, r in res.items():
        chk = bench_multidev.overlap_check(r)
        side = r["strata_overlap"].get("side_copies", {})
        log(f"fig7bc M = {M}: overlap_check {chk}; side copies beside a "
            f"compute kernel {side.get('beside_compute_us', 0.0):.1f} of "
            f"{side.get('side_copy_us', 0.0):.1f} us "
            f"({side.get('share', 0.0):.1%}, reported)")
        if not (chk["coll_no_worse"] and chk["rotation_hidden"]):
            raise AssertionError(f"fig7bc M = {M}: {chk}")
        want = 2 * b * (M - 1) / M
        if r["sync"]["psum"] != want:
            raise AssertionError(f"fig7bc M = {M}: sync psum "
                                 f"{r['sync']['psum']} != {want}")
        for name, s in r.items():
            ref = REF_FIG7BC[M][name]
            log(f"fig7bc {name} M = {M}: {s['us_per_step']:.1f} us a step "
                f"({1e6 / s['us_per_step']:.1f} steps/s); flops/dev "
                f"{s['flops']:,.0f} [reference HLO {ref[0]:,.1f}, "
                f"x{s['flops'] / ref[0]:.4f}]; coll/step {s['coll']:,.1f} "
                f"(psum {s['psum']:,.1f} + permute {s['permute']:,.1f}) "
                f"[reference {ref[1]:,.1f}]; permutes/step "
                f"{s['permutes']:.4g} [{ref[2]}]; hidden_flops/step "
                f"{s['hidden_flops']:.6g} [{ref[3]}]; async_starts "
                f"{s['async_starts']}; work_scaling_eff "
                f"{s['work_scaling_eff']:.4f}; launches a step "
                f"{s['launches']}")
            if abs(s["work_scaling_eff"] - 1) > 0.01:
                raise AssertionError(
                    f"fig7bc {name} M = {M}: work_scaling_eff "
                    f"{s['work_scaling_eff']}")
            per = 1 if name == "local" else M
            if s["launches"] != {"kruskal_grad": per,
                                 "scatter_accum": 3 * per}:
                raise AssertionError(f"fig7bc {name} M = {M}: launches "
                                     f"{s['launches']}")
    log(f"fig7bc FULL: {seconds:.1f}s, launch counts {counts}")
    return {"results": res, "seconds": seconds, "launch_counts": counts}, \
        counts


def phase_multidev_benchmarks(torch, K, out_dir: Path) -> tuple[dict, dict]:
    """The multi-device benchmarks at FULL on workers sharing the card:
    ``bench_multidev`` (Fig. 7b/c) at M = 2 and 4, ``bench_ingest`` FULL
    attached to phase 18's ``BENCH_torch_step.json``, ``bench_convergence``
    FULL with both configs into ``BENCH_torch_convergence.json``, and the
    multipod example at 8 workers."""
    from repro_torch.benchmarks import bench_convergence, bench_ingest
    from repro_torch.examples import multipod_std

    rec, main = {}, {k: 0 for k in REPLACES}

    def add(counts):
        for k, v in counts.items():
            main[k] += v

    rec["fig7bc"], counts = _fig7bc(torch, K)
    add(counts)

    # 22.2: the ingestion sweep; its stores spill under build/
    spill = ROOT / "build" / "ingest_spill"
    shutil.rmtree(spill, ignore_errors=True)
    step_doc = out_dir / "BENCH_torch_step.json"
    K.reset_launch_counts()
    t0 = time.perf_counter()
    ingest = bench_ingest.run(smoke=False, device="cuda", backend="cuda",
                              spill_root=str(spill), attach=str(step_doc))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    add(counts)
    note_written("22 (ingest stores)", tree_bytes(spill))
    note_written("22 (benchmark documents)", tree_bytes(step_doc))
    shutil.rmtree(spill, ignore_errors=True)
    for r in ingest["rows"]:
        log(f"ingest nnz {r['nnz']:,}: store {r['store_mb']} MB "
            f"({r['num_strata']} strata of {r['stratum_mb']} MB, built in "
            f"{r['store_build_s']} s); us a step resident "
            f"{r['us_per_step_resident']}, depth 0 "
            f"{r['us_per_step_sync']:.1f}, depth {r['prefetch_depth']} "
            f"{r['us_per_step_stream']:.1f}; a stratum's load "
            f"{r['us_per_stratum_load']:.1f} us; hidden "
            f"{r['transfer_hidden_fraction']}; stream/resident "
            f"{r.get('stream_vs_resident')}; epoch {r['epoch_s']} s, "
            f"{r['ingest_nnz_per_s']:,.1f} nonzeros/s; bitwise resident "
            f"{r.get('stream_bitwise_resident')}")
        fits = r["store_mb"] * 2**20 <= bench_ingest.RESIDENT_BUDGET_BYTES
        if fits != (r["us_per_step_resident"] is not None):
            raise AssertionError(f"ingest nnz {r['nnz']}: resident run "
                                 f"{r['us_per_step_resident']}")
        if fits and r.get("stream_bitwise_resident") is not True:
            raise AssertionError(f"ingest nnz {r['nnz']}: not bitwise")
    if ingest["rows"][-1]["us_per_step_resident"] is not None:
        raise AssertionError("ingest at 10^7 nonzeros must skip resident")
    rec["ingest"] = {"doc": ingest, "seconds": time.perf_counter() - t0,
                     "launch_counts": counts}
    log(f"ingest FULL: {rec['ingest']['seconds']:.1f}s, attached to "
        f"{step_doc} (validate_bench_step passed); launch counts {counts}")

    # 22.3: bench_convergence FULL, local and strata
    K.reset_launch_counts()
    t0 = time.perf_counter()
    conv_doc = out_dir / "BENCH_torch_convergence.json"
    doc = bench_convergence.run(smoke=False, out_path=str(conv_doc),
                                device="cuda", backend="cuda")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    add(counts)
    note_written("22 (benchmark documents)", tree_bytes(conv_doc))
    for c in doc["configs"]:
        log(f"bench_convergence {c['name']} ({doc['devices']} workers for "
            f"strata): cold {c['cold']['steps_to_target']} steps / "
            f"{c['cold']['wallclock_s_to_target']:.3f}s (final "
            f"{c['cold']['final_rmse']:.5f}); warm "
            f"{c['sketched']['steps_to_target']} steps / "
            f"{c['sketched']['wallclock_s_to_target']:.3f}s (final "
            f"{c['sketched']['final_rmse']:.5f}); speedup steps "
            f"{c['speedup_vs_cold']:.1f}, wall "
            f"{c['wallclock_speedup_vs_cold']:.3f}")
    rec["convergence"] = {"doc": doc, "seconds": time.perf_counter() - t0,
                          "launch_counts": counts}
    log(f"bench_convergence FULL (both configs): "
        f"{rec['convergence']['seconds']:.1f}s, validator passed; launch "
        f"counts {counts}")

    # 22.4: the multipod example, 8 workers, 200 steps
    K.reset_launch_counts()
    t0 = time.perf_counter()
    hist = multipod_std.main(["--device", "cuda", "--backend", "cuda"])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    add(counts)
    rmse = [r for _, r in hist]
    if not (all(math.isfinite(r) for r in rmse) and rmse[-1] < rmse[0]):
        raise AssertionError(f"multipod_std: RMSE {hist}")
    rec["multipod"] = {"history": hist, "launch_counts": counts,
                       "seconds": time.perf_counter() - t0}
    log(f"multipod_std (strata_overlap, 8 workers): RMSE {hist}; "
        f"{rec['multipod']['seconds']:.1f}s; launch counts {counts}")
    return rec, main


# ---------------------------------------------------------------------------
# phase 23
# ---------------------------------------------------------------------------

def _sharded_mesh(shape):
    """``make_host_mesh``'s workers for ``shape``, every one on the card."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(shape[1], num_workers=shape[0] * shape[1],
                          device="cuda")
    if mesh.shape != shape or any(d.type != "cuda" for d in mesh.devices):
        raise AssertionError(f"sharded LM: mesh {mesh.shape} on "
                             f"{mesh.devices}, want {shape} on the card")
    return mesh


def _worker_shapes(torch, train, cfg, mesh, policy: str, B: int, T: int
                   ) -> dict:
    """Worker 0's kernel shapes in a sharded step of ``cfg`` (global batch
    B × T) on ``mesh`` under ``policy``, from the step's own layouts and
    head selection: its batch rows, query and KV heads, and the d_ff rows
    of its Tucker FFN (every worker's alike where each dimension
    divides)."""
    import types

    from repro_torch.distributed.sharded_lm import ShardedLM
    from repro_torch.distributed.sharding import Layout, batch_spec

    lm = ShardedLM(cfg, mesh, train.layouts_for(cfg, mesh, policy), policy)

    def gathered(name):      # worker 0's copy of a leaf before it computes
        return tuple(r.stop - r.start for r in lm.plans[name].region[0])

    mixer = types.SimpleNamespace(**{
        w: torch.empty(gathered(f"layers.0.mixer.{w}"), device="meta")
        for w in ("wq", "wk", "wv")})
    mixer = lm._local_attention(mixer, 0, 0)
    rows = Layout((B, T), batch_spec(mesh, B, 1, policy), mesh).index(0)[0]
    bw = len(range(B)[rows])
    return {"B_w": bw, "M": bw * T, "H": mixer.wq.shape[1],
            "Kv": mixer.wk.shape[1],
            "d_ff_up": gathered("layers.0.ffn.up.u2")[0],
            "d_ff_down": gathered("layers.0.ffn.down.u1")[0]}


def _sharded_kernel_checks(torch, K, train, cfg, B: int, T: int) -> dict:
    """``tucker_matmul`` (forward and dx, x in bf16 and f32) and the flash
    forward and backward against their plain versions at the per-worker
    shapes of every ``SHARDED_LM_PAIRS`` run, within phase 11's bounds.
    The flash kernels take f32 only: the model projects q, k, v in f32
    (its weights are f32) whatever the residual stream's dtype."""
    ref = K.ref
    tm = K.tucker_matmul.tucker_matmul
    fa = K.flash_attention.flash_attention
    fb = K.flash_attention_bwd.flash_attention_bwd
    gen = torch.Generator(device="cuda").manual_seed(2323)
    d, D = cfg.d_model, cfg.head_dim
    shapes = {f"{shape} {policy}": _worker_shapes(
        torch, train, cfg, _sharded_mesh(shape), policy, B, T)
        for shape, policy in SHARDED_LM_PAIRS}
    for tag, w in shapes.items():
        log(f"sharded LM kernels: {tag} worker shapes {w}")
    worst: dict = {}
    ffn = sorted({(w["M"], w["d_ff_up"], w["d_ff_down"])
                  for w in shapes.values()}, reverse=True)
    for M, n_up, k_down in ffn:
        for name, (Kd, N) in (("up/gate", (d, n_up)), ("down", (k_down, d))):
            for xdt in (torch.bfloat16, torch.float32):
                dt = str(xdt)[6:]
                x, u1, g, u2 = _tucker_inputs(torch, gen, M, Kd, N, xdt)
                _held(worst, "tucker_matmul", tm(x, u1, g, u2),
                      ref.tucker_matmul_ref(x, u1, g, u2),
                      f"{name} M={M} K={Kd} N={N} x {dt}")
                gy = torch.randn((M, N), generator=gen,
                                 device="cuda").to(xdt)
                gt = g.t().contiguous()
                _held(worst, "tucker_matmul", tm(gy, u2, gt, u1),
                      ref.tucker_matmul_ref(gy, u2, gt, u1),
                      f"{name} dx M={M} {N}->{Kd} Gᵀ ȳ {dt}")
                del x, u1, g, u2, gy, gt
    heads = sorted({(w["B_w"], w["H"], w["Kv"]) for w in shapes.values()},
                   reverse=True)
    for bw, h, kv in heads:
        what = f"B={bw} S={T} H={h} Kv={kv} D={D} causal"
        q, k, v = _flash_inputs(torch, gen, T, T, B=bw, H=h, Hk=kv, D=D)
        dout = torch.randn(q.shape, generator=gen, device="cuda")
        o, lse = fa(q, k, v, causal=True, return_lse=True)
        o_ref, lse_ref = ref.flash_attention_ref(q, k, v, True,
                                                 return_lse=True)
        _held(worst, "flash_attention", o, o_ref, what)
        _held(worst, "flash_attention", lse, lse_ref, what + " lse")
        got = fb(q, k, v, o, lse, dout, causal=True)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, True)
        for nm, a, b in zip(("dq", "dk", "dv"), got, want):
            _held(worst, "flash_attention_bwd", a, b, f"{what} {nm}")
        del q, k, v, dout, o, lse, o_ref, lse_ref, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for key, (e, r) in worst.items():
        log(f"sharded LM kernels at the worker shapes: {key} max abs err "
            f"{e:.3g}, max relative err {r:.3g} (tolerance {TOL[key]})")
    return {"worker_shapes": shapes,
            **{k: {"max_abs_err": e, "max_rel_err": r, "tol": TOL[k]}
               for k, (e, r) in worst.items()}}


def _sharded_backends(torch, train, S, cfg, opt_cfg, batch, shape,
                      policy: str) -> dict:
    """Phase 13 on a mesh: one sharded step of ``cfg`` (the config's
    dtype) from one state with the ``"cuda"`` backend and with
    ``"torch"``; the loss within 2⁻⁷, m and v within 2⁻⁵ of each leaf's
    largest, and the parameters where the torch step's |g| is past
    ``LM_SETTLED`` of its leaf's largest within 2⁻⁵ of the lr."""
    from repro_torch.checkpoint.manager import flatten

    mesh = _sharded_mesh(shape)
    loss, tag = {}, f"{shape} {policy}"
    for bk in ("torch", "cuda"):
        st, layouts = train.build_state(
            torch.Generator(device="cuda").manual_seed(23), cfg, mesh, policy)
        step = S.make_sharded_train_step(cfg, opt_cfg, mesh, layouts, bk,
                                         policy=policy)
        st, met = step(st, batch)
        loss[bk], lr = float(met["loss"]), float(met["lr"])
        if bk == "torch":
            settled = {}
            for name, m in flatten(st).items():
                if name.startswith("opt.m."):   # m ∝ g after one step
                    g = m.full().abs()
                    settled["params." + name[len("opt.m."):]] = (
                        g > LM_SETTLED * g.max()).cpu()
                    del g
            want = _host_leaves(torch, st)
            del st, step
            torch.cuda.empty_cache()
    rel_loss = abs(loss["cuda"] - loss["torch"]) / abs(loss["torch"])
    errs = _leaf_errs(torch, st, want)
    mv = max(((n, e) for n, e in errs.items() if n.startswith("opt.")),
             key=lambda kv: kv[1])
    pw, pleaf, held = _settled_param_err(torch, st, want, settled, lr)
    del st, step, want, settled
    torch.cuda.empty_cache()
    log(f"sharded LM (b, {cfg.dtype}) {tag}, {cfg.num_layers} layers, batch "
        f"{batch['tokens'].shape[0]}: one step 'cuda' against 'torch': loss "
        f"{loss['cuda']:.6f} / {loss['torch']:.6f}, relative diff "
        f"{rel_loss:.3g} (tolerance {TOL['lm.loss']:.4g}); worst moment "
        f"{mv[0]} {mv[1]:.3g} of its largest (tolerance "
        f"{TOL['lm.grads']:.4g}); parameters where |g| > {LM_SETTLED:g} of "
        f"its leaf's largest ({held:,}): worst {pleaf} {pw:.3g} of the lr")
    if not (math.isfinite(loss["cuda"]) and rel_loss <= TOL["lm.loss"]
            and mv[1] <= TOL["lm.grads"] and pw <= TOL["lm.grads"]):
        raise AssertionError(f"sharded LM (b, {cfg.dtype}) {tag}: loss "
                             f"{rel_loss:.3g}, moment {mv}, parameters "
                             f"{pw:.3g} ({pleaf})")
    return {"loss": loss, "loss_rel_diff": rel_loss, "worst_moment": mv,
            "worst_settled_param": [pleaf, pw], "settled_entries": held}


def _host_leaves(torch, state) -> dict:
    """Every leaf of a (sharded or not) training state, unsharded, in
    pinned host memory (the comparisons copy each back to the card: ~4×
    the rate of pageable copies, and the pinned blocks are reused by the
    next call)."""
    from repro_torch.checkpoint.manager import flatten

    out = {}
    for name, t in flatten(state).items():
        full = t.full() if hasattr(t, "full") else t.detach()
        out[name] = torch.empty(full.shape, dtype=full.dtype,
                                pin_memory=True).copy_(full)
        del full
    return out


def _leaf_errs(torch, state, want: dict) -> dict:
    """{leaf name: max |state − want| / max |want|}, a leaf at a time on
    the card."""
    from repro_torch.checkpoint.manager import flatten

    errs = {}
    for name, t in flatten(state).items():
        got = t.full() if hasattr(t, "full") else t.detach()
        errs[name] = rel_err(got.float(),
                             want[name].to(got.device, non_blocking=True
                                           ).float())[1]
        del got
    return errs


def _settled_param_err(torch, state, want: dict, settled: dict,
                       lr_sum: float) -> tuple:
    """Phase 13's sign rule over several steps: the parameters settled at
    every step (``settled``, host masks by leaf name), max |Δ| over the
    steps' summed lr → (worst ratio, leaf, entries)."""
    from repro_torch.checkpoint.manager import flatten

    worst, leaf, held = 0.0, "", 0
    for name, t in flatten(state).items():
        if name not in settled:
            continue
        got = t.full() if hasattr(t, "full") else t.detach()
        d = (got.float() - want[name].cuda(non_blocking=True).float())[
            settled[name].cuda()]
        held += d.numel()
        r = d.abs().max().item() / lr_sum if d.numel() else 0.0
        if r > worst:
            worst, leaf = r, name
        del got, d
    return worst, leaf, held


def _step_settled(torch, opt, prev: dict | None, masks: dict, b1: float
                  ) -> dict:
    """AND into ``masks`` ({"params." + name: bool mask}) where this step's
    gradient — ∝ m − b1·m_prev — is past ``LM_SETTLED`` of its leaf's
    largest; → a copy of m for the next step."""
    for n, m in opt.m.items():
        g = (m - b1 * prev[n]) if prev is not None else m
        g = g.abs()
        ok = g > LM_SETTLED * g.max()
        key = "params." + n
        masks[key] = ok if key not in masks else masks[key] & ok
        del g
    return {n: m.clone() for n, m in opt.m.items()}


def phase_sharded_lm(torch, K, train, cfg) -> tuple[dict, dict]:
    """Sharded LM training on M = 4 workers sharing the card (full width;
    the depth, batch and steps of ``SHARDED_LM``): the kernels against
    their plain versions at every run's per-worker shapes; (a) a (1, 1)
    mesh against ``make_train_step``; (b) four policy/mesh pairs against
    the unsharded ``"cuda"`` step in f32, and two "cuda" against "torch"
    in the config's bf16; (c) ``SHARDED_LM["steps"]`` of each through
    ``launch/train.run`` — the phase's main path — with (d) its launch
    counts; (e) the elastic restore of a (2, 2) fsdp_tp checkpoint into
    (4, 1) zero3 and one device, and a failure's replay."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FailureInjector

    C = SHARDED_LM
    B, T = C["batch"], C["seq"]
    rec: dict = {"card": nvidia_smi_line()}
    seconds: dict = {}
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)  # noqa
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=T, global_batch=B))
    batches = [train.device_batch(pipe.global_batch(i), "cuda")
               for i in range(C["parity_steps"])]

    torch.cuda.empty_cache()
    log(f"sharded LM: {torch.cuda.memory_allocated():,} device bytes "
        "held by earlier phases at the start")
    t0 = time.perf_counter()
    cfg4 = dataclasses.replace(cfg, num_layers=C["layers"])
    rec["kernels"] = _sharded_kernel_checks(torch, K, train, cfg4, B, T)
    seconds["kernels"] = time.perf_counter() - t0

    # (a), (b): three fed steps at 2 layers against the unsharded step, the
    # residual stream in f32 (``SHARDED_LM``)
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, num_layers=C["parity_layers"],
                               dtype="float32")
    opt_cfg = adamw.AdamWConfig(**SHARDED_LM_OPT)
    state = S.init_train_state(cfg2, gen(23), "cuda")
    step = S.make_train_step(cfg2, opt_cfg, "cuda")
    ref_loss, lrs, masks, prev = [], [], {}, None
    for b in batches:
        state, m = step(state, b)
        ref_loss.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        prev = _step_settled(torch, state.opt, prev, masks, opt_cfg.b1)
    want = _host_leaves(torch, state)
    settled = {n: t.cpu() for n, t in masks.items()}
    del state, step, prev, masks
    torch.cuda.empty_cache()
    log(f"sharded LM parity reference: the unsharded 'cuda' step, "
        f"{cfg2.num_layers} layers, batch {B} x seq {T}, losses "
        f"{[f'{x:.6f}' for x in ref_loss]}")
    parity, compare = {}, 0.0
    for shape, policy in [((1, 1), "fsdp_tp")] + SHARDED_LM_PAIRS:
        mesh = _sharded_mesh(shape)
        st, layouts = train.build_state(gen(23), cfg2, mesh, policy)
        sstep = S.make_sharded_train_step(cfg2, opt_cfg, mesh, layouts,
                                          "cuda", policy=policy)
        losses = []
        for b in batches:
            st, m = sstep(st, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        loss_err = max(abs(g - w) / abs(w) for g, w in zip(losses, ref_loss))
        tc = time.perf_counter()
        errs = _leaf_errs(torch, st, want)
        tag = f"{shape} {policy}"
        if shape == (1, 1):
            worst = max(errs.items(), key=lambda kv: kv[1])
            log(f"sharded LM (a) {tag}: losses {losses}, max relative "
                f"diff {loss_err:.3g}; worst leaf {worst[0]} {worst[1]:.3g} "
                f"of its largest (tolerance {TOL['lm.resume']})")
            if not (loss_err <= TOL["lm.resume"]
                    and worst[1] <= TOL["lm.resume"]):
                raise AssertionError(f"sharded LM (a): the (1, 1) mesh is "
                                     f"not make_train_step ({loss_err:.3g}, "
                                     f"{worst})")
            parity[tag] = {"loss_rel_diff": loss_err, "worst_leaf": worst}
        else:
            mv = max(((n, e) for n, e in errs.items()
                      if n.startswith("opt.")), key=lambda kv: kv[1])
            pw, pleaf, held = _settled_param_err(torch, st, want, settled,
                                                 sum(lrs))
            log(f"sharded LM (b) {tag}: losses {losses}, max relative diff "
                f"{loss_err:.3g} (tolerance {TOL['lm.loss']:.4g}); worst "
                f"moment {mv[0]} {mv[1]:.3g} of its largest (tolerance "
                f"{TOL['lm.grads']:.4g}); parameters where the reference's "
                f"|g| > {LM_SETTLED:g} of its leaf's largest at every step "
                f"({held:,}): "
                f"worst {pleaf} {pw:.3g} of the summed lr; traffic a step "
                f"{_per_step(sstep.traffic, len(batches))}")
            if not (loss_err <= TOL["lm.loss"] and mv[1] <= TOL["lm.grads"]
                    and pw <= TOL["lm.grads"]):
                raise AssertionError(f"sharded LM (b) {tag}: loss "
                                     f"{loss_err:.3g}, moment {mv}, "
                                     f"parameters {pw:.3g} ({pleaf})")
            parity[tag] = {"loss_rel_diff": loss_err, "worst_moment": mv,
                           "worst_settled_param": [pleaf, pw],
                           "settled_entries": held}
        compare += time.perf_counter() - tc
        del st, sstep
        torch.cuda.empty_cache()
    del want, settled
    seconds["parity f32"] = time.perf_counter() - t0
    seconds["parity f32, of it the leaf comparisons"] = compare
    # (b) in the config's bf16, "cuda" against "torch" (phase 13's check)
    t0 = time.perf_counter()
    cfg2b = dataclasses.replace(cfg, num_layers=C["parity_layers"])
    for shape, policy in SHARDED_LM_BACKEND_PAIRS:
        parity[f"{shape} {policy} {cfg2b.dtype} cuda-torch"] = (
            _sharded_backends(torch, train, S, cfg2b,
                              adamw.AdamWConfig(**LM_TRAIN_PARITY_OPT),
                              batches[0], shape, policy))
    seconds["parity bf16"] = time.perf_counter() - t0
    rec["parity"] = parity

    # (c), (d): the training runs, the phase's main path
    t0 = time.perf_counter()
    L, W = cfg4.num_layers, 4
    N = C["steps"]
    ckpt_root = ROOT / "build" / "sharded_ckpt"   # git-ignored
    shutil.rmtree(ckpt_root, ignore_errors=True)
    runs, counts_all = {}, {}
    for shape, policy in SHARDED_LM_PAIRS:
        mesh = _sharded_mesh(shape)
        K.reset_launch_counts()
        res = train.run(cfg4, steps=N, batch=B, seq=T, lr=C["lr"],
                        ckpt_dir=str(ckpt_root / "runs"), ckpt_every=N + 1,
                        log_every=5, device="cuda", backend="cuda",
                        mesh=mesh, policy=policy)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
        hist = res["history"]
        losses = [hist[i]["loss"] for i in range(1, N + 1)]
        med = statistics.median(hist[i]["seconds"] for i in range(2, N + 1))
        wantc = {"tucker_matmul": 6 * L * W * N, "flash_attention": L * W * N,
                 "flash_attention_bwd": L * W * N}
        tag = f"{shape} {policy}"
        log(f"sharded LM (c) {tag}: {L} layers, batch {B} x seq {T}, {N} "
            f"steps: {res['steps_per_s']:.4f} steps/s, "
            f"{res['tokens_per_s']:.1f} tokens/s (median step {med:.4f}s = "
            f"{B * T / med:.1f} tokens/s); peak device bytes "
            f"{res['peak_device_bytes'] or 0:,}; state bytes a worker "
            f"{res['state_bytes_per_worker']:,} (from the layouts "
            f"{res['layout_state_bytes']:,}); collective bytes a step and "
            f"worker {res['traffic_per_step']}; losses "
            + ", ".join(f"{x:.4f}" for x in losses))
        log(f"sharded LM (d) {tag}: launch counts {counts} (want {wantc}: "
            f"6·L·W tucker_matmul, L·W of each flash kernel a step, "
            f"W = {W})")
        if res["state_bytes_per_worker"] != res["layout_state_bytes"]:
            raise AssertionError(f"sharded LM (c) {tag}: a worker holds "
                                 f"{res['state_bytes_per_worker']:,} bytes, "
                                 f"the layouts say "
                                 f"{res['layout_state_bytes']:,}")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"sharded LM (c) {tag}: losses {losses}")
        for k in REPLACES:
            if counts[k] != wantc.get(k, 0):
                raise AssertionError(f"sharded LM (d) {tag}: {k} launched "
                                     f"{counts[k]} times, want "
                                     f"{wantc.get(k, 0)}")
        runs[tag] = {"steps_per_s": res["steps_per_s"],
                     "tokens_per_s": res["tokens_per_s"],
                     "median_step_s": med,
                     "peak_device_bytes": res["peak_device_bytes"],
                     "state_bytes_per_worker": res["state_bytes_per_worker"],
                     "traffic_per_step": res["traffic_per_step"],
                     "losses": losses, "launch_counts": counts}
        del res
        torch.cuda.empty_cache()
    rec["runs"] = runs
    seconds["runs"] = time.perf_counter() - t0

    # (e): a failure's replay and the elastic restore, at the cut vocab
    te = time.perf_counter()
    cfge = dataclasses.replace(cfg, num_layers=C["parity_layers"],
                               vocab_size=C["elastic_vocab"])
    mesh = _sharded_mesh((2, 2))
    E = C["elastic"]
    whole = train.run(cfge, steps=E["steps"], batch=B, seq=T, lr=C["lr"],
                      ckpt_dir=str(ckpt_root / "whole"),
                      ckpt_every=E["steps"] + 1, log_every=E["steps"],
                      device="cuda", backend="cuda", mesh=mesh,
                      policy="fsdp_tp")
    want = _host_leaves(torch, whole["state"])
    wl = [whole["history"][i]["loss"] for i in range(1, E["steps"] + 1)]
    del whole
    torch.cuda.empty_cache()
    failed = train.run(cfge, steps=E["steps"], batch=B, seq=T, lr=C["lr"],
                       ckpt_dir=str(ckpt_root / "cut"),
                       ckpt_every=E["ckpt_at"], log_every=E["steps"],
                       device="cuda", backend="cuda", mesh=mesh,
                       policy="fsdp_tp",
                       injector=FailureInjector({E["fail_at"]}))
    fl = [failed["history"][i]["loss"] for i in range(1, E["steps"] + 1)]
    loss_err = max(abs(g - w) / abs(w) for g, w in zip(fl, wl))
    errs = _leaf_errs(torch, failed["state"], want)
    worst = max(errs.items(), key=lambda kv: kv[1])
    restarts = failed["stats"].restarts
    del failed, want
    torch.cuda.empty_cache()
    log(f"sharded LM (e) failure at step {E['fail_at']} of {E['steps']} "
        f"((2, 2) fsdp_tp, vocab {cfge.vocab_size}, {cfge.num_layers} "
        f"layers): {restarts} restart from step {E['ckpt_at']}; losses "
        f"against the uninterrupted run's: max relative diff "
        f"{loss_err:.3g}; worst final leaf {worst[0]} {worst[1]:.3g} of its "
        f"largest (tolerance {TOL['lm.resume']})")
    if not (restarts == 1 and loss_err <= TOL["lm.resume"]
            and worst[1] <= TOL["lm.resume"]):
        raise AssertionError(f"sharded LM (e): the replay ended "
                             f"{loss_err:.3g} / {worst} from the "
                             "uninterrupted run")
    ckpt = CheckpointManager(ckpt_root / "cut")
    if ckpt.all_steps() != [E["ckpt_at"]]:
        raise AssertionError(f"sharded LM (e): checkpoints "
                             f"{ckpt.all_steps()}")
    manifest, saved = ckpt.load_leaves(E["ckpt_at"])
    elastic = {}
    for what in ("(4, 1) zero3", "one device"):
        t0 = time.perf_counter()
        if what == "one device":
            dst, shardings = S.init_train_state(cfge, gen(5), "cuda"), None
        else:
            dst, layouts = train.build_state(
                gen(5), cfge, _sharded_mesh((4, 1)), "zero3")
            shardings = train.state_shardings(layouts)
        dst, at = ckpt.restore(dst, shardings=shardings)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _host_leaves(torch, dst)
        bad = [s["name"] for s, a in zip(manifest["leaves"], saved)
               if not _same_host_bits(torch, got[s["name"]], a, s["dtype"])]
        log(f"sharded LM (e) elastic restore of the (2, 2) fsdp_tp step-"
            f"{at} checkpoint into {what}: {len(saved)} leaves in "
            f"{secs:.2f}s, {len(saved) - len(bad)} bitwise the checkpoint's")
        if bad or at != E["ckpt_at"]:
            raise AssertionError(f"sharded LM (e): {what} differs in {bad}")
        elastic[what] = {"restore_seconds": secs, "leaves": len(saved)}
        del dst, got
        torch.cuda.empty_cache()
    del saved
    note_written("23 (sharded LM checkpoint)", tree_bytes(ckpt_root))
    shutil.rmtree(ckpt_root, ignore_errors=True)
    rec["elastic"] = {"loss_rel_diff": loss_err, "worst_leaf": worst,
                      "restores": elastic, "vocab": cfge.vocab_size}
    seconds["elastic"] = time.perf_counter() - te
    rec["seconds"] = seconds
    log("sharded LM: seconds by part " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return rec, counts_all


def _per_step(traffic, steps: int) -> dict:
    return {k: v / steps for k, v in traffic.as_dict().items() if v}


def _same_host_bits(torch, got, saved, dtype: str) -> bool:
    """A restored leaf (host tensor) bitwise its checkpoint array."""
    from repro_torch.checkpoint.manager import from_host

    want = from_host(saved, dtype)
    return got.shape == want.shape and got.dtype == want.dtype and bool(
        torch.equal(got.view(torch.uint8) if got.dim() else got,
                    want.view(torch.uint8) if want.dim() else want))


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 24
# ---------------------------------------------------------------------------

def _mla_flash(torch, K, cfg, qm_cfg) -> tuple[dict, dict]:
    """(a): the flash kernel at the prefill shapes phase 24 sends it —
    MLA's (D, Dv) = (192, 128) and Qwen3-MoE's GQA at D = 128, G = 8 —
    against its plain version, with and without the lse, two calls
    bitwise equal; then the (192, 128) route's time beside the bound, the
    plain version and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    fa = K.flash_attention.flash_attention
    ref = K.ref
    gen = torch.Generator(device="cuda").manual_seed(2424)
    B, H = LM_SERVE["batch"], cfg.num_heads
    D = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    Dv = cfg.v_head_dim
    P = LM_SERVE["prompt_len"]
    Sk = P + LM_SERVE["gen"]
    dev = torch.device("cuda")

    def inputs(h, kv, d, dv, sk, Sq):
        return (torch.randn((B, Sq, h, d), generator=gen, device=dev),
                torch.randn((B, sk, kv, d), generator=gen, device=dev),
                torch.randn((B, sk, kv, dv), generator=gen, device=dev))

    mla = (H, H, D, Dv, Sk)
    qm = (qm_cfg.num_heads, qm_cfg.num_kv_heads, qm_cfg.head_dim,
          qm_cfg.head_dim, P + MOE_SERVE["qm_gen"])
    worst = {"mla": {}, "gqa": {}}
    cases = [  # (route, (H, Kv, D, Dv, Sk), Sq, kv_len, q_offset)
        ("mla", mla, P, P, 0),            # the prefill into the serving cache
        ("mla", mla, P - 1, P - 1, 0),    # a ragged prompt
        ("mla", mla, P // 2, P, P // 2),  # a chunk behind 1024 cached keys
        ("gqa", qm, P, P, 0)]             # Qwen3-MoE's prefill
    for route, shape, Sq, kv_len, q_offset in cases:
        h, kv, d, dv, sk = shape
        q, k, v = inputs(*shape, Sq)
        for with_lse in (False, True):
            kw = dict(causal=True, kv_len=kv_len, q_offset=q_offset,
                      return_lse=with_lse)
            got, again = fa(q, k, v, **kw), fa(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, True, kv_len=kv_len,
                                           q_offset=q_offset,
                                           return_lse=with_lse)
            what = (f"(D, Dv) = ({d}, {dv}) B={B} H={h} Kv={kv} "
                    f"G={h // kv} Sq={Sq} Sk={sk} kv_len={kv_len} "
                    f"q_offset={q_offset}")
            held = functools.partial(_held, worst[route], "flash_attention")
            if with_lse:
                held(got[0], want[0], what + " with lse")
                held(got[1], want[1], what + ": the lse")
                same = all(torch.equal(a, b) for a, b in zip(got, again))
            else:
                held(got, want, what)
                same = torch.equal(got, again)
            if not same:
                raise AssertionError(f"flash_attention {what}: two calls "
                                     "gave different bits")
            del got, again, want
        del q, k, v
    torch.cuda.synchronize()

    q, k, v = inputs(*mla, P)
    call = lambda: fa(q, k, v, causal=True, kv_len=P)  # noqa: E731
    qt = q.transpose(1, 2)
    kt, vt = (t[:, :P].transpose(1, 2) for t in (k, v))
    sdpa = lambda: F.scaled_dot_product_attention(    # noqa: E731
        qt, kt, vt, is_causal=True)
    try:
        sdpa()
    except (RuntimeError, TypeError) as exc:   # Dv != D not taken
        log(f"scaled_dot_product_attention at (D, Dv) = ({D}, {Dv}): {exc}")
        sdpa = None
    # the kernel and its yardstick in turns
    t = alternate_ms(torch, {"kernel": call, "library": sdpa}, iters=30)
    ms, lib = t["kernel"], t["library"]
    plain = device_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, True, kv_len=P), iters=10)
    dev_ms = profiled_ms(torch, call, "flash_fwd")
    floor = floor_ms(torch, K.build)
    pairs = P * (P + 1) // 2        # causal (i, j ≤ i), all below kv_len
    nbytes = 4 * B * P * H * (2 * D + 2 * Dv)
    flops = 2 * pairs * B * H * (D + Dv)   # Q Kᵀ and P V, 3xTF32 in both
    t_b, by = tc_bound(nbytes, [(3, flops)])
    f32 = bound(nbytes, flops)
    log(f"flash_attention [(D, Dv) = ({D}, {Dv}) prefill B={B} H=Kv={H} "
        f"S={P} causal, cache {Sk}]: {ms:.4f} ms/call (plain {plain:.4f} ms"
        + (f", scaled_dot_product_attention {lib:.4f} ms: the kernel "
           f"{ms / lib:.3f}x of it, medians of {ROUNDS} rounds in turns"
           if lib else "")
        + f"; device {dev_ms} ms by the profiler), bound on the kernel's "
        f"units {t_b:.4f} ms by {by} ({t_b / ms:.1%} of it), f32 bound "
        f"{f32[0]:.4f} ms ({f32[0] / ms:.1%}), launch floor {floor:.4f} ms")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    (e, r), (ge, gr) = (worst[k]["flash_attention"] for k in ("mla", "gqa"))
    return ({"max_abs_err": e, "max_rel_err": r, "tol": TOL["flash_attention"],
             "gqa": {"max_abs_err": ge, "max_rel_err": gr,
                     "variant": f"B={B} H={qm[0]} Kv={qm[1]} D={qm[2]} "
                                f"Sq={P} Sk={qm[4]} causal"}},
            {"name": "flash_attention_mla",
             "variant": f"prefill B={B} H=Kv={H} S={P} (D, Dv) = ({D}, {Dv}) "
                        f"causal, cache {Sk}",
             "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": t_b,
             "bound_by": by, "floor_ms": floor, "device_ms": dev_ms,
             "f32_bound_ms": f32[0], "f32_bound_by": f32[1],
             "launches_note": "1 per layer per prefill"})


@contextlib.contextmanager
def _moe_calls(on_call):
    """Every ``models.moe.moe_ffn`` call of the block runs as it does,
    then ``on_call(params, cfg, x, y)`` sees its input and output."""
    from repro_torch.models import moe

    orig = moe.moe_ffn

    def spy(params, cfg, x):
        y = orig(params, cfg, x)
        on_call(params, cfg, x, y)
        return y

    moe.moe_ffn = spy
    try:
        yield
    finally:
        moe.moe_ffn = orig


def _routes(torch, params, cfg, x) -> dict:
    """A MoE call's routes from its input: router logits, picks, kept."""
    from repro_torch.models import moe

    xt = x.reshape(-1, x.shape[-1])
    logits, _, ids = moe.route(params, cfg, xt)
    _, keep, _ = moe.dispatch_indices(ids, cfg.num_experts,
                                      moe.capacity(cfg, xt.shape[0]))
    return {"logits": logits, "ids": ids, "keep": keep}


def _drop_stats(torch, batch: int):
    """(on_call, stats): the share of picks the capacity dropped at prefill
    (T > batch) and at decode, and the largest |routed output| of the first
    MoE call of each (the output less the shared experts')."""
    from repro_torch.models.layers import mlp

    stats = {k: {"picks": 0, "dropped": 0, "routed_max": None}
             for k in ("prefill", "decode")}

    def on_call(params, cfg, x, y):
        r = _routes(torch, params, cfg, x)
        kind = "prefill" if r["ids"].shape[0] > batch else "decode"
        s = stats[kind]
        s["picks"] += r["keep"].numel()
        s["dropped"] += int((~r["keep"]).sum())
        if s["routed_max"] is None:
            xt = x.reshape(-1, x.shape[-1])
            shared = (mlp(params.shared, xt, cfg.activation)
                      if hasattr(params, "shared") else 0)
            s["routed_max"] = float(
                (y.reshape(xt.shape[0], -1) - shared).abs().max())
    return on_call, stats


def _serve_moe(torch, K, serve, cfg, name: str, gen: int, profile: bool
               ) -> dict:
    """(b), (d): ``launch/serve.run`` of ``cfg`` with random weights drawn
    on the card: a warm-up request (which records the capacity's drops and
    the routed output), then the measured one: exactly L flash launches a
    prefill, none in decode, no other kernel; finite logits; the peak."""
    from repro_torch.models import init_model

    B, P = LM_SERVE["batch"], LM_SERVE["prompt_len"]
    L = cfg.num_layers
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{name}: {L} layers, {n_params:,} f32 parameters drawn on the card "
        f"in {init_s:.2f}s")
    on_call, drops = _drop_stats(torch, B)
    with _moe_calls(on_call):
        warm = serve.run(cfg, batch=B, prompt_len=P, gen=4, seed=1,
                         device="cuda", backend="cuda", params=params)
    log(f"{name} warm-up request: prefill {warm['prefill_seconds']:.3f}s")
    del warm
    for kind, s in drops.items():
        s["share"] = s["dropped"] / max(s["picks"], 1)
        log(f"{name} {kind}: the capacity dropped {s['dropped']:,} of "
            f"{s['picks']:,} picks ({s['share']:.2%}); the first MoE "
            f"layer's routed output max |y| {s['routed_max']:.4g}")
        if not s["routed_max"] > 0:
            raise AssertionError(f"{name} {kind}: the routed experts' "
                                 "output is all zero")
    K.reset_launch_counts()
    res = serve.run(cfg, batch=B, prompt_len=P, gen=gen, seed=0,
                    device="cuda", backend="cuda", params=params)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak = res["peak_device_bytes"]
    log(f"{name} serve: batch {B}, prompt {P}, {gen} tokens: prefill "
        f"{res['prefill_seconds']:.4f}s, decode "
        f"{res['decode_tokens_per_s']:.2f} tokens/s "
        f"({res['decode_seconds']:.4f}s for {gen - 1} steps), peak device "
        f"bytes {peak:,} ({'under' if peak < MOE_PEAK else 'OVER'} "
        f"{MOE_PEAK / 1e9:.0f} GB), logits finite {res['finite']}")
    log(f"{name} serve: sample generation {res['generated'][0].tolist()}")
    log(f"{name} serve: launch counts {counts} (want flash_attention {L}: "
        "L per prefill, none in decode, no other kernel)")
    if not res["finite"]:
        raise AssertionError(f"{name} serve: non-finite prefill logits")
    if res["generated"].shape != (B, gen):
        raise AssertionError(f"{name} serve: generated "
                             f"{res['generated'].shape}")
    want = {k: (L if k == "flash_attention" else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{name} serve: launch counts {counts}, want "
                             f"{want}")
    if not peak < 80e9:
        raise AssertionError(f"{name} serve: peak {peak:,} bytes")
    out = {k: res[k] for k in ("prefill_seconds", "decode_seconds",
                               "decode_tokens_per_s", "peak_device_bytes",
                               "finite")}
    out.update(init_seconds=init_s, layers=L, params=n_params,
               launch_counts=counts, drops=drops,
               generated=res["generated"].tolist())
    if profile:
        out["profile"] = phase_lm_profile(torch, serve, cfg, params)
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _route_mask(torch, got: list, want: list, what: str, rec: dict):
    """Tokens whose picks and kept picks agree in every MoE call of both
    runs (``got``, ``want``: one ``_routes`` a call, in order).  Where the
    picks or their order differ, two of the token's K + 1 best router
    logits must lie within ``ROUTE_MARGIN`` (a last-bit flip); a kept pick that differs where the picks agree is
    the capacity's answer to such a flip earlier in the arrival order."""
    mask = None
    for i, (g, w) in enumerate(zip(got, want)):
        ids_same = (g["ids"] == w["ids"]).all(-1)
        same = ids_same & (g["keep"] == w["keep"]).all(-1)
        if not ids_same.all():
            # the closest two of the K + 1 best logits: a flip of order
            # inside the picks, or of the last pick and the next
            k = w["ids"].shape[1]
            top = w["logits"].sort(-1, descending=True).values[:, :k + 1]
            margin = (top[:, :-1] - top[:, 1:]).min(-1).values[~ids_same]
            layer = w.get("layer", i)
            for t, m in zip((~ids_same).nonzero()[:, 0].tolist(),
                            margin.tolist()):
                log(f"  {what}: layer {layer} token {t}: the picks differ, "
                    f"router margin {m:.3g}")
                rec.setdefault("route_flips", []).append(
                    {"what": what, "layer": layer, "token": t, "margin": m})
                if m > ROUTE_MARGIN:
                    raise AssertionError(
                        f"{what}: layer {layer} token {t} routes otherwise "
                        f"with a router margin of {m:.3g} > {ROUTE_MARGIN}")
        elif not same.all():
            raise AssertionError(f"{what}: MoE call {i}: kept picks differ "
                                 "where no pick does")
        mask = same if mask is None else mask & same
    return mask


def _moe_parity(torch, cfg) -> dict:
    """(c): 2 layers (the dense one, one MoE layer), batch 2, prompt 2048,
    4 fed decode steps, the residual stream in f32: "cuda" against "torch"
    on the card (the logits within ``TOL["moe.logits"]`` on the tokens
    whose routes agree: the MoE layer is the last, so a token's logits
    depend on its own route only), and the absorbed decode against the
    decompressing one (``TOL["mla.absorb"]``)."""
    from repro_torch.models import decode_step, init_cache, init_model

    C = MOE_PARITY
    cfg2 = dataclasses.replace(cfg, num_layers=C["layers"], dtype="float32")
    cfg_abs = dataclasses.replace(cfg2, mla_absorb=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = init_model(cfg2, gen, "cuda")
    layer_of = {id(layer.ffn): i for i, layer in enumerate(params.layers)}
    B, P, G = C["batch"], C["prompt_len"], C["gen"]
    prompts = torch.randint(0, cfg2.vocab_size, (B, P), generator=gen,
                            device="cuda")
    runs = ("cuda", "torch", "absorbed")
    caches = {r: init_cache(cfg2, B, P + G, dtype=torch.float32,
                            device="cuda") for r in ("cuda", "torch")}
    calls: dict = {r: [] for r in runs}
    rec: dict = {"prefill": None, "decode": [], "absorbed": []}
    worst = {"moe.logits": 0.0, "mla.absorb": 0.0}

    def step(r, toks, index):
        c = cfg_abs if r == "absorbed" else cfg2
        bk = "cuda" if r == "absorbed" else r
        calls[r].clear()
        with _moe_calls(lambda p, cf, x, y: calls[r].append(
                {**_routes(torch, p, cf, x), "layer": layer_of[id(p)]})):
            return decode_step(params, c, {"tokens": toks}, caches[r],
                               index, backend=bk)[0]

    def compare(key, a, b, what):
        mask = _route_mask(torch, calls[a], calls[b], what, rec)
        la, lb = logits[a].reshape(mask.shape[0], -1), logits[b].reshape(
            mask.shape[0], -1)
        e, r = rel_err(la[mask], lb[mask])
        worst[key] = max(worst[key], r)
        log(f"MoE parity {what}: max abs diff {e:.4g}, relative {r:.4g} "
            f"over {int(mask.sum())} of {mask.numel()} tokens "
            f"(tolerance {TOL[key]})")
        return {"max_abs_diff": e, "max_rel_diff": r,
                "tokens": int(mask.sum()), "of": mask.numel()}

    logits = {r: step(r, prompts, 0) for r in ("cuda", "torch")}
    rec["prefill"] = compare("moe.logits", "cuda", "torch",
                             f"prefill (2 layers, batch {B}, prompt {P})")
    caches["absorbed"] = [{"attn": {k: v.clone() for k, v in
                                    c["attn"].items()}}
                          for c in caches["cuda"]]
    for i in range(G):
        fed = logits["cuda"][:, -1].float().argmax(-1).to(torch.int32)[
            :, None]
        logits = {r: step(r, fed, P + i) for r in runs}
        rec["decode"].append(compare("moe.logits", "cuda", "torch",
                                     f"decode step {i}"))
        rec["absorbed"].append(compare("mla.absorb", "absorbed", "cuda",
                                       f"absorbed decode step {i}"))
    torch.cuda.synchronize()
    for key, w in worst.items():
        if not w <= TOL[key]:
            raise AssertionError(f"MoE parity: {key} differs by {w:.4g} of "
                                 f"the largest (tolerance {TOL[key]})")
    rec["worst"] = worst
    del params, caches, logits
    torch.cuda.empty_cache()
    return rec


def _mla_kernel_row(report: dict, row: dict, moe_counts: dict) -> dict:
    """The kernels line's entry of the flash kernel's MLA route."""
    return {"name": "flash_attention_mla", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": REPLACES["flash_attention"],
            "launches": moe_counts["flash_attention_mla"],
            "max_abs_err": report["moe_serving"]["kernel"]["max_abs_err"],
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "floor_ms", "device_ms")}}


def phase_moe_serving(torch, K, serve, ds_cfg, qm_cfg
                      ) -> tuple[dict, dict, dict]:
    """Phase 24: MoE and MLA serving at full width — (a) the flash kernel
    at (192, 128), (b) DeepSeek-V2-Lite through ``launch/serve.run``,
    (c) its "cuda" and "torch" parity at 2 layers, (d) Qwen3-MoE at 8
    layers.  Returns (record, the kernel's times row, launch counts of
    the two serving runs: DeepSeek-V2-Lite's flash launches are the MLA
    route's)."""
    rec: dict = {"card": nvidia_smi_line()}
    seconds: dict = {}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"MoE serving: {torch.cuda.memory_allocated():,} device bytes held "
        "by earlier phases at the start")
    t0 = time.perf_counter()
    rec["kernel"], row = _mla_flash(torch, K, ds_cfg, qm_cfg)
    seconds["kernel"] = time.perf_counter() - t0
    if ds_cfg.num_layers != 27:
        log(f"CUT: {ds_cfg.num_layers} layers instead of DeepSeek-V2-Lite's "
            "27")
    t0 = time.perf_counter()
    rec["deepseek"] = _serve_moe(torch, K, serve, ds_cfg,
                                 "deepseek_v2_lite_16b", LM_SERVE["gen"],
                                 profile=True)
    seconds["deepseek"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["parity"] = _moe_parity(torch, ds_cfg)
    seconds["parity"] = time.perf_counter() - t0
    log(f"CUT: {qm_cfg.num_layers} layers instead of Qwen3-MoE's 48 "
        "(MOE_SERVE: the phase's time)")
    t0 = time.perf_counter()
    rec["qwen3_moe"] = _serve_moe(torch, K, serve, qm_cfg,
                                  "qwen3_moe_30b_a3b", MOE_SERVE["qm_gen"],
                                  profile=False)
    seconds["qwen3_moe"] = time.perf_counter() - t0
    rec["seconds"] = seconds
    log("phase 24 seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    counts = {"flash_attention_mla": rec["deepseek"]["launch_counts"][
        "flash_attention"],
        "flash_attention": rec["qwen3_moe"]["launch_counts"][
            "flash_attention"]}
    return rec, row, counts


# ---------------------------------------------------------------------------
# phase 25
# ---------------------------------------------------------------------------

def _mla_bwd_checks(torch, K, cfg) -> tuple[dict, list[dict]]:
    """(a): the flash backward at MLA's (D, Dv) = (192, 128) against its
    plain version at the training shape and three variants, two calls
    bitwise, and the forward with the lse that feeds it against its plain
    version; the backward's time beside the bound, the plain version and
    the backward of ``scaled_dot_product_attention`` in f32, and the
    forward's (with the lse) beside ``_scaled_dot_product_efficient_
    attention`` with ``compute_log_sumexp``, each in turns with its
    yardstick."""
    import torch.nn.functional as F

    ref, fa = K.ref, K.flash_attention.flash_attention
    fb = K.flash_attention_bwd.flash_attention_bwd
    gen = torch.Generator(device="cuda").manual_seed(2525)
    B, S, H = MOE_TRAIN["batch"], MOE_TRAIN["seq"], cfg.num_heads
    D, Dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim

    def inputs(Sq, Sk):
        return (torch.randn((B, Sq, H, D), generator=gen, device="cuda"),
                torch.randn((B, Sk, H, D), generator=gen, device="cuda"),
                torch.randn((B, Sk, H, Dv), generator=gen, device="cuda"),
                torch.randn((B, Sq, H, Dv), generator=gen, device="cuda"))

    cases = [  # (tag, Sq, Sk, causal, kv_len, q_offset)
        ("training shape", S, S, True, S, 0),
        ("S = 2047", S - 1, S - 1, True, S - 1, 0),
        ("Sq = 1024 behind q_offset 1024", S // 2, S, True, S, S // 2),
        ("non-causal, kv_len < Sk", S - 1, S, False, S - 77, 0)]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    worst_abs = fwd_abs = 0.0
    for tag, Sq, Sk, causal, kv_len, q_offset in cases:
        q, k, v, dout = inputs(Sq, Sk)
        kw = dict(causal=causal, kv_len=kv_len, q_offset=q_offset)
        o, lse = fa(q, k, v, return_lse=True, **kw)
        for name, g, w in zip(("o", "lse"), (o, lse), ref.flash_attention_ref(
                q, k, v, causal, kv_len=kv_len, q_offset=q_offset,
                return_lse=True)):
            e, r = rel_err(g, w)
            fwd_abs = max(fwd_abs, e)
            if not r <= TOL["flash_attention"]:
                raise AssertionError(f"flash forward (192, 128) with the lse "
                                     f"[{tag}]: {name} {r:.3g} of its largest")
        got, again = fb(q, k, v, o, lse, dout, **kw), \
            fb(q, k, v, o, lse, dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, causal,
                                           kv_len=kv_len, q_offset=q_offset)
        torch.cuda.synchronize()
        msg = []
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            if g.shape != w.shape:
                raise AssertionError(f"flash backward (192, 128) [{tag}]: "
                                     f"{name} {tuple(g.shape)}")
            e, r = rel_err(g, w)
            worst[name] = max(worst[name], r)
            worst_abs = max(worst_abs, e)
            msg.append(f"{name} {e:.3g} ({r:.3g} of its largest)")
            if not r <= TOL["flash_attention_bwd"]:
                raise AssertionError(
                    f"flash backward (192, 128) [{tag}]: {name} {r:.3g} of "
                    f"its largest > {TOL['flash_attention_bwd']}")
            if not torch.equal(g, a):
                raise AssertionError(f"flash backward (192, 128) [{tag}]: "
                                     f"two calls gave different {name} bits")
        log(f"  flash_attention_bwd [(D, Dv) = ({D}, {Dv}) {tag}: B={B} "
            f"Sq={Sq} Sk={Sk} H=Kv={H} causal={causal} kv_len={kv_len} "
            f"q_offset={q_offset}]: " + ", ".join(msg)
            + "; two calls bitwise equal")
        del q, k, v, dout, o, lse, got, again, want
    torch.cuda.empty_cache()

    q, k, v, dout = inputs(S, S)
    o, lse = fa(q, k, v, return_lse=True)
    kernel = lambda: fb(q, k, v, o, lse, dout)            # noqa: E731
    sdpa_bwd = _sdpa_bwd_call(torch, F, q, k, v, dout)
    t = alternate_ms(torch, {"kernel": kernel, "library": sdpa_bwd})
    ms, lib = t["kernel"], t["library"]
    plain = device_ms(torch, lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, dout), iters=5)
    floor = floor_ms(torch, K.build)
    pairs = S * (S + 1) // 2
    # q, k, v, o, dO and lse in; dq, dk, dv out
    nbytes = 4 * (B * S * H * (4 * D + 4 * Dv) + B * H * S)
    flops = 2 * pairs * B * H * (D + Dv + Dv + D + D)   # S, dP, dV, dK, dQ
    bplan = K.flash_attention_bwd.plan(B, S, S, H, H, D, Dv)
    t_tc, by_tc = tc_bound(nbytes, [(bplan.passes[0], flops)])
    f32 = bound(nbytes, flops)
    row = {"name": "flash_attention_bwd_mla",
           "variant": f"training B={B} H=Kv={H} S={S} (D, Dv) = ({D}, {Dv}) "
                      "causal", "ms": ms, "plain_ms": plain,
           "library_ms": lib, "bound_ms": t_tc, "bound_by": by_tc,
           "floor_ms": floor, "f32_bound_ms": f32[0],
           "f32_bound_by": f32[1], "device_ms": None,
           "plan": dataclasses.asdict(bplan)}
    log(f"flash_attention_bwd [{row['variant']}]: {ms:.4f} ms/call (plain "
        f"{plain:.4f} ms"
        + (f", scaled_dot_product_attention backward {lib:.4f} ms: the "
           f"kernel {ms / lib:.3f}x of it, in turns" if lib is not None
           else "")
        + f"), bound on the tensor cores {t_tc:.4f} ms by {by_tc} "
        f"({t_tc / ms:.1%} of it), f32 bound {f32[0]:.4f} ms "
        f"({f32[0] / ms:.1%}); launch floor {floor:.4f} ms; ring tiles "
        f"{bplan.kv_tile[1]} rows, {bplan.smem[0]:,} shared bytes a block")
    del sdpa_bwd
    torch.cuda.empty_cache()

    # the forward with the lse that training calls (row 6d), beside the
    # one PyTorch call that returns the output and the lse
    fwd = lambda: fa(q, k, v, return_lse=True)           # noqa: E731
    eff = _efficient_lse_call(torch, q, k, v)
    t = alternate_ms(torch, {"kernel": fwd, "library": eff})
    f_plain = device_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, True, return_lse=True), iters=5)
    f_bytes = 4 * (B * S * H * (2 * D + 2 * Dv) + B * H * S)
    f_flops = 2 * pairs * B * H * (D + Dv)   # Q Kᵀ and P V, 3xTF32 in both
    f_tb, f_by = tc_bound(f_bytes, [(3, f_flops)])
    f_f32 = bound(f_bytes, f_flops)
    fwd_row = {"name": "flash_attention_mla_lse",
               "variant": f"training forward with the lse B={B} H=Kv={H} "
                          f"S={S} (D, Dv) = ({D}, {Dv}) causal, f32",
               "ms": t["kernel"], "plain_ms": f_plain,
               "library_ms": t["library"], "bound_ms": f_tb,
               "bound_by": f_by, "floor_ms": floor,
               "f32_bound_ms": f_f32[0], "f32_bound_by": f_f32[1],
               "device_ms": None}
    log(f"flash_attention [{fwd_row['variant']}]: {t['kernel']:.4f} ms/call "
        f"(plain {f_plain:.4f} ms"
        + (f", _scaled_dot_product_efficient_attention with the lse "
           f"{t['library']:.4f} ms: the kernel "
           f"{t['kernel'] / t['library']:.3f}x of it, in turns"
           if t["library"] else "")
        + f"), bound on the tensor cores {f_tb:.4f} ms by {f_by} "
        f"({f_tb / t['kernel']:.1%} of it), f32 bound {f_f32[0]:.4f} ms")
    del q, k, v, dout, o, lse, eff
    torch.cuda.empty_cache()
    return ({"worst_rel": worst, "max_abs_err": worst_abs,
             "fwd_max_abs_err": fwd_abs,
             "tol": TOL["flash_attention_bwd"]}, [row, fwd_row])


def _sdpa_bwd_call(torch, F, q, k, v, dout, causal: bool = True):
    """One backward of ``scaled_dot_product_attention`` (causal unless
    asked, the layouts transposed to (B, H, S, D)) as a call, or None
    where it does not take these inputs."""
    try:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        gt = dout.transpose(1, 2)

        def call():
            return torch.autograd.grad(out, (qt, kt, vt), gt,
                                       retain_graph=True)
        call()
        return call
    except (TypeError, RuntimeError) as exc:
        log(f"scaled_dot_product_attention backward at {tuple(q.shape)} "
            f"{q.dtype}, v {tuple(v.shape)}: {exc}")
        return None


def _sdpa_fwd_call(torch, F, q, k, v, causal: bool = True):
    """``scaled_dot_product_attention`` (causal unless asked) as a call, or
    None."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    try:
        call()
        return call
    except (TypeError, RuntimeError) as exc:
        log(f"scaled_dot_product_attention at {tuple(q.shape)} {q.dtype}, "
            f"v {tuple(v.shape)}: {exc}")
        return None


def _efficient_lse_call(torch, q, k, v, causal: bool = True):
    """``_scaled_dot_product_efficient_attention`` with
    ``compute_log_sumexp`` (causal unless asked): the one PyTorch call that
    returns the output and the lse, as a call, or None, with the reason
    logged, where it refuses these inputs."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, None, compute_log_sumexp=True, is_causal=causal)
    try:
        call()
        return call
    except (TypeError, RuntimeError, NotImplementedError) as exc:
        log(f"_scaled_dot_product_efficient_attention at {tuple(q.shape)} "
            f"{q.dtype}, v {tuple(v.shape)}: {exc}")
        return None


def _bf16_checks(torch, K) -> tuple[dict, list[dict]]:
    """(a): bf16 q, k, v (and o, dO) into both flash kernels at every
    width in ``WIDTHS``, at the paths' shapes where a path takes the width:
    the f32 kernels' bits on the inputs widened to f32 (the forward's
    output then rounded to bf16), or, where not, within 2e-5; and against
    the plain versions on the same inputs, within 2e-5 of each output's
    largest (o, which both round to bf16, within that plus half a bf16
    ulp of the plain f32 value: the rounding itself).  ``max_abs_err`` is
    the distance to the plain versions.  The MLA shape's times."""
    import torch.nn.functional as F

    fa = K.flash_attention.flash_attention
    fb = K.flash_attention_bwd.flash_attention_bwd
    ref = K.ref
    gen = torch.Generator(device="cuda").manual_seed(2526)
    B, S = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    rec: dict = {"cases": [], "bitwise": True, "max_abs_err": 0.0,
                 "max_abs_err_fwd": 0.0, "max_abs_err_bwd": 0.0}
    for tag, h, hk, d, dv in BF16_SHAPES:
        if (d, dv) not in K.flash_attention.WIDTHS:
            raise AssertionError(f"bf16 check at ({d}, {dv}): not a width")
        q = torch.randn((B, S, h, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, S, hk, d), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((B, S, hk, dv), generator=gen,
                        device="cuda").bfloat16()
        dout = torch.randn((B, S, h, dv), generator=gen,
                           device="cuda").bfloat16()
        o_plain = fa(q, k, v)
        o, lse = fa(q, k, v, return_lse=True)
        o32, lse32 = fa(q.float(), k.float(), v.float(), return_lse=True)
        got = fb(q, k, v, o, lse, dout)
        want = fb(q.float(), k.float(), v.float(), o.float(), lse,
                  dout.float())
        # the plain versions on the same inputs: bf16 is exact in f32, so
        # the widened copies are the same values; o before its rounding
        p_o, p_lse = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                             True, return_lse=True)
        p_grads = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout)
        torch.cuda.synchronize()
        pairs = [("o", o_plain, o32.bfloat16()), ("o with lse", o, o32),
                 ("lse", lse, lse32), *zip(("dq", "dk", "dv"), got, want)]
        case = {"case": tag, "shape": [B, S, h, hk, d, dv], "bitwise": {},
                "plain_rel": {}}
        for name, g, w in pairs:
            same = bool(torch.equal(g, w.to(g.dtype)))
            case["bitwise"][name] = same
            if not same:
                e, r = rel_err(g, w)
                rec["bitwise"] = False
                log(f"  bf16 flash [{tag}] {name}: not the f32 kernel's bits "
                    f"on the widened inputs: {e:.3g} ({r:.3g} of its "
                    "largest)")
                if not r <= TOL["flash_attention_bwd"]:
                    raise AssertionError(f"bf16 flash [{tag}] {name}: {r:.3g}")
        # half a bf16 ulp of each plain value: 2^(e - 9) for x = m·2^e,
        # m in [0.5, 1), with bf16's 8 significant bits
        half_ulp = torch.ldexp(torch.ones_like(p_o),
                               torch.frexp(p_o)[1] - 9)
        for name, g in (("o", o_plain), ("o with lse", o)):
            over = ((g.float() - p_o).abs() - half_ulp).clamp_min(0)
            e = over.max().item()
            r = e / p_o.abs().max().item()
            case["plain_rel"][name] = r
            rec["max_abs_err_fwd"] = max(rec["max_abs_err_fwd"], e)
            if not r <= TOL["flash_attention"]:
                raise AssertionError(
                    f"bf16 flash [{tag}] {name}: {r:.3g} of its largest past "
                    f"its bf16 rounding from the plain version")
        for name, g, w in (("lse", lse, p_lse),
                           *zip(("dq", "dk", "dv"), got, p_grads)):
            e, r = rel_err(g, w)
            case["plain_rel"][name] = r
            side = "max_abs_err_fwd" if name == "lse" else "max_abs_err_bwd"
            rec[side] = max(rec[side], e)
            if not r <= TOL["flash_attention_bwd"]:
                raise AssertionError(f"bf16 flash [{tag}] {name}: {r:.3g} of "
                                     "its largest from the plain version")
        log(f"  bf16 flash [{tag}: B={B} S={S} H={h} Kv={hk} (D, Dv) = ({d}, "
            f"{dv}) causal]: forward without and with the lse, lse and "
            "backward against the f32 kernels on the widened inputs: "
            + ("bitwise equal" if all(case["bitwise"].values())
               else f"{case['bitwise']}") + "; against the plain versions "
            "on the same inputs (of each output's largest; o past its bf16 "
            "rounding): " + ", ".join(f"{n} {r:.3g}"
                                      for n, r in case["plain_rel"].items()))
        rec["cases"].append(case)
        del q, k, v, dout, o_plain, o, lse, o32, lse32, got, want
        del p_o, p_lse, p_grads, half_ulp
    rec["max_abs_err"] = max(rec["max_abs_err_fwd"], rec["max_abs_err_bwd"])
    torch.cuda.empty_cache()

    # times at MLA's training shape, the mixed-precision path's
    h, d, dv = BF16_SHAPES[-1][1], BF16_SHAPES[-1][3], BF16_SHAPES[-1][4]
    q = torch.randn((B, S, h, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, S, h, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, h, dv), generator=gen, device="cuda").bfloat16()
    dout = torch.randn((B, S, h, dv), generator=gen, device="cuda").bfloat16()
    o, lse = fa(q, k, v, return_lse=True)
    floor = floor_ms(torch, K.build)
    pairs_n = S * (S + 1) // 2
    t = alternate_ms(torch, {"kernel": lambda: fa(q, k, v, return_lse=True),
                             "library": _sdpa_fwd_call(torch, F, q, k, v)})
    f_ms, f_lib = t["kernel"], t["library"]
    f_plain = device_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, True, return_lse=True), iters=5)
    f_bytes = 2 * B * S * h * (2 * d + 2 * dv) + 4 * B * h * S
    # bf16 passes per product by its operands (``bf16_bound``): S and dP
    # are bf16 × bf16, P·V, dV, dK and dQ have an f32 side (P or dS)
    x3 = F32_SIDE_BF16_PASSES
    f_tb, f_by = bf16_bound(f_bytes, [(1, 2 * pairs_n * B * h * d),    # S
                                      (x3, 2 * pairs_n * B * h * dv)])  # P·V
    t = alternate_ms(torch, {
        "kernel": lambda: fb(q, k, v, o, lse, dout),
        "library": _sdpa_bwd_call(torch, F, q, k, v, dout)})
    b_ms, b_lib = t["kernel"], t["library"]
    b_plain = device_ms(torch, lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, dout), iters=5)
    b_bytes = (2 * B * S * h * (2 * d + 3 * dv) + 4 * B * h * S
               + 4 * B * S * h * (2 * d + dv))
    unit = 2 * pairs_n * B * h
    b_tb, b_by = bf16_bound(b_bytes, [(1, unit * d), (1, unit * dv),  # S, dP
                                      (x3, unit * dv), (x3, unit * d),  # dV, dK
                                      (x3, unit * d)])                  # dQ
    variant = f"B={B} H=Kv={h} S={S} (D, Dv) = ({d}, {dv}) causal, bf16"
    rows = [
        {"name": "flash_attention_bf16", "variant": "training forward with "
         "lse " + variant, "ms": f_ms, "plain_ms": f_plain,
         "library_ms": f_lib, "bound_ms": f_tb, "bound_by": f_by,
         "floor_ms": floor, "device_ms": None},
        {"name": "flash_attention_bwd_bf16", "variant": "training " + variant,
         "ms": b_ms, "plain_ms": b_plain, "library_ms": b_lib,
         "bound_ms": b_tb, "bound_by": b_by, "floor_ms": floor,
         "device_ms": None}]
    for r in rows:
        log(f"{r['name']} [{r['variant']}]: {r['ms']:.4f} ms/call (plain "
            f"{r['plain_ms']:.4f} ms"
            + (f", scaled_dot_product_attention {r['library_ms']:.4f} ms "
               "in bf16" if r["library_ms"] is not None else "")
            + f"), bound {r['bound_ms']:.4f} ms by {r['bound_by']} (bf16 "
            "at 989 TFLOP/s, 1 pass for bf16 × bf16, 3 for f32 × bf16; bf16 "
            f"bytes; {r['bound_ms'] / r['ms']:.1%} of it)")
    del q, k, v, dout, o, lse
    torch.cuda.empty_cache()
    return rec, rows


@contextlib.contextmanager
def _flash_calls(K, seen: set):
    """The ``"cuda"`` backend's two flash entries record (name, dtype, D,
    Dv) of every call into ``seen``, then run as they are."""
    be = K.dispatch.get_backend("cuda")
    fwd, bwd = be.flash_attention, be.flash_attention_bwd

    def f_spy(q, k, v, **kw):
        seen.add(("flash_attention", str(q.dtype), q.shape[-1], v.shape[-1]))
        return fwd(q, k, v, **kw)

    def b_spy(q, k, v, o, lse, dout, **kw):
        seen.add(("flash_attention_bwd", str(q.dtype), q.shape[-1],
                  v.shape[-1]))
        return bwd(q, k, v, o, lse, dout, **kw)

    be.flash_attention, be.flash_attention_bwd = f_spy, b_spy
    try:
        yield
    finally:
        del be.flash_attention, be.flash_attention_bwd


def _train_moe(torch, K, train, cfg, name: str, steps: int,
               profile: bool) -> dict:
    """(b), (c), (e): ``launch/train.run`` of ``cfg`` on the card (no
    checkpoint is written): steps/s, tokens/s, peak, finite and falling
    loss, exactly L ``flash_attention`` and L ``flash_attention_bwd``
    launches a step and no other kernel, the (dtype, D, Dv) the flash
    kernels were called at; then the capacity's drop share over one
    batch, and (``profile``) one more step under the profiler."""
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import forward
    from repro_torch.optim import adamw

    L, B, T = cfg.num_layers, MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    seen: set = set()
    K.reset_launch_counts()
    with _flash_calls(K, seen):
        res = train.run(cfg, steps=steps, batch=B, seq=T,
                        ckpt_dir=str(ROOT / "build" / "moe_train_ckpt"),
                        ckpt_every=steps + 1, log_every=5, device="cuda",
                        backend="cuda")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    hist = res["history"]
    losses = [hist[i]["loss"] for i in range(1, steps + 1)]
    gnorms = [hist[i]["grad_norm"] for i in range(1, steps + 1)]
    med = statistics.median(hist[i]["seconds"] for i in range(2, steps + 1))
    n_params = sum(p.numel() for p in res["state"].params.parameters())
    peak = res["peak_device_bytes"]
    want = {k: (L * steps if k in ("flash_attention", "flash_attention_bwd")
                else 0) for k in counts}
    log(f"{name} train: {L} layers, {n_params:,} f32 parameters "
        f"(mixed_precision {cfg.mixed_precision}, dtype {cfg.dtype}), batch "
        f"{B} × seq {T}, {steps} steps: {res['seconds']:.2f}s, "
        f"{res['steps_per_s']:.3f} steps/s, {res['tokens_per_s']:.1f} "
        f"tokens/s; median step {med:.4f}s = {B * T / med:.1f} tokens/s; "
        f"peak device bytes {peak:,}")
    log(f"{name} train: loss per step "
        + ", ".join(f"{x:.4f}" for x in losses))
    log(f"{name} train: grad norm per step "
        + ", ".join(f"{x:.4f}" for x in gnorms))
    log(f"{name} train: launch counts {counts} (want {want}); flash calls "
        f"at (name, dtype, D, Dv) {sorted(seen)}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{name} train: a non-finite loss or grad norm")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name} train: loss did not fall "
                             f"({losses[0]:.4f} → {losses[-1]:.4f})")
    if not peak < 80e9:
        raise AssertionError(f"{name} train: peak {peak:,} bytes")
    if counts != want:
        raise AssertionError(f"{name} train: launch counts {counts}, want "
                             f"{want}")
    out = {"layers": L, "params": n_params, "steps": steps, "batch": B,
           "seq": T, "losses": losses, "grad_norms": gnorms,
           "seconds": res["seconds"], "steps_per_s": res["steps_per_s"],
           "tokens_per_s": res["tokens_per_s"], "median_step_s": med,
           "median_tokens_per_s": B * T / med, "peak_device_bytes": peak,
           "launch_counts": counts, "flash_calls": sorted(seen)}
    state = res["state"]
    del res
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=T, global_batch=B))
    on_call, drops = _drop_stats(torch, B)
    with torch.no_grad(), _moe_calls(on_call):
        forward(state.params, cfg, train.device_batch(pipe.global_batch(0),
                                                      "cuda"),
                backend="cuda")
    d = drops["prefill"]
    d["share"] = d["dropped"] / max(d["picks"], 1)
    log(f"{name} train: the capacity dropped {d['dropped']:,} of "
        f"{d['picks']:,} picks ({d['share']:.2%}) over batch 0's {B * T} "
        f"tokens; the first MoE layer's routed output max |y| "
        f"{d['routed_max']:.4g}")
    if not d["routed_max"] > 0:
        raise AssertionError(f"{name} train: the routed output is all zero")
    out["drops"] = d
    if profile:
        step = S.make_train_step(cfg, adamw.AdamWConfig(total_steps=steps),
                                 "cuda")
        box = {}

        def one_step():
            box["s"], box["m"] = step(state, train.device_batch(
                pipe.global_batch(steps), "cuda"))
            float(box["m"]["loss"])

        wall, kernels = _profile_window(torch, one_step)
        out["profile"] = {"measured": bool(kernels), "wall_ms": wall * 1e3}
        if kernels:
            busy = sum(v[1] for v in kernels.values())
            top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:16]
            log(f"{name} train profile [one step]: {wall * 1e3:.1f} ms wall "
                f"under the profiler; device busy {busy / 1e3:.1f} ms = "
                f"{busy / (wall * 1e6):.1%} of wall; "
                f"{sum(v[0] for v in kernels.values())} device operations")
            for kname, (cnt, us) in top:
                log(f"  {us / 1e3:9.3f} ms  {cnt:5d}x  {kname[:90]}")
            out["profile"].update(
                device_busy_ms=busy / 1e3,
                top_kernels=[{"name": k, "calls": c, "ms": us / 1e3}
                             for k, (c, us) in top])
        else:
            log(f"{name} train profile: no device time recorded (not "
                "measured)")
        del box, step
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _route_tap(record: list | None = None, feed=None):
    """Every ``models.moe.route`` call appends its router logits and its
    own picks to ``record``; with ``feed`` (one entry of such a record a
    call, in order, or a function of the call's index giving one) the call
    takes the fed experts instead, its gates from its own logits at them
    (``moe.gates``, as ``route`` forms them)."""
    from repro_torch.models import moe

    real = moe.route
    calls = [0]

    def tap(params, cfg, xt):
        logits, gates, ids = real(params, cfg, xt)
        if record is not None:
            record.append({"logits": logits.detach(), "ids": ids})
        if feed is not None:
            c = calls[0]
            ids = (feed(c) if callable(feed) else feed[c])["ids"]
            gates = moe.gates(cfg, logits, ids)
        calls[0] += 1
        return logits, gates, ids

    moe.route = tap
    try:
        yield
    finally:
        moe.route = real


def _route_flips(torch, got: list, want: list, margin: float, what: str
                 ) -> list:
    """Picks of two runs' MoE calls compared: each token whose picks differ
    reported with the closest two of ``want``'s K + 1 best router logits,
    which must lie within ``margin`` of each other."""
    flips = []
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g["ids"] != w["ids"]).any(-1)
        if not diff.any():
            continue
        k = w["ids"].shape[1]
        top = w["logits"].sort(-1, descending=True).values[:, :k + 1]
        gaps = (top[:, :-1] - top[:, 1:]).min(-1).values[diff]
        for t, m in zip(diff.nonzero()[:, 0].tolist(), gaps.tolist()):
            log(f"  {what}: MoE call {i} token {t}: the picks differ, "
                f"router margin {m:.3g}")
            flips.append({"call": i, "token": t, "margin": m})
            if m > margin:
                raise AssertionError(f"{what}: MoE call {i} token {t} routes "
                                     f"otherwise at a margin of {m:.3g} > "
                                     f"{margin}")
    return flips


def _moe_train_parity(torch, train, cfg, what: str, margin: float,
                      loss_tol: str, repeat: bool = False) -> dict:
    """(d), (e): ``"cuda"`` against ``"torch"`` at 2 layers from one state,
    phase 13's comparison (``_backend_parity``); both runs' picks
    recorded, and where a pick differs the ``"torch"`` run fed the
    ``"cuda"`` run's picks.  ``repeat``: the ``"cuda"`` run once more, and
    the gradient leaves whose bits differ between the two recorded (the
    MoE gather's backward and the embedding's add into rows with
    ``index_put_``'s accumulation)."""
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import loss_fn
    from repro_torch.optim import adamw

    P = LM_TRAIN_PARITY
    cfg2 = dataclasses.replace(cfg, num_layers=MOE_TRAIN["parity_layers"])
    state = S.init_train_state(
        cfg2, torch.Generator(device="cuda").manual_seed(11), "cuda")
    params = adamw.named(state.params)
    batch = train.device_batch(TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg2.vocab_size, seq_len=P["seq"],
        global_batch=P["batch"])).global_batch(0), "cuda")
    loss, grads, picks = {}, {}, {}

    def run(bk, feed=None):
        picks[bk] = []
        with _route_tap(picks[bk], feed):
            lo = loss_fn(state.params, cfg2, batch, backend=bk)
        grads[bk] = dict(zip(params, torch.autograd.grad(
            lo, list(params.values()))))
        loss[bk] = float(lo.detach())

    run("cuda")
    differ = None
    if repeat:
        first = grads.pop("cuda")
        run("cuda")
        differ = [n for n in params if not torch.equal(first[n],
                                                       grads["cuda"][n])]
        log(f"{what}: the cuda gradients twice: "
            + (f"{len(differ)} of {len(params)} leaves differ in their bits: "
               f"{differ}" if differ else "bitwise equal"))
        del first
    run("torch")
    flips = _route_flips(torch, picks["torch"], picks["cuda"], margin, what)
    if flips:
        log(f"{what}: {len(flips)} picks differ; the torch run again, fed "
            "the cuda run's picks")
        run("torch", feed=picks["cuda"])
    del picks
    rec = _backend_parity(torch, state, params, loss, grads, what, loss_tol)
    rec.update(layers=cfg2.num_layers, route_flips=flips,
               dtype=cfg2.dtype, mixed_precision=cfg2.mixed_precision,
               repeat_differing_leaves=differ)
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_moe_train(torch, K, train, ds_cfg, qm_cfg
                    ) -> tuple[dict, list[dict], dict]:
    """Phase 25: MoE and MLA training at full width — (a) the flash
    backward at (192, 128) and bf16 into both flash kernels, (b)
    DeepSeek-V2-Lite and (c) Qwen3-MoE through ``launch/train.run`` at
    ``MOE_TRAIN["layers"]`` layers, (d) ``"cuda"`` against ``"torch"`` at
    2 layers in f32, (e) ``mixed_precision``.  Returns (record, the new
    routes' kernel rows, their launches on the main paths)."""
    rec: dict = {"card": nvidia_smi_line()}
    seconds: dict = {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["mla_bwd"], mla_rows = _mla_bwd_checks(torch, K, ds_cfg)
    rec["bf16"], bf16_rows = _bf16_checks(torch, K)
    f32_ms, bf16_ms = mla_rows[1]["ms"], bf16_rows[0]["ms"]
    log(f"the forward with the lse at MLA's training shape: bf16 "
        f"{bf16_ms:.4f} ms, {bf16_ms / f32_ms:.3f}x f32's {f32_ms:.4f} ms")
    seconds["kernels"] = time.perf_counter() - t0
    for cfg, full in ((ds_cfg, 27), (qm_cfg, 48)):
        log(f"CUT: {cfg.arch_id} trains at {cfg.num_layers} of its {full} "
            "layers (MOE_TRAIN: the f32 parameters, gradients and AdamW "
            "moments of the whole model do not fit the card)")
    t0 = time.perf_counter()
    rec["deepseek"] = _train_moe(torch, K, train, ds_cfg,
                                 "deepseek_v2_lite_16b", MOE_TRAIN["steps"],
                                 profile=True)
    seconds["deepseek"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["qwen3_moe"] = _train_moe(torch, K, train, qm_cfg,
                                  "qwen3_moe_30b_a3b", MOE_TRAIN["steps"],
                                  profile=False)
    seconds["qwen3_moe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["parity"] = _moe_train_parity(
        torch, train, dataclasses.replace(ds_cfg, dtype="float32"),
        "MoE train parity (deepseek_v2_lite_16b, 2 layers, f32)",
        ROUTE_MARGIN, "lm.loss", repeat=True)
    seconds["parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp = dataclasses.replace(ds_cfg, mixed_precision=True, dtype="bfloat16")
    rec["mixed"] = _train_moe(torch, K, train, mp,
                              "deepseek_v2_lite_16b mixed_precision",
                              MOE_TRAIN["mixed_steps"], profile=False)
    want = {("flash_attention", "torch.bfloat16", 192, 128),
            ("flash_attention_bwd", "torch.bfloat16", 192, 128)}
    if set(map(tuple, rec["mixed"]["flash_calls"])) != want:
        raise AssertionError(f"mixed_precision: flash calls "
                             f"{rec['mixed']['flash_calls']}, want {want}")
    rec["mixed_parity"] = _moe_train_parity(
        torch, train, mp,
        "MoE train parity (deepseek_v2_lite_16b, 2 layers, mixed_precision)",
        MIXED_ROUTE_MARGIN, "lm.grads")
    seconds["mixed"] = time.perf_counter() - t0
    rec["seconds"] = seconds
    log("phase 25 seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    ds, mx = rec["deepseek"]["launch_counts"], rec["mixed"]["launch_counts"]
    launches = {"flash_attention_mla": ds["flash_attention"],
                "flash_attention_mla_lse": ds["flash_attention"],
                "flash_attention_bwd_mla": ds["flash_attention_bwd"],
                "flash_attention_bf16": mx["flash_attention"],
                "flash_attention_bwd_bf16": mx["flash_attention_bwd"],
                "flash_attention": rec["qwen3_moe"]["launch_counts"][
                    "flash_attention"],
                "flash_attention_bwd": rec["qwen3_moe"]["launch_counts"][
                    "flash_attention_bwd"]}
    errs = {"flash_attention_bwd_mla": rec["mla_bwd"]["max_abs_err"],
            "flash_attention_mla_lse": rec["mla_bwd"]["fwd_max_abs_err"],
            "flash_attention_bf16": rec["bf16"]["max_abs_err_fwd"],
            "flash_attention_bwd_bf16": rec["bf16"]["max_abs_err_bwd"]}
    rows = [dict(r, max_abs_err=errs[r["name"]])
            for r in [*mla_rows, *bf16_rows]]
    return rec, rows, launches


# ---------------------------------------------------------------------------
# phase 26
# ---------------------------------------------------------------------------

def _moe_worker_shapes(torch, train, cfg, mesh, policy: str, B: int, T: int
                       ) -> tuple:
    """Worker 0's flash shape in a sharded step of ``cfg`` (global batch
    B × T) on ``mesh`` under ``policy``, from the step's own layouts and
    head selection: (batch rows, query heads, KV heads, D, Dv); MLA's k
    is expanded over the worker's heads."""
    import types

    from repro_torch.distributed.sharded_lm import ShardedLM
    from repro_torch.distributed.sharding import Layout, batch_spec

    lm = ShardedLM(cfg, mesh, train.layouts_for(cfg, mesh, policy), policy)
    names = ("wq", "w_uk", "w_uv", "wo") if cfg.use_mla else ("wq", "wk",
                                                              "wv")
    mixer = types.SimpleNamespace(**{w: torch.empty(tuple(
        r.stop - r.start for r in lm.plans[f"layers.0.mixer.{w}"].region[0]),
        device="meta") for w in names})
    mixer = lm._local_attention(mixer, 0, 0)
    rows = Layout((B, T), batch_spec(mesh, B, 1, policy), mesh).index(0)[0]
    H = mixer.wq.shape[1]
    if cfg.use_mla:
        return (len(range(B)[rows]), H, H,
                cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
    return (len(range(B)[rows]), H, mixer.wk.shape[1], cfg.head_dim,
            cfg.head_dim)


def _sharded_moe_kernels(torch, K, shapes: dict, T: int) -> dict:
    """The flash forward (with and without the lse) and backward against
    their plain versions at each per-worker shape within phase 11's 2e-5;
    at a bf16 run's shapes, the bf16 kernels bitwise the f32 kernels on the
    widened inputs (o rounded to bf16 where it is)."""
    ref = K.ref
    fa = K.flash_attention.flash_attention
    fb = K.flash_attention_bwd.flash_attention_bwd
    gen = torch.Generator(device="cuda").manual_seed(2626)
    worsts: dict = {}       # by route: "" (D = 128), "_mla", "_bf16"
    for (bw, h, kv, d, dv, dt), tags in sorted(shapes.items()):
        what = f"B={bw} S={T} H={h} Kv={kv} (D, Dv) = ({d}, {dv}) causal"
        log(f"sharded MoE kernels: {what} {dt} for {', '.join(tags)}")
        worst = worsts.setdefault("_bf16" if dt == "bfloat16" else
                                  "_mla" if (d, dv) == (192, 128) else "", {})
        q = torch.randn((bw, T, h, d), generator=gen, device="cuda")
        k = torch.randn((bw, T, kv, d), generator=gen, device="cuda")
        v = torch.randn((bw, T, kv, dv), generator=gen, device="cuda")
        dout = torch.randn((bw, T, h, dv), generator=gen, device="cuda")
        if dt == "bfloat16":    # the values bf16 holds, widened to f32
            q, k, v, dout = (t.bfloat16().float() for t in (q, k, v, dout))
        o_plain = fa(q, k, v, causal=True)
        o, lse = fa(q, k, v, causal=True, return_lse=True)
        o_ref, lse_ref = ref.flash_attention_ref(q, k, v, True,
                                                 return_lse=True)
        _held(worst, "flash_attention", o_plain, o_ref, what)
        _held(worst, "flash_attention", o, o_ref, what + " with the lse")
        _held(worst, "flash_attention", lse, lse_ref, what + " lse")
        got = fb(q, k, v, o, lse, dout, causal=True)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, True)
        for nm, a, b in zip(("dq", "dk", "dv"), got, want):
            _held(worst, "flash_attention_bwd", a, b, f"{what} {nm}")
        if dt == "bfloat16":
            qb, kb, vb, db = (t.bfloat16() for t in (q, k, v, dout))
            ob_plain = fa(qb, kb, vb, causal=True)
            ob, lseb = fa(qb, kb, vb, causal=True, return_lse=True)
            gotb = fb(qb, kb, vb, ob, lseb, db, causal=True)
            wantb = fb(q, k, v, ob.float(), lseb, dout, causal=True)
            pairs = [("o", ob_plain, o_plain.bfloat16()),
                     ("o with lse", ob, o.bfloat16()), ("lse", lseb, lse),
                     *zip(("dq", "dk", "dv"), gotb, wantb)]
            same = {n: bool(torch.equal(g, w.to(g.dtype)))
                    for n, g, w in pairs}
            log(f"  bf16 {what}: the f32 kernels' bits on the widened "
                f"inputs: {same}")
            if not all(same.values()):
                raise AssertionError(f"sharded MoE kernels: bf16 {what} is "
                                     f"not the f32 kernels' bits: {same}")
            del qb, kb, vb, db, ob_plain, ob, lseb, gotb, wantb
        del q, k, v, dout, o_plain, o, lse, o_ref, lse_ref, got, want
        torch.cuda.empty_cache()
    return {f"{k}{route}": {"max_abs_err": e, "max_rel_err": r,
                            "tol": TOL[k]}
            for route, worst in worsts.items() for k, (e, r) in worst.items()}


def _sharded_moe_parity(torch, train, cfg, runs: list, B: int, T: int
                        ) -> dict:
    """(b): 3 fed steps of ``cfg`` at 2 layers, f32 stream, on each
    (mesh, policy) of ``runs`` against the unsharded ``"cuda"`` step from
    one state, phase 23's comparison; each sharded worker fed the
    unsharded run's picks at its rows, each flip within
    ``SHARDED_ROUTE_MARGIN`` of the next-best router logit."""
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.distributed.sharding import Layout, batch_spec
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw

    C = SHARDED_MOE
    gen = lambda: torch.Generator(device="cuda").manual_seed(26)  # noqa
    cfg2 = dataclasses.replace(cfg, num_layers=C["parity_layers"],
                               dtype="float32")
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg2.vocab_size, seq_len=T, global_batch=B))
    batches = [train.device_batch(pipe.global_batch(i), "cuda")
               for i in range(C["parity_steps"])]
    opt_cfg = adamw.AdamWConfig(**SHARDED_LM_OPT)
    state = S.init_train_state(cfg2, gen(), "cuda")
    step = S.make_train_step(cfg2, opt_cfg, "cuda")
    ref_loss, lrs, masks, prev, picks = [], [], {}, None, []
    for b in batches:
        rec: list = []
        with _route_tap(rec):
            state, m = step(state, b)
        picks.append(rec)
        ref_loss.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        prev = _step_settled(torch, state.opt, prev, masks, opt_cfg.b1)
    want = _host_leaves(torch, state)
    settled = {n: t.cpu() for n, t in masks.items()}
    del state, step, prev, masks
    gc.collect()
    torch.cuda.empty_cache()
    log(f"sharded MoE parity reference ({cfg.arch_id}): the unsharded "
        f"'cuda' step, {cfg2.num_layers} layers, batch {B} x seq {T}, f32, "
        f"losses {[f'{x:.6f}' for x in ref_loss]}")
    out = {}
    for shape, policy in runs:
        mesh = _sharded_mesh(shape)
        M = mesh.size
        rows = [Layout((B, T), batch_spec(mesh, B, 1, policy), mesh
                       ).index(m)[0] for m in range(M)]
        st, layouts = train.build_state(gen(), cfg2, mesh, policy)
        sstep = S.make_sharded_train_step(cfg2, opt_cfg, mesh, layouts,
                                          "cuda", policy=policy)
        tag = f"{cfg.arch_id} {shape} {policy}"
        losses, flips, noise = [], [], []
        for i, b in enumerate(batches):
            def feed(c, rec=picks[i]):   # call c: layer c // M, worker c % M
                r, e = rows[c % M], rec[c // M]
                return {k: e[k][r.start * T:r.stop * T]
                        for k in ("ids", "logits")}

            own: list = []
            with _route_tap(own, feed):
                st, m = sstep(st, b)
            losses.append(float(m["loss"]))
            fed = [feed(c) for c in range(len(own))]
            flips += _route_flips(torch, own, fed, SHARDED_ROUTE_MARGIN,
                                  f"{tag} step {i}")
            noise += [float((g["logits"] - w["logits"]).abs().max())
                      for g, w in zip(own, fed)]
        torch.cuda.synchronize()
        loss_err = max(abs(g - w) / abs(w) for g, w in zip(losses, ref_loss))
        errs = _leaf_errs(torch, st, want)
        mv = max(((n, e) for n, e in errs.items() if n.startswith("opt.")),
                 key=lambda kv: kv[1])
        pw, pleaf, held = _settled_param_err(torch, st, want, settled,
                                             sum(lrs))
        log(f"sharded MoE (b) {tag}: losses {losses}, max relative diff "
            f"{loss_err:.3g} (tolerance {TOL['lm.loss']:.4g}); worst moment "
            f"{mv[0]} {mv[1]:.3g} of its largest (tolerance "
            f"{TOL['lm.grads']:.4g}); parameters where the reference's |g| > "
            f"{LM_SETTLED:g} of its leaf's largest at every step ({held:,}): "
            f"worst {pleaf} {pw:.3g} of the summed lr; {len(flips)} picks "
            f"fed against the worker's own, the router logits at most "
            f"{max(noise):.3g} from the unsharded run's; traffic a step "
            f"{_per_step(sstep.traffic, len(batches))}")
        if not (loss_err <= TOL["lm.loss"] and mv[1] <= TOL["lm.grads"]
                and pw <= TOL["lm.grads"]):
            raise AssertionError(f"sharded MoE (b) {tag}: loss "
                                 f"{loss_err:.3g}, moment {mv}, parameters "
                                 f"{pw:.3g} ({pleaf})")
        out[tag] = {"loss_rel_diff": loss_err, "worst_moment": mv,
                    "worst_settled_param": [pleaf, pw],
                    "settled_entries": held, "route_flips": flips,
                    "router_logits_max_diff": max(noise)}
        del st, sstep
        gc.collect()
        torch.cuda.empty_cache()
    del want, settled, picks
    return out


def _run_batch(mesh, policy: str) -> int:
    """(c)'s global batch: ``MOE_TRAIN``'s, or the least multiple of it
    that the policy's batch shards divide, so that no batch is
    replicated."""
    from repro_torch.distributed.sharding import BATCH_AXES_BY_POLICY

    sizes = dict(zip(mesh.axis_names, mesh.shape))
    shards = math.prod(sizes.get(a, 1) for a in BATCH_AXES_BY_POLICY.get(
        policy, ("pod", "data")))
    return math.lcm(MOE_TRAIN["batch"], shards)


def _reckoned_peak(train, cfg, mesh, policy: str, B: int, T: int,
                   held: int) -> float:
    """``held`` bytes, the state every worker holds (16 bytes a parameter
    element: the parameter, its gradient, m and v), ``ACT_BYTES`` for each
    layer and each worker's batch row of ``T`` tokens, and twice (the
    copies and their gradients) the f32 bytes the workers gather for the
    largest layer and for the head."""
    from repro_torch.distributed.sharded_lm import ShardedLM
    from repro_torch.distributed.sharding import Layout, batch_spec

    layouts = train.layouts_for(cfg, mesh, policy)
    state = mesh.size * 4 * sum(lay.part_bytes(4) for lay in layouts.values())
    blay = Layout((B, T), batch_spec(mesh, B, 1, policy), mesh)
    rows = sum(len(range(B)[blay.index(m)[0]]) for m in range(mesh.size))
    plans = ShardedLM(cfg, mesh, layouts, policy).plans

    def gathered(prefix: str) -> int:
        return sum(4 * math.prod(r.stop - r.start for r in p.region[m])
                   for n, p in plans.items() if n.startswith(prefix)
                   for m in range(mesh.size) if not p.own[m])

    copies = max(gathered(f"layers.{i}.") for i in range(cfg.num_layers))
    head = gathered("lm_head" if "lm_head" in layouts else "embed.")
    return (held + state
            + ACT_BYTES[cfg.arch_id] * cfg.num_layers * rows * T / 2048
            + 2 * (copies + head))


def _sharded_moe_run(torch, K, train, cfg, shape, policy: str, B: int,
                     N: int, reckoned: float) -> dict:
    """(c): N steps of ``cfg`` through ``launch/train.run(mesh=, policy=)``
    at global batch B (no checkpoint is written): steps/s, tokens/s,
    peak (beside the ``reckoned`` one), state bytes a worker against the
    layouts', the collectives' bytes a step and worker; loss finite and
    falling, exactly L·W ``flash_attention`` launches a step and, of
    ``flash_attention_bwd``, L for each worker that reaches the loss: the
    workers whose rows it counts (``Layout.owners``) and, where the batch
    is shared over ``model``, their model groups, whose psums carry the
    gradient — all W unless the batch does not divide the batch axes;
    none of ``tucker_matmul``; the (dtype, D, Dv) the flash kernels took;
    the first step's drop share and the first MoE layer's routed
    output."""
    from repro_torch.distributed.sharded_lm import model_groups
    from repro_torch.distributed.sharding import (BATCH_AXES_BY_POLICY,
                                                  Layout, batch_spec)
    from repro_torch.models import moe

    T = MOE_TRAIN["seq"]
    mesh = _sharded_mesh(shape)
    L, W = cfg.num_layers, mesh.size
    tag = (f"{cfg.arch_id} {shape} {policy}"
           + (" moe_sharded" if cfg.moe_sharded else "")
           + (" mixed_precision" if cfg.mixed_precision else ""))
    calls = (L - cfg.first_k_dense) * W      # route calls of one step
    rec: list = []
    real = moe._routed

    def spy(params, c, xt, gate_vals, index_mat, keep):
        y = real(params, c, xt, gate_vals, index_mat, keep)
        if len(rec) < calls:
            rec.append(((~keep).sum(), keep.numel(), y.detach().abs().max()))
        return y

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    seen: set = set()
    K.reset_launch_counts()
    moe._routed = spy
    try:
        with _flash_calls(K, seen):
            res = train.run(cfg, steps=N, batch=B, seq=T,
                            ckpt_dir=str(ROOT / "build" / "sharded_moe_ckpt"),
                            ckpt_every=N + 1, log_every=5, device="cuda",
                            backend="cuda", mesh=mesh, policy=policy)
        torch.cuda.synchronize()
    finally:
        moe._routed = real
    counts = K.launch_counts()
    hist = res["history"]
    losses = [hist[i]["loss"] for i in range(1, N + 1)]
    med = statistics.median(hist[i]["seconds"] for i in range(2, N + 1))
    peak = res["peak_device_bytes"]
    dropped = sum(int(d) for d, _, _ in rec)
    picks = sum(n for _, n, _ in rec)
    routed_max = max(float(r) for _, _, r in rec[:W])
    own = set(Layout((B, T), batch_spec(mesh, B, 1, policy), mesh).owners())
    tp = "model" not in BATCH_AXES_BY_POLICY.get(policy, ())
    owners = sum(len(g) if tp else len(own & set(g))
                 for g in model_groups(mesh) if own & set(g))
    want = dict({k: 0 for k in counts}, flash_attention=L * W * N,
                flash_attention_bwd=L * owners * N)
    log(f"sharded MoE (c) {tag}: {L} layers, batch {B} x seq {T}, {N} "
        f"steps: {res['steps_per_s']:.4f} steps/s, {res['tokens_per_s']:.1f} "
        f"tokens/s (median step {med:.4f}s = {B * T / med:.1f} tokens/s); "
        f"peak device bytes {peak:,} (reckoned {reckoned:,.0f}); state "
        f"bytes a worker "
        f"{res['state_bytes_per_worker']:,} (from the layouts "
        f"{res['layout_state_bytes']:,}); collective bytes a step and "
        f"worker {res['traffic_per_step']}; the first step dropped "
        f"{dropped:,} of {picks:,} picks ({dropped / max(picks, 1):.2%}); "
        f"the first MoE layer's routed output max |y| {routed_max:.4g}; "
        f"losses " + ", ".join(f"{x:.4f}" for x in losses) + "; "
        f"{held:,} device bytes held at its start; "
        f"{time.perf_counter() - t0:.1f}s with the set-up; "
        + nvidia_smi_line())
    log(f"sharded MoE (c) {tag}: launch counts {counts} (want {want}: "
        f"L·W forward, L·{owners} backward a step: {owners} of {W} workers "
        f"reach the loss); flash calls at (name, dtype, D, Dv) "
        f"{sorted(seen)}")
    if res["state_bytes_per_worker"] != res["layout_state_bytes"]:
        raise AssertionError(f"sharded MoE (c) {tag}: a worker holds "
                             f"{res['state_bytes_per_worker']:,} bytes, the "
                             f"layouts say {res['layout_state_bytes']:,}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"sharded MoE (c) {tag}: losses {losses}")
    if counts != want:
        raise AssertionError(f"sharded MoE (c) {tag}: launch counts "
                             f"{counts}, want {want}")
    if not peak < 80e9:
        raise AssertionError(f"sharded MoE (c) {tag}: peak {peak:,} bytes")
    if not routed_max > 0:
        raise AssertionError(f"sharded MoE (c) {tag}: the routed output is "
                             "all zero")
    dt = "torch.bfloat16" if cfg.mixed_precision else "torch.float32"
    d = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim) \
        if cfg.use_mla else (cfg.head_dim, cfg.head_dim)
    if seen != {(n, dt, *d) for n in ("flash_attention",
                                      "flash_attention_bwd")}:
        raise AssertionError(f"sharded MoE (c) {tag}: flash calls {seen}")
    out = {"layers": L, "steps": N, "losses": losses,
           "steps_per_s": res["steps_per_s"],
           "tokens_per_s": res["tokens_per_s"], "median_step_s": med,
           "peak_device_bytes": peak, "reckoned_peak": reckoned,
           "batch": B, "state_bytes_per_worker": res["state_bytes_per_worker"],
           "traffic_per_step": res["traffic_per_step"],
           "drop_share": dropped / max(picks, 1), "routed_max": routed_max,
           "held_at_start": held,
           "launch_counts": counts, "flash_calls": sorted(seen)}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_sharded_moe(torch, K, train, cfgs: dict
                      ) -> tuple[dict, dict, dict]:
    """Phase 26: sharded training of MLA, MoE and ``mixed_precision`` on
    M = 4 workers sharing the card, full width ((a) the flash kernels at
    every run's per-worker shapes, (b) parity, (c) the training runs, the
    phase's main path).  ``cfgs``: the two configs by arch.  Returns
    (record, the kernels line's added errors by row, its added launches
    by row)."""
    rec: dict = {"card": nvidia_smi_line()}
    seconds: dict = {}
    C = SHARDED_MOE
    T = MOE_TRAIN["seq"]
    Bp = C["parity_batch"]
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"sharded MoE: {held:,} device bytes held by earlier phases at the "
        "start")

    # the runs' batches and depths: 4 layers where the reckoned peak fits,
    # else fewer
    runs = []
    for arch, shape, policy, change in SHARDED_MOE_RUNS:
        cfg = dataclasses.replace(cfgs[arch], **change)
        mesh = _sharded_mesh(shape)
        B = _run_batch(mesh, policy)
        L = MOE_TRAIN["layers"]
        while L > 1 and _reckoned_peak(train, dataclasses.replace(
                cfg, num_layers=L), mesh, policy, B, T, held) >= MOE_PEAK:
            L -= 1
        peak = _reckoned_peak(train, dataclasses.replace(cfg, num_layers=L),
                              mesh, policy, B, T, held)
        if L < MOE_TRAIN["layers"]:
            log(f"CUT: sharded MoE (c) {arch} {shape} {policy} trains at {L} "
                f"of MOE_TRAIN's {MOE_TRAIN['layers']} layers (reckoned "
                f"peak {peak:,.0f} bytes; {MOE_TRAIN['layers']} layers "
                f"would pass MOE_PEAK {MOE_PEAK:,.0f})")
        log(f"sharded MoE (c) {arch} {shape} {policy} {change or ''}: "
            f"batch {B}, {L} layers, reckoned peak {peak:,.0f} bytes")
        runs.append((dataclasses.replace(cfg, num_layers=L), shape, policy,
                     B, peak))

    # (a): the flash kernels at every run's per-worker shapes
    t0 = time.perf_counter()
    shapes: dict = {}
    for cfg, shape, policy, B, _ in runs:
        w = _moe_worker_shapes(torch, train, cfg, _sharded_mesh(shape),
                               policy, B, T)
        dt = "bfloat16" if cfg.mixed_precision else "float32"
        shapes.setdefault((*w, dt), []).append(f"(c) {shape} {policy}")
    for arch, shape, policy in SHARDED_MOE_PARITY:
        w = _moe_worker_shapes(torch, train, cfgs[arch], _sharded_mesh(shape),
                               policy, Bp, T)
        shapes.setdefault((*w, "float32"), []).append(
            f"(b) {arch} {shape} {policy}")
    rec["kernels"] = _sharded_moe_kernels(torch, K, shapes, T)
    rec["worker_shapes"] = {str(k): v for k, v in shapes.items()}
    seconds["kernels"] = time.perf_counter() - t0

    # (b): parity at 2 layers, f32 stream
    t0 = time.perf_counter()
    parity = {}
    for arch in cfgs:
        pairs = [(s, p) for a, s, p in SHARDED_MOE_PARITY if a == arch]
        parity.update(_sharded_moe_parity(torch, train, cfgs[arch], pairs,
                                          Bp, T))
    rec["parity"] = parity
    seconds["parity"] = time.perf_counter() - t0

    # (c): the training runs, the phase's main path
    t0 = time.perf_counter()
    out_runs, launches = {}, {}
    for cfg, shape, policy, B, peak in runs:
        r = _sharded_moe_run(torch, K, train, cfg, shape, policy, B,
                             C["steps"], peak)
        tag = (f"{cfg.arch_id} {shape} {policy}"
               + (" moe_sharded" if cfg.moe_sharded else "")
               + (" mixed_precision" if cfg.mixed_precision else ""))
        out_runs[tag] = r
        if cfg.mixed_precision:
            rows = ("flash_attention_bf16", "flash_attention_bwd_bf16")
        elif cfg.use_mla:
            rows = ("flash_attention_mla_lse", "flash_attention_bwd_mla")
        else:
            rows = ("flash_attention", "flash_attention_bwd")
        for row, k in zip(rows, ("flash_attention", "flash_attention_bwd")):
            launches[row] = launches.get(row, 0) + r["launch_counts"][k]
    rec["runs"] = out_runs
    seconds["runs"] = time.perf_counter() - t0
    rec["seconds"] = seconds
    log("phase 26 seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    errs = {k: v["max_abs_err"] for k, v in rec["kernels"].items()}
    if "flash_attention_mla" in errs:   # the forward without the lse too
        errs["flash_attention_mla_lse"] = errs["flash_attention_mla"]
    launches["flash_attention_mla"] = launches.get(
        "flash_attention_mla_lse", 0)
    return rec, errs, launches


# ---------------------------------------------------------------------------
# phase 27
# ---------------------------------------------------------------------------

def _d128_checks(torch, K, cfgs: dict) -> dict:
    """(a): both f32 flash kernels at the head groupings that phase 27's
    D = 128 main paths bring and no earlier phase holds — StarCoder2-15B's
    48 heads over 4 KV heads (G = 12), DeepSeek-67B's 64 over 8 and
    InternVL2-2B's 16 over 8 (G = 2) — causal, within ``TOL`` of their
    plain versions: the forward at ``LM_SERVE``'s batch and prompt, the
    forward with the lse and the backward at ``P27_TRAIN``'s batch and
    sequence.  Returns each output's largest distance by kernel."""
    fa = K.flash_attention.flash_attention
    fb = K.flash_attention_bwd.flash_attention_bwd
    ref = K.ref
    gen = torch.Generator(device="cuda").manual_seed(2728)
    worst = {"flash_attention": 0.0, "flash_attention_bwd": 0.0}
    rec: dict = {}

    def held(kernel, got, want, what):
        e, r = rel_err(got, want)
        worst[kernel] = max(worst[kernel], e)
        if not r <= TOL[kernel]:
            raise AssertionError(f"flash D = 128 [{what}]: {r:.3g} of its "
                                 f"largest > {TOL[kernel]}")
        return r

    for arch in ("starcoder2_15b", "deepseek_67b", "internvl2_2b"):
        cfg = cfgs[arch]
        H, Kv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rel = {}
        for B, S, train in ((LM_SERVE["batch"], LM_SERVE["prompt_len"],
                             False),
                            (P27_TRAIN["batch"], P27_TRAIN["seq"], True)):
            q = torch.randn((B, S, H, D), generator=gen, device="cuda")
            k, v = (torch.randn((B, S, Kv, D), generator=gen, device="cuda")
                    for _ in range(2))
            tag = f"{arch} B={B} S={S} H={H} Kv={Kv}"
            if not train:
                rel["serve o"] = held("flash_attention", fa(q, k, v),
                                      ref.flash_attention_ref(q, k, v, True),
                                      f"{tag} o")
                del q, k, v
                continue
            dout = torch.randn((B, S, H, D), generator=gen, device="cuda")
            o, lse = fa(q, k, v, return_lse=True)
            p_o, p_lse = ref.flash_attention_ref(q, k, v, True,
                                                 return_lse=True)
            rel["train o"] = held("flash_attention", o, p_o, f"{tag} o")
            rel["train lse"] = held("flash_attention", lse, p_lse,
                                    f"{tag} lse")
            del p_o, p_lse
            for name, g, w in zip(("dq", "dk", "dv"),
                                  fb(q, k, v, o, lse, dout),
                                  ref.flash_attention_bwd_ref(
                                      q, k, v, o, lse, dout, True)):
                rel[f"train {name}"] = held("flash_attention_bwd", g, w,
                                            f"{tag} {name}")
            del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
        rec[arch] = rel
        log(f"  flash D = 128 [{arch}: H={H} Kv={Kv} (G = {H // Kv}) causal; "
            f"serving B={LM_SERVE['batch']} S={LM_SERVE['prompt_len']}, "
            f"training B={P27_TRAIN['batch']} S={P27_TRAIN['seq']}]: of "
            "each output's largest from the plain version "
            + ", ".join(f"{n} {x:.3g}" for n, x in rel.items()))
    rec["max_abs_err"] = worst
    return rec


def _d80_checks(torch, K) -> tuple[dict, list[dict]]:
    """(a): both flash kernels at HuBERT-XLarge's width (D = Dv = 80,
    H = Kv = 16, ``HUBERT``'s batch and frames), non-causal, at S = 1,500
    (46 key tiles of 32 and 28 keys) and at S = 1,499 with kv_len < Sk: the
    forward without and with the lse and the backward within 2e-5 of their
    plain versions (each output's largest), the forward's output the same
    bits with and without the lse, two backward calls bitwise; bf16 q, k,
    v (o, dO) give the f32 kernels' bits on the inputs widened to f32 and
    are within 2e-5 of the plain versions (o past its bf16 rounding).
    Then the five routes' times at S = 1,500 beside their bounds, their
    plain versions and ``scaled_dot_product_attention(is_causal=False)``
    (f32 and bf16; with the lse ``_scaled_dot_product_efficient_attention``),
    in turns."""
    import torch.nn.functional as F

    fa = K.flash_attention.flash_attention
    fb = K.flash_attention_bwd.flash_attention_bwd
    ref = K.ref
    gen = torch.Generator(device="cuda").manual_seed(2727)
    B, H, D = HUBERT["batch"], HUBERT["heads"], HUBERT["head_dim"]
    rec: dict = {"cases": [], "max_abs_err": {}}
    worst = collections.defaultdict(float)   # row → max abs err

    def inputs(S):
        return [torch.randn((B, S, H, D), generator=gen, device="cuda")
                for _ in range(4)]

    def held(name, row, got, want, tol, what):
        e, r = rel_err(got, want)
        worst[row] = max(worst[row], e)
        if not r <= tol:
            raise AssertionError(f"flash D = 80 [{what}] {name}: {r:.3g} "
                                 f"of its largest > {tol}")
        return r

    for tag, S, kv_len in (("S = 1500", HUBERT["frames"], HUBERT["frames"]),
                           ("S = 1499, kv_len < Sk", HUBERT["frames"] - 1,
                            HUBERT["kv_len"])):
        q, k, v, dout = inputs(S)
        kw = dict(causal=False, kv_len=kv_len)
        case = {"case": tag, "S": S, "kv_len": kv_len, "rel": {}}
        o = fa(q, k, v, **kw)
        o2, lse = fa(q, k, v, return_lse=True, **kw)
        p_o, p_lse = ref.flash_attention_ref(q, k, v, False, kv_len=kv_len,
                                             return_lse=True)
        got = fb(q, k, v, o2, lse, dout, **kw)
        again = fb(q, k, v, o2, lse, dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o2, lse, dout, False,
                                           kv_len=kv_len)
        torch.cuda.synchronize()
        case["rel"]["o"] = held("o", "flash_attention_d80", o, p_o,
                                TOL["flash_attention"], tag)
        case["rel"]["o with lse"] = held("o with lse",
                                         "flash_attention_d80_lse", o2, p_o,
                                         TOL["flash_attention"], tag)
        case["rel"]["lse"] = held("lse", "flash_attention_d80_lse", lse,
                                  p_lse, TOL["flash_attention"], tag)
        if not torch.equal(o, o2):
            raise AssertionError(f"flash D = 80 [{tag}]: o differs with and "
                                 "without the lse")
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            case["rel"][name] = held(name, "flash_attention_bwd_d80", g, w,
                                     TOL["flash_attention_bwd"], tag)
            if not torch.equal(g, a):
                raise AssertionError(f"flash D = 80 [{tag}]: two backward "
                                     f"calls gave different {name} bits")
        del o, o2, lse, p_o, p_lse, got, again, want
        # bf16: the f32 kernels' bits on the widened inputs
        qb, kb, vb, db = (t.bfloat16() for t in (q, k, v, dout))
        del q, k, v, dout
        wide = [t.float() for t in (qb, kb, vb, db)]
        ob = fa(qb, kb, vb, **kw)
        ob2, lseb = fa(qb, kb, vb, return_lse=True, **kw)
        o32, lse32 = fa(*wide[:3], return_lse=True, **kw)
        gb = fb(qb, kb, vb, ob2, lseb, db, **kw)
        g32 = fb(*wide[:3], ob2.float(), lseb, wide[3], **kw)
        torch.cuda.synchronize()
        bits = {"o": torch.equal(ob, o32.bfloat16()),
                "o with lse": torch.equal(ob2, ob),
                "lse": torch.equal(lseb, lse32),
                **{n: torch.equal(g, w)
                   for n, g, w in zip(("dq", "dk", "dv"), gb, g32)}}
        case["bf16_bitwise"] = bits
        if not all(bits.values()):
            raise AssertionError(f"flash D = 80 bf16 [{tag}]: not the f32 "
                                 f"kernels' bits on the widened inputs: "
                                 f"{bits}")
        p_o, p_lse = ref.flash_attention_ref(*wide[:3], False, kv_len=kv_len,
                                             return_lse=True)
        half_ulp = torch.ldexp(torch.ones_like(p_o),
                               torch.frexp(p_o)[1] - 9)
        over = ((ob2.float() - p_o).abs() - half_ulp).clamp_min(0)
        e = over.max().item()
        r = e / p_o.abs().max().item()
        worst["flash_attention_d80_bf16"] = max(
            worst["flash_attention_d80_bf16"], e)
        case["rel"]["bf16 o past its rounding"] = r
        if not r <= TOL["flash_attention"]:
            raise AssertionError(f"flash D = 80 bf16 [{tag}]: o {r:.3g} of "
                                 "its largest past its bf16 rounding")
        case["rel"]["bf16 lse"] = held("bf16 lse", "flash_attention_d80_bf16",
                                       lseb, p_lse, TOL["flash_attention"],
                                       tag)
        for name, g, w in zip(("dq", "dk", "dv"), gb,
                              ref.flash_attention_bwd_ref(
                                  qb, kb, vb, ob2, lseb, db, False,
                                  kv_len=kv_len)):
            case["rel"][f"bf16 {name}"] = held(
                f"bf16 {name}", "flash_attention_bwd_d80_bf16", g, w,
                TOL["flash_attention_bwd"], tag)
        log(f"  flash D = 80 [{tag}: B={B} Sq=Sk={S} H=Kv={H} non-causal "
            f"kv_len={kv_len}]: of each output's largest "
            + ", ".join(f"{n} {x:.3g}" for n, x in case["rel"].items())
            + "; o the same bits with and without the lse; two backward "
            "calls bitwise; bf16 the f32 kernels' bits on the widened inputs")
        rec["cases"].append(case)
        del qb, kb, vb, db, wide, ob, ob2, lseb, o32, lse32, gb, g32
        del p_o, p_lse, half_ulp, over
        torch.cuda.empty_cache()

    # times at S = 1500, every key visible
    S = HUBERT["frames"]
    q, k, v, dout = inputs(S)
    o, lse = fa(q, k, v, causal=False, return_lse=True)
    floor = floor_ms(torch, K.build)
    pairs = B * H * S * S
    f32 = 4
    fwd_bytes = f32 * B * S * H * 4 * D
    bwd_bytes = f32 * (B * S * H * 8 * D + B * H * S)   # 5 in, 3 out, lse
    fwd_flops = [(3, 2 * pairs * D), (3, 2 * pairs * D)]   # S, P·V
    bwd_flops = [(3, 2 * pairs * D)] * 5                   # S, dP, dV, dK, dQ
    calls = {
        "flash_attention_d80": (
            lambda: fa(q, k, v, causal=False),
            _sdpa_fwd_call(torch, F, q, k, v, causal=False),
            lambda: ref.flash_attention_ref(q, k, v, False),
            tc_bound(fwd_bytes, fwd_flops), "serving forward, f32"),
        "flash_attention_d80_lse": (
            lambda: fa(q, k, v, causal=False, return_lse=True),
            _efficient_lse_call(torch, q, k, v, causal=False),
            lambda: ref.flash_attention_ref(q, k, v, False, return_lse=True),
            tc_bound(fwd_bytes + f32 * B * H * S, fwd_flops),
            "training forward with the lse, f32"),
        "flash_attention_bwd_d80": (
            lambda: fb(q, k, v, o, lse, dout, causal=False),
            _sdpa_bwd_call(torch, F, q, k, v, dout, causal=False),
            lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, False),
            tc_bound(bwd_bytes, bwd_flops), "training backward, f32"),
    }
    rows = _d80_rows(torch, calls, floor, B, H, S)
    del calls
    qb, kb, vb, db = (t.bfloat16() for t in (q, k, v, dout))
    del q, k, v, dout, o, lse
    ob, lseb = fa(qb, kb, vb, causal=False, return_lse=True)
    bf = 2
    unit = 2 * pairs * D
    x3 = F32_SIDE_BF16_PASSES
    calls = {
        "flash_attention_d80_bf16": (
            lambda: fa(qb, kb, vb, causal=False, return_lse=True),
            _sdpa_fwd_call(torch, F, qb, kb, vb, causal=False),
            lambda: ref.flash_attention_ref(qb, kb, vb, False,
                                            return_lse=True),
            bf16_bound(bf * B * S * H * 4 * D + f32 * B * H * S,
                       [(1, unit), (x3, unit)]),
            "training forward with the lse, bf16 (SDPA: bf16, no lse)"),
        "flash_attention_bwd_d80_bf16": (
            lambda: fb(qb, kb, vb, ob, lseb, db, causal=False),
            _sdpa_bwd_call(torch, F, qb, kb, vb, db, causal=False),
            lambda: ref.flash_attention_bwd_ref(qb, kb, vb, ob, lseb, db,
                                                False),
            bf16_bound(bf * B * S * H * 5 * D + f32 * B * H * S
                       + f32 * B * S * H * 3 * D,
                       [(1, unit), (1, unit), (x3, unit), (x3, unit),
                        (x3, unit)]),
            "training backward, bf16 (SDPA: bf16)"),
    }
    rows += _d80_rows(torch, calls, floor, B, H, S)
    del calls, qb, kb, vb, db, ob, lseb
    torch.cuda.empty_cache()
    for r in rows:
        r["max_abs_err"] = worst[r["name"]]
    rec["max_abs_err"] = dict(worst)
    return rec, rows


def _d80_rows(torch, calls: dict, floor: float, B: int, H: int,
              S: int) -> list[dict]:
    """Each route's kernel and yardstick in turns, its plain version, its
    bound (f32: ``tc_bound``, 3 TF32 passes a product; bf16:
    ``bf16_bound``)."""
    rows = []
    for name, (kernel, library, plain, (b_ms, b_by), what) in calls.items():
        t = alternate_ms(torch, {"kernel": kernel, "library": library})
        p_ms = device_ms(torch, plain, iters=5)
        row = {"name": name, "variant": f"{what}: B={B} H=Kv={H} S={S} "
               "D = Dv = 80 non-causal", "ms": t["kernel"], "plain_ms": p_ms,
               "library_ms": t["library"], "bound_ms": b_ms,
               "bound_by": b_by, "floor_ms": floor, "device_ms": None}
        log(f"{name} [{row['variant']}]: {row['ms']:.4f} ms/call (plain "
            f"{p_ms:.4f} ms"
            + (f", its yardstick {t['library']:.4f} ms: the kernel "
               f"{t['kernel'] / t['library']:.3f}x of it, in turns"
               if t["library"] else "")
            + f"), bound {b_ms:.4f} ms by {b_by} ({b_ms / row['ms']:.1%} of "
            f"it); launch floor {floor:.4f} ms")
        rows.append(row)
    return rows


def _check_launches(what: str, counts: dict, want: dict) -> None:
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        raise AssertionError(f"{what}: launch counts {counts}, want {full}")


def _check_routes(what: str, seen: set, cfg, names: tuple) -> list:
    """The flash routes a run reached (``_flash_calls``) are ``names`` at
    ``cfg``'s head width, bf16 under ``mixed_precision`` and else f32:
    the route its launches are counted under."""
    dt = "torch.bfloat16" if cfg.mixed_precision else "torch.float32"
    want = {(n, dt, cfg.head_dim, cfg.head_dim) for n in names}
    if seen != want:
        raise AssertionError(f"{what}: flash calls {sorted(seen)}, want "
                             f"{sorted(want)}")
    return sorted(seen)


def _serve_text(torch, K, serve, cfg, name: str) -> dict:
    """(b): ``launch/serve.run`` of ``cfg`` with random weights drawn on the
    card, one request of ``LM_SERVE``'s shape (the kernels are warm from
    the phases before): exactly L ``flash_attention`` launches a prefill,
    none in decode and no other kernel; finite logits; the peak."""
    B, P, G = LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["gen"]
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    seen: set = set()
    K.reset_launch_counts()
    with _flash_calls(K, seen):
        res = serve.run(cfg, batch=B, prompt_len=P, gen=G, seed=0,
                        device="cuda", backend="cuda")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak = res["peak_device_bytes"]
    n_params = sum(p.numel() for p in res["params"].parameters())
    log(f"{name} serve: {L} layers, {n_params:,} f32 parameters drawn on "
        f"the card in {res['init_seconds']:.2f}s; batch {B}, prompt {P}, "
        f"{G} tokens: prefill {res['prefill_seconds']:.4f}s, decode "
        f"{res['decode_tokens_per_s']:.2f} tokens/s "
        f"({res['decode_seconds']:.4f}s for {G - 1} steps), peak device "
        f"bytes {peak:,}, logits finite {res['finite']}; launch counts "
        f"{counts}")
    if not res["finite"]:
        raise AssertionError(f"{name} serve: non-finite prefill logits")
    if res["generated"].shape != (B, G):
        raise AssertionError(f"{name} serve: generated "
                             f"{tuple(res['generated'].shape)}")
    _check_launches(f"{name} serve", counts, {"flash_attention": L})
    routes = _check_routes(f"{name} serve", seen, cfg, ("flash_attention",))
    if not peak < 80e9:
        raise AssertionError(f"{name} serve: peak {peak:,} bytes")
    out = {k: res[k] for k in ("init_seconds", "prefill_seconds",
                               "decode_seconds", "decode_tokens_per_s",
                               "peak_device_bytes", "finite")}
    out.update(layers=L, params=n_params, launch_counts=counts,
               flash_calls=routes, generated=res["generated"][0].tolist())
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_vision(torch, K, cfg) -> dict:
    """(b): InternVL2-2B's prefill of ``num_patches`` patches and the rest
    of the 2,048 positions in text tokens through ``make_prefill_step`` on
    an ``input_specs`` batch, then ``LM_SERVE``'s greedy text decode from
    cache index 2,048 through ``make_decode_step``."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps as S
    from repro_torch.models import init_cache, init_model

    B, P, G = LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["gen"]
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = S.concretize(S.input_specs(cfg, ShapeCell(
        "phase 27 vision prefill", P, B, "prefill")), gen, "cuda")
    caches = init_cache(cfg, B, P + G, dtype=torch.float32, device="cuda")
    prefill = S.make_prefill_step(cfg, "cuda")
    decode = S.make_decode_step(cfg, "cuda")
    seen: set = set()
    K.reset_launch_counts()
    with _flash_calls(K, seen):
        t0 = time.perf_counter()
        last, caches = prefill(params, batch, caches)
        tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(last).all())
        at_prefill = K.launch_counts()
        out_toks, index = [tok], P
        t0 = time.perf_counter()
        for _ in range(G - 1):
            tok, caches, index = decode(params, caches, index,
                                        {"tokens": tok})
            out_toks.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.parameters())
    tok_s = B * (G - 1) / decode_s
    log(f"internvl2_2b serve: {L} layers, {n_params:,} f32 parameters; "
        f"prefill of {cfg.num_patches} patches + {P - cfg.num_patches} "
        f"tokens x batch {B} {prefill_s:.4f}s, decode {tok_s:.2f} tokens/s "
        f"({decode_s:.4f}s for {G - 1} steps from index {P}), peak device "
        f"bytes {peak:,}, logits finite {finite}; launch counts at prefill "
        f"{at_prefill}, after decode {counts}")
    if not finite:
        raise AssertionError("internvl2_2b serve: non-finite prefill logits")
    if index != P + G - 1:
        raise AssertionError(f"internvl2_2b serve: decode ended at {index}")
    _check_launches("internvl2_2b prefill", at_prefill,
                    {"flash_attention": L})
    _check_launches("internvl2_2b serve", counts, {"flash_attention": L})
    routes = _check_routes("internvl2_2b serve", seen, cfg,
                           ("flash_attention",))
    if not peak < 80e9:
        raise AssertionError(f"internvl2_2b serve: peak {peak:,} bytes")
    out = {"init_seconds": init_s, "prefill_seconds": prefill_s,
           "decode_seconds": decode_s, "decode_tokens_per_s": tok_s,
           "peak_device_bytes": peak, "finite": finite, "layers": L,
           "params": n_params, "launch_counts": counts, "flash_calls": routes,
           "generated": torch.cat(out_toks, 1)[0].tolist()}
    del params, caches, batch, last
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _encode_audio(torch, K, cfg) -> dict:
    """(b): HuBERT-XLarge's encoder step (``make_encoder_step``, the
    reference's encoder-only "prefill") over ``HUBERT``'s batch of frames:
    exactly L ``flash_attention`` launches (non-causal, D = 80) and no
    other kernel; finite logits of (B, S, vocab); the peak.  No decode:
    the config is encoder-only."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps as S
    from repro_torch.models import init_model

    B, T, L = HUBERT["batch"], HUBERT["frames"], cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = S.concretize(S.input_specs(cfg, ShapeCell(
        "phase 27 audio encoder", T, B, "prefill")), gen, "cuda")
    encode = S.make_encoder_step(cfg, "cuda")
    seen: set = set()
    K.reset_launch_counts()
    with _flash_calls(K, seen):
        t0 = time.perf_counter()
        logits = encode(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all())
    n_params = sum(p.numel() for p in params.parameters())
    log(f"hubert_xlarge encode: {L} layers, {n_params:,} f32 parameters "
        f"drawn in {init_s:.2f}s; {B} x {T} frames in {secs:.4f}s "
        f"({B * T / secs:.1f} frames/s), logits {tuple(logits.shape)} "
        f"finite {finite}, peak device bytes {peak:,}; launch counts "
        f"{counts}")
    if not finite or tuple(logits.shape) != (B, T, cfg.vocab_size):
        raise AssertionError(f"hubert_xlarge encode: logits "
                             f"{tuple(logits.shape)}, finite {finite}")
    _check_launches("hubert_xlarge encode", counts, {"flash_attention": L})
    routes = _check_routes("hubert_xlarge encode", seen, cfg,
                           ("flash_attention",))
    if not peak < 80e9:
        raise AssertionError(f"hubert_xlarge encode: peak {peak:,} bytes")
    out = {"init_seconds": init_s, "seconds": secs,
           "frames_per_s": B * T / secs, "peak_device_bytes": peak,
           "finite": finite, "layers": L, "params": n_params,
           "launch_counts": counts, "flash_calls": routes}
    del params, batch, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _trained(name: str, L: int, steps: int, losses: list, secs: list,
             peak: int, counts: dict, n_params: int, tokens: int) -> dict:
    """The checks and the record of one (c) run: finite and falling loss,
    exactly L ``flash_attention`` and L ``flash_attention_bwd`` launches a
    step and no other kernel, the peak under 80 GB."""
    med = statistics.median(secs[1:])
    log(f"{name} train: {L} layers, {n_params:,} f32 parameters, {tokens} "
        f"positions a step, {steps} steps: median step {med:.4f}s = "
        f"{tokens / med:.1f} positions/s; losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; peak device bytes {peak:,}; launch counts {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name} train: a non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name} train: loss did not fall "
                             f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    _check_launches(f"{name} train", counts,
                    {"flash_attention": L * steps,
                     "flash_attention_bwd": L * steps})
    if not peak < 80e9:
        raise AssertionError(f"{name} train: peak {peak:,} bytes")
    return {"layers": L, "params": n_params, "steps": steps,
            "positions_per_step": tokens, "losses": losses,
            "step_seconds": secs, "median_step_s": med,
            "positions_per_s": tokens / med, "peak_device_bytes": peak,
            "launch_counts": counts}


def _train_text(torch, K, train, cfg, name: str) -> dict:
    """(c): ``launch/train.run`` of ``cfg`` on the card (InternVL2-2B on
    text alone, as the reference's ``launch/train.py`` trains it) at
    ``P27_TRAIN``'s batch and steps, ``train.run``'s lr and warmup, no
    checkpoint written."""
    P = P27_TRAIN
    gc.collect()
    torch.cuda.empty_cache()
    seen: set = set()
    K.reset_launch_counts()
    with _flash_calls(K, seen):
        res = train.run(cfg, steps=P["steps"], batch=P["batch"],
                        seq=P["seq"],
                        ckpt_dir=str(ROOT / "build" / "phase27_ckpt"),
                        ckpt_every=P["steps"] + 1, log_every=P["steps"],
                        device="cuda", backend="cuda")
    torch.cuda.synchronize()
    hist = res["history"]
    routes = _check_routes(f"{name} train", seen, cfg,
                           ("flash_attention", "flash_attention_bwd"))
    out = _trained(
        name, cfg.num_layers, P["steps"],
        [hist[i]["loss"] for i in range(1, P["steps"] + 1)],
        [hist[i]["seconds"] for i in range(1, P["steps"] + 1)],
        res["peak_device_bytes"], K.launch_counts(),
        sum(p.numel() for p in res["state"].params.parameters()),
        P["batch"] * P["seq"])
    out["flash_calls"] = routes
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_audio(torch, K, cfg, name: str) -> dict:
    """(c): HuBERT-XLarge through ``make_train_step`` (the reference's own
    way: its ``launch/train.py`` feeds tokens only) on a fresh
    ``concretize``d ``input_specs`` batch of ``HUBERT``'s frames each step,
    ``train.run``'s lr
    with a one-step warmup (its default 100 would hold 8 steps at lr
    ≤ 2.4e-5, and the labels are uniform draws: the loss would move by
    about its batch-to-batch spread)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw

    P = P27_TRAIN
    B, T = HUBERT["batch"], HUBERT["frames"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = S.init_train_state(cfg, gen, "cuda")
    step = S.make_train_step(cfg, adamw.AdamWConfig(
        warmup_steps=P["audio_warmup"], total_steps=P["steps"]), "cuda")
    specs = S.input_specs(cfg, ShapeCell("phase 27 audio train", T, B,
                                         "train"))
    losses, secs = [], []
    seen: set = set()
    K.reset_launch_counts()
    with _flash_calls(K, seen):
        for _ in range(P["steps"]):
            batch = S.concretize(specs, gen, "cuda")
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))    # synchronizes
            secs.append(time.perf_counter() - t0)
    routes = _check_routes(f"{name} train", seen, cfg,
                           ("flash_attention", "flash_attention_bwd"))
    out = _trained(name, cfg.num_layers, P["steps"], losses, secs,
                   torch.cuda.max_memory_allocated(), K.launch_counts(),
                   sum(p.numel() for p in state.params.parameters()),
                   B * T)
    out["flash_calls"] = routes
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _parity_27(torch, K, cfg, name: str, batch_of) -> dict:
    """(d): ``"cuda"`` against ``"torch"`` at ``P27_TRAIN``'s parity depth
    under ``mixed_precision`` (so that the ``"cuda"`` run reaches the bf16
    flash kernels, which it records), phase 13's comparison and bounds."""
    from repro_torch.launch import steps as S
    from repro_torch.models import loss_fn
    from repro_torch.optim import adamw

    cfg2 = dataclasses.replace(cfg, num_layers=P27_TRAIN["parity_layers"],
                               mixed_precision=True, dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    state = S.init_train_state(
        cfg2, torch.Generator(device="cuda").manual_seed(11), "cuda")
    params = adamw.named(state.params)
    batch = batch_of(cfg2)
    loss, grads = {}, {}
    seen: set = set()
    for bk in ("cuda", "torch"):
        with _flash_calls(K, seen):
            lo = loss_fn(state.params, cfg2, batch, backend=bk)
            grads[bk] = dict(zip(params, torch.autograd.grad(
                lo, list(params.values()))))
        loss[bk] = float(lo.detach())
        del lo
    rec = _backend_parity(torch, state, params, loss, grads,
                          f"{name} parity ({cfg2.num_layers} layers, "
                          "mixed_precision)")
    D = cfg.head_dim
    want = {("flash_attention", "torch.bfloat16", D, D),
            ("flash_attention_bwd", "torch.bfloat16", D, D)}
    log(f"{name} parity: the cuda run's flash calls at (name, dtype, D, "
        f"Dv) {sorted(seen)}")
    if seen != want:
        raise AssertionError(f"{name} parity: flash calls "
                             f"{sorted(seen)}, want "
                             f"{sorted(want)}")
    del state, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg2.num_layers,
            "flash_calls": sorted(seen), **rec}


def phase_attention_archs(torch, K, serve, train, get_config
                          ) -> tuple[dict, list[dict], dict]:
    """Phase 27: Qwen2.5-14B, DeepSeek-67B, StarCoder2-15B, InternVL2-2B
    and HuBERT-XLarge at full width — (a) both flash kernels at D = 80
    non-causal and at the D = 128 main paths' new head groupings, (b)
    serving, (c) training, (d) parity.  Returns (record, the D = 80
    routes' kernel rows with their main-path launches, the D = 128 f32
    kernels' main-path launches and largest distance from the plain
    versions)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import init_model

    rec: dict = {"card": nvidia_smi_line()}
    seconds: dict = {}
    cfgs = {a: get_config(a) for a in ("qwen2_5_14b", "starcoder2_15b",
                                       "deepseek_67b", "internvl2_2b",
                                       "hubert_xlarge")}
    t0 = time.perf_counter()
    rec["kernels"], rows = _d80_checks(torch, K)
    rec["kernels_d128"] = _d128_checks(torch, K, cfgs)
    seconds["kernels"] = time.perf_counter() - t0

    # (b) serving; DeepSeek-67B's depth from its f32 bytes a layer
    meta = init_model(dataclasses.replace(cfgs["deepseek_67b"],
                                          num_layers=1), device="meta")
    layer_b = 4 * sum(p.numel() for n, p in meta.named_parameters()
                      if n.startswith("layers."))
    rest_b = 4 * sum(p.numel() for n, p in meta.named_parameters()
                     if not n.startswith("layers."))
    ds_layers = int((P27_SERVE["aim"] - P27_SERVE["reserve"] - rest_b)
                    // layer_b)
    log(f"CUT: deepseek_67b serves at {ds_layers} of its 95 layers: "
        f"{layer_b / 1e9:.3f} GB of f32 parameters a layer, "
        f"{rest_b / 1e9:.3f} GB for the embedding, head and final norm, "
        f"{P27_SERVE['reserve'] / 1e9:.0f} GB kept for the KV cache, the "
        "prompt's logits and activations and the head's bf16 copy, under "
        f"{P27_SERVE['aim'] / 1e9:.0f} GB")
    t0 = time.perf_counter()
    rec["serve"] = {}
    for arch in ("qwen2_5_14b", "starcoder2_15b", "deepseek_67b"):
        cfg = cfgs[arch]
        if arch == "deepseek_67b":
            cfg = dataclasses.replace(cfg, num_layers=ds_layers)
        rec["serve"][arch] = _serve_text(torch, K, serve, cfg, arch)
    rec["serve"]["internvl2_2b"] = _serve_vision(
        torch, K, cfgs["internvl2_2b"])
    rec["serve"]["hubert_xlarge"] = _encode_audio(
        torch, K, cfgs["hubert_xlarge"])
    seconds["serve"] = time.perf_counter() - t0

    # (c) training
    P = P27_TRAIN
    log(f"CUT: training depths {P['layers']} of the published 48 "
        "(qwen2_5_14b), 40 (starcoder2_15b) and 95 (deepseek_67b) layers: "
        "the f32 parameters, gradients and AdamW m and v take 16 bytes a "
        f"parameter — {16 * layer_b / 1e9:.1f} GB a DeepSeek-67B layer and "
        f"{16 * rest_b / 1e9:.1f} GB for its embedding and head — beside "
        "the step's activations; InternVL2-2B (24) and HuBERT-XLarge (48) "
        "train at full depth")
    t0 = time.perf_counter()
    rec["train"] = {}
    for arch in ("qwen2_5_14b", "starcoder2_15b", "deepseek_67b",
                 "internvl2_2b"):
        cfg = dataclasses.replace(cfgs[arch], num_layers=P["layers"].get(
            arch, cfgs[arch].num_layers))
        rec["train"][arch] = _train_text(torch, K, train, cfg, arch)
    rec["train"]["hubert_xlarge"] = _train_audio(
        torch, K, cfgs["hubert_xlarge"], "hubert_xlarge")
    rec["train"]["hubert_xlarge mixed_precision"] = _train_audio(
        torch, K, dataclasses.replace(cfgs["hubert_xlarge"],
                                      mixed_precision=True),
        "hubert_xlarge mixed_precision")
    seconds["train"] = time.perf_counter() - t0

    # (d) parity under mixed_precision
    t0 = time.perf_counter()

    def frames(cfg):
        return S.concretize(S.input_specs(cfg, ShapeCell(
            "phase 27 parity", HUBERT["frames"], 1, "train")),
            torch.Generator(device="cuda").manual_seed(12), "cuda")

    def tokens(cfg):
        return train.device_batch(TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_PARITY["seq"],
            global_batch=LM_TRAIN_PARITY["batch"])).global_batch(0), "cuda")

    rec["parity"] = {
        "hubert_xlarge": _parity_27(torch, K, cfgs["hubert_xlarge"],
                                    "hubert_xlarge", frames),
        "qwen2_5_14b": _parity_27(torch, K, cfgs["qwen2_5_14b"],
                                  "qwen2_5_14b", tokens)}
    seconds["parity"] = time.perf_counter() - t0
    rec["seconds"] = seconds
    # each run's launch counts, by the route its flash calls were checked
    # to take: the D = 128 runs f32, HuBERT's f32 encoder step (no lse)
    # and training (with it), and its mixed-precision training bf16
    sv, tr = rec["serve"], rec["train"]
    dense = ("qwen2_5_14b", "starcoder2_15b", "deepseek_67b", "internvl2_2b")
    audio = tr["hubert_xlarge"]["launch_counts"]
    mixed = tr["hubert_xlarge mixed_precision"]["launch_counts"]
    launches = {
        "flash_attention": sum(sv[a]["launch_counts"]["flash_attention"]
                               + tr[a]["launch_counts"]["flash_attention"]
                               for a in dense),
        "flash_attention_bwd": sum(tr[a]["launch_counts"][
            "flash_attention_bwd"] for a in dense),
        "flash_attention_d80": sv["hubert_xlarge"]["launch_counts"][
            "flash_attention"],
        "flash_attention_d80_lse": audio["flash_attention"],
        "flash_attention_bwd_d80": audio["flash_attention_bwd"],
        "flash_attention_d80_bf16": mixed["flash_attention"],
        "flash_attention_bwd_d80_bf16": mixed["flash_attention_bwd"]}
    rec["launches"] = launches
    log("phase 27 seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; flash launches on the main paths by route: {launches}")
    for r in rows:
        r["launches"] = launches[r["name"]]
        if not r["launches"]:
            raise AssertionError(f"phase 27: {r['name']} was not launched "
                                 "on a main path")
    return rec, rows, {
        "launches": {k: launches[k] for k in ("flash_attention",
                                              "flash_attention_bwd")},
        "max_abs_err": rec["kernels_d128"]["max_abs_err"]}


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
    ap.add_argument("--refresh-host", action="store_true",
                    help="run only the patch's host split and the refresh "
                         "contract (refresh_host), print them as JSON")
    ap.add_argument("--bench-out", default="build/bench",
                    help="directory (under the checkout unless absolute) "
                         "for phase 18's BENCH_torch_*.json documents")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if args.refresh_host:
        print(json.dumps(refresh_host(torch), default=str), flush=True)
        return 0
    import repro_torch.kernels as K
    from repro_torch.core import fasttucker as ft
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import (online_train, serve, serve_tucker,
                                    std_train, train)

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
    t_conv = time.perf_counter()
    report["convergence"], conv_times, conv_counts = phase_convergence(
        torch, K, std_train, base, args.steps)
    times += conv_times
    report["convergence_seconds"] = time.perf_counter() - t_conv
    log(f"phase 17 (warm start, adaptive rank): "
        f"{report['convergence_seconds']:.1f}s")
    t_bench = time.perf_counter()
    (report["benchmarks"], bench_times, bench_counts,
     table_errs) = phase_benchmarks(torch, K, ROOT / args.bench_out)
    times += bench_times
    report["benchmarks_seconds"] = time.perf_counter() - t_bench
    log(f"phase 18 (the port's benchmarks): "
        f"{report['benchmarks_seconds']:.1f}s")
    note_written("18 (benchmark documents)", tree_bytes(ROOT / args.bench_out))
    t_online = time.perf_counter()
    report["online"], online_counts = phase_online(torch, K, online_train,
                                                   base, args.steps)
    report["online_seconds"] = time.perf_counter() - t_online
    log(f"phase 19 (online training, the data layer): "
        f"{report['online_seconds']:.1f}s")
    t_strat = time.perf_counter()
    strat_steps = min(args.steps, STRAT_STEPS)
    if strat_steps < args.steps:
        log(f"CUT: phase 20's strategy runs and online warm-up take "
            f"{strat_steps} of the {args.steps} steps (STRAT_STEPS: the "
            "script's time; the out-of-core run is host-bound at ~13 "
            "steps/s)")
    report["strategies"], strat_counts = phase_strategies(
        torch, K, ft, std_train, online_train, base, strat_steps)
    report["strategies_seconds"] = time.perf_counter() - t_strat
    report["strategies"]["seconds"] = report["strategies_seconds"]
    report["strategies"]["disk_bytes"] = sum(
        v for k, v in WRITTEN.items() if k.startswith("20 "))
    log(f"phase 20 (the multi-device strategies, {STRAT_WORKERS} workers): "
        f"{report['strategies_seconds']:.1f}s, disk writes "
        f"{report['strategies']['disk_bytes']:,} bytes")
    t_shard = time.perf_counter()
    report["sharded_serving"], shard_counts = phase_sharded_serving(
        torch, K, serve_tucker, online_train, base, wide_params, args.steps,
        ROOT / args.bench_out)
    report["sharded_serving_seconds"] = time.perf_counter() - t_shard
    log(f"phase 21 (sharded serving, {SHARD_WORKERS} workers): "
        f"{report['sharded_serving_seconds']:.1f}s")
    t_multi = time.perf_counter()
    report["multidev_benchmarks"], multi_counts = phase_multidev_benchmarks(
        torch, K, ROOT / args.bench_out)
    report["multidev_benchmarks_seconds"] = time.perf_counter() - t_multi
    log(f"phase 22 (the multi-device benchmarks): "
        f"{report['multidev_benchmarks_seconds']:.1f}s")
    # phase 23 takes the card's memory to ~78 GB: drop the FastTucker runs'
    # device tensors (their training and test sets) first
    del paths, base, wide_params
    gc.collect()
    t_lm = time.perf_counter()
    log(f"CUT: phases 23 and 26 train {SHARDED_LM['steps']} and "
        f"{SHARDED_MOE['steps']} steps a run (10 before phase 27: the "
        "script's time; every run's loss falls from step 2)")
    report["sharded_lm"], sharded_counts = phase_sharded_lm(
        torch, K, train, lm_cfg)
    report["sharded_lm_seconds"] = time.perf_counter() - t_lm
    log(f"phase 23 (sharded LM training, 4 workers): "
        f"{report['sharded_lm_seconds']:.1f}s")
    t_moe = time.perf_counter()
    ds_cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b"),
                                 num_layers=MOE_SERVE["ds_layers"])
    qm_cfg = dataclasses.replace(get_config("qwen3_moe_30b_a3b"),
                                 num_layers=MOE_SERVE["qm_layers"])
    report["moe_serving"], mla_row, moe_counts = phase_moe_serving(
        torch, K, serve, ds_cfg, qm_cfg)
    report["moe_serving_seconds"] = time.perf_counter() - t_moe
    log(f"phase 24 (MoE and MLA serving): "
        f"{report['moe_serving_seconds']:.1f}s")
    t_mt = time.perf_counter()
    report["moe_train"], train_rows, train_launches = phase_moe_train(
        torch, K, train,
        *(dataclasses.replace(get_config(a), num_layers=MOE_TRAIN["layers"])
          for a in ("deepseek_v2_lite_16b", "qwen3_moe_30b_a3b")))
    report["moe_train_seconds"] = time.perf_counter() - t_mt
    log(f"phase 25 (MoE and MLA training): "
        f"{report['moe_train_seconds']:.1f}s")
    t_sm = time.perf_counter()
    report["sharded_moe"], sm_errs, sm_launches = phase_sharded_moe(
        torch, K, train, {a: get_config(a) for a in (
            "deepseek_v2_lite_16b", "qwen3_moe_30b_a3b")})
    report["sharded_moe_seconds"] = time.perf_counter() - t_sm
    log(f"phase 26 (sharded MoE and MLA training, 4 workers): "
        f"{report['sharded_moe_seconds']:.1f}s")
    t_27 = time.perf_counter()
    report["attention_archs"], d80_rows, d128 = phase_attention_archs(
        torch, K, serve, train, get_config)
    report["attention_archs_seconds"] = time.perf_counter() - t_27
    log(f"phase 27 (Qwen2.5-14B, DeepSeek-67B, StarCoder2-15B, InternVL2-2B, "
        f"HuBERT-XLarge): {report['attention_archs_seconds']:.1f}s")
    for run in report["driver"]["runs"].values():
        for k, v in run["launch_counts"].items():
            counts[k] += v
    for part in (report["baselines"]["cutucker"]["counts"],
                 report["baselines"]["als"]["counts"],
                 report["baselines"]["ccd"]["counts"],
                 report["baselines"]["bench_accuracy"]["launch_counts"],
                 serve_counts, conv_counts, bench_counts, online_counts,
                 strat_counts, shard_counts, multi_counts, sharded_counts):
        for k, v in part.items():
            counts[k] += v
    counts["flash_attention"] += moe_counts["flash_attention"]
    for k in ("flash_attention", "flash_attention_bwd"):
        counts[k] += train_launches[k]   # Qwen3-MoE's training, D = 128
    moe_counts["flash_attention_mla"] += train_launches["flash_attention_mla"]
    # phase 26's four-worker runs: D = 128 (Qwen3-MoE), MLA and bf16 routes
    for k in ("flash_attention", "flash_attention_bwd"):
        counts[k] += sm_launches.get(k, 0)
    moe_counts["flash_attention_mla"] += sm_launches["flash_attention_mla"]
    for k in ("flash_attention_mla_lse", "flash_attention_bwd_mla",
              "flash_attention_bf16", "flash_attention_bwd_bf16"):
        train_launches[k] += sm_launches.get(k, 0)
    # phase 27's main paths at D = 128 in f32: the dense and vision serve
    # requests and training runs
    for k, n in d128["launches"].items():
        counts[k] += n
    report["seconds"] = time.perf_counter() - t_start
    total_written = sum(WRITTEN.values())
    report["disk_writes"] = {"reckoned_by_phase": dict(WRITTEN),
                             "reckoned_total": total_written}
    log(f"disk writes of the run: reckoned {total_written:,} bytes = "
        f"{total_written / 2**30:.2f} GiB (limit {DISK_LIMIT / 2**30:.0f} "
        "GiB): " + ", ".join(f"phase {k} {v:,}" for k, v in WRITTEN.items()))
    if not total_written < DISK_LIMIT:
        raise AssertionError(f"the run wrote {total_written:,} bytes, past "
                             f"the machine's {DISK_LIMIT:,}")

    errs = report["kernels_vs_plain"]
    lm_errs = {k: {"max_abs_err": max(
        v["max_abs_err"], report["sharded_lm"]["kernels"][k]["max_abs_err"])}
        for k, v in report["lm_kernels_vs_plain"].items()}
    max_err = {
        "kruskal_contract": errs["kruskal_contract"]["max_abs_err"],
        "kruskal_grad": max(errs["kruskal_grad.rows"]["max_abs_err"],
                            errs["kruskal_grad.core"]["max_abs_err"]),
        "scatter_accum": errs["scatter_accum"]["max_abs_err"],
        "segment_reduce": errs["segment_reduce"]["max_abs_err"],
        "tucker_matmul": lm_errs["tucker_matmul"]["max_abs_err"],
        "flash_attention": max(
            lm_errs["flash_attention"]["max_abs_err"],
            report["moe_serving"]["kernel"]["gqa"]["max_abs_err"],
            sm_errs.get("flash_attention", 0.0),
            d128["max_abs_err"]["flash_attention"]),
        "flash_attention_bwd": max(
            report["flash_bwd"]["max_abs_err"],
            report["sharded_lm"]["kernels"]["flash_attention_bwd"][
                "max_abs_err"], sm_errs.get("flash_attention_bwd", 0.0),
            d128["max_abs_err"]["flash_attention_bwd"]),
        **table_errs,
    }
    kernels = []
    for name in sorted(REPLACES):
        t = next(t for t in times if t["name"] == name)  # the path's main
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{SOURCE.get(name, name)}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "floor_ms": t["floor_ms"], "device_ms": t.get("device_ms")})
    mla = _mla_kernel_row(report, mla_row, moe_counts)
    mla["max_abs_err"] = max(mla["max_abs_err"],
                             sm_errs.get("flash_attention_mla", 0.0))
    kernels.append(mla)
    for r in train_rows:   # phase 25's routes of the two flash kernels
        base = r["name"].split("_mla")[0].split("_bf16")[0]
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{base}.cu",
            "replaces": REPLACES[base], "launches": train_launches[r["name"]],
            "max_abs_err": max(r["max_abs_err"], sm_errs.get(r["name"], 0.0)),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "floor_ms", "device_ms")}})
    for r in d80_rows:   # phase 27's D = 80 routes
        base = r["name"].split("_d80")[0]
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{base}.cu",
            "replaces": REPLACES[base], "launches": r["launches"],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "floor_ms",
                                 "device_ms")}})
    report["kernels"] = kernels
    if args.report:
        path = Path(args.report)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1, default=str))
    log(f"launches on the main paths (the three training paths, the "
        f"phase 14's nine runs, cuTucker's SGD run, the ALS and CCD "
        f"epochs, bench_accuracy, phase 16's closed loops and refresh "
        f"rounds, phase 17's warm starts, warm and adaptive runs and "
        f"bench_convergence, phase 18's benchmarks and examples, phase "
        f"19's two online runs, phase 20's strategy runs and online "
        f"strata run, phase 21's sharded queries, refresh rounds, "
        f"serve_tucker, online run and bench_serve, and phase 22's "
        f"fig7bc, ingest, bench_convergence and multipod runs; the LM "
        f"serve request, the LM training run and phase 23's four sharded "
        f"training runs for {', '.join(LM_KERNELS)}; phase 24's Qwen3-MoE "
        f"serve request for flash_attention; phase 25's Qwen3-MoE training "
        f"and phase 26's sharded Qwen3-MoE run for both flash kernels; "
        f"phase 27's D = 128 serve requests and training runs): "
        f"{counts}; the MLA route (DeepSeek-V2-Lite's serve request, "
        f"training and phase 26's sharded f32 runs): "
        f"{moe_counts['flash_attention_mla']}; phase 25's new routes (with "
        f"phase 26's sharded runs): "
        + ", ".join(f"{k} {train_launches[k]}" for k in (
            "flash_attention_mla_lse", "flash_attention_bwd_mla",
            "flash_attention_bf16", "flash_attention_bwd_bf16"))
        + "; phase 27's D = 80 routes (HuBERT-XLarge's encoder step and "
        "training runs): " + ", ".join(f"{r['name']} {r['launches']}"
                                       for r in d80_rows))
    log(f"total {report['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
