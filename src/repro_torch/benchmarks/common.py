"""Schema contracts and timing helpers of the port's benchmark documents.

``validate_bench_step`` (``bench_step/v3``, with its legacy v2 and the
optional ``ingest`` section) and ``validate_bench_serve``
(``bench_serve/v1``) are the port's own copies of the reference's
``benchmarks.common`` validators, word for word: the same schemas and the
same claims.  ``validate_bench_serve`` keeps the ``devices > 1`` clauses
(``collectives`` and ``crossover`` required there), which the port's
``bench_serve`` fills at its default of 4 in-process workers.  ``validate_bench_accuracy`` is its copy of
``validate_bench_accuracy`` (``bench_accuracy/v1``).
``validate_bench_convergence`` is its copy of
``validate_bench_convergence`` (``bench_convergence/v1``), word for word
but for the backend of its coverage clause: a ``local`` and a ``strata*``
config on the document's backend (its first config's: ``"cuda"`` or
``"torch"`` for the port's documents), where the reference asks for
``xla``.

``time_call`` and ``row`` are the reference's timing and CSV helpers, a
``torch.cuda.synchronize()`` closing each timed call where the reference
blocks on its results.
"""
from __future__ import annotations

import time

import torch

BENCH_STEP_SCHEMA = "bench_step/v3"
BENCH_STEP_SCHEMA_V2 = "bench_step/v2"

# every result row must carry exactly these fields
BENCH_STEP_ROW_FIELDS = {
    "backend": str,        # kernel backend name (kernels.dispatch)
    "dtype": str,          # parameter storage dtype
    "update_order": str,   # jacobi | gauss_seidel
    "mode": str,           # joint | phase_split | two_phase |
                           # two_phase_cached | sorted | onehot_scatter
    "us_per_step": float,  # median wall time per full training step
}

# v2: every non-joint row additionally carries its speedup against the
# joint row of the same (backend, dtype, update_order) — >1 means the
# mode is FASTER than joint.  This is the per-pair field that makes
# regressions like xla/f32 phase_split-slower-than-joint visible in the
# document itself instead of requiring a reader to divide rows.
BENCH_STEP_SPEEDUP_FIELD = "speedup_vs_joint"

# v3: an optional top-level "ingest" section records the out-of-core
# ingestion sweep (benchmarks/bench_ingest.py): per-nnz rows measuring
# the store+prefetch pipeline against the resident-bucket path.
INGEST_ROW_FIELDS = {
    "nnz": int,                        # source tensor nonzeros
    "store": str,                      # "memory" | "spill"
    "prefetch_depth": int,             # strata issued ahead of use
    "us_per_step_stream": float,       # steady-state prefetched step
    "us_per_step_sync": float,         # depth-0: load on the hot path
    "us_per_stratum_load": float,      # pure load+device_put of a chunk
    "transfer_hidden_fraction": float,  # (sync − stream) / load, in [0,1]
}
# optional per-row fields (None/absent when the resident path can't run
# at that nnz — the memory-bounded regime the store exists for):
#   us_per_step_resident : float   resident-bucket step time
#   stream_vs_resident   : float   stream/resident ratio (1.0 = parity)
#   epoch_s, epoch_steps, nnz_per_s : full-epoch streaming stats


def _validate_ingest(ingest) -> None:
    if not isinstance(ingest, dict):
        raise ValueError("ingest section must be a dict")
    rows = ingest.get("rows")
    if not isinstance(rows, list) or not rows:
        raise ValueError("ingest.rows must be a non-empty list")
    for i, r in enumerate(rows):
        for field, typ in INGEST_ROW_FIELDS.items():
            if field not in r:
                raise ValueError(f"ingest.rows[{i}] missing {field!r}")
            if not isinstance(r[field], typ):
                raise ValueError(
                    f"ingest.rows[{i}].{field} must be {typ.__name__}, "
                    f"got {type(r[field]).__name__}")
        if not 0.0 <= r["transfer_hidden_fraction"] <= 1.0:
            raise ValueError(
                f"ingest.rows[{i}].transfer_hidden_fraction must be in "
                f"[0, 1], got {r['transfer_hidden_fraction']}")
        for field in ("us_per_step_stream", "us_per_step_sync",
                      "us_per_stratum_load"):
            if r[field] <= 0:
                raise ValueError(f"ingest.rows[{i}].{field} must be > 0")


def validate_bench_step(doc: dict) -> None:
    """Raise ``ValueError`` unless ``doc`` is a valid BENCH_step document.

    The contract CI's bench-smoke step (and tests) hold the emitted JSON
    to, so the recorded perf trajectory stays machine-readable across PRs.
    Schema ``bench_step/v3`` adds the optional top-level ``ingest``
    section (out-of-core ingestion sweep); ``bench_step/v2`` documents —
    the same result rows, no ingest section — stay readable.
    """
    if not isinstance(doc, dict):
        raise ValueError(f"BENCH_step document must be a dict, "
                         f"got {type(doc).__name__}")
    schema = doc.get("schema")
    if schema not in (BENCH_STEP_SCHEMA, BENCH_STEP_SCHEMA_V2):
        raise ValueError(f"schema must be {BENCH_STEP_SCHEMA!r} "
                         f"(or legacy {BENCH_STEP_SCHEMA_V2!r}), "
                         f"got {schema!r}")
    if schema == BENCH_STEP_SCHEMA_V2 and "ingest" in doc:
        raise ValueError("ingest section requires schema bench_step/v3")
    if "ingest" in doc:
        _validate_ingest(doc["ingest"])
    for key in ("config", "results"):
        if key not in doc:
            raise ValueError(f"missing top-level key {key!r}")
    cfg = doc["config"]
    for key in ("dims", "nnz", "rank", "core_rank", "batch"):
        if key not in cfg:
            raise ValueError(f"config missing {key!r}")
    results = doc["results"]
    if not isinstance(results, list) or not results:
        raise ValueError("results must be a non-empty list")
    for i, row_ in enumerate(results):
        for field, typ in BENCH_STEP_ROW_FIELDS.items():
            if field not in row_:
                raise ValueError(f"results[{i}] missing {field!r}")
            if not isinstance(row_[field], typ):
                raise ValueError(
                    f"results[{i}].{field} must be {typ.__name__}, "
                    f"got {type(row_[field]).__name__}")
        if row_["us_per_step"] <= 0:
            raise ValueError(f"results[{i}].us_per_step must be > 0")
        if row_["mode"] != "joint":
            spd = row_.get(BENCH_STEP_SPEEDUP_FIELD)
            if not isinstance(spd, float) or spd <= 0:
                raise ValueError(
                    f"results[{i}] (mode {row_['mode']!r}) must carry "
                    f"{BENCH_STEP_SPEEDUP_FIELD!r} as a positive float")


# ---------------------------------------------------------------------------
# bench_serve/v1 (benchmarks/bench_serve.py, the port's bench_serve.py): the
# serving-path contract
# ---------------------------------------------------------------------------

BENCH_SERVE_SCHEMA = "bench_serve/v1"

# closed_loop.rows: one row per (shard_mode, query, offered rate) point
# measured by the closed-loop harness (serve.frontend.run_closed_loop)
SERVE_CLOSED_LOOP_ROW_FIELDS = {
    "shard_mode": str,       # none | row | batch | gspmd (baseline top_k)
    "query": str,            # predict | top_k
    "offered_qps": float,    # target offered rate
    "achieved_qps": float,   # served queries / wall
    "p50_ms": float,         # end-to-end request latency percentiles
    "p99_ms": float,
    "served_requests": int,
    "shed": int,             # queue-full + deadline rejections
}

# collectives: the sharded-top_k win at M > 1 workers — the bytes the
# row-sharded top_k's copies move between workers for one request bucket
# (the shard-local merge) vs the baseline on the same row-sharded tables
# (the reference: the GSPMD-compiled unsharded program's collective
# operand bytes; the port, which has no GSPMD: that program's data flow,
# every worker's score block all-gathered, counted by the same rule; the
# document's ``baseline`` field says so).
SERVE_COLLECTIVE_FIELDS = {
    "devices": int,
    "bucket": int,                   # request bucket the programs serve
    "k": int,
    "sharded_operand_bytes": int,    # shard-local merge path
    "gspmd_operand_bytes": int,      # GSPMD baseline (O(rows) payload)
    "reduction": float,              # gspmd / sharded — must be > 1
}


def validate_bench_serve(doc: dict) -> None:
    """Raise ``ValueError`` unless ``doc`` is a valid BENCH_serve document.

    Schema ``bench_serve/v1``: ``config`` (+ device count), ``throughput``
    (bucketed vs per-query + bounded compiles), ``closed_loop.rows``
    (typed latency/QPS points) and — whenever ``config.devices > 1`` —
    ``collectives`` proving the shard-local top-k merge moves fewer
    collective bytes than the GSPMD baseline (``reduction > 1`` is part
    of the contract, so CI enforces the win, not just the format).
    ``crossover`` (row- vs batch-sharded capacity) is required at
    multi-device too.
    """
    if not isinstance(doc, dict):
        raise ValueError(f"BENCH_serve document must be a dict, "
                         f"got {type(doc).__name__}")
    if doc.get("schema") != BENCH_SERVE_SCHEMA:
        raise ValueError(f"schema must be {BENCH_SERVE_SCHEMA!r}, "
                         f"got {doc.get('schema')!r}")
    for key in ("config", "throughput", "closed_loop"):
        if key not in doc:
            raise ValueError(f"missing top-level key {key!r}")
    cfg = doc["config"]
    for key in ("dims", "rank", "core_rank", "backend", "devices",
                "microbatch"):
        if key not in cfg:
            raise ValueError(f"config missing {key!r}")
    thr = doc["throughput"]
    for key in ("per_query_qps", "bucketed_qps", "speedup",
                "sweep_compiles", "ladder_bound"):
        if key not in thr:
            raise ValueError(f"throughput missing {key!r}")
    if thr["speedup"] <= 0 or thr["bucketed_qps"] <= 0:
        raise ValueError("throughput speedup/bucketed_qps must be > 0")
    if thr["sweep_compiles"] > thr["ladder_bound"]:
        raise ValueError(
            f"unbounded compiles: {thr['sweep_compiles']} exceeds the "
            f"ladder bound {thr['ladder_bound']}")
    rows = doc["closed_loop"].get("rows")
    if not isinstance(rows, list) or not rows:
        raise ValueError("closed_loop.rows must be a non-empty list")
    for i, r in enumerate(rows):
        for field, typ in SERVE_CLOSED_LOOP_ROW_FIELDS.items():
            if field not in r:
                raise ValueError(f"closed_loop.rows[{i}] missing {field!r}")
            if not isinstance(r[field], typ):
                raise ValueError(
                    f"closed_loop.rows[{i}].{field} must be "
                    f"{typ.__name__}, got {type(r[field]).__name__}")
        if r["p50_ms"] > r["p99_ms"]:
            raise ValueError(
                f"closed_loop.rows[{i}]: p50 {r['p50_ms']} > p99 "
                f"{r['p99_ms']} — percentiles must be monotone")
    multi = int(cfg["devices"]) > 1
    if multi and "collectives" not in doc:
        raise ValueError("collectives section is required at devices > 1")
    if "collectives" in doc:
        col = doc["collectives"]
        for field, typ in SERVE_COLLECTIVE_FIELDS.items():
            if field not in col:
                raise ValueError(f"collectives missing {field!r}")
            if not isinstance(col[field], typ):
                raise ValueError(
                    f"collectives.{field} must be {typ.__name__}, "
                    f"got {type(col[field]).__name__}")
        if col["sharded_operand_bytes"] <= 0 or col["gspmd_operand_bytes"] <= 0:
            raise ValueError("collective byte counts must be > 0")
        if col["reduction"] <= 1.0:
            raise ValueError(
                f"collectives.reduction must be > 1 (the shard-local "
                f"merge must beat GSPMD), got {col['reduction']}")
    if multi and "crossover" not in doc:
        raise ValueError("crossover section is required at devices > 1")
    if "crossover" in doc:
        x = doc["crossover"]
        for key in ("row_max_qps", "batch_max_qps", "batch_vs_row"):
            if key not in x:
                raise ValueError(f"crossover missing {key!r}")
            if not isinstance(x[key], float) or x[key] <= 0:
                raise ValueError(f"crossover.{key} must be a positive "
                                 f"float, got {x[key]!r}")


# ---------------------------------------------------------------------------
# bench_accuracy/v1
# ---------------------------------------------------------------------------

BENCH_ACCURACY_SCHEMA = "bench_accuracy/v1"

ACCURACY_ROW_FIELDS = {
    "model": str,     # fasttucker | cutucker
    "variant": str,   # factor+core | factor_only | baseline
    "rank": int,      # J (per-mode factor rank)
    "rmse": float,
    "mae": float,
}
FACTOR_ONLY_SLACK = 1.02   # factor+core no worse than factor-only by > 2 %
CUTUCKER_SLACK = 1.10      # factor+core within 10 % of cuTucker's RMSE


def validate_bench_accuracy(doc: dict) -> None:
    """Raise ``ValueError`` unless ``doc`` is a valid BENCH_accuracy doc.

    Beyond the format, per rank: FastTucker factor+core must match or beat
    its factor-only ablation (slack 2 %) and stay within 10 % of the
    dense-core cuTucker baseline's RMSE (the paper's Kruskal-core
    approximation claim).  Every row must also beat the zero predictor
    (``config.value_rms``).
    """
    if not isinstance(doc, dict):
        raise ValueError(f"BENCH_accuracy document must be a dict, "
                         f"got {type(doc).__name__}")
    if doc.get("schema") != BENCH_ACCURACY_SCHEMA:
        raise ValueError(f"schema must be {BENCH_ACCURACY_SCHEMA!r}, "
                         f"got {doc.get('schema')!r}")
    cfg = doc.get("config")
    if not isinstance(cfg, dict):
        raise ValueError("missing config section")
    for key in ("dims", "nnz", "steps", "seed", "value_rms"):
        if key not in cfg:
            raise ValueError(f"config missing {key!r}")
    rows = doc.get("results")
    if not isinstance(rows, list) or not rows:
        raise ValueError("results must be a non-empty list")
    by_rank: dict[int, dict[str, dict]] = {}
    for i, r in enumerate(rows):
        for field, typ in ACCURACY_ROW_FIELDS.items():
            if field not in r:
                raise ValueError(f"results[{i}] missing {field!r}")
            if not isinstance(r[field], typ):
                raise ValueError(
                    f"results[{i}].{field} must be {typ.__name__}, "
                    f"got {type(r[field]).__name__}")
        if r["rmse"] <= 0 or r["mae"] <= 0:
            raise ValueError(f"results[{i}]: rmse/mae must be > 0")
        if r["rmse"] >= cfg["value_rms"]:
            raise ValueError(
                f"results[{i}]: rmse {r['rmse']} does not beat the "
                f"zero predictor ({cfg['value_rms']})")
        by_rank.setdefault(r["rank"], {})[
            f"{r['model']}/{r['variant']}"] = r
    for rank, rows_ in by_rank.items():
        fc = rows_.get("fasttucker/factor+core")
        fo = rows_.get("fasttucker/factor_only")
        cu = rows_.get("cutucker/baseline")
        if fc is None or fo is None or cu is None:
            raise ValueError(
                f"rank {rank}: needs fasttucker factor+core, "
                f"factor_only and cutucker baseline rows, "
                f"got {sorted(rows_)}")
        if fc["rmse"] > fo["rmse"] * FACTOR_ONLY_SLACK:
            raise ValueError(
                f"rank {rank}: factor+core rmse {fc['rmse']} worse than "
                f"factor_only {fo['rmse']} (>2%)")
        if fc["rmse"] > cu["rmse"] * CUTUCKER_SLACK:
            raise ValueError(
                f"rank {rank}: factor+core rmse {fc['rmse']} more than "
                f"10% above the cutucker baseline {cu['rmse']}")


# ---------------------------------------------------------------------------
# bench_convergence/v1
# ---------------------------------------------------------------------------

BENCH_CONVERGENCE_SCHEMA = "bench_convergence/v1"

# per-arm (cold / sketched) measurement fields
CONVERGENCE_ARM_FIELDS = {
    "reached": bool,            # hit target_rmse within horizon_steps
    "steps_to_target": int,     # first eval step at/below target
                                # (= horizon_steps when not reached)
    "wallclock_s_to_target": float,  # init + training wall to that step
    "init_s": float,            # init cost alone (warm: full sketch)
    "final_rmse": float,        # RMSE at the horizon
    "trajectory": list,         # [[step, rmse], ...] at eval cadence
}

CONVERGENCE_CONFIG_FIELDS = {
    "name": str,
    "backend": str,             # kernel backend
    "strategy": str,            # training strategy name
    "dims": list,
    "nnz": int,
    "rank": int,
    "core_rank": int,
    "batch": int,
    "seed": int,
    "target_rmse": float,
    "horizon_steps": int,
    "eval_every": int,
    "cold": dict,
    "sketched": dict,
    "speedup_vs_cold": float,           # cold steps / max(warm steps, 1)
    "wallclock_speedup_vs_cold": float,  # cold wall / warm wall to target
}
WARM_FINAL_SLACK = 1.05   # warm final RMSE within 5 % of cold's


def _validate_convergence_arm(arm, where: str) -> None:
    for field, typ in CONVERGENCE_ARM_FIELDS.items():
        if field not in arm:
            raise ValueError(f"{where} missing {field!r}")
        if not isinstance(arm[field], typ):
            raise ValueError(f"{where}.{field} must be {typ.__name__}, "
                             f"got {type(arm[field]).__name__}")
    traj = arm["trajectory"]
    if not traj:
        raise ValueError(f"{where}.trajectory must be non-empty")
    for p in traj:
        if (not isinstance(p, list) or len(p) != 2
                or not isinstance(p[0], int) or p[1] <= 0):
            raise ValueError(
                f"{where}.trajectory entries must be [step, rmse>0] "
                f"pairs, got {p!r}")
    if arm["final_rmse"] <= 0 or arm["wallclock_s_to_target"] <= 0:
        raise ValueError(f"{where}: final_rmse and wallclock must be > 0")


def validate_bench_convergence(doc: dict) -> None:
    """Raise ``ValueError`` unless ``doc`` is a valid BENCH_convergence doc.

    Beyond the format: a ``local`` and a ``strata*`` config on the
    document's backend (its first config's); in
    every config the warm start reaches the target (``sketched.reached``)
    in strictly fewer steps than cold, with ``speedup_vs_cold > 1``; its
    final RMSE is within 5 % of cold's; and on full (non-``smoke``)
    documents it also wins wall-clock, ``wallclock_speedup_vs_cold > 1``
    with the sketch's own ``init_s`` in its wall.  Cold may fail to reach
    the target inside the horizon (the decaying-LR plateau); its
    ``steps_to_target`` is then the horizon and the speedups are lower
    bounds.
    """
    if not isinstance(doc, dict):
        raise ValueError(f"BENCH_convergence document must be a dict, "
                         f"got {type(doc).__name__}")
    if doc.get("schema") != BENCH_CONVERGENCE_SCHEMA:
        raise ValueError(f"schema must be {BENCH_CONVERGENCE_SCHEMA!r}, "
                         f"got {doc.get('schema')!r}")
    smoke = bool(doc.get("smoke", False))
    configs = doc.get("configs")
    if not isinstance(configs, list) or not configs:
        raise ValueError("configs must be a non-empty list")
    seen = set()
    for i, c in enumerate(configs):
        for field, typ in CONVERGENCE_CONFIG_FIELDS.items():
            if field not in c:
                raise ValueError(f"configs[{i}] missing {field!r}")
            if not isinstance(c[field], typ):
                raise ValueError(
                    f"configs[{i}].{field} must be {typ.__name__}, "
                    f"got {type(c[field]).__name__}")
        _validate_convergence_arm(c["cold"], f"configs[{i}].cold")
        _validate_convergence_arm(c["sketched"], f"configs[{i}].sketched")
        warm, cold = c["sketched"], c["cold"]
        if not warm["reached"]:
            raise ValueError(
                f"configs[{i}]: sketched warm start must reach "
                f"target_rmse {c['target_rmse']} within the horizon "
                f"(got final {warm['final_rmse']})")
        if warm["steps_to_target"] >= cold["steps_to_target"]:
            raise ValueError(
                f"configs[{i}]: warm steps_to_target "
                f"{warm['steps_to_target']} must be < cold's "
                f"{cold['steps_to_target']}")
        if c["speedup_vs_cold"] <= 1.0:
            raise ValueError(
                f"configs[{i}].speedup_vs_cold must be > 1, "
                f"got {c['speedup_vs_cold']}")
        if warm["final_rmse"] > cold["final_rmse"] * WARM_FINAL_SLACK:
            raise ValueError(
                f"configs[{i}]: warm final_rmse {warm['final_rmse']} "
                f"worse than cold's {cold['final_rmse']} (>5%): the "
                f"speedup must not trade accuracy away")
        if not smoke and c["wallclock_speedup_vs_cold"] <= 1.0:
            raise ValueError(
                f"configs[{i}].wallclock_speedup_vs_cold must be > 1 on "
                f"full runs, got {c['wallclock_speedup_vs_cold']}")
        seen.add((c["backend"],
                  "strata" if c["strategy"].startswith("strata")
                  else c["strategy"]))
    backend = configs[0]["backend"]
    for need in ((backend, "local"), (backend, "strata")):
        if need not in seen:
            raise ValueError(
                f"configs must cover backend/strategy {need}, "
                f"got {sorted(seen)}")


# ---------------------------------------------------------------------------
# timing and CSV rows
# ---------------------------------------------------------------------------

def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_call(fn, *args, warmup: int = 2, iters: int = 5, **kw) -> float:
    """Median wall time per call in microseconds (each call closed by a
    ``torch.cuda.synchronize()``)."""
    for _ in range(warmup):
        fn(*args, **kw)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def row(name: str, us: float, derived: str = "") -> str:
    line = f"{name},{us:.1f},{derived}"
    print(line, flush=True)
    return line
