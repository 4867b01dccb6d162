"""Schema contracts of the port's benchmark documents.

``validate_bench_accuracy`` is the port's own copy of the reference's
``benchmarks.common.validate_bench_accuracy``: the same schema
(``bench_accuracy/v1``) and the same claims.  ``validate_bench_convergence``
is its copy of ``validate_bench_convergence`` (``bench_convergence/v1``),
with one difference: coverage asks for a ``local`` config only, on any
backend.  The reference also asks for a ``strata*`` config on ``xla``; the
port's strata strategies are not ported yet (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

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

    Beyond the format: at least one ``local`` config (any backend); in
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
        seen.add(c["strategy"])
    if "local" not in seen:
        raise ValueError(f"configs must cover strategy 'local', got "
                         f"{sorted(seen)}")
