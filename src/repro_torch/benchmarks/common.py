"""Schema contracts of the port's benchmark documents.

``validate_bench_accuracy`` is the port's own copy of the reference's
``benchmarks.common.validate_bench_accuracy``: the same schema
(``bench_accuracy/v1``) and the same claims.
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
