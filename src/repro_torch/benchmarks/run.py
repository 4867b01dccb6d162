"""Benchmark harness of the port: one module per paper table or figure.

Counterpart of ``benchmarks/run.py`` for the names ported so far:

    PYTHONPATH=src python -m repro_torch.benchmarks.run \\
        [--only fig5,table13] [--device cpu]

prints ``name,us_per_call,derived`` CSV rows; ``--device`` reaches every
entry point.  ``fig7bc`` (``bench_multidev``) and ``ingest``
(``bench_ingest``) are the multi-device benchmarks, not ported yet: asking
for either exits non-zero before anything runs.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import traceback

# "module" (calls run()) or "module:function" for alternate entry points
MODULES = {
    "table13": "repro_torch.benchmarks.bench_sota_time",
    "step_sweep": "repro_torch.benchmarks.bench_sota_time:run_step_sweep",
    "fig5": "repro_torch.benchmarks.bench_param_sweep",
    "fig34": "repro_torch.benchmarks.bench_accuracy",
    "tbl8_12": "repro_torch.benchmarks.bench_kernel_blocks",
    "fig7a": "repro_torch.benchmarks.bench_order_scaling",
    "serve": "repro_torch.benchmarks.bench_serve",
    "lm_step": "repro_torch.benchmarks.bench_lm_step",
    "convergence": "repro_torch.benchmarks.bench_convergence",
}
# the reference's names whose benchmarks wait for the multi-device
# strategies
NOT_PORTED = {"fig7bc": "bench_multidev", "ingest": "bench_ingest"}


def entry(name: str):
    """The entry point a name runs."""
    mod_name, _, attr = MODULES[name].partition(":")
    return getattr(importlib.import_module(mod_name), attr or "run")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated names (default: every ported one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else list(MODULES)
    waiting = [n for n in names if n in NOT_PORTED]
    if waiting:
        what = ", ".join(f"{n} ({NOT_PORTED[n]})" for n in waiting)
        sys.exit(f"not ported yet: {what} — the multi-device benchmarks "
                 "wait for ROADMAP.md Queue 1 item 4 (b)")
    unknown = [n for n in names if n not in MODULES]
    if unknown:
        ap.error(f"unknown benchmark(s) {unknown}; known: {list(MODULES)}")

    print("name,us_per_call,derived", flush=True)
    failures = []
    for name in names:
        try:
            entry(name)(device=args.device)
        except Exception:  # noqa: BLE001 — reported, and the exit code says
            failures.append(name)
            traceback.print_exc()
    if failures:
        print(f"# FAILED benches: {failures}", file=sys.stderr)
        sys.exit(1)
    print("# all benches complete", flush=True)


if __name__ == "__main__":
    main()
