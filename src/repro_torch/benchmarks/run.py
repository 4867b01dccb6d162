"""Benchmark harness of the port: one module per paper table or figure.

Counterpart of ``benchmarks/run.py``, under the reference's names:

    PYTHONPATH=src python -m repro_torch.benchmarks.run \\
        [--only fig5,table13] [--device cpu]

prints ``name,us_per_call,derived`` CSV rows; ``--device`` reaches every
entry point.  ``fig7bc`` (``bench_multidev``) and ``ingest``
(``bench_ingest``) run their workers on an in-process mesh on that device.
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
    "fig7bc": "repro_torch.benchmarks.bench_multidev",
    "ingest": "repro_torch.benchmarks.bench_ingest",
    "serve": "repro_torch.benchmarks.bench_serve",
    "lm_step": "repro_torch.benchmarks.bench_lm_step",
    "convergence": "repro_torch.benchmarks.bench_convergence",
}


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
