"""The port's benchmarks (counterparts of the repo's ``benchmarks/``), each
writing its own ``BENCH_torch_*.json`` document."""
