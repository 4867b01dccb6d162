"""The port's benchmarks, harness and examples against the reference's.

Each port validator (``validate_bench_step``, ``validate_bench_serve``,
``bench_refresh.validate``) is fed the same documents as the reference's
— valid ones and single mutations — and must accept or refuse alike, with
the same message.  The FULL/SMOKE constants, sweeps and fractions equal
the reference's; ``derive_step_summary`` and ``_stamp_speedups`` equal the
reference's on fed rows; each benchmark's ``--smoke`` runs on the CPU
through its validator, with the keys of the reference's smoke document
(the reference's runs once, in a module fixture).  Timing ratios are
asserted only through a validator where the CPU's margin is wide.  Also:
``run.py``'s dispatch and its refusal of ``fig7bc`` and ``ingest``, the
refusal of the reference's file names, both examples (the decompose one
stopped and resumed), the benchmark's one-hot scatter against
``index_add_``, ``register_backend``, and the serving tables built and
patched through the registry's ops.
"""
import ast
import copy
import inspect
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.benchmarks import (bench_kernel_blocks, bench_lm_step,
                                    bench_order_scaling, bench_param_sweep,
                                    bench_refresh, bench_serve,
                                    bench_sota_time, common, run)
from repro_torch.kernels import dispatch
from repro_torch.kernels import mode_product_rows as mpr

import benchmarks.bench_kernel_blocks as ref_blocks
import benchmarks.bench_order_scaling as ref_order
import benchmarks.bench_param_sweep as ref_sweep
import benchmarks.bench_refresh as ref_refresh
import benchmarks.bench_serve as ref_serve
import benchmarks.bench_sota_time as ref_sota
import benchmarks.common as ref_common
import benchmarks.run as ref_run


def _outcome(fn, doc):
    try:
        fn(copy.deepcopy(doc))
        return None
    except ValueError as e:
        return str(e)


def _agree(port_fn, ref_fn, doc):
    got, want = _outcome(port_fn, doc), _outcome(ref_fn, doc)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# validators against the reference's, on fed documents
# ---------------------------------------------------------------------------

def _step_doc():
    rows = [{"backend": b, "dtype": "float32", "update_order": "jacobi",
             "mode": m, "us_per_step": us}
            for b in ("cuda", "torch")
            for m, us in (("joint", 100.0), ("sorted", 80.0))]
    for r in rows:
        if r["mode"] != "joint":
            r["speedup_vs_joint"] = 1.25
    return {"schema": "bench_step/v3", "config": {
        "dims": [60, 50, 40], "nnz": 5000, "rank": 4, "core_rank": 4,
        "batch": 512}, "results": rows}


def _ingest():
    return {"rows": [{"nnz": 1000, "store": "memory", "prefetch_depth": 2,
                      "us_per_step_stream": 10.0, "us_per_step_sync": 12.0,
                      "us_per_stratum_load": 4.0,
                      "transfer_hidden_fraction": 0.5}]}


def _set(path, value):
    def f(d):
        node = d
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return f


def _drop(path):
    def f(d):
        node = d
        for k in path[:-1]:
            node = node[k]
        del node[path[-1]]
    return f


STEP_MUTATIONS = [
    ("ok", lambda d: None, True),
    ("v2", _set(("schema",), "bench_step/v2"), True),
    ("schema", _set(("schema",), "bench_step/v1"), False),
    ("ingest_ok", _set(("ingest",), _ingest()), True),
    ("v2_ingest", lambda d: d.update(schema="bench_step/v2",
                                     ingest=_ingest()), False),
    ("ingest_fraction", lambda d: d.update(ingest=dict(rows=[dict(
        _ingest()["rows"][0], transfer_hidden_fraction=1.5)])), False),
    ("ingest_empty", _set(("ingest",), {"rows": []}), False),
    ("no_config", _drop(("config",)), False),
    ("config_batch", _drop(("config", "batch")), False),
    ("results_empty", _set(("results",), []), False),
    ("row_no_mode", _drop(("results", 0, "mode")), False),
    ("row_us_int", _set(("results", 0, "us_per_step"), 100), False),
    ("row_us_zero", _set(("results", 2, "us_per_step"), 0.0), False),
    ("no_speedup", _drop(("results", 1, "speedup_vs_joint")), False),
    ("speedup_neg", _set(("results", 1, "speedup_vs_joint"), -1.0), False),
    ("not_dict", None, False),
]


@pytest.mark.parametrize("name,mutate,valid", STEP_MUTATIONS,
                         ids=[m[0] for m in STEP_MUTATIONS])
def test_validate_bench_step_agrees_with_reference(name, mutate, valid):
    doc = _step_doc()
    if mutate is None:
        doc = [doc]
    else:
        mutate(doc)
    msg = _agree(common.validate_bench_step,
                 ref_common.validate_bench_step, doc)
    assert (msg is None) == valid


def _serve_doc(devices=1):
    doc = {"schema": "bench_serve/v1",
           "config": {"dims": [120, 90, 30], "rank": 4, "core_rank": 4,
                      "backend": "cuda", "devices": devices,
                      "microbatch": 64},
           "throughput": {"per_query_qps": 1000.0, "bucketed_qps": 1e6,
                          "speedup": 1000.0, "sweep_compiles": 7,
                          "ladder_bound": 9},
           "closed_loop": {"rows": [{
               "shard_mode": "none", "query": "predict",
               "offered_qps": 2000.0, "achieved_qps": 1900.0,
               "p50_ms": 1.0, "p99_ms": 3.0, "served_requests": 100,
               "shed": 0}]}}
    if devices > 1:
        doc["collectives"] = {"devices": devices, "bucket": 64, "k": 5,
                              "sharded_operand_bytes": 100,
                              "gspmd_operand_bytes": 1000,
                              "reduction": 10.0}
        doc["crossover"] = {"row_max_qps": 1.0, "batch_max_qps": 2.0,
                            "batch_vs_row": 2.0}
    return doc


SERVE_MUTATIONS = [
    ("ok", 1, lambda d: None, True),
    ("ok_multi", 4, lambda d: None, True),
    ("schema", 1, _set(("schema",), "bench_serve/v0"), False),
    ("no_throughput", 1, _drop(("throughput",)), False),
    ("config_devices", 1, _drop(("config", "devices")), False),
    ("thr_ladder", 1, _drop(("throughput", "ladder_bound")), False),
    ("speedup_zero", 1, _set(("throughput", "speedup"), 0.0), False),
    ("unbounded", 1, _set(("throughput", "sweep_compiles"), 10), False),
    ("at_bound", 1, _set(("throughput", "sweep_compiles"), 9), True),
    ("rows_empty", 1, _set(("closed_loop", "rows"), []), False),
    ("row_no_shed", 1, _drop(("closed_loop", "rows", 0, "shed")), False),
    ("row_qps_int", 1, _set(("closed_loop", "rows", 0, "achieved_qps"),
                            1900), False),
    ("p50_gt_p99", 1, _set(("closed_loop", "rows", 0, "p50_ms"), 5.0),
     False),
    ("multi_no_collectives", 4, _drop(("collectives",)), False),
    ("reduction_one", 4, _set(("collectives", "reduction"), 1.0), False),
    ("bytes_zero", 4, _set(("collectives", "sharded_operand_bytes"), 0),
     False),
    ("multi_no_crossover", 4, _drop(("crossover",)), False),
    ("crossover_int", 4, _set(("crossover", "batch_vs_row"), 2), False),
    ("single_with_collectives", 1, lambda d: d.update(
        collectives=_serve_doc(4)["collectives"]), True),
]


@pytest.mark.parametrize("name,devices,mutate,valid", SERVE_MUTATIONS,
                         ids=[m[0] for m in SERVE_MUTATIONS])
def test_validate_bench_serve_agrees_with_reference(name, devices, mutate,
                                                    valid):
    doc = _serve_doc(devices)
    mutate(doc)
    msg = _agree(common.validate_bench_serve, ref_common.validate_bench_serve,
                 doc)
    assert (msg is None) == valid


def _refresh_doc():
    return {"schema": "bench_refresh/v1", "rows": [
        {"dirty_fraction": f, "dirty_rows": int(600 * f * 100),
         "patch_ms": 0.1, "rebuild_ms": 0.3, "speedup": 3.0}
        for f in (0.01, 0.1, 0.25)],
        "supervised": {"rounds": 5, "clean_round_ms": 3.0,
                       "faulted_round_ms": 20.0, "faults_injected": 3,
                       "breaker_trips": 1, "recoveries": 1}}


REFRESH_MUTATIONS = [
    ("ok", lambda d: None, True),
    ("no_supervised", _drop(("supervised",)), True),
    ("schema", _set(("schema",), "bench_refresh/v0"), False),
    ("rows_empty", _set(("rows",), []), False),
    ("rows_int_fraction", _set(("rows", 0, "dirty_rows"), 6.0), False),
    ("patch_zero", _set(("rows", 0, "patch_ms"), 0.0), False),
    ("loses_at_10pct", _set(("rows", 1, "speedup"), 0.9), False),
    ("ties_at_1pct", _set(("rows", 0, "speedup"), 1.0), False),
    ("loses_at_25pct", _set(("rows", 2, "speedup"), 0.5), True),
    ("sup_field", _drop(("supervised", "recoveries")), False),
    ("sup_rounds", _set(("supervised", "rounds"), 0), False),
    ("sup_outage", _set(("supervised", "recoveries"), 0), False),
]


@pytest.mark.parametrize("name,mutate,valid", REFRESH_MUTATIONS,
                         ids=[m[0] for m in REFRESH_MUTATIONS])
def test_refresh_validate_agrees_with_reference(name, mutate, valid):
    doc = _refresh_doc()
    mutate(doc)
    msg = _agree(bench_refresh.validate, ref_refresh.validate, doc)
    assert (msg is None) == valid


# ---------------------------------------------------------------------------
# constants, sweeps and the summary functions
# ---------------------------------------------------------------------------

def test_schemas_and_field_tables_are_the_reference_ones():
    for name in ("BENCH_STEP_SCHEMA", "BENCH_STEP_SCHEMA_V2",
                 "BENCH_STEP_ROW_FIELDS", "BENCH_STEP_SPEEDUP_FIELD",
                 "INGEST_ROW_FIELDS", "BENCH_SERVE_SCHEMA",
                 "SERVE_CLOSED_LOOP_ROW_FIELDS", "SERVE_COLLECTIVE_FIELDS"):
        assert getattr(common, name) == getattr(ref_common, name), name


def test_refresh_constants_are_the_reference_ones():
    for name in ("SCHEMA", "FULL", "SMOKE", "FRACTIONS",
                 "CONTRACT_MAX_FRACTION", "SUP_FULL", "SUP_SMOKE"):
        assert getattr(bench_refresh, name) == getattr(ref_refresh, name)


def test_serve_and_sota_constants_are_the_reference_ones():
    assert bench_serve.FULL == ref_serve.FULL
    assert bench_serve.SMOKE == ref_serve.SMOKE
    assert bench_serve.DEVICES == ref_serve.DEVICES
    for name in ("DIMS", "NNZ", "J", "BATCH", "SWEEP_DIMS", "SWEEP_NNZ",
                 "SWEEP_J", "SWEEP_BATCH", "SMOKE_DIMS", "SMOKE_NNZ",
                 "SMOKE_J", "SMOKE_BATCH", "FUSED_STEP_MODES"):
        assert getattr(bench_sota_time, name) == getattr(ref_sota, name)
    # Table 13's J sweep and the reference's two backends, in their places
    assert f"for Jx in {bench_sota_time.TABLE13_J}" in inspect.getsource(
        ref_sota.run)
    assert 'backends = ("xla", "pallas_interpret")' in inspect.getsource(
        ref_sota.run_step_sweep)
    assert bench_sota_time.SWEEP_BACKENDS == ("cuda", "torch")
    assert bench_sota_time.SMOKE_BACKENDS == ("torch",)


def test_scaling_sweeps_are_the_reference_ones():
    assert (bench_param_sweep.DIMS, bench_param_sweep.NNZ,
            bench_param_sweep.BATCH) == (ref_sweep.DIMS, ref_sweep.NNZ,
                                         ref_sweep.BATCH)
    src = inspect.getsource(ref_sweep.run)
    assert f"for J in {bench_param_sweep.J_SWEEP}" in src
    assert f"for R in {bench_param_sweep.R_SWEEP}" in src
    assert f"for J in {bench_param_sweep.FULL_CORE_J}" in src
    assert (bench_order_scaling.J, bench_order_scaling.BATCH) == (
        ref_order.J, ref_order.BATCH)
    src = inspect.getsource(ref_order.run)
    assert f"for order in {bench_order_scaling.ORDERS}" in src
    assert f"for order in {bench_order_scaling.FULL_CORE_ORDERS}" in src
    assert f"({bench_order_scaling.PER_MODE},) * order" in src
    assert f"{bench_order_scaling.NNZ:_}" in src
    assert (bench_kernel_blocks.N, bench_kernel_blocks.B,
            bench_kernel_blocks.J, bench_kernel_blocks.R) == (
        ref_blocks.N, ref_blocks.B, ref_blocks.J, ref_blocks.R)
    assert "B, Ss = 4, 64" in inspect.getsource(
        __import__("benchmarks.bench_lm_step").bench_lm_step.run)
    assert (bench_lm_step.B, bench_lm_step.SEQ) == (4, 64)


def _fed_rows(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for backend in ("cuda", "torch"):
        for dtype in ("float32", "bfloat16"):
            for order, modes in (
                    ("jacobi", ("joint", "phase_split", "sorted",
                                "onehot_scatter", "two_phase",
                                "two_phase_cached")),
                    ("gauss_seidel", ("joint", "phase_split", "sorted"))):
                for mode in modes:
                    rows.append({"backend": backend, "dtype": dtype,
                                 "update_order": order, "mode": mode,
                                 "us_per_step": float(rng.uniform(50,
                                                                  900))})
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_summary_functions_equal_the_reference(seed):
    rows = _fed_rows(seed)
    port, ref = copy.deepcopy(rows), copy.deepcopy(rows)
    bench_sota_time._stamp_speedups(port)
    ref_sota._stamp_speedups(ref)
    assert port == ref
    assert (bench_sota_time.derive_step_summary(port)
            == ref_sota.derive_step_summary(ref))


# ---------------------------------------------------------------------------
# smoke runs on the CPU, against the reference's smoke documents' keys
# ---------------------------------------------------------------------------

def _keys(d):
    return sorted(d)


@pytest.fixture(scope="module")
def ref_smoke():
    """The reference's smoke documents (bench_serve's measure in-process:
    one device, so no subprocess)."""
    docs = {"refresh": ref_refresh.measure(True),
            "step": ref_sota.run_step_sweep(smoke=True, out_path=None)}
    real = ref_serve._run_child
    ref_serve._run_child = lambda smoke, devices: ref_serve.measure(smoke)
    try:
        docs["serve"] = ref_serve.run(smoke=True)
    finally:
        ref_serve._run_child = real
    return docs


def test_step_sweep_smoke_matches_reference_keys(ref_smoke, tmp_path):
    out = tmp_path / bench_sota_time.OUT_NAME
    doc = bench_sota_time.main(["--step-sweep", "--smoke", "--device", "cpu",
                                "--out", str(out)])
    common.validate_bench_step(json.loads(out.read_text()))
    ref = ref_smoke["step"]
    assert _keys(doc) == _keys(ref)
    assert _keys(doc["config"]) == _keys(ref["config"])
    assert doc["config"]["platform"] == "cpu"
    port_rows = {(r["update_order"], r["mode"]): _keys(r)
                 for r in doc["results"]}
    ref_rows = {(r["update_order"], r["mode"]): _keys(r)
                for r in ref["results"]}
    assert port_rows == ref_rows
    assert {r["backend"] for r in doc["results"]} == {"torch"}
    assert ({k.replace("/torch/", "/B/") for k in doc["derived"]}
            == {k.replace("/xla/", "/B/") for k in ref["derived"]})


def test_serve_smoke_matches_reference_keys(ref_smoke, tmp_path):
    out = tmp_path / bench_serve.OUT_NAME
    doc = bench_serve.main(["--smoke", "--device", "cpu", "--devices", "1",
                            "--out", str(out)])
    common.validate_bench_serve(json.loads(out.read_text()))
    ref = ref_smoke["serve"]
    assert _keys(doc) == _keys(ref)
    for key in ("config", "throughput"):
        assert _keys(doc[key]) == _keys(ref[key])
    assert (_keys(doc["closed_loop"]["rows"][0])
            == _keys(ref["closed_loop"]["rows"][0]))
    assert doc["config"]["devices"] == 1
    assert doc["throughput"]["sweep_compiles"] \
        <= doc["throughput"]["ladder_bound"]


def test_serve_smoke_at_four_workers_validates():
    """``bench_serve`` SMOKE at devices 4 on the CPU (four in-process
    workers): the document it returns passes the reference's validator
    as ported, with the reference's multi-device sections — collectives
    (the shard-local merge's bytes below the score gather's), the row,
    batch and baseline closed-loop rows, and the crossover."""
    doc = bench_serve.run(smoke=True, device="cpu", devices=4)
    common.validate_bench_serve(doc)
    assert doc["config"]["devices"] == 4
    col = doc["collectives"]
    assert col["devices"] == 4 and col["bucket"] == bench_serve.SMOKE[
        "microbatch"] and col["k"] == bench_serve.SMOKE["k"]
    assert 0 < col["sharded_operand_bytes"] < col["gspmd_operand_bytes"]
    assert "all-gathered" in col["baseline"]
    got = {(r["shard_mode"], r["query"], r["offered_qps"])
           for r in doc["closed_loop"]["rows"]}
    qps = bench_serve.SMOKE["predict_qps"][0]
    tk = bench_serve.SMOKE["top_k_qps"]
    assert got == {("none", "predict", qps), ("row", "predict", qps),
                   ("batch", "predict", qps), ("row", "top_k", tk),
                   ("gspmd", "top_k", tk)}
    x = doc["crossover"]
    assert x["batch_vs_row"] == x["batch_max_qps"] / x["row_max_qps"]


def test_serve_sweep_counts_the_buckets_it_launched():
    """``sweep_compiles`` is read from the server's chunks: the distinct
    bucket sizes of the 1→512 sweep, which ``split_batch`` gives for those
    request sizes."""
    from repro_torch.core import fasttucker as ft
    from repro_torch.serve import TuckerServer, split_batch

    cfg = ft.FastTuckerConfig(dims=(30, 20, 10), ranks=(4,) * 3,
                              core_rank=4, backend="torch")
    srv = TuckerServer(ft.init_params(torch.Generator().manual_seed(0), cfg,
                                      "cpu"), backend="torch")
    q = np.zeros((512, 3), np.int32)
    got = bench_serve.sweep_bucket_lengths(srv, q)
    sizes = [b for b in range(1, 513)
             if b in (1, 2, 3, 5, 7) or b % 16 == 0 or b in (511, 512)]
    assert got == {bucket for b in sizes
                   for _, bucket in split_batch(b, srv.ladder)}
    assert len(got) <= len(srv.ladder)
    assert "_bucketed_chunks" not in vars(srv)   # the hook is gone


def test_refresh_smoke_matches_reference_keys(ref_smoke, tmp_path):
    out = tmp_path / bench_refresh.OUT_NAME
    doc = bench_refresh.main(["--smoke", "--supervised", "--device", "cpu",
                              "--out", str(out)])
    bench_refresh.validate(json.loads(out.read_text()))
    ref = ref_smoke["refresh"]
    assert _keys(doc) == _keys(dict(ref, supervised=None))
    assert _keys(doc["config"]) == _keys(dict(ref["config"], backend=None))
    assert [_keys(r) for r in doc["rows"]] == [_keys(r) for r in ref["rows"]]
    assert [r["dirty_fraction"] for r in doc["rows"]] == list(
        ref_refresh.FRACTIONS)
    # the supervised section's keys, read from the reference's source
    tree = ast.parse(inspect.getsource(ref_refresh.measure_supervised))
    sec = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", "") == "sec")
    assert _keys(doc["supervised"]) == sorted(k.value for k in sec.keys)
    assert doc["supervised"]["recoveries"] >= 1


@pytest.mark.parametrize("bench,sweeps", [
    (bench_param_sweep, {"J": 4, "R": 4, "full": 3}),
    (bench_order_scaling, {"fast": 6, "full": 4})])
def test_scaling_smoke_rows(bench, sweeps, capsys):
    lines = bench.run(smoke=True, device="cpu", backend="torch")
    names = [ln.rsplit(",", 2)[0] for ln in lines]
    ref_names = [n for _, n, _ in bench.points(True, "cpu", "torch")]
    assert names == ref_names and len(names) == sum(sweeps.values())
    firsts = [ln for ln in lines if ln.endswith(",")]
    assert len(firsts) == len(sweeps)     # one growth-free row a sweep
    tag = "vs_prev" if bench is bench_param_sweep else "vs_prev_order"
    assert all(ln.endswith(f"_{tag}") for ln in lines if ln not in firsts)
    assert capsys.readouterr().out.splitlines() == lines


def test_table13_smoke_rows():
    lines = bench_sota_time.run(smoke=True, device="cpu", backend="torch")
    names = [ln.rsplit(",", 2)[0] for ln in lines]
    src = inspect.getsource(ref_sota.run)
    for n in names:     # the reference's row names
        stem = n.split("/", 1)[1].split("_J")[0]
        assert stem in src, n
    assert len(names) == 2 * 3 + 3
    assert all(float(ln.rsplit(",", 2)[1]) > 0 for ln in lines)


def test_fusion_and_lm_step_rows():
    fusion = bench_kernel_blocks.run(device="cpu")
    assert [ln.rsplit(",", 2)[0] for ln in fusion] == [
        "fusion/unfused_contract+torch_grads", "fusion/fused_kruskal_grad",
        "fusion/batch_gradients_kruskal_grad_launches"]
    # on the CPU the wrappers take their plain paths and count nothing
    assert fusion[-1].endswith("plain_path_on_cpu;launches_not_counted")
    assert bench_kernel_blocks.batch_gradients_launches(
        torch.device("cpu")) == {k: 0 for k in dispatch_counts()}
    lm = bench_lm_step.run(device="cpu", backend="torch")
    from repro_torch.configs import PORTED_ARCHS
    assert [ln.rsplit(",", 2)[0] for ln in lm] == [
        f"lm_step/{arch}" for arch in PORTED_ARCHS]


def dispatch_counts():
    from repro_torch.kernels import launch_counts
    return launch_counts()


# ---------------------------------------------------------------------------
# the harness and the reference names
# ---------------------------------------------------------------------------

def test_run_modules_are_the_reference_ones_ported():
    ported = {k: v.replace("benchmarks.", "repro_torch.benchmarks.", 1)
              for k, v in ref_run.MODULES.items()}
    assert run.MODULES == ported
    assert list(run.MODULES) == list(ref_run.MODULES)
    assert {"fig7bc", "ingest"} <= set(run.MODULES)
    for name in run.MODULES:
        assert callable(run.entry(name))


@pytest.mark.parametrize("name", ["fig7bc", "ingest"])
def test_run_refuses_the_multi_device_benchmarks(name, monkeypatch, capsys):
    """The multi-device benchmarks, once refused, dispatch with their
    device like every other name."""
    seen = []
    monkeypatch.setattr(run, "entry", lambda n: lambda device=None:
                        seen.append((n, device)))
    run.main(["--only", f"fig5,{name}", "--device", "cpu"])
    assert seen == [("fig5", "cpu"), (name, "cpu")]
    assert capsys.readouterr().out.splitlines()[-1] == \
        "# all benches complete"


def test_committed_step_document_carries_the_ingest_sweep():
    """``BENCH_torch_step.json`` as ``chip_smoke.py``'s phase 22 left it: a
    v3 document whose ``ingest`` section holds both FULL points, the
    resident run skipped past the budget at 10^7 nonzeros and the
    store-fed states bitwise the resident one at 10^6."""
    import json
    from pathlib import Path

    from repro_torch.benchmarks import bench_ingest
    from repro_torch.benchmarks.common import validate_bench_step

    doc = json.loads((Path(__file__).resolve().parents[1]
                      / "BENCH_torch_step.json").read_text())
    validate_bench_step(doc)
    assert doc["schema"] == "bench_step/v3" and not doc["ingest"]["smoke"]
    small, big = doc["ingest"]["rows"]
    assert [r["nnz"] for r in (small, big)] == [
        p["nnz"] for p in bench_ingest.FULL_POINTS]
    assert small["stream_bitwise_resident"] is True
    assert big["us_per_step_resident"] is None and big["resident_skipped"]


def test_committed_convergence_document_covers_local_and_strata():
    import json
    from pathlib import Path

    from repro_torch.benchmarks.common import validate_bench_convergence

    doc = json.loads((Path(__file__).resolve().parents[1]
                      / "BENCH_torch_convergence.json").read_text())
    validate_bench_convergence(doc)
    assert not doc["smoke"] and doc["devices"] == 2
    assert [(c["name"], c["backend"]) for c in doc["configs"]] == [
        ("planted_local", "cuda"), ("planted_strata", "cuda")]


def test_run_dispatches_with_its_device(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(run, "entry", lambda name: lambda device=None:
                        seen.append((name, device)))
    run.main(["--only", "fig5,tbl8_12,step_sweep", "--device", "cpu"])
    assert seen == [("fig5", "cpu"), ("tbl8_12", "cpu"),
                    ("step_sweep", "cpu")]
    assert capsys.readouterr().out.splitlines()[-1] == \
        "# all benches complete"
    with pytest.raises(SystemExit):
        run.main(["--only", "nope"])


def test_run_reports_a_failing_benchmark(monkeypatch):
    def boom(device=None):
        raise RuntimeError("boom")
    monkeypatch.setattr(run, "entry", lambda name: boom)
    with pytest.raises(SystemExit) as e:
        run.main(["--only", "fig5"])
    assert e.value.code == 1


@pytest.mark.parametrize("runner,ref_name", [
    (lambda p: bench_sota_time.run_step_sweep(True, p, "cpu"),
     "BENCH_step.json"),
    (lambda p: bench_serve.run(True, p, "cpu"), "BENCH_serve.json"),
    (lambda p: bench_refresh.run(True, out_path=p, device="cpu"),
     "BENCH_refresh.json")])
def test_reference_names_are_refused(runner, ref_name, tmp_path):
    with pytest.raises(ValueError, match="BENCH_torch_"):
        runner(str(tmp_path / ref_name))
    assert not (tmp_path / ref_name).exists()


# ---------------------------------------------------------------------------
# the benchmark's one-hot backend and register_backend
# ---------------------------------------------------------------------------

def test_onehot_scatter_equals_index_add():
    rng = np.random.default_rng(3)
    g = torch.tensor(rng.standard_normal((777, 8)), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, 50, 777), dtype=torch.int32)
    got = bench_sota_time._TorchOneHotBackend().scatter_accum(g, idx, 50)
    want = torch.zeros((50, 8)).index_add_(0, idx.long(), g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # ids outside the rows are dropped, as segment_sum drops them
    bad = idx.clone()
    bad[:5] = torch.tensor([-1, 50, 51, -7, 99], dtype=torch.int32)
    keep = (bad >= 0) & (bad < 50)
    torch.testing.assert_close(
        bench_sota_time._TorchOneHotBackend().scatter_accum(g, bad, 50),
        torch.zeros((50, 8)).index_add_(0, bad[keep].long(), g[keep]),
        rtol=1e-5, atol=1e-5)
    bench_sota_time._ensure_onehot_backend()
    bench_sota_time._ensure_onehot_backend()     # idempotent
    assert "torch_onehot" in dispatch.available_backends()


def test_register_backend_refuses_an_existing_name(monkeypatch):
    monkeypatch.setattr(dispatch, "_REGISTRY", dict(dispatch._REGISTRY))

    class Dummy(dispatch.TorchBackend):
        name = "dummy"

    first = Dummy()
    dispatch.register_backend(first)
    assert dispatch.get_backend("dummy") is first
    with pytest.raises(ValueError, match="already registered"):
        dispatch.register_backend(Dummy())
    with pytest.raises(ValueError, match="already registered"):
        dispatch.register_backend(dispatch.TorchBackend())
    # a refusal leaves the registered backend in place
    assert dispatch.get_backend("dummy") is first
    assert isinstance(dispatch.get_backend("torch"), dispatch.TorchBackend)


# ---------------------------------------------------------------------------
# the serving tables through the registry, and their kernels' plain paths
# ---------------------------------------------------------------------------

def test_server_builds_and_patches_through_the_registry(monkeypatch):
    """``TuckerServer`` builds its tables with the backend's
    ``mode_product_rows`` (one call a mode) and patches with its
    ``patch_table_rows`` (one call an ``update_rows``)."""
    from repro_torch.core import fasttucker as ft
    from repro_torch.serve import TuckerServer

    calls = []
    for name in ("mode_product_rows", "patch_table_rows"):
        real = getattr(dispatch.CudaBackend, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(dispatch.CudaBackend, name, counted)
    cfg = ft.FastTuckerConfig(dims=(40, 30, 20), ranks=(4,) * 3,
                              core_rank=4, backend="cuda")
    srv = TuckerServer(ft.init_params(torch.Generator().manual_seed(1), cfg,
                                      "cpu"), backend="cuda")
    assert calls == ["mode_product_rows"] * 3
    calls.clear()
    srv.update_rows(1, [3, 7, 9], np.ones((3, 4), np.float32))
    assert calls == ["patch_table_rows"]
    calls.clear()
    srv.refresh_tables()
    assert calls == ["mode_product_rows"] * 3


def test_mode_product_rows_plain_path_against_the_reference():
    from repro.core.kruskal import mode_products

    rng = np.random.default_rng(5)
    a = rng.standard_normal((301, 48)).astype(np.float32)
    b = rng.standard_normal((48, 48)).astype(np.float32)
    got = mpr.mode_product_rows(torch.tensor(a), torch.tensor(b))
    want = np.asarray(mode_products([jnp.asarray(a)], [jnp.asarray(b)])[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the same bits for a row alone and among the others
    assert torch.equal(got[7:8], mpr.mode_product_rows(
        torch.tensor(a[7:8]), torch.tensor(b)))


def test_patch_table_rows_plain_path_against_the_reference_patch():
    """The plain patch against the reference server's jitted patch on the
    same table, colsum and rows."""
    from repro.core.fasttucker import FastTuckerParams as JParams
    from repro.serve import TuckerServer as JServer

    rng = np.random.default_rng(6)
    I, J, R, K = 200, 6, 5, 37
    facs = [rng.standard_normal((d, J)).astype(np.float32)
            for d in (I, 30, 20)]
    cores = [rng.standard_normal((J, R)).astype(np.float32)
             for _ in range(3)]
    jsrv = JServer(JParams(tuple(map(jnp.asarray, facs)),
                           tuple(map(jnp.asarray, cores))), backend="xla")
    ids = np.sort(rng.permutation(I)[:K]).astype(np.int32)
    new = rng.standard_normal((K, J)).astype(np.float32)
    table = torch.tensor(np.asarray(jsrv._tables[0]))
    colsum = torch.tensor(np.asarray(jsrv._colsums[0]))
    mirror = torch.tensor(facs[0])
    frozen = table.clone()
    t, c = mpr.patch_table_rows(table, colsum, mirror, torch.tensor(cores[0]),
                                ids, torch.tensor(new))
    jt, jc = jsrv._patch_fn(jsrv._tables[0], jsrv._colsums[0], ids, new,
                            facs[0][ids], np.ones(K, bool), cores[0])
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(table, frozen)                 # the live table
    np.testing.assert_array_equal(mirror.numpy()[ids], new)


@pytest.mark.parametrize("J,R", [(4, 4), (8, 3), (48, 48), (64, 64),
                                 (1, 64), (64, 1)])
@pytest.mark.parametrize("patch", [False, True])
def test_mode_product_rows_plan_fits(J, R, patch):
    """Every tile plan covers the rows, keeps its blocks under its route's
    cap, and fits a block's shared memory (a patch's without an opt-in)."""
    for M in (1, 7, 600, 60_000, 480_189):
        p = mpr.plan(M, J, R, patch=patch)
        per = p.rows_per_block or p.rows_per_tile
        covered = p.blocks * per if p.rows_per_block else p.tiles * per
        assert covered >= M > covered - per
        cap = (mpr.MAX_BLOCKS if patch else mpr.NARROW_BLOCKS
               if p.route == "narrow" else mpr.BUILD_BLOCKS)
        assert 1 <= p.blocks <= min(p.tiles, cap)
        assert p.smem <= (mpr.SMEM_DEFAULT if patch else mpr.SMEM_MAX)
    with pytest.raises(ValueError, match="J, R <= 64"):
        mpr.plan(10, 65, 4)


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def test_decompose_example_stops_and_resumes(tmp_path, capsys):
    from repro_torch.examples import decompose_ratings

    small = ["--dims", "240,89,11", "--nnz", "20000", "--batch", "512",
             "--eval-every", "40", "--device", "cpu", "--backend", "torch"]
    first = decompose_ratings.main(small + ["--steps", "40", "--ckpt-dir",
                                            str(tmp_path / "a")])
    assert first["start"] == 0 and len(first["history"]) == 1
    resumed = decompose_ratings.main(small + ["--steps", "80", "--ckpt-dir",
                                              str(tmp_path / "a")])
    assert resumed["start"] == 40
    assert "resumed from step 40" in capsys.readouterr().out
    whole = decompose_ratings.main(small + ["--steps", "80", "--ckpt-dir",
                                            str(tmp_path / "b")])
    for a, b in zip(resumed["state"].params.factors
                    + resumed["state"].params.core_factors,
                    whole["state"].params.factors
                    + whole["state"].params.core_factors):
        assert torch.equal(a, b)
    assert resumed["history"][-1] == whole["history"][-1]
    assert np.isfinite(whole["cutucker_rmse"])


def test_serve_batched_example_runs():
    from repro_torch.examples import serve_batched

    res = serve_batched.main(["--device", "cpu", "--backend", "torch",
                              "--steps", "100"])
    assert res["rmse"] < res["zero_rmse"]
    assert res["items"].shape == (3, 5) and np.isfinite(res["scores"]).all()


def test_no_port_benchmark_imports_jax():
    mods = [m for n, m in sys.modules.items()
            if n.startswith("repro_torch.benchmarks")
            or n.startswith("repro_torch.examples")]
    for m in mods:
        src = inspect.getsource(m)
        assert "import jax" not in src and "from repro." not in src, m
