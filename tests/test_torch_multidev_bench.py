"""The port's multi-device benchmarks against the live reference.

``bench_multidev`` (Fig. 7b/c) at its own FULL shape (1024 × 768 × 512,
100,000 nonzeros, J = R = 8, global batch 8192) on CPU workers, held
against the reference's ``benchmarks.bench_multidev._run_for(M)`` (its
compiled step's HLO, in its own subprocesses); ``collectives.Traffic``'s
rules; ``bench_ingest --smoke`` and ``attach_ingest``; the multipod
example at 8 workers.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import bench_ingest, bench_multidev, bench_sota_time
from repro_torch.benchmarks.common import _validate_ingest, validate_bench_step
from repro_torch.core import fasttucker as ft
from repro_torch.core.cost import (core_update_flops, kruskal_grad_cost,
                                   step_flops)
from repro_torch.distributed import base, collectives
from repro_torch.launch.mesh import make_host_mesh

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
STRATEGIES = ("local", "strata", "strata_overlap", "sync")
BIT_OPS = ("xor", "or", "shift-left", "shift-right-logical")

# the reference's step HLO again, its integer bit operations tallied per
# strategy a step, by hlo_analysis' own walk (fusions, calls, loop trips)
_BIT_OPS_SNIPPET = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={M}"
import json, re
import jax
from repro.core import FastTuckerConfig, init_state
from repro.data.synthetic import planted_tensor
from repro.distributed import available_strategies, get_strategy
from repro.launch import hlo_analysis as H
from repro.launch.mesh import make_host_mesh

BITS = {bits!r}
CALLS = r"(?:calls|to_apply|body|condition|true_computation|" \\
        r"false_computation)=\\{{?%([\\w\\.\\-]+)"

def walk(mod, comp, mult, acc):
    for line in mod.computations.get(comp, []):
        im = H._INSTR_RE.match(line)
        if not im:
            continue
        rhs = im.group(2)
        om = re.search(r"\\s([a-z][\\w\\-]*)\\(", rhs)
        if not om:
            continue
        op = om.group(1)
        if op in BITS:
            acc[0] += mult * H._shape_elems(rhs.split(f" {{op}}(", 1)[0])[0]
        elif op in ("fusion", "call", "custom-call", "async-start"):
            cm = re.search(r"(?:to_apply|calls|called_computations)="
                           r"\\{{?%([\\w\\.\\-]+)", rhs)
            if cm:
                walk(mod, cm.group(1), mult, acc)
        elif op == "while":
            tm = H._TRIP_RE.search(rhs)
            trips = int(tm.group(1)) if tm else 1
            for k in ("body", "condition"):
                bm = re.search(k + r"=%([\\w\\.\\-]+)", rhs)
                if bm:
                    walk(mod, bm.group(1), mult * trips, acc)
        elif op == "conditional":
            for cm in re.finditer(r"(?:true_computation|false_computation|"
                                  r"branch_computations=\\{{)%([\\w\\.\\-]+)",
                                  rhs):
                walk(mod, cm.group(1), mult, acc)

dims = (1024, 768, 512)
t = planted_tensor(dims, 100_000, seed=0)
cfg = FastTuckerConfig(dims=dims, ranks=(8,)*3, core_rank=8,
                       batch_size=8192 // {M})
mesh = make_host_mesh()
out = {{}}
for name in available_strategies():
    st = get_strategy(name)
    plan = st.prepare(t, cfg, mesh if st.needs_mesh else None, seed=0)
    ds = st.init(plan, init_state(jax.random.PRNGKey(0), cfg),
                 jax.random.PRNGKey(1))
    with mesh:
        txt = st.lower_step(plan, ds).compile().as_text()
    mod = H.HloModule(txt)
    called = set()
    for lines in mod.computations.values():
        for ln in lines:
            called.update(re.findall(CALLS, ln))
    roots = [c for c in mod.computations if c not in called]
    entry = max(roots, key=lambda r: mod.cost(r).flops)
    acc = [0.0]
    walk(mod, entry, 1, acc)
    out[name] = acc[0] / st.steps_per_call(plan)
print(json.dumps(out))
"""


def _bit_ops_proc(M: int) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-c", _BIT_OPS_SNIPPET.format(M=M, bits=BIT_OPS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def ref():
    """{M: {strategy: the reference's figures}}, from its own
    ``_run_for(M)``, and beside each the bit operations of its step (the
    tally runs in two more subprocesses at the same time)."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.bench_multidev import _run_for

    procs = {M: _bit_ops_proc(M) for M in bench_multidev.WORKERS}
    out = {M: _run_for(M) for M in bench_multidev.WORKERS}
    for M, p in procs.items():
        stdout, stderr = p.communicate(timeout=1800)
        assert p.returncode == 0, stderr[-2000:]
        for name, bits in json.loads(stdout.strip().splitlines()[-1]).items():
            out[M][name]["bit_ops"] = bits
    return out


@pytest.fixture(scope="module")
def sweep():
    return bench_multidev.sweep(device="cpu")


@pytest.fixture(scope="module")
def tensor():
    from repro_torch.data.synthetic import planted_tensor

    return planted_tensor(bench_multidev.DIMS, bench_multidev.NNZ, seed=0,
                          device="cpu")


def _ref_schedule(plan, M: int) -> None:
    """Put the reference's epoch schedule (its LHC permutation under
    ``PRNGKey(0)``) into a port plan."""
    import jax

    from repro.core.sampling import latin_hypercube_schedule, stratum_digits

    s = np.asarray(latin_hypercube_schedule(jax.random.PRNGKey(0), M, 3))
    plan.schedule = s
    plan.digits = np.asarray(stratum_digits(s, M, 3))


def _one_call(name: str, tensor, M: int, ref_schedule: bool):
    """The traffic of the first call (one step; one chunk for overlap)."""
    st, plan, dstate = bench_multidev.prepare(name, tensor, M, CPU)
    if ref_schedule:
        _ref_schedule(plan, M)
    step = st.make_step(plan)
    after = step(dstate)
    return step.traffic, after.step, plan


# ---------------------------------------------------------------------------
# collective bytes against the reference's HLO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [2, 4])
def test_sync_psum_bytes_equal_the_reference(ref, sweep, M):
    """Sync's dense factor and core gradients summed by the ring rule:
    2·b·(M − 1)/M with b = ((1024 + 768 + 512)·8 + 3·8·8)·4 = 74,496."""
    b = ((1024 + 768 + 512) * 8 + 3 * 8 * 8) * 4
    s = sweep[M]["sync"]
    assert s["psum"] == ref[M]["sync"]["coll"] == 2 * b * (M - 1) / M
    assert s["permute"] == 0 and s["coll"] == s["psum"]


@pytest.mark.parametrize("M", [2, 4])
def test_strata_first_step_equals_the_reference_lowering(ref, tensor, M):
    """The reference lowers strata's ``schedule[0]`` stratum, which rotates
    nothing: its figure is the core psum alone.  The port's first step on
    the same schedule counts the same bytes and no permute."""
    t, steps, _ = _one_call("strata", tensor, M, ref_schedule=True)
    assert steps == 1
    assert t.psum_bytes == ref[M]["strata"]["coll"]
    assert t.permute_bytes == 0 and t.permutes == ref[M]["strata"]["permutes"]


@pytest.mark.parametrize("M", [2, 4])
def test_overlap_first_chunk_permutes_equal_the_reference(ref, tensor, M):
    """``strata_overlap``'s rotations over its first chunk (K = 4 strata, 5
    rotations a mode from home to home), a step: the reference's coll − its
    psum, 10,240 bytes at M = 2 and 6,144 at M = 4, and its permutes.

    The schedule is a random draw: the reference's from JAX's threefry, the
    port's from ``torch.randperm``.  They agree at M = 2 ([0, 1, 3, 2])
    and differ at M = 4, where the port's own first chunk (strata 12, 10,
    9, 6) rotates more, 10,240 bytes a step.  So the port is run on the
    reference's schedule, and its own schedule's count is held to what its
    digits give by the same rule (one shard of the mode a non-zero shift).
    """
    t, steps, _ = _one_call("strata_overlap", tensor, M, ref_schedule=True)
    r = ref[M]
    assert steps == 4
    assert t.psum_bytes / steps == r["strata"]["coll"]
    assert t.permute_bytes / steps == (r["strata_overlap"]["coll"]
                                       - r["strata"]["coll"])
    assert t.permutes / steps == r["strata_overlap"]["permutes"]
    assert t.rotated_bytes == M * t.permute_bytes

    own, _, plan = _one_call("strata_overlap", tensor, M,
                             ref_schedule=False)
    shard = [-(-d // M) * 8 * 4 for d in bench_multidev.DIMS]
    prev, want = [0, 0, 0], 0
    for digits in [list(plan.digits[k]) for k in range(4)] + [[0, 0, 0]]:
        want += sum(sh for sh, d, p in zip(shard, digits, prev)
                    if (d - p) % M)
        prev = digits
    assert own.permute_bytes == want
    assert own.permute_bytes / 4 == {2: 10_240, 4: 10_240}[M]


def test_epoch_counts_local_overlap_and_the_reference_fault(ref, sweep):
    """Local counts nothing; over a whole epoch overlap moves strictly
    fewer bytes than strata and hides its core updates behind rotations,
    plain strata hides nothing.  The reference's one-step figures read
    ``coll_no_worse=False`` (its strata step rotates nothing: ROADMAP Queue
    3); the port's epoch count does not share the fault."""
    for M, r in sweep.items():
        loc = r["local"]
        assert (loc["psum"], loc["permute"], loc["permutes"],
                loc["hidden_flops"], loc["async_starts"]) == (0, 0, 0, 0, 0)
        assert r["strata_overlap"]["coll"] < r["strata"]["coll"]
        assert r["strata_overlap"]["hidden_flops"] > 0
        assert r["strata"]["hidden_flops"] == 0
        assert r["strata"]["async_starts"] == 0   # no side stream
        assert r["strata_overlap"]["async_starts"] == 0   # the CPU copies
        assert bench_multidev.overlap_check(r) == {
            "coll_no_worse": True, "rotation_hidden": True}
        assert ref[M]["strata_overlap"]["coll"] > ref[M]["strata"]["coll"]


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", STRATEGIES)
def test_flops_within_a_quarter_of_the_reference_hlo(ref, sweep, name, M,
                                                     capsys):
    """The counted FLOPs a step and worker against the reference's HLO
    count less its integer bit operations (xor, or, shifts: its threefry
    sampler's random bits, 0.59 M a step for local and 1.17 M for the mesh
    strategies at M = 2, which the port's count from the shapes leaves
    out, as it leaves out its own sampler); within 25 %.  The raw ratio is
    printed beside (0.72–0.83).  ``work_scaling_eff`` within 1 % of 1."""
    r = ref[M][name]
    mine = sweep[M][name]["flops"]
    net = r["flops"] - r["bit_ops"]
    with capsys.disabled():
        print(f"\n{name} M={M}: counted {mine:,.0f} / reference HLO "
              f"{r['flops']:,.1f} = {mine / r['flops']:.4f}; without its "
              f"{r['bit_ops']:,.0f} bit operations {mine / net:.4f}")
    assert abs(mine / net - 1) <= 0.25
    assert abs(sweep[M][name]["work_scaling_eff"] - 1) <= 0.01


def test_step_flops_adds_the_step_to_the_kernel_count():
    cfg = ft.FastTuckerConfig(dims=(10, 7, 5), ranks=(3, 3, 3), core_rank=2,
                              batch_size=16, backend="torch")
    _, kg = kruskal_grad_cost(3, 16, 3, 2, 4, 3, True, False, False)
    core = 3 * 3 * 2
    assert core_update_flops(cfg, 1) == 2 * core
    assert core_update_flops(cfg, 4) == core * 3 / 4 + 2 * core
    scatter = 3 * 16 * 3
    dense = (10 + 7 + 5) * 3
    assert step_flops("local", cfg, 4) == kg + scatter + 2 * dense + 2 * core
    assert step_flops("sync", cfg, 4) == (kg + scatter + 2 * dense
                                          + dense * 3 / 4
                                          + core_update_flops(cfg, 4))
    block = (3 + 2 + 2) * 3                      # ⌈I_n / 4⌉ rows a mode
    for name in ("strata", "strata_overlap"):
        assert step_flops(name, cfg, 4) == (kg + scatter + 2 * block
                                            + core_update_flops(cfg, 4))


# ---------------------------------------------------------------------------
# collectives.Traffic
# ---------------------------------------------------------------------------

def test_traffic_counts_by_the_reference_rules():
    mesh = make_host_mesh(num_workers=4, device="cpu")
    t = collectives.Traffic()
    parts = [(torch.ones(5, 2), torch.ones(3)) for _ in range(4)]
    collectives.psum(parts, mesh, t)
    assert t.psum_bytes == 2 * 52 * 3 / 4
    shards = [torch.zeros(6, 2) for _ in range(4)]
    collectives.rotate(shards, 4, mesh, t)         # 0 mod M: nothing
    collectives.rotate(shards, 1, mesh, t)
    collectives.SideStreams().rotate(shards, 3, mesh, t).wait()
    assert (t.permutes, t.permute_bytes, t.rotated_bytes) == (2, 96, 384)
    assert t.async_starts == 0                      # copies on the CPU
    one = collectives.Traffic()
    collectives.psum(parts[:1], make_host_mesh(num_workers=1, device="cpu"),
                     one)
    assert one.psum_bytes == 0
    t.reset()
    assert {getattr(t, f) for f in t.FIELDS} == {0}


def test_compressed_sum_counts_the_f32_it_moves():
    """The int8 path dequantizes on each worker before the sum, so it moves
    the bytes of the uncompressed sum."""
    mesh = make_host_mesh(num_workers=2, device="cpu")
    dense = [(torch.randn(6, 4),) for _ in range(2)]
    ef = [(torch.zeros(6, 4),) for _ in range(2)]
    plain, packed = collectives.Traffic(), collectives.Traffic()
    collectives.psum(dense, mesh, plain)
    base.compressed_reduce(dense, ef, mesh, packed)
    assert packed.psum_bytes == plain.psum_bytes == 2 * 96 / 2


# ---------------------------------------------------------------------------
# the harness: fig7bc at FULL on the CPU
# ---------------------------------------------------------------------------

def test_run_fig7bc_at_full_on_the_cpu(capsys):
    from repro_torch.benchmarks import run

    run.main(["--only", "fig7bc", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "# all benches complete"
    names = [ln.split(",", 1)[0] for ln in lines[1:-1]]
    assert names == [f"fig7bc/{n}_M{M}" for M in (2, 4)
                     for n in list(STRATEGIES) + ["overlap_check"]]
    for ln in lines[1:-1]:
        if "overlap_check" in ln:
            assert ln.endswith("coll_no_worse=True;rotation_hidden=True")
        else:
            assert float(ln.split(",")[1]) > 0       # µs a step
    assert all("kruskal_grad/step=0;scatter_accum/step=0" in ln
               for ln in lines[1:-1] if "overlap_check" not in ln)


# ---------------------------------------------------------------------------
# bench_ingest and attach_ingest
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ingest(tmp_path_factory):
    spill = tmp_path_factory.mktemp("spill")
    return bench_ingest.run(smoke=True, device="cpu", spill_root=str(spill))


def test_ingest_constants_are_the_reference_ones():
    sys.path.insert(0, str(ROOT))
    import benchmarks.bench_ingest as ref_ingest

    for k in ("DEVICES", "FULL_POINTS", "SMOKE_POINTS",
              "RESIDENT_BUDGET_BYTES"):
        assert getattr(bench_ingest, k) == getattr(ref_ingest, k), k


def test_ingest_smoke_validates_and_the_store_is_bitwise(ingest):
    _validate_ingest(ingest)
    (r,) = ingest["rows"]
    assert (r["devices"], r["num_strata"], r["store"]) == (4, 16, "spill")
    assert r["stream_bitwise_resident"] is True
    assert r["us_per_step_resident"] > 0 and r["stream_vs_resident"] > 0
    assert r["epoch_steps"] == 16 and r["ingest_nnz_per_s"] > 0
    assert ingest["resident_budget_mb"] == 128
    assert ingest["platform"] == "cpu"


def test_attach_ingest_keeps_the_step_rows(ingest, tmp_path):
    src = ROOT / bench_sota_time.OUT_NAME
    path = tmp_path / bench_sota_time.OUT_NAME
    shutil.copy(src, path)
    before = json.loads(src.read_text())
    doc = bench_sota_time.attach_ingest(ingest, str(path))
    on_disk = json.loads(path.read_text())
    assert on_disk == doc and doc["schema"] == "bench_step/v3"
    validate_bench_step(on_disk)
    assert on_disk["results"] == before["results"]
    assert on_disk["config"] == before["config"]
    assert on_disk["ingest"] == json.loads(json.dumps(ingest))
    with pytest.raises(ValueError, match="BENCH_torch_step"):
        bench_sota_time.attach_ingest(ingest, str(tmp_path /
                                                  "BENCH_step.json"))


def test_ingest_store_fed_runs_equal_the_resident_run():
    """The bitwise check itself: the same strata run from resident buckets
    and from a spilled store at depth 0 and 2."""
    from repro_torch.data.pipeline import NonzeroStore
    from repro_torch.data.synthetic import planted_tensor
    from repro_torch.distributed import get_strategy

    p = bench_ingest.SMOKE_POINTS[0]
    t = planted_tensor(p["dims"], p["nnz"], rank=3, core_rank=3, seed=0,
                       device="cpu")
    cfg = ft.FastTuckerConfig(dims=p["dims"], ranks=(3,) * 3, core_rank=3,
                              batch_size=p["batch"], backend="torch")
    mesh = make_host_mesh(num_workers=4, device="cpu")
    store = NonzeroStore.build(t, 4)
    st = get_strategy("strata")
    ends = []
    for s, d in ((None, 0), (store, 0), (store, 2)):
        plan = st.prepare(t, cfg, mesh, seed=0, store=s, prefetch_depth=d)
        gen = torch.Generator().manual_seed(0)
        ds = st.init(plan, ft.init_state(gen, cfg, "cpu"), gen)
        step = st.make_step(plan)
        for _ in range(20):
            ds = step(ds)
        if step.prefetcher is not None:
            step.prefetcher.close()
        ends.append(ds)
    assert bench_ingest.same_state(ends[1], ends[0])
    assert bench_ingest.same_state(ends[2], ends[0])
    ends[2].params[1].factors[0][0, 0] += 1
    assert not bench_ingest.same_state(ends[2], ends[0])


# ---------------------------------------------------------------------------
# the multipod example
# ---------------------------------------------------------------------------

def test_multipod_example_runs_at_eight_workers(capsys):
    from repro_torch.examples import multipod_std

    hist = multipod_std.main(["--device", "cpu", "--backend", "torch",
                              "--steps", "8"])
    out = capsys.readouterr().out
    assert "on 8 workers (8^3 = 512 blocks, 64 strata)" in out
    assert [s for s, _ in hist] == [0, 8]
    assert all(math.isfinite(r) for _, r in hist)
    assert hist[-1][1] < hist[0][1]
