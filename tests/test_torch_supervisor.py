"""The port's resilient online serving (``repro_torch.serve.supervisor`` and
``runtime.fault``'s ``FaultPlan``), on the CPU.

* ``FaultPlan`` against the reference's ``repro.runtime.fault.FaultPlan``
  for the same spec and seed: the same fire/clear sequence over 200 checks
  per site, targeted and probabilistic (the per-site numpy generators are
  the reference's draws).
* The contracts of the reference's ``tests/test_supervisor.py`` on the
  port's objects: the fault matrix over all four sites (concurrent queries
  never error and never see a torn generation; after recovery the tables,
  colsums, factors and the generator state equal a never-faulted run's
  bitwise), degraded health while stuck, drift escalation by colsum and by
  patched fraction, ``sync_factor_rows``, out-of-range ids.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.runtime import fault as jfault
from repro_torch.core import fasttucker as ft
from repro_torch.core.sptensor import SparseTensor
from repro_torch.data.synthetic import planted_tensor
from repro_torch.distributed import get_strategy
from repro_torch.runtime.fault import (FailureInjector, FaultInjected,
                                       FaultPlan, FaultSpec, backoff)
from repro_torch.serve import (DriftTracker, RefreshSupervisor,
                               SupervisorConfig, TuckerServer, window_block)

DIMS = (12, 10, 8)


# ---------------------------------------------------------------------------
# FaultPlan against the reference, and its own units
# ---------------------------------------------------------------------------

def _fires(plan, site, n=200):
    out = []
    for _ in range(n):
        try:
            plan.check(site)
            out.append(False)
        except (FaultInjected, jfault.FaultInjected) as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("spec,seed", [
    ("ingest@0:2:5,transfer%0.3", 0),
    ("refresh@0:1:2,publish@0", 7),
    ("publish%0.5,ingest@199", 3),
    ("transfer%0.05,refresh%1.0", 11),
])
def test_fault_plan_matches_reference(spec, seed):
    ours, ref = FaultPlan.parse(spec, seed), jfault.FaultPlan.parse(spec,
                                                                    seed)
    for site in ("ingest", "transfer", "refresh", "publish", "other"):
        assert _fires(ours, site) == _fires(ref, site), site
        assert ours.checks(site) == ref.checks(site)
    assert ours.fired == ref.fired
    assert ours.fired_by_site() == ref.fired_by_site()
    ours.clear()
    ref.clear()
    assert _fires(ours, "transfer", 5) == _fires(ref, "transfer", 5)


def test_fault_plan_targeted_hits_clear():
    plan = FaultPlan([FaultSpec("ingest", hits=frozenset({0, 2}))])
    with pytest.raises(FaultInjected, match="ingest"):
        plan.check("ingest")
    plan.check("ingest")                      # check 1 passes
    with pytest.raises(FaultInjected):
        plan.check("ingest")                  # check 2 fires
    plan.check("ingest")                      # cleared for good
    plan.check("unspecified-site")            # free pass
    assert plan.fired == 2
    assert plan.fired_by_site() == {"ingest": 2}
    assert plan.checks("ingest") == 4


def test_fault_plan_probabilistic_is_seed_deterministic():
    def fires(seed):
        plan = FaultPlan([FaultSpec("transfer", prob=0.5)], seed=seed)
        return [bool(f) for f in _fires(plan, "transfer", 40)]

    a, b, c = fires(7), fires(7), fires(8)
    assert a == b and a != c
    assert any(a) and not all(a)


def test_fault_plan_parse_grammar():
    plan = FaultPlan.parse("ingest@0:2,refresh%0.25, publish@1 ", seed=3)
    with pytest.raises(FaultInjected):
        plan.check("ingest")
    plan.check("publish")
    with pytest.raises(FaultInjected):
        plan.check("publish")
    with pytest.raises(ValueError, match="bad fault term"):
        FaultPlan.parse("refresh")
    with pytest.raises(ValueError, match="no check indices"):
        FaultPlan.parse("refresh@")
    with pytest.raises(ValueError, match="prob"):
        FaultPlan.parse("refresh%1.5")
    with pytest.raises(ValueError, match="duplicate"):
        FaultPlan.parse("a@0,a@1")
    with pytest.raises(ValueError, match="site"):
        FaultSpec("")


def test_fault_plan_clear_removes_specs():
    plan = FaultPlan([FaultSpec("x", prob=1.0)])
    with pytest.raises(FaultInjected):
        plan.check("x")
    plan.clear()
    plan.check("x")
    assert plan.fired == 1


def test_failure_injector_and_backoff_unchanged():
    inj = FailureInjector({3})
    inj.maybe_fail(2)
    with pytest.raises(RuntimeError, match="step 3"):
        inj.maybe_fail(3)
    inj.maybe_fail(3)
    sched = [backoff(a, base=0.1, cap=0.5, seed=1) for a in range(6)]
    assert sched == [jfault.backoff(a, base=0.1, cap=0.5, seed=1)
                     for a in range(6)]


def test_window_block():
    idx = np.arange(10, dtype=np.int32).reshape(5, 2)
    val = np.arange(5, dtype=np.float32)
    wi, wv = window_block(idx, val, 3)
    np.testing.assert_array_equal(wv, [2, 3, 4])
    wi, wv = window_block(idx, val, 12)
    assert wi.shape == (12, 2) and wv.shape == (12,)
    np.testing.assert_array_equal(wv[-5:], val)


# ---------------------------------------------------------------------------
# supervisor harness
# ---------------------------------------------------------------------------

def _setup(seed=0, warmup=4, nnz=500, stream=100):
    """Warmed-up ``local`` strategy + params + the streaming tail."""
    t = planted_tensor(DIMS, nnz, rank=3, core_rank=3, noise=0.05,
                       seed=seed, device="cpu")
    idx, val = t.indices.numpy(), t.values.numpy()
    n_warm = nnz - stream
    warm_t = SparseTensor.from_numpy(idx[:n_warm], val[:n_warm], DIMS,
                                     "cpu")
    strategy = get_strategy("local")
    cfg = ft.FastTuckerConfig(dims=DIMS, ranks=(3,) * 3, core_rank=3,
                              batch_size=64, backend="cuda")
    plan = strategy.prepare(warm_t, cfg, None, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    dstate = strategy.init(plan, ft.init_state(gen, cfg, "cpu"), gen)
    step = strategy.make_step(plan)
    for _ in range(warmup):
        dstate = step(dstate)
    return {
        "strategy": strategy, "plan": plan, "dstate": dstate,
        "params": strategy.eval_params(plan, dstate),
        "warm": (idx[:n_warm], val[:n_warm]),
        "stream": (idx[n_warm:], val[n_warm:]),
    }


def _config(**kw):
    kw.setdefault("refresh_steps", 2)
    kw.setdefault("window", 64)
    kw.setdefault("backoff_base_s", 1e-3)
    kw.setdefault("backoff_cap_s", 5e-3)
    kw.setdefault("degraded_retry_s", 5e-3)
    kw.setdefault("poll_interval_s", 2e-3)
    return SupervisorConfig(**kw)


def _run_rounds(env, fault_plan=None, rounds=2, config=None,
                recorder=None, query_thread=None):
    """``rounds`` submit→drain cycles through a fresh supervisor over a
    fresh server built from the SAME warmed-up params."""
    srv = TuckerServer(env["params"])
    if recorder is not None:
        recorder(srv)
    sup = RefreshSupervisor(
        srv, env["strategy"], env["plan"], env["dstate"],
        config=config or _config(), fault_plan=fault_plan,
        history=env["warm"])
    sup.start()
    stop_queries = threading.Event()
    qt = None
    if query_thread is not None:
        qt = threading.Thread(target=query_thread,
                              args=(srv, stop_queries), daemon=True)
        qt.start()
    try:
        s_idx, s_val = env["stream"]
        per = len(s_val) // rounds
        for rd in range(rounds):
            lo, hi = rd * per, (rd + 1) * per
            sup.submit(s_idx[lo:hi], s_val[lo:hi])
            assert sup.drain(timeout=60), sup.health()
    finally:
        stop_queries.set()
        if qt is not None:
            qt.join(timeout=10)
            assert not qt.is_alive()
        sup.stop()
    return sup


@pytest.fixture(scope="module")
def env():
    return _setup()


# ---------------------------------------------------------------------------
# the fault matrix: each class degrades, recovers, and recovery is bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["ingest", "transfer", "refresh",
                                  "publish"])
def test_fault_matrix_degrade_recover_bitwise(env, site):
    """One fault class at a time: four consecutive hits against
    max_attempts=3 (a breaker trip), clearing afterwards.  Concurrent
    queries never error and never see a torn generation; after recovery
    the tables, colsums, factors and generator state are bitwise the clean
    run's."""
    probe = np.stack([np.arange(8) % d for d in DIMS], 1).astype(np.int32)
    allowed: dict[int, bytes] = {}

    def recorder(srv):
        allowed[0] = srv.predict(probe).numpy().tobytes()
        orig_u, orig_r = srv.update_rows, srv.refresh_tables

        def u(*a, **kw):
            v = orig_u(*a, **kw)
            allowed[v] = srv.predict(probe).numpy().tobytes()
            return v

        def r():
            v = orig_r()
            allowed[v] = srv.predict(probe).numpy().tobytes()
            return v

        srv.update_rows, srv.refresh_tables = u, r

    clean = _run_rounds(env, rounds=2, recorder=recorder)
    assert len(allowed) == clean.server.table_version + 1

    fp = FaultPlan([FaultSpec(site, hits=frozenset(range(4)))])
    answers: list[bytes] = []
    errors: list[BaseException] = []

    def hammer(srv, stop):
        while not stop.is_set():
            try:
                answers.append(srv.predict(probe).numpy().tobytes())
            except BaseException as e:  # noqa: BLE001 — the assertion
                errors.append(e)

    faulted = _run_rounds(env, fault_plan=fp, rounds=2, query_thread=hammer)
    h = faulted.health()
    assert not errors, f"concurrent queries errored: {errors[:3]}"
    assert answers, "query thread never ran"
    bad = [a for a in answers if a not in allowed.values()]
    assert not bad, (f"{len(bad)}/{len(answers)} answers match no "
                     "published generation — torn read")
    assert fp.fired == 4 and h["faults_injected"] == 4
    assert h["breaker_trips"] >= 1 and h["recoveries"] >= 1
    assert h["retries"] >= 4
    assert h["generation"] == clean.server.table_version
    for n in range(len(DIMS)):
        np.testing.assert_array_equal(faulted.server._tables[n].numpy(),
                                      clean.server._tables[n].numpy())
        np.testing.assert_array_equal(faulted.server._colsums[n].numpy(),
                                      clean.server._colsums[n].numpy())
        np.testing.assert_array_equal(
            faulted.server.params.factors[n].numpy(),
            clean.server.params.factors[n].numpy())
        np.testing.assert_array_equal(faulted.dstate.params.factors[n]
                                      .numpy(),
                                      clean.dstate.params.factors[n].numpy())
    assert torch.equal(faulted.dstate.rng, clean.dstate.rng)
    assert faulted.dstate.step == clean.dstate.step == env["dstate"].step + 4


def test_patched_server_equals_fresh_server_from_refreshed_params(env):
    """After rounds of patches the served tables are bitwise those of a
    fresh server built from the supervisor's refreshed params."""
    sup = _run_rounds(env, rounds=3,
                      config=_config(max_patched_fraction=1e9,
                                     max_colsum_drift=1e9))
    assert sup.health()["last_publish"]["kind"] == "patch"
    fresh = TuckerServer(sup.dstate.params)
    for n in range(len(DIMS)):
        np.testing.assert_array_equal(sup.server._tables[n].numpy(),
                                      fresh._tables[n].numpy())
        np.testing.assert_array_equal(sup.server.params.factors[n].numpy(),
                                      sup.dstate.params.factors[n].numpy())


def test_degraded_health_while_stuck(env):
    """While the breaker is open the server keeps answering from the stale
    generation and health() reports degraded + staleness + error."""
    fp = FaultPlan([FaultSpec("refresh", hits=frozenset(range(10_000)))])
    srv = TuckerServer(env["params"])
    sup = RefreshSupervisor(srv, env["strategy"], env["plan"],
                            env["dstate"], config=_config(),
                            fault_plan=fp, history=env["warm"])
    sup.start()
    try:
        s_idx, s_val = env["stream"]
        sup.submit(s_idx[:40], s_val[:40])
        assert not sup.drain(timeout=0.3)   # stuck: the fault never clears
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            h = sup.health()
            if h["state"] == "degraded":
                break
            time.sleep(0.01)
        assert h["state"] == "degraded", h
        assert h["breaker_trips"] >= 1
        assert "refresh" in h["last_error"]
        assert h["staleness_s"] > 0
        assert h["generation"] == 0          # nothing ever published
        assert h["pending_rounds"] == 1
        probe = np.stack([np.arange(4) % d for d in DIMS], 1)
        assert srv.predict(probe).shape == (4,)
    finally:
        sup.stop()
    assert sup.health()["state"] == "stopped"


def test_run_round_raises_after_max_cycles(env):
    fp = FaultPlan([FaultSpec("publish", hits=frozenset(range(100)))])
    sup = RefreshSupervisor(TuckerServer(env["params"]), env["strategy"],
                            env["plan"], env["dstate"], config=_config(),
                            fault_plan=fp, history=env["warm"])
    s_idx, s_val = env["stream"]
    with pytest.raises(FaultInjected, match="publish"):
        sup.run_round(s_idx[:40], s_val[:40], max_cycles=2)
    h = sup.health()
    assert h["state"] == "degraded" and h["breaker_trips"] == 2
    sup.start()
    with pytest.raises(RuntimeError, match="stopped"):
        sup.run_round(s_idx[:40], s_val[:40])
    sup.stop()


# ---------------------------------------------------------------------------
# drift escalation
# ---------------------------------------------------------------------------

def test_drift_escalation_colsum_threshold(env):
    eps = float(np.finfo(np.float32).eps)
    cfg = _config(max_colsum_drift=eps, max_patched_fraction=1e9)
    srv = TuckerServer(env["params"])
    sup = RefreshSupervisor(srv, env["strategy"], env["plan"],
                            env["dstate"], config=cfg, history=env["warm"])
    s_idx, s_val = env["stream"]
    h0 = sup.run_round(s_idx[:40], s_val[:40])
    assert h0["last_publish"]["kind"] == "patch"
    assert h0["drift"]["colsum_drift"] > 0
    v_before = srv.table_version
    assert v_before == sum(1 for d in h0["last_dirty"] if d)

    h1 = sup.run_round(s_idx[40:80], s_val[40:80])
    assert h1["last_publish"]["kind"] == "rebuild"
    assert "colsum drift" in h1["last_publish"]["reason"]
    assert h1["rebuilds"] == 1
    assert srv.table_version == v_before + 1
    assert h1["drift"]["colsum_drift"] == 0.0
    assert h1["drift"]["patched_rows"] == [0] * len(DIMS)

    ref = TuckerServer(srv.params)
    for n in range(len(DIMS)):
        np.testing.assert_array_equal(srv._tables[n].numpy(),
                                      ref._tables[n].numpy())
        np.testing.assert_array_equal(srv._colsums[n].numpy(),
                                      ref._colsums[n].numpy())


def test_drift_escalation_patched_fraction(env):
    cfg = _config(max_patched_fraction=1e-6, max_colsum_drift=1e9)
    srv = TuckerServer(env["params"])
    sup = RefreshSupervisor(srv, env["strategy"], env["plan"],
                            env["dstate"], config=cfg, history=env["warm"])
    s_idx, s_val = env["stream"]
    h = sup.run_round(s_idx[:40], s_val[:40])
    assert h["last_publish"]["kind"] == "rebuild"
    assert "patched fraction" in h["last_publish"]["reason"]
    assert srv.table_version == 1


def test_drift_tracker_units():
    cfg = SupervisorConfig(max_patched_fraction=0.5, max_colsum_drift=1.0)
    dt = DriftTracker((10, 20), cfg)
    assert dt.should_rebuild((0, 0)) is None
    assert dt.should_rebuild((5, 0)) is not None          # 5/10 ≥ 0.5
    dt.note_patch(0, 3, delta_l1=1.0, scale_l1=1.0)
    assert dt.patched_rows == [3, 0]
    assert dt.should_rebuild((2, 0)) is not None          # (3+2)/10 ≥ 0.5
    assert dt.should_rebuild((0, 0)) is None
    dt.colsum_drift = 2.0
    reason = dt.should_rebuild((0, 0))
    assert reason and "drift" in reason
    dt.reset()
    assert dt.patched_rows == [0, 0] and dt.colsum_drift == 0.0


# ---------------------------------------------------------------------------
# engine satellites: sync_factor_rows + out-of-range diagnostics
# ---------------------------------------------------------------------------

def test_sync_factor_rows_updates_model_without_publish(env):
    srv = TuckerServer(env["params"])
    rng = np.random.default_rng(0)
    ids = np.array([1, 4, 7], np.int32)
    rows = rng.standard_normal((3, 3)).astype(np.float32)
    v = srv.table_version
    srv.sync_factor_rows(1, ids, rows)
    assert srv.table_version == v               # no generation published
    np.testing.assert_array_equal(srv.params.factors[1].numpy()[ids], rows)
    # the caller's params were not written
    assert not np.array_equal(env["params"].factors[1].numpy()[ids], rows)
    srv.refresh_tables()
    ref = TuckerServer(srv.params)
    for n in range(srv.order):
        np.testing.assert_array_equal(srv._tables[n].numpy(),
                                      ref._tables[n].numpy())
    with pytest.raises(ValueError, match="unique"):
        srv.sync_factor_rows(0, [1, 1], np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        srv.sync_factor_rows(0, [DIMS[0]], np.zeros((1, 3), np.float32))


def test_update_rows_out_of_range_names_mode_id_dim(env):
    srv = TuckerServer(env["params"])
    with pytest.raises(ValueError) as ei:
        srv.update_rows(1, [2, DIMS[1] + 5], np.zeros((2, 3), np.float32))
    msg = str(ei.value)
    assert "out of range" in msg
    assert "mode 1" in msg
    assert str(DIMS[1] + 5) in msg
    assert f"I={DIMS[1]}" in msg
    assert "dim growth" in msg
