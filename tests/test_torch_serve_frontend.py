"""The port's async serving front end (``repro_torch.serve.frontend``), on
the CPU: the contracts of the reference's ``tests/test_serve_frontend.py``
(microbatch coalescing parity, bounded-queue admission, shed-on-deadline,
per-bucket latency stats, SLO alarm counters, degraded-serving visibility,
the closed-loop harness) and of ``tests/test_online_refresh.py``'s stale
flush count, on the port's ``TuckerServer`` built from the reference's
parameters.  ``FrontendStats`` is held against the reference's on the same
records.  One contract is the port's own: a lone request is flushed within
``max_wait_ms`` (the reference's batcher woke only at a full microbatch,
so a lone request waited for its 100 ms idle poll).
"""
import asyncio
import json
import time

import jax
import numpy as np
import pytest

from repro.core import fasttucker as jft
from repro.serve import FrontendStats as JFrontendStats
from repro_torch.core import fasttucker as ft
from repro_torch.serve import (
    AdmissionConfig, FrontendStats, RequestShed, ServeFrontend,
    TuckerServer, bucket_for, run_closed_loop,
)

DIMS = (9, 7, 5)


def _server(**kw):
    cfg = jft.FastTuckerConfig(dims=DIMS, ranks=(3, 4, 2), core_rank=3,
                               batch_size=32)
    params = jft.init_params(jax.random.PRNGKey(0), cfg)
    return TuckerServer(ft.params_from_numpy(params, device="cpu"), **kw)


@pytest.fixture(scope="module")
def server():
    return _server()


# ---------------------------------------------------------------------------
# coalescing parity: concurrent submits answer exactly like direct calls
# ---------------------------------------------------------------------------

def test_concurrent_submits_match_direct_predict(server):
    rng = np.random.default_rng(0)
    reqs = [np.stack([rng.integers(0, d, n) for d in DIMS], 1)
            .astype(np.int32) for n in (1, 3, 7, 12, 5)]

    async def main():
        async with ServeFrontend(server,
                                 AdmissionConfig(microbatch=16)) as fe:
            outs = await asyncio.gather(*(fe.submit(r) for r in reqs))
        return outs, fe.stats

    outs, stats = asyncio.run(main())
    for req, out in zip(reqs, outs):
        np.testing.assert_allclose(out, server.predict(req).numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert stats.served == len(reqs)
    assert stats.served_queries == sum(len(r) for r in reqs)
    assert stats.flushes <= len(reqs)


def test_top_k_query_path(server):
    ids = np.arange(DIMS[0], dtype=np.int32)

    async def main():
        async with ServeFrontend(server, query="top_k",
                                 top_k_args=(0, 3)) as fe:
            return await asyncio.gather(
                fe.submit(ids[:4]), fe.submit(ids[4:]))

    (s_a, i_a), (s_b, i_b) = asyncio.run(main())
    s0, i0 = server.top_k(0, ids, 3)
    np.testing.assert_allclose(np.concatenate([s_a, s_b]), s0.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.concatenate([i_a, i_b]), i0.numpy())


def test_frontend_requires_start_and_validates(server):
    fe = ServeFrontend(server)
    with pytest.raises(RuntimeError, match="not started"):
        asyncio.run(fe.submit(np.zeros((1, 3), np.int32)))
    with pytest.raises(ValueError, match="predict"):
        ServeFrontend(server, query="reconstruct")
    with pytest.raises(ValueError, match="top_k_args"):
        ServeFrontend(server, query="top_k")

    async def empty():
        async with ServeFrontend(server) as fe2:
            await fe2.submit(np.zeros((0, 3), np.int32))

    with pytest.raises(ValueError, match="empty"):
        asyncio.run(empty())


def test_lone_request_flushed_within_max_wait(server):
    """Sequential lone requests each wait about ``max_wait_ms`` for company,
    not the batcher's 100 ms idle poll (the reference's behaviour)."""
    async def main():
        lat = []
        async with ServeFrontend(
                server, AdmissionConfig(microbatch=10**6,
                                        max_wait_ms=1.0)) as fe:
            for _ in range(5):
                t0 = time.monotonic()
                await fe.submit(np.zeros((1, 3), np.int32))
                lat.append(time.monotonic() - t0)
        return lat, fe.stats

    lat, stats = asyncio.run(main())
    assert stats.flushes == 5
    assert min(lat) < 0.05, lat


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_bounded_queue_sheds_at_submit(server):
    async def main():
        async with ServeFrontend(
                server, AdmissionConfig(max_queue=8, microbatch=10**6,
                                        max_wait_ms=50.0)) as fe:
            t1 = asyncio.ensure_future(
                fe.submit(np.zeros((8, 3), np.int32)))
            await asyncio.sleep(0)           # let it enqueue
            with pytest.raises(RequestShed, match="queue full"):
                await fe.submit(np.zeros((1, 3), np.int32))
            shed = fe.stats.shed_queue_full
            await t1
            return shed

    assert asyncio.run(main()) == 1


def test_deadline_shed_at_flush(server):
    clock = {"t": 0.0}

    async def main():
        fe = ServeFrontend(
            server,
            AdmissionConfig(deadline_ms=10.0, microbatch=4,
                            max_wait_ms=0.1),
            clock=lambda: clock["t"])
        async with fe:
            stale = asyncio.ensure_future(
                fe.submit(np.zeros((1, 3), np.int32)))
            await asyncio.sleep(0)
            clock["t"] = 1.0                 # 1000ms pass in queue
            fresh = asyncio.ensure_future(
                fe.submit(np.zeros((3, 3), np.int32)))
            with pytest.raises(RequestShed, match="deadline"):
                await stale
            out = await fresh
            return fe.stats, out

    stats, out = asyncio.run(main())
    assert stats.shed_deadline == 1
    assert stats.served == 1 and out.shape == (3,)


def test_oversized_request_raises(server):
    async def main():
        async with ServeFrontend(
                server, AdmissionConfig(max_queue=8)) as fe:
            with pytest.raises(ValueError, match="max_queue"):
                await fe.submit(np.zeros((9, 3), np.int32))
            return fe.stats

    stats = asyncio.run(main())
    assert stats.shed_queue_full == 0
    assert stats.admitted == 0


def test_flush_attributes_latency_per_request_bucket(server):
    reqs = [np.zeros((1, 3), np.int32), np.zeros((12, 3), np.int32)]

    async def main():
        async with ServeFrontend(server,
                                 AdmissionConfig(microbatch=13)) as fe:
            await asyncio.gather(*(fe.submit(r) for r in reqs))
            return fe.stats

    stats = asyncio.run(main())
    assert stats.flushes == 1
    want = {bucket_for(1, server.ladder): 1,
            bucket_for(12, server.ladder): 1}
    assert {b: len(v) for b, v in stats.by_bucket.items()} == want


def test_stats_percentiles_match_reference():
    ours, ref = FrontendStats(), JFrontendStats()
    assert ours.percentiles() == ref.percentiles()
    rng = np.random.default_rng(1)
    for ms, bucket in zip(rng.exponential(3.0, 50),
                          rng.choice([8, 16, 32], 50)):
        for st in (ours, ref):
            st.record(int(bucket), float(ms), slo_ms=4.0)
    assert ours.percentiles() == ref.percentiles()
    assert ours.bucket_percentiles() == ref.bucket_percentiles()
    assert ours.slo_violations == ref.slo_violations

    st = FrontendStats()
    for ms in (1.0, 2.0, 3.0, 4.0):
        st.record(8, ms)
    st.record(16, 100.0)
    assert st.percentiles()["p50"] == pytest.approx(3.0)
    by = st.bucket_percentiles()
    assert by[8]["count"] == 4 and by[16]["p50"] == pytest.approx(100.0)


# ---------------------------------------------------------------------------
# SLO alarm counters + degraded-serving visibility + stale flushes
# ---------------------------------------------------------------------------

def test_admission_slo_for_float_dict_none():
    assert AdmissionConfig().slo_for(8) is None
    assert AdmissionConfig(slo_ms=5.0).slo_for(8) == 5.0
    cfg = AdmissionConfig(slo_ms={8: 2.0, 16: 4.0})
    assert cfg.slo_for(8) == 2.0 and cfg.slo_for(16) == 4.0
    assert cfg.slo_for(32) is None


def test_stats_slo_violation_counter():
    st = FrontendStats()
    st.record(8, 1.0, slo_ms=2.0)
    st.record(8, 3.0, slo_ms=2.0)
    st.record(8, 2.0, slo_ms=2.0)           # AT budget is not a violation
    st.record(16, 9.0)                      # unbudgeted: no entry at all
    st.record(32, 0.5, slo_ms=1.0)
    assert st.slo_violations == {8: 1, 32: 0}


def test_flush_counts_slo_violations_per_bucket(server):
    reqs = [np.zeros((1, 3), np.int32), np.zeros((12, 3), np.int32)]
    b_small = bucket_for(1, server.ladder)
    b_big = bucket_for(12, server.ladder)
    slo = {b_small: 1e-9, b_big: 1e9}

    async def main():
        async with ServeFrontend(
                server, AdmissionConfig(microbatch=13, slo_ms=slo)) as fe:
            outs = await asyncio.gather(*(fe.submit(r) for r in reqs))
            return fe.stats, outs

    stats, outs = asyncio.run(main())
    assert all(o is not None for o in outs)
    assert stats.served == 2
    assert stats.slo_violations == {b_small: 1, b_big: 0}


class _FakeSupervisor:
    """health()-shaped stand-in: the front end only reads state."""

    def __init__(self, state="degraded"):
        self.state = state

    def health(self):
        return {"state": self.state, "generation": 0, "staleness_s": 1.0}


def test_flush_counts_degraded_serving(server):
    async def main(sup):
        async with ServeFrontend(server, AdmissionConfig(microbatch=4),
                                 supervisor=sup) as fe:
            await fe.submit(np.zeros((4, 3), np.int32))
            return fe.stats

    degraded = asyncio.run(main(_FakeSupervisor("degraded")))
    assert degraded.flushes == 1 and degraded.degraded_flushes == 1
    healthy = asyncio.run(main(_FakeSupervisor("ok")))
    assert healthy.flushes == 1 and healthy.degraded_flushes == 0


def test_frontend_counts_stale_flushes():
    """A table swap landing while a flush is in flight is counted in
    ``stale_flushes``; a flush after the swap reports the new
    ``table_version``."""
    srv = _server()

    class SwapDuringPredict:
        def __init__(self, inner):
            self.inner = inner
            self.swapped = False

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def predict(self, idx):
            out = self.inner.predict(idx)
            if not self.swapped:
                self.swapped = True
                self.inner.update_rows(0, np.array([1], np.int32),
                                       np.zeros((1, 3), np.float32))
            return out

    req = np.zeros((3, 3), np.int32)

    async def main():
        async with ServeFrontend(SwapDuringPredict(srv),
                                 AdmissionConfig(max_wait_ms=0.1)) as fe:
            await fe.submit(req)
            await fe.submit(req)
            return fe.stats

    stats = asyncio.run(main())
    assert stats.stale_flushes == 1
    assert stats.table_version == srv.table_version == 1
    assert stats.served == 2


def test_closed_loop_report_slo_and_supervisor_sections(server):
    sup = _FakeSupervisor("degraded")
    rep = run_closed_loop(
        server, qps=400.0, duration_s=0.5, concurrency=4, max_request=8,
        admission=AdmissionConfig(slo_ms=1e-9), supervisor=sup, seed=4)
    assert rep["served_requests"] > 0
    assert rep["slo_budget_ms"] == 1e-9
    assert sum(rep["slo_violations"].values()) == rep["served_requests"]
    assert all(isinstance(k, str) for k in rep["slo_violations"])
    assert rep["degraded_flushes"] == rep["flushes"] > 0
    assert rep["supervisor"]["state"] == "degraded"
    json.dumps(rep)


def test_closed_loop_report_without_slo_is_unbudgeted(server):
    rep = run_closed_loop(server, qps=200.0, duration_s=0.3,
                          concurrency=2, max_request=4, seed=5)
    assert rep["slo_budget_ms"] is None
    assert rep["slo_violations"] == {}
    assert "supervisor" not in rep


# ---------------------------------------------------------------------------
# closed-loop harness
# ---------------------------------------------------------------------------

def test_closed_loop_smoke(server):
    rep = run_closed_loop(server, qps=500.0, duration_s=0.6,
                          concurrency=4, max_request=8, seed=1)
    assert rep["served_requests"] > 0
    assert rep["achieved_qps"] > 0
    assert rep["latency_ms"]["p50"] <= rep["latency_ms"]["p99"]
    assert set(rep["by_bucket"])
    # every admitted request is answered
    assert rep["served_requests"] == (rep["requests"]
                                      - rep["shed_queue_full"]
                                      - rep["shed_deadline"])


def test_closed_loop_top_k(server):
    rep = run_closed_loop(server, qps=300.0, duration_s=0.5,
                          concurrency=2, max_request=4, query="top_k",
                          top_k_args=(0, 2), seed=2)
    assert rep["served_queries"] > 0


def test_closed_loop_sheds_under_overload(server):
    rep = run_closed_loop(
        server, qps=50_000.0, duration_s=0.5, concurrency=16,
        max_request=32,
        admission=AdmissionConfig(max_queue=32, microbatch=32,
                                  deadline_ms=5.0),
        seed=3)
    assert rep["shed_queue_full"] + rep["shed_deadline"] > 0
