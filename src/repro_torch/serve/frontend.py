"""Closed-loop async serving front end over a ``TuckerServer``.

Counterpart of ``repro.serve.frontend``.  The engine answers *batches*;
traffic arrives as *requests*.  This module is the glue between them: an
asyncio microbatch queue that coalesces concurrent requests into one
bucketed engine call, plus admission control for when the offered load
exceeds capacity:

  * **bounded queue** — at most ``AdmissionConfig.max_queue`` queries may
    wait; a request that would overflow is rejected at submit time;
  * **shed on deadline** — whatever is still queued past ``deadline_ms``
    is dropped at flush time instead of being served late.

Both rejections surface as ``RequestShed`` to the caller and are counted
in ``FrontendStats`` alongside per-bucket latency reservoirs, SLO
violation counts and the stale and degraded flush counts, so the
closed-loop harness (``run_closed_loop``, driving ``launch.serve_tucker
--qps``) can report p50/p95/p99 per request-size bucket and the shed rate
at each offered QPS.

The engine call runs on a single worker thread (``loop.run_in_executor``)
and returns host numpy arrays: the copy back waits for the device, so a
flush's latency includes the device's work, and one thread keeps the event
loop free to admit and shed while a batch is in flight.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np

from .bucketing import bucket_for


class RequestShed(RuntimeError):
    """The front end refused this request (queue full / deadline passed)."""


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission-control knobs for :class:`ServeFrontend`.

    ``max_queue``   — bound on QUERIES (not requests) waiting to be
                      served; submissions beyond it shed immediately.
    ``deadline_ms`` — a queued request older than this at flush time is
                      shed instead of served (its answer is already too
                      late to be useful).
    ``microbatch``  — flush the queue once this many queries have
                      coalesced (one engine call per flush).
    ``max_wait_ms`` — flush timer: a lone request never waits longer
                      than this for company, bounding added latency at
                      low traffic.
    ``slo_ms``      — latency SLO budget (milliseconds): a float applies
                      one budget to every request-size bucket, a dict
                      maps bucket → budget (buckets without an entry are
                      unbudgeted).  A served request whose latency
                      exceeds its bucket's budget increments
                      ``FrontendStats.slo_violations[bucket]`` — the
                      alarm counter, not an enforcement mechanism (the
                      answer is still delivered; ``deadline_ms`` is the
                      enforcement knob).
    """

    max_queue: int = 4096
    deadline_ms: float = 200.0
    microbatch: int = 256
    max_wait_ms: float = 2.0
    slo_ms: float | dict | None = None

    def slo_for(self, bucket: int) -> float | None:
        """The SLO budget (ms) covering ``bucket``, or None."""
        if self.slo_ms is None:
            return None
        if isinstance(self.slo_ms, dict):
            v = self.slo_ms.get(bucket)
            return None if v is None else float(v)
        return float(self.slo_ms)


@dataclasses.dataclass
class FrontendStats:
    """Counters + per-bucket latency reservoirs (milliseconds)."""

    admitted: int = 0            # requests accepted into the queue
    served: int = 0              # requests answered
    served_queries: int = 0      # queries answered (Σ request sizes)
    shed_queue_full: int = 0     # rejected at submit (bounded queue)
    shed_deadline: int = 0       # dropped at flush (deadline passed)
    flushes: int = 0             # engine calls made
    table_version: int = 0       # server table version the last flush ran on
    stale_flushes: int = 0       # flushes answered by a version that a
                                 # table swap superseded while in flight
    degraded_flushes: int = 0    # flushes served while the refresh
                                 # supervisor reported state=degraded
    latency_ms: list = dataclasses.field(default_factory=list)
    by_bucket: dict = dataclasses.field(default_factory=dict)
    slo_violations: dict = dataclasses.field(default_factory=dict)

    def record(self, bucket: int, ms: float,
               slo_ms: float | None = None) -> None:
        self.latency_ms.append(ms)
        self.by_bucket.setdefault(bucket, []).append(ms)
        if slo_ms is not None:
            # zero-init on first sighting so the report distinguishes
            # "bucket under budget" (0) from "bucket unbudgeted" (absent)
            self.slo_violations.setdefault(bucket, 0)
            if ms > slo_ms:
                self.slo_violations[bucket] += 1

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)) -> dict:
        if not self.latency_ms:
            return {f"p{q:g}": None for q in qs}
        lat = np.asarray(self.latency_ms)
        return {f"p{q:g}": float(np.percentile(lat, q)) for q in qs}

    def bucket_percentiles(self, qs: Sequence[float] = (50, 95, 99)) -> dict:
        out = {}
        for bucket in sorted(self.by_bucket):
            lat = np.asarray(self.by_bucket[bucket])
            out[bucket] = {f"p{q:g}": float(np.percentile(lat, q))
                           for q in qs}
            out[bucket]["count"] = int(lat.size)
        return out


class _Pending:
    __slots__ = ("indices", "enqueued", "future")

    def __init__(self, indices: np.ndarray, enqueued: float,
                 future: asyncio.Future):
        self.indices = indices
        self.enqueued = enqueued
        self.future = future


class ServeFrontend:
    """Asyncio microbatch front end: ``await submit(indices)`` → answers.

    ``query`` selects the engine entry point the flush loop drives:
    ``"predict"`` (default) answers (B, N) index tuples; ``"top_k"``
    answers 1-D entity id batches with ``(scores, items)`` via
    ``top_k_args=(mode, k)`` (optionally ``(mode, k, target_mode)``).

    Use as an async context manager (or call :meth:`start`/:meth:`stop`)
    so the batcher task and its worker thread are torn down cleanly.
    """

    def __init__(
        self,
        server,
        admission: AdmissionConfig | None = None,
        *,
        query: str = "predict",
        top_k_args: tuple | None = None,
        supervisor=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if query not in ("predict", "top_k"):
            raise ValueError(f"query must be 'predict' | 'top_k', not "
                             f"{query!r}")
        if query == "top_k" and top_k_args is None:
            raise ValueError("query='top_k' needs top_k_args=(mode, k[, "
                             "target_mode])")
        self.server = server
        self.admission = admission or AdmissionConfig()
        # optional RefreshSupervisor: flushes served while it reports
        # degraded are counted (answers still flow — from stale tables)
        self.supervisor = supervisor
        self.query = query
        self.top_k_args = top_k_args
        self.stats = FrontendStats()
        self._clock = clock
        self._queue: list[_Pending] = []
        self._queued_queries = 0
        self._wakeup: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._executor: ThreadPoolExecutor | None = None
        self._closing = False

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> "ServeFrontend":
        self._wakeup = asyncio.Event()
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-flush")
        self._closing = False
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def stop(self) -> None:
        self._closing = True
        if self._wakeup is not None:
            self._wakeup.set()
        if self._task is not None:
            await self._task
            self._task = None
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    async def __aenter__(self) -> "ServeFrontend":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- submission -----------------------------------------------------------

    async def submit(self, indices):
        """Queue one request; resolves to its answers (or raises
        :class:`RequestShed` when admission control rejects it)."""
        if self._task is None:
            raise RuntimeError("front end not started (use `async with`)")
        indices = np.asarray(indices, np.int32)
        n = indices.shape[0]
        if n == 0:
            raise ValueError("empty request")
        if n > self.admission.max_queue:
            # not an overload condition: this request can NEVER be admitted
            # (it exceeds the whole queue bound even when empty).  A shed
            # would send closed-loop clients into an infinite retry loop —
            # it's a caller error, so say so.
            raise ValueError(
                f"request of {n} queries exceeds max_queue="
                f"{self.admission.max_queue} and can never be admitted; "
                f"split it or raise AdmissionConfig.max_queue")
        if self._queued_queries + n > self.admission.max_queue:
            self.stats.shed_queue_full += 1
            raise RequestShed(
                f"queue full ({self._queued_queries}/"
                f"{self.admission.max_queue} queries)")
        fut = asyncio.get_running_loop().create_future()
        first = not self._queue
        self._queue.append(_Pending(indices, self._clock(), fut))
        self._queued_queries += n
        self.stats.admitted += 1
        if first or self._queued_queries >= self.admission.microbatch:
            # the first waiting request starts the flush timer, so it
            # waits at most max_wait_ms (the reference woke the batcher
            # only at a full microbatch, and a lone request waited for the
            # batcher's 100 ms idle poll)
            self._wakeup.set()
        return await fut

    # -- batcher --------------------------------------------------------------

    async def _run(self) -> None:
        max_wait = self.admission.max_wait_ms / 1e3
        while True:
            if not self._queue and not self._closing:
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=0.1)
                except asyncio.TimeoutError:
                    pass
                self._wakeup.clear()
                continue
            if self._queue and self._queued_queries < self.admission.microbatch \
                    and not self._closing:
                # flush-timer window: let company accumulate, bounded
                oldest = self._queue[0].enqueued
                remaining = max_wait - (self._clock() - oldest)
                if remaining > 0:
                    try:
                        await asyncio.wait_for(self._wakeup.wait(),
                                               timeout=remaining)
                    except asyncio.TimeoutError:
                        pass
                    self._wakeup.clear()
            if self._queue:
                await self._flush()
            elif self._closing:
                return

    async def _flush(self) -> None:
        now = self._clock()
        deadline = self.admission.deadline_ms / 1e3
        batch, self._queue = self._queue, []
        self._queued_queries = 0
        live: list[_Pending] = []
        for p in batch:
            if now - p.enqueued > deadline:
                self.stats.shed_deadline += 1
                p.future.set_exception(RequestShed(
                    f"deadline passed after "
                    f"{(now - p.enqueued) * 1e3:.1f}ms in queue"))
            else:
                live.append(p)
        if not live:
            return
        indices = np.concatenate([p.indices for p in live])
        loop = asyncio.get_running_loop()
        version = getattr(self.server, "table_version", 0)
        try:
            results = await loop.run_in_executor(
                self._executor, self._serve_batch, indices)
        except Exception as e:   # surface engine errors to every waiter
            for p in live:
                p.future.set_exception(e)
            return
        self.stats.flushes += 1
        self.stats.table_version = version
        if getattr(self.server, "table_version", 0) != version:
            # an online table swap landed while this flush was in flight:
            # its answers are consistent (one version end to end) but stale
            self.stats.stale_flushes += 1
        if (self.supervisor is not None
                and self.supervisor.health()["state"] == "degraded"):
            self.stats.degraded_flushes += 1
        done = self._clock()
        ladder = self.server.ladder
        off = 0
        for p in live:
            n = p.indices.shape[0]
            if self.query == "predict":
                p.future.set_result(results[off:off + n])
            else:
                p.future.set_result(tuple(r[off:off + n] for r in results))
            off += n
            self.stats.served += 1
            self.stats.served_queries += n
            # per-bucket latency keyed by the REQUEST's own size bucket,
            # not the coalesced batch's — p50/p99 per request class is
            # what the closed-loop report labels them as
            bucket = bucket_for(min(n, ladder[-1]), ladder)
            self.stats.record(bucket, (done - p.enqueued) * 1e3,
                              slo_ms=self.admission.slo_for(bucket))

    def _serve_batch(self, indices: np.ndarray):
        if self.query == "predict":
            return self.server.predict(indices).cpu().numpy()
        mode, k, *rest = self.top_k_args
        target = rest[0] if rest else None
        scores, items = self.server.top_k(mode, indices, k,
                                          target_mode=target)
        return scores.cpu().numpy(), items.cpu().numpy()


# ---------------------------------------------------------------------------
# closed-loop load harness
# ---------------------------------------------------------------------------

def run_closed_loop(
    server,
    *,
    qps: float,
    duration_s: float,
    concurrency: int = 16,
    max_request: int = 64,
    admission: AdmissionConfig | None = None,
    query: str = "predict",
    top_k_args: tuple | None = None,
    request_pool: np.ndarray | None = None,
    supervisor=None,
    seed: int = 0,
) -> dict:
    """Drive a front end with ``concurrency`` closed-loop clients at a
    target offered rate and measure what actually happened.

    Each client sends a request, awaits its answer (that is what makes
    the loop *closed* — in-flight work bounds itself at ``concurrency``),
    then sleeps an exponential gap calibrated so the aggregate offered
    rate is ``qps`` queries/s. Request sizes are log-uniform in
    [1, max_request] (the web-traffic shape the bucket ladder exists
    for). When the engine can't keep up, admission control sheds — the
    achieved rate and shed counts in the result are the capacity
    measurement.

    ``request_pool``: optional (P, N) index pool to draw predict queries
    from (defaults to uniform over ``server.dims``).

    Returns a plain dict (JSON-ready): offered/achieved rates,
    request/shed counts, overall and per-bucket latency percentiles.
    """
    async def _main() -> dict:
        rng = np.random.default_rng(seed)
        mean_size = (max_request - 1) / max(np.log(max_request), 1e-9) \
            if max_request > 1 else 1.0
        rate_per_client = qps / (concurrency * mean_size)  # requests/s

        def draw() -> np.ndarray:
            size = int(np.exp(rng.uniform(0, np.log(max_request)))) \
                if max_request > 1 else 1
            if query == "predict":
                if request_pool is not None:
                    pick = rng.integers(0, len(request_pool), size)
                    return np.asarray(request_pool)[pick]
                return np.stack(
                    [rng.integers(0, d, size) for d in server.dims],
                    axis=1).astype(np.int32)
            mode = top_k_args[0]
            return rng.integers(0, server.dims[mode], size,
                                dtype=np.int32)

        async with ServeFrontend(server, admission, query=query,
                                 top_k_args=top_k_args,
                                 supervisor=supervisor) as fe:
            t_end = time.monotonic() + duration_s

            async def client() -> None:
                while time.monotonic() < t_end:
                    req = draw()
                    try:
                        await fe.submit(req)
                    except RequestShed:
                        pass
                    gap = rng.exponential(1.0 / rate_per_client) \
                        if rate_per_client > 0 else 0.0
                    # never oversleep the horizon by more than one gap
                    await asyncio.sleep(min(gap, 1.0))

            t0 = time.monotonic()
            await asyncio.gather(*(client() for _ in range(concurrency)))
            wall = time.monotonic() - t0
            st = fe.stats
            return {
                "offered_qps": float(qps),
                "duration_s": float(wall),
                "concurrency": int(concurrency),
                "max_request": int(max_request),
                "requests": int(st.admitted + st.shed_queue_full),
                "served_requests": int(st.served),
                "served_queries": int(st.served_queries),
                "achieved_qps": float(st.served_queries / max(wall, 1e-9)),
                "shed_queue_full": int(st.shed_queue_full),
                "shed_deadline": int(st.shed_deadline),
                "flushes": int(st.flushes),
                "stale_flushes": int(st.stale_flushes),
                "degraded_flushes": int(st.degraded_flushes),
                "latency_ms": st.percentiles(),
                "by_bucket": {str(b): v for b, v in
                              st.bucket_percentiles().items()},
                "slo_budget_ms": (
                    {str(b): float(v) for b, v in
                     sorted(fe.admission.slo_ms.items())}
                    if isinstance(fe.admission.slo_ms, dict)
                    else fe.admission.slo_ms),
                "slo_violations": {str(b): int(v) for b, v in
                                   sorted(st.slo_violations.items())},
                **({"supervisor": supervisor.health()}
                   if supervisor is not None else {}),
            }

    return asyncio.run(_main())
