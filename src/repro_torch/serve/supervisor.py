"""In-process refresh supervisor: resilient ingest→refresh→patch rounds.

Counterpart of ``repro.serve.supervisor``.  The online refresh round runs
on a background thread INSIDE the serving process, with the
``TuckerServer._live`` generation swap as the only synchronization point
with queries.  Both threads run their work on the device's default
stream, so a query and a patch never run at once on the card.

The failure contract
--------------------

Each round runs as a pipeline of four stages, every one fronted by a
``FaultPlan`` check site so tests can fail it deterministically:

    ingest    (``"ingest"``)    fold arrivals into the ``NonzeroStore``,
                                extend the recent-nonzero window
    transfer  (``"transfer"``)  host→device copy of the window
    refresh   (``"refresh"``)   K factor-phase SGD steps → dirty rows
    publish   (``"publish"``)   delta-patch (or drift-escalated rebuild)
                                behind the generation swap

A failed stage retries with the shared exponential-backoff-plus-jitter
schedule (``runtime.fault.backoff``) up to ``max_attempts`` per cycle;
completed stages are never redone (the round object carries its resume
point), so a recovered round runs ``refresh_steps`` exactly once, from the
generator state its ``DistState`` carries — which is why post-recovery
tables and factors are **bitwise-equal (f32)** to a run that never
faulted.  When a cycle's budget is spent the breaker trips into
**degraded mode**: the server keeps answering every query from the last
published generation, ``health()`` reports ``state="degraded"`` with the
staleness age and last error, and the supervisor keeps retrying the stuck
round at a slow cadence with a fresh budget until it clears — then
transitions back to ``ok`` and counts a recovery.

Drift-triggered rebuild
-----------------------

``DriftTracker`` bounds the patched-row fraction per mode and an estimate
of the incremental colsum error; when either crosses its
``SupervisorConfig`` threshold, the next publish sends the dirty rows to
``TuckerServer.sync_factor_rows`` and publishes ONE ``refresh_tables()``
rebuild, resetting the tracker.  The decision is recorded on
``health()["last_publish"]``.

With ``store=`` (a ``data.pipeline.NonzeroStore``) the ingest stage folds
each round's arrivals in by ``self.store = self.store.append(...)`` after
its fault check, so a retried ingest never appends twice; ``store=None``
advances the window alone.  The refresh keeps each mode's dirty ids on the
device beside the host copy, so the publish gathers the new factor rows
with no host-to-device copy and no sync.  ``health()["stage_seconds"]``
has the last published round's seconds in each stage.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time

import numpy as np
import torch

from repro_torch.runtime.fault import FaultPlan, backoff

log = logging.getLogger("repro_torch.serve.supervisor")


def window_block(idx: np.ndarray, val: np.ndarray, size: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-size recent-nonzero window (tiled up when short) — one array
    shape across rounds."""
    if len(val) >= size:
        return idx[-size:], val[-size:]
    reps = -(-size // max(len(val), 1))
    return (np.tile(idx, (reps, 1))[-size:],
            np.tile(val, reps)[-size:])


@dataclasses.dataclass
class SupervisorConfig:
    """Knobs for the refresh round, its retry policy, and drift limits."""

    refresh_steps: int = 4        # K factor-phase steps per round
    window: int = 256             # recent-nonzero window fed to refresh
    max_attempts: int = 3         # per-cycle retry budget before the breaker
    backoff_base_s: float = 0.01  # shared backoff schedule (runtime.fault)
    backoff_cap_s: float = 0.25
    degraded_retry_s: float = 0.05  # cadence of fresh cycles while degraded
    poll_interval_s: float = 0.02   # idle round-queue poll
    seed: int = 0
    # drift escalation: either threshold crossed → next publish is a full
    # refresh_tables() rebuild instead of per-mode delta patches
    max_patched_fraction: float = 1.5   # cumulative dirty rows / mode dim
    max_colsum_drift: float = 1e-4      # accumulated colsum error estimate


class DriftTracker:
    """Accumulates patch drift and decides patch-vs-rebuild.

    ``patched_rows[n]`` counts every row EVENT patched into mode ``n``;
    ``colsum_drift`` is a conservative running estimate of the relative
    error the incremental colsum updates may have accumulated: each patch
    contributes one f32 epsilon scaled by the relative size of its delta.
    """

    def __init__(self, dims, cfg: SupervisorConfig):
        self.dims = tuple(int(d) for d in dims)
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        self.patched_rows = [0] * len(self.dims)
        self.colsum_drift = 0.0

    def note_patch(self, mode: int, count: int, delta_l1: float,
                   scale_l1: float) -> None:
        self.patched_rows[mode] += int(count)
        eps = float(np.finfo(np.float32).eps)
        self.colsum_drift += eps * (1.0 + delta_l1 / max(scale_l1, 1e-30))

    @property
    def patched_fraction(self) -> float:
        return max(r / d for r, d in zip(self.patched_rows, self.dims))

    def should_rebuild(self, pending_counts) -> str | None:
        """Rebuild reason (or None) given the NEXT round's dirty counts —
        the decision includes the pending patch."""
        frac = max((r + int(p)) / d for r, p, d in
                   zip(self.patched_rows, pending_counts, self.dims))
        if frac >= self.cfg.max_patched_fraction:
            return (f"patched fraction {frac:.3f} ≥ "
                    f"{self.cfg.max_patched_fraction}")
        if self.colsum_drift >= self.cfg.max_colsum_drift:
            return (f"colsum drift estimate {self.colsum_drift:.2e} ≥ "
                    f"{self.cfg.max_colsum_drift:.2e}")
        return None


_STAGES = ("ingest", "transfer", "refresh", "publish")


class _Round:
    """One submitted arrival batch + its pipeline resume point."""

    __slots__ = ("idx", "val", "stage", "win_idx", "win_val",
                 "dstate", "dirty", "dirty_dev", "params", "seconds")

    def __init__(self, idx: np.ndarray, val: np.ndarray):
        self.idx = idx
        self.val = val
        self.stage = 0
        self.win_idx = self.win_val = None
        self.dstate = self.dirty = self.dirty_dev = self.params = None
        self.seconds: dict[str, float] = {}


class RefreshSupervisor:
    """Runs the online refresh round on a thread inside the server.

    Parameters
    ----------
    server : TuckerServer
        The live server; its ``_live`` swap is the only point where
        supervisor work becomes visible to queries.
    strategy, plan, dstate
        The training strategy, its prepared plan, and the current
        training state (``strategy.refresh_steps`` drives the catch-up
        and carries the sampling generator's state forward).
    store : NonzeroStore | None
        Ingest target for arrivals (``None`` skips the store fold).
    config : SupervisorConfig
    fault_plan : FaultPlan | None
        Deterministic failure injection at the four stage sites.
    history : (np.ndarray, np.ndarray) | None
        Seed (indices, values) for the recent-nonzero window.
    """

    def __init__(self, server, strategy, plan, dstate, *, store=None,
                 config: SupervisorConfig | None = None,
                 fault_plan: FaultPlan | None = None,
                 history=None):
        self.server = server
        self.strategy = strategy
        self.plan = plan
        self.dstate = dstate
        # where the refresh runs: the global layout's device
        self._device = strategy.eval_params(plan, dstate).factors[0].device
        self.store = store
        self.config = config or SupervisorConfig()
        self.fault_plan = fault_plan
        self.drift = DriftTracker(server.dims, self.config)

        hist_idx, hist_val = (history if history is not None
                              else (np.zeros((0, server.order), np.int32),
                                    np.zeros((0,), np.float32)))
        self._hist_idx = np.asarray(hist_idx, np.int32)
        self._hist_val = np.asarray(hist_val, np.float32)

        self._rounds: collections.deque[_Round] = collections.deque()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending = 0
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

        self._state = "ok"
        self._last_error: str | None = None
        self._last_publish_t = time.monotonic()
        self._last_publish = {"kind": "none", "reason": "no round yet"}
        self._last_dirty: list[int] = [0] * server.order
        self._stage_seconds: dict[str, float] = {}
        self._rounds_ok = 0
        self._retries = 0
        self._breaker_trips = 0
        self._recoveries = 0
        self._rebuilds = 0

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "RefreshSupervisor":
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="refresh-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None
        with self._lock:
            self._state = "stopped"

    # -- submission -----------------------------------------------------------

    def submit(self, indices, values) -> None:
        """Queue one arrival batch for a background round."""
        idx = np.ascontiguousarray(np.asarray(indices, np.int32))
        val = np.ascontiguousarray(np.asarray(values, np.float32))
        with self._lock:
            self._rounds.append(_Round(idx, val))
            self._pending += 1

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted round has published (or timeout).
        Returns False on timeout — e.g. while degraded on a stuck round."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._pending:
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return False
                self._idle.wait(timeout=left if left is not None
                                else self.config.poll_interval_s)
        return True

    def run_round(self, indices, values, max_cycles: int | None = None
                  ) -> dict:
        """Synchronous one-round path (thread must not be running) — the
        test harness entry.  Same retry/breaker machinery as the
        background loop; returns ``health()`` after the publish."""
        if self._thread is not None:
            raise RuntimeError("run_round requires a stopped supervisor")
        self.submit(indices, values)
        with self._lock:
            rnd = self._rounds.popleft()
        self._process(rnd, max_cycles=max_cycles)
        return self.health()

    # -- health ---------------------------------------------------------------

    def health(self) -> dict:
        """Locked snapshot of supervisor + serving-freshness state."""
        with self._lock:
            return {
                "state": self._state,
                "generation": self.server.table_version,
                "staleness_s": time.monotonic() - self._last_publish_t,
                "last_error": self._last_error,
                "rounds_ok": self._rounds_ok,
                "retries": self._retries,
                "breaker_trips": self._breaker_trips,
                "recoveries": self._recoveries,
                "rebuilds": self._rebuilds,
                "last_publish": dict(self._last_publish),
                "last_dirty": list(self._last_dirty),
                "stage_seconds": dict(self._stage_seconds),
                "drift": {
                    "patched_rows": list(self.drift.patched_rows),
                    "patched_fraction": self.drift.patched_fraction,
                    "colsum_drift": self.drift.colsum_drift,
                },
                "faults_injected": (self.fault_plan.fired
                                    if self.fault_plan else 0),
                "pending_rounds": self._pending,
            }

    # -- the round pipeline ---------------------------------------------------

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            with self._lock:
                rnd = self._rounds.popleft() if self._rounds else None
            if rnd is None:
                self._stop_evt.wait(self.config.poll_interval_s)
                continue
            self._process(rnd)

    def _process(self, rnd: _Round, max_cycles: int | None = None) -> None:
        """Drive one round to publication through the retry/breaker FSM."""
        cfg = self.config
        attempt = 0      # failures in the current cycle
        cycles = 0
        while not self._stop_evt.is_set():
            try:
                self._advance(rnd)
            except Exception as e:  # noqa: BLE001 — the breaker's whole job
                attempt += 1
                with self._lock:
                    self._retries += 1
                    self._last_error = f"{type(e).__name__}: {e}"
                if attempt >= cfg.max_attempts:
                    cycles += 1
                    with self._lock:
                        self._breaker_trips += 1
                        if self._state != "degraded":
                            log.warning(
                                "breaker tripped at stage %s: %s — serving "
                                "stale generation %d",
                                _STAGES[rnd.stage], e,
                                self.server.table_version)
                        self._state = "degraded"
                    if max_cycles is not None and cycles >= max_cycles:
                        raise
                    attempt = 0      # fresh budget for the next slow cycle
                    self._stop_evt.wait(cfg.degraded_retry_s)
                else:
                    self._stop_evt.wait(backoff(
                        attempt - 1, base=cfg.backoff_base_s,
                        cap=cfg.backoff_cap_s, seed=cfg.seed))
                continue
            with self._idle:
                if self._state == "degraded":
                    self._recoveries += 1
                    log.info("recovered: round published, generation %d",
                             self.server.table_version)
                self._state = "ok"
                self._last_error = None
                self._rounds_ok += 1
                self._pending -= 1
                self._idle.notify_all()
            return
        # stopping with the round unfinished: leave it pending
        with self._idle:
            self._idle.notify_all()

    def _advance(self, rnd: _Round) -> None:
        """Run the round's remaining stages; ``rnd.stage`` is the resume
        point, bumped only after a stage fully completes.  Every stage
        checks its fault site FIRST, so an injected fault never leaves a
        stage half-applied."""
        while rnd.stage < len(_STAGES):
            name = _STAGES[rnd.stage]
            t0 = time.perf_counter()
            getattr(self, f"_stage_{name}")(rnd)
            rnd.seconds[name] = time.perf_counter() - t0
            rnd.stage += 1
        with self._lock:
            self._stage_seconds = dict(rnd.seconds)

    def _check(self, site: str) -> None:
        if self.fault_plan is not None:
            self.fault_plan.check(site)

    def _stage_ingest(self, rnd: _Round) -> None:
        self._check("ingest")
        if self.store is not None and len(rnd.val):
            self.store = self.store.append(rnd.idx, rnd.val)
        # trailing-window history: identical to concatenating every batch
        # ever seen and windowing, but bounded host memory
        w = self.config.window
        self._hist_idx = np.concatenate([self._hist_idx, rnd.idx])[-w:]
        self._hist_val = np.concatenate([self._hist_val, rnd.val])[-w:]
        rnd.win_idx, rnd.win_val = window_block(
            self._hist_idx, self._hist_val, w)

    def _stage_transfer(self, rnd: _Round) -> None:
        self._check("transfer")
        # synchronous copies: the host window may be rebuilt next round
        dev = self._device
        rnd.win_idx = torch.tensor(rnd.win_idx, device=dev)
        rnd.win_val = torch.tensor(rnd.win_val, device=dev)

    def _stage_refresh(self, rnd: _Round) -> None:
        self._check("refresh")
        # functional: nothing is committed until the call returns, and the
        # generator state comes from self.dstate, so a retry after an
        # injected fault runs the K steps exactly once on the same draws
        dstate, dirty, dirty_dev = self.strategy.refresh_steps(
            self.plan, self.dstate, rnd.win_idx, rnd.win_val,
            self.config.refresh_steps)
        rnd.dstate, rnd.dirty, rnd.dirty_dev = dstate, dirty, dirty_dev
        rnd.params = self.strategy.eval_params(self.plan, dstate)

    def _stage_publish(self, rnd: _Round) -> None:
        self._check("publish")
        srv = self.server
        counts = [len(d) for d in rnd.dirty]
        reason = self.drift.should_rebuild(counts)

        def rows(n, ids):
            # the refresh's own device ids: no host-to-device copy, no sync
            return rnd.params.factors[n].index_select(0, rnd.dirty_dev[n])

        if reason is not None:
            # escalation: rows reach the model without a wasted patch,
            # then ONE rebuild publishes everything and resets drift
            for n, ids in enumerate(rnd.dirty):
                if len(ids):
                    srv.sync_factor_rows(n, ids, rows(n, ids))
            srv.refresh_tables()
            self.drift.reset()
            publish = {"kind": "rebuild", "reason": reason}
            with self._lock:
                self._rebuilds += 1
        else:
            for n, ids in enumerate(rnd.dirty):
                if not len(ids):
                    continue
                before = srv._colsums[n].float().cpu().numpy()
                srv.update_rows(n, ids, rows(n, ids))
                after = srv._colsums[n].float().cpu().numpy()
                self.drift.note_patch(
                    n, len(ids), float(np.abs(after - before).sum()),
                    float(np.abs(after).sum()))
            publish = {"kind": "patch", "reason": "drift within budget"}
        # the refresh's state becomes current only once its publish lands
        self.dstate = rnd.dstate
        with self._lock:
            self._last_publish = publish
            self._last_dirty = counts
            self._last_publish_t = time.monotonic()
