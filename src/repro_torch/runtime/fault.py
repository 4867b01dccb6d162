"""Fault tolerance for training: retry backoff, the supervisor, failure
injection.

Counterpart of ``backoff``, ``SupervisorConfig``, ``SupervisorStats``,
``Supervisor`` and ``FailureInjector`` in ``repro.runtime.fault``.  The
supervisor wraps the training loop: on an exception it restores the latest
checkpoint and resumes from its step, within a budget of ``max_restarts``;
it checkpoints every ``checkpoint_every`` steps and counts straggler steps
against an EWMA of the step time.  ``restore`` copies into the state it is
given (``checkpoint.manager``).  ``FaultPlan`` / ``FaultSpec``, which
drive the reference's serving-side fault injection, wait for Tucker
serving (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager

log = logging.getLogger("repro_torch.fault")


def backoff(attempt: int, base: float = 0.05, cap: float = 1.0,
            seed: int = 0) -> float:
    """Deterministic exponential backoff + jitter, in seconds.

    ``min(cap, base·2^attempt)`` scaled by a jitter factor in [0.5, 1.0)
    drawn from a ``(seed, attempt)``-keyed generator — the reference's
    schedule, draw for draw.
    """
    if attempt < 0:
        raise ValueError(f"attempt must be ≥ 0, got {attempt}")
    span = min(float(cap), float(base) * (2.0 ** attempt))
    jitter = 0.5 + 0.5 * np.random.default_rng((seed, attempt)).random()
    return span * jitter


@dataclasses.dataclass
class SupervisorConfig:
    checkpoint_every: int = 100
    async_checkpoint: bool = True
    max_restarts: int = 5
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


@dataclasses.dataclass
class SupervisorStats:
    restarts: int = 0
    straggler_steps: int = 0
    checkpoints: int = 0
    ewma_step_s: float = 0.0


class Supervisor:
    def __init__(self, ckpt: CheckpointManager, cfg: SupervisorConfig):
        self.ckpt = ckpt
        self.cfg = cfg
        self.stats = SupervisorStats()

    def run(
        self,
        state: Any,
        step_fn: Callable[[Any, int], Any],
        num_steps: int,
        start_step: int = 0,
    ) -> Any:
        """Run ``step_fn(state, i) -> state`` with restart-on-failure.

        On exception: restore the latest checkpoint, resume from its step.
        """
        i = start_step
        restarts_left = self.cfg.max_restarts
        while i < num_steps:
            try:
                t0 = time.monotonic()
                state = step_fn(state, i)
                dt = time.monotonic() - t0
                st = self.stats
                if st.ewma_step_s == 0.0:
                    st.ewma_step_s = dt
                else:
                    a = self.cfg.ewma_alpha
                    if dt > self.cfg.straggler_factor * st.ewma_step_s:
                        st.straggler_steps += 1
                        log.warning(
                            "straggler step %d: %.3fs vs ewma %.3fs",
                            i, dt, st.ewma_step_s,
                        )
                    st.ewma_step_s = (1 - a) * st.ewma_step_s + a * dt
                i += 1
                if i % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(
                        i, state, blocking=not self.cfg.async_checkpoint)
                    self.stats.checkpoints += 1
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — restart-on-any-failure
                if restarts_left == 0:
                    raise RuntimeError(
                        f"supervisor: out of restarts at step {i}"
                    ) from e
                restarts_left -= 1
                self.stats.restarts += 1
                log.error("step %d failed (%s); restoring", i, e)
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    log.error("no checkpoint to restore; restarting fresh")
                    i = start_step
                    continue
                state, i = self.ckpt.restore(state)
        self.ckpt.wait()
        return state


class FailureInjector:
    """Deterministic failure injection for tests: raises at given steps."""

    def __init__(self, fail_at: set[int]):
        self.fail_at = set(fail_at)
        self.raised: set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.raised:
            self.raised.add(step)
            raise RuntimeError(f"injected failure at step {step}")
