"""Fault tolerance: injection plans, retry backoff, the training supervisor.

Counterpart of ``repro.runtime.fault``:

  * ``FaultPlan`` / ``FaultSpec`` — deterministic, seedable fault injection
    at named *sites* (``ingest`` / ``transfer`` / ``refresh`` / ``publish``
    in the serving refresh supervisor, ``serve.supervisor``).  Each
    ``check(site)`` advances that site's counter and raises
    ``FaultInjected`` at targeted check indices or with a seeded per-site
    probability, draw for draw the reference's.
  * ``backoff(attempt, ...)`` — the shared deterministic
    exponential-backoff-with-jitter schedule every retry loop uses.
  * ``Supervisor`` — the training-loop wrapper: on an exception it
    restores the latest checkpoint and resumes from its step, within a
    budget of ``max_restarts``; it checkpoints every ``checkpoint_every``
    steps and counts straggler steps against an EWMA of the step time.
    ``restore`` copies into the state it is given
    (``checkpoint.manager``).  ``FailureInjector`` is the step-targeted
    injector it is tested with.
"""
from __future__ import annotations

import dataclasses
import logging
import time
import zlib
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


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

class FaultInjected(RuntimeError):
    """An injected (not organic) failure — raised by ``FaultPlan.check``."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One site's injection rule.

    ``hits``  — check indices (0-based, per-site counter) that raise;
                e.g. ``{0, 1, 2}`` fails the first three checks of the
                site then clears.
    ``prob``  — additionally raise with this probability per check,
                from a ``(seed, site)``-keyed deterministic stream.
    """

    site: str
    hits: frozenset = frozenset()
    prob: float = 0.0

    def __post_init__(self):
        if not self.site:
            raise ValueError("FaultSpec needs a site name")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")


class FaultPlan:
    """Deterministic, seedable multi-site failure injection.

        plan = FaultPlan([FaultSpec("ingest", hits={0, 1})], seed=0)
        plan.check("ingest")   # raises FaultInjected (check #0)
        plan.check("ingest")   # raises FaultInjected (check #1)
        plan.check("ingest")   # passes — the fault has cleared

    ``parse`` builds a plan from the CLI grammar: comma-separated
    ``site@i:j:k`` (targeted check indices) and/or ``site%p``
    (probability) terms, e.g. ``"ingest@0:1,refresh@2,transfer%0.1"``.
    """

    def __init__(self, specs=(), seed: int = 0):
        self.seed = int(seed)
        self._specs: dict[str, FaultSpec] = {}
        for s in specs:
            if s.site in self._specs:
                raise ValueError(f"duplicate FaultSpec for site {s.site!r}")
            self._specs[s.site] = s
        self._counts: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self._rngs: dict[str, np.random.Generator] = {}

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Build a plan from the CLI grammar (see class docstring)."""
        specs = []
        for term in filter(None, (t.strip() for t in text.split(","))):
            if "%" in term:
                site, _, p = term.partition("%")
                specs.append(FaultSpec(site, prob=float(p)))
            elif "@" in term:
                site, _, idxs = term.partition("@")
                hits = frozenset(int(i) for i in idxs.split(":") if i != "")
                if not hits:
                    raise ValueError(f"no check indices in {term!r}")
                specs.append(FaultSpec(site, hits=hits))
            else:
                raise ValueError(
                    f"bad fault term {term!r} (want site@i:j or site%p)")
        return cls(specs, seed=seed)

    def check(self, site: str) -> None:
        """Advance ``site``'s check counter; raise ``FaultInjected`` if
        the spec fires at this check.  Sites without a spec pass free."""
        n = self._counts.get(site, 0)
        self._counts[site] = n + 1
        spec = self._specs.get(site)
        if spec is None:
            return
        fire = n in spec.hits
        if not fire and spec.prob:
            rng = self._rngs.get(site)
            if rng is None:
                rng = self._rngs[site] = np.random.default_rng(
                    (self.seed, zlib.crc32(site.encode())))
            fire = rng.random() < spec.prob
        if fire:
            self._fired[site] = self._fired.get(site, 0) + 1
            raise FaultInjected(
                f"injected {site} fault (check #{n} of site {site!r})")

    @property
    def fired(self) -> int:
        """Total faults raised so far, across all sites."""
        return sum(self._fired.values())

    def fired_by_site(self) -> dict[str, int]:
        return dict(self._fired)

    def checks(self, site: str) -> int:
        return self._counts.get(site, 0)

    def clear(self) -> None:
        """Drop all specs (keep counters): the 'injector removed' state."""
        self._specs.clear()


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
