"""Named training-strategy registry (counterpart of
``repro.distributed.base``).

Every training scheme is a ``DistStrategy`` registered under a name, the
same pattern as the kernel-backend registry (``repro_torch.kernels.dispatch``)
one layer up.  The port registers ``"local"`` (single-device SGD, the
reference trajectory); ``"sync"``, ``"strata"`` and ``"strata_overlap"``
are the reference's multi-device schemes and are not ported yet
(``get_strategy`` raises ``NotImplementedError`` for them, ``KeyError`` for
a name the reference does not know either).

Uniform contract (the launcher drives every strategy through this):

    plan    = strategy.prepare(tensor, cfg, None, compress=..., seed=...)
    dstate  = strategy.init(plan, train_state, generator)
    step_fn = strategy.make_step(plan)
    dstate  = step_fn(dstate)                     # advances steps_per_call
    params  = strategy.eval_params(plan, dstate)
    dstate, dirty, dirty_dev = strategy.refresh_steps(plan, dstate, idx,
                                                      val, K)
    strategy.save(plan, ckpt, dstate) / strategy.restore(plan, ckpt, dstate)

Randomness.  The reference's ``DistState.key`` is a base PRNG key into
which each step folds its step count, so its resume is exact by
construction.  PyTorch draws from a stateful ``torch.Generator`` instead,
and the port keeps **the generator's state** (``Generator.get_state()``, a
CPU ``uint8`` tensor) as the ``rng`` leaf: each step sets it on the
step's generator, draws its batch and stores the advanced state.  A
restored run therefore draws exactly the batches the uninterrupted run
drew after the same step, and an uninterrupted run draws exactly what one
generator advanced step by step draws (what ``std_train`` drew before the
strategy layer existed), so earlier trajectories stay comparable.  A seed
from which each step derived its generator would have changed every
batch.

``DistState.step`` is a Python int, as ``TrainState.step`` is in the port;
``save`` writes it as a 0-dim int64 tensor and ``restore`` reads it back,
so the checkpoint is one tree of tensors.  XLA's ``lower_step`` and the
donation policy (``step_donation``) have no PyTorch counterpart.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.fasttucker import (FastTuckerConfig, FastTuckerParams,
                                         TrainState)

DEFAULT_STRATEGY = "local"
# the reference's other strategies, for a clear refusal until they land
UNPORTED = ("sync", "strata", "strata_overlap")


class DistState(NamedTuple):
    """Uniform training state (one checkpointable tree with ``step``).

    ``ef`` holds the int8 error-feedback residuals when compression is on
    (factor-shaped, f32) and is ``()`` otherwise.
    """

    params: FastTuckerParams
    step: int             # global update counter
    rng: torch.Tensor     # the sampling generator's state (CPU uint8)
    ef: tuple = ()


class DistStrategy(abc.ABC):
    """Interface every training scheme implements."""

    name: str = "?"
    needs_mesh: bool = True

    # -- lifecycle -----------------------------------------------------------

    @abc.abstractmethod
    def prepare(self, tensor, cfg: FastTuckerConfig, mesh, *,
                compress: bool = False, seed: int = 0) -> Any:
        """Data layout and schedule; returns an opaque plan."""

    @abc.abstractmethod
    def init(self, plan, state: TrainState,
             generator: torch.Generator) -> DistState:
        """Lift a fresh ``TrainState`` into strategy state; ``generator``
        (on the plan's device) is the sampling stream, taken at its
        current state."""

    @abc.abstractmethod
    def make_step(self, plan) -> Callable[[DistState], DistState]:
        """Build the update function (advances ``steps_per_call`` steps)."""

    def steps_per_call(self, plan) -> int:
        return 1

    def nnz_per_step(self, plan) -> int:
        """Nonzeros consumed per update step (throughput accounting)."""
        return plan.cfg.batch_size

    # -- evaluation ----------------------------------------------------------

    def eval_params(self, plan, dstate: DistState) -> FastTuckerParams:
        """Parameters in the global (unpadded, unrotated) layout."""
        return dstate.params

    # -- online refresh ------------------------------------------------------

    def refresh_steps(self, plan, dstate: DistState, indices, values,
                      num_steps: int) -> tuple[DistState, tuple, tuple]:
        """K bounded factor-phase SGD steps over a recent-nonzero window.

        The strategy-uniform face of ``core.fasttucker.refresh_steps``:
        evaluate to the global layout, catch the factors up on the window
        (``indices`` (W, N), ``values`` (W,), numpy or tensors; core
        frozen), and lift the result back into strategy state (the
        single-device layout is the global one; ``ef`` carries over: the
        refresh is factor-phase only).
        The batches are drawn from the generator state ``dstate.rng``
        carries, and the advanced state goes back into the result, so a
        refresh run twice from the same ``dstate`` draws the same batches
        and successive refreshes draw fresh ones.

        Returns ``(dstate', dirty, dirty_dev)`` — ``dirty[n]`` the sorted
        int32 row ids of mode ``n`` touched by the window, sized for
        ``TuckerServer.update_rows(n, dirty[n], factors[n][dirty[n]])``,
        and ``dirty_dev[n]`` the same ids as an int64 tensor on the device.
        """
        from repro_torch.core.fasttucker import refresh_steps as _refresh

        params = self.eval_params(plan, dstate)
        dev = params.factors[0].device
        indices = torch.as_tensor(indices, dtype=torch.int32, device=dev)
        values = torch.as_tensor(values, dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev)
        gen.set_state(dstate.rng)
        state, dirty, dirty_dev = _refresh(TrainState(params, dstate.step),
                                           gen, indices, values, plan.cfg,
                                           num_steps)
        return (DistState(state.params, state.step, gen.get_state(),
                          dstate.ef), dirty, dirty_dev)

    # -- checkpointing (uniform across strategies) ---------------------------

    def save(self, plan, ckpt, dstate: DistState,
             blocking: bool = True) -> None:
        ckpt.save(dstate.step, checkpoint_tree(dstate), blocking=blocking)

    def restore(self, plan, ckpt, like: DistState,
                step: int | None = None) -> DistState:
        """Copy a committed step into the tensors of ``like`` (a fresh
        ``init``) and return it as a ``DistState``."""
        restored, _ = ckpt.restore(checkpoint_tree(like), step)
        return restored._replace(step=int(restored.step))


def checkpoint_tree(dstate: DistState) -> DistState:
    """``dstate`` as the tree of tensors a checkpoint holds: the step as a
    0-dim int64 tensor."""
    return dstate._replace(step=torch.tensor(dstate.step, dtype=torch.int64))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, DistStrategy] = {}


def register_strategy(strategy: DistStrategy) -> None:
    if strategy.name in _REGISTRY:
        raise ValueError(f"strategy {strategy.name!r} already registered")
    _REGISTRY[strategy.name] = strategy


def available_strategies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_strategy(name: str | None = None) -> DistStrategy:
    """The strategy registered as ``name`` (``local`` when None)."""
    name = name or DEFAULT_STRATEGY
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in UNPORTED:
        raise NotImplementedError(
            f"distributed strategy {name!r} is not ported yet "
            "(ROADMAP.md, Queue 1 item 4); available: "
            f"{available_strategies()}")
    raise KeyError(
        f"unknown distributed strategy {name!r}; "
        f"available: {available_strategies()}")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def compressed_reduce(dense, ef, axis: str | None = None):
    """int8 error-feedback quantize → (reduce) → dequantize.

    ``dense``/``ef`` are matching tuples of tensors.  Only ``axis=None``
    exists in the port (one device: the quantization round trip and the
    residual carry still apply, so ``local --compress`` is the numerics
    reference for the distributed compressed paths); a collective comes
    with the multi-device strategies.
    """
    from repro_torch.optim.compression import compress_ef, decompress

    if axis is not None:
        raise NotImplementedError(
            "compressed_reduce over a device axis needs the multi-device "
            "strategies (ROADMAP.md, Queue 1 item 4)")
    out, new_ef = [], []
    for g, e in zip(dense, ef):
        q, scale, ne = compress_ef(g, e)
        out.append(decompress(q, scale))
        new_ef.append(ne)
    return tuple(out), tuple(new_ef)


__all__ = [
    "DEFAULT_STRATEGY",
    "UNPORTED",
    "DistState",
    "DistStrategy",
    "checkpoint_tree",
    "register_strategy",
    "available_strategies",
    "get_strategy",
    "compressed_reduce",
]
