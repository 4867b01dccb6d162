"""Named training-strategy registry (counterpart of
``repro.distributed.base``).

Every training scheme is a ``DistStrategy`` registered under a name, the
same pattern as the kernel-backend registry (``repro_torch.kernels.dispatch``)
one layer up: ``"local"`` (single-device SGD, the reference trajectory),
``"sync"`` (data-parallel minibatch, summed gradients), ``"strata"`` (the
paper's Fig.-2 stratified rotation over a Latin-hypercube schedule) and
``"strata_overlap"`` (the same schedule in chunks, the rotations issued
ahead of use on side streams).  The last three run on an in-process worker
mesh (``launch.mesh``); ``distributed.collectives`` moves their data.

Uniform contract (the launcher drives every strategy through this):

    plan    = strategy.prepare(tensor, cfg, mesh, compress=..., seed=...)
    dstate  = strategy.init(plan, train_state, generator)
    step_fn = strategy.make_step(plan)
    dstate  = step_fn(dstate)                     # advances steps_per_call
    dstate  = strategy.step_batch(plan, dstate, picks)   # fed draws
    params  = strategy.eval_params(plan, dstate)
    dstate, dirty, dirty_dev = strategy.refresh_steps(plan, dstate, idx,
                                                      val, K)
    strategy.save(plan, ckpt, dstate) / strategy.restore(plan, ckpt, dstate)

Randomness.  The reference's ``DistState.key`` is a base PRNG key into
which each step folds its step count (and each device its index), so its
resume is exact by construction.  PyTorch draws from a stateful
``torch.Generator`` instead, and the port keeps **the generator's state**
(``Generator.get_state()``, a CPU ``uint8`` tensor) as the ``rng`` leaf:
each step sets it on the step's generator, draws its batch and stores the
advanced state.  A restored run therefore draws exactly the batches the
uninterrupted run drew after the same step.  The mesh strategies keep one
state a worker, stacked (M, ·): worker 0 takes the state of the generator
given to ``init`` (so ``sync`` on one worker draws what ``local`` draws)
and worker m > 0 a generator seeded from its initial seed and m.  PyTorch
cannot reproduce threefry, so every strategy also takes fed draws
(``step_batch``), which the parity tests use.

``DistState.step`` is a Python int, as ``TrainState.step`` is in the port;
``save`` writes it as a 0-dim int64 tensor and ``restore`` reads it back,
so the checkpoint is one tree of tensors.  XLA's ``lower_step`` and the
donation policy (``step_donation``) have no PyTorch counterpart.
"""
from __future__ import annotations

import abc
import os
import warnings
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch.core.fasttucker import (FastTuckerConfig, FastTuckerParams,
                                         TrainState)

ENV_VAR = "REPRO_DIST_STRATEGY"
DEFAULT_STRATEGY = "local"
# worker m > 0 seeds its generator with (initial seed + m·this) mod 2^63
_WORKER_SEED_STRIDE = 0x9E3779B97F4A7C15


class DistState(NamedTuple):
    """Uniform training state (one checkpointable tree with ``step``).

    ``local`` holds the global tensors: ``params`` a ``FastTuckerParams``,
    ``rng`` one generator state, ``ef`` the int8 error-feedback residuals
    (factor-shaped, f32) when compression is on and ``()`` otherwise.  The
    mesh strategies hold one entry a worker, on its device: ``params`` a
    tuple of M ``FastTuckerParams`` (``sync``: replicas; the strata
    flavors: each mode's row shard and a core replica), ``rng`` the (M, ·)
    stacked generator states, ``ef`` a tuple of M residual tuples.
    """

    params: Any           # FastTuckerParams, or one a worker
    step: int             # global update counter
    rng: torch.Tensor     # generator state(s), CPU uint8
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
        (on the plan's first device) is the sampling stream, taken at its
        current state."""

    @abc.abstractmethod
    def make_step(self, plan) -> Callable[[DistState], DistState]:
        """Build the update function (advances ``steps_per_call`` steps)."""

    def steps_per_call(self, plan) -> int:
        return 1

    def nnz_per_step(self, plan) -> int:
        """Nonzeros consumed per update step (throughput accounting).

        Default: one |Ψ| draw.  Strategies whose workers each draw their
        own |Ψ| (sync, the strata flavors) override with M·|Ψ|.
        """
        return plan.cfg.batch_size

    # -- evaluation ----------------------------------------------------------

    def eval_params(self, plan, dstate: DistState) -> FastTuckerParams:
        """Parameters in the global (unpadded, unrotated) layout, on the
        first worker's device."""
        return dstate.params

    # -- online refresh ------------------------------------------------------

    def _refresh_rng(self, dstate: DistState) -> torch.Tensor:
        """The generator state a refresh draws from."""
        return dstate.rng

    def _lift_eval_params(self, plan, dstate: DistState, state: TrainState,
                          rng: torch.Tensor) -> DistState:
        """Lift refreshed global-layout params (and the refresh's advanced
        generator state) back into strategy state.

        The inverse of ``eval_params``'s view: the single-device layout IS
        the global one, so only the step and the state move; the mesh
        strategies override this to re-shard (the strata flavors re-pad
        the factor rows to the worker multiple).  ``ef`` carries over: the
        refresh is factor-phase only.
        """
        return DistState(state.params, state.step, rng, dstate.ef)

    def refresh_steps(self, plan, dstate: DistState, indices, values,
                      num_steps: int) -> tuple[DistState, tuple, tuple]:
        """K bounded factor-phase SGD steps over a recent-nonzero window.

        The strategy-uniform face of ``core.fasttucker.refresh_steps``:
        evaluate to the global layout, catch the factors up on the window
        (``indices`` (W, N), ``values`` (W,), numpy or tensors; core
        frozen), and lift the result back into strategy state through
        ``_lift_eval_params``.  The batches are drawn from the generator
        state ``_refresh_rng`` picks (the mesh strategies: worker 0's), and
        the advanced state goes back into the result, so a refresh run
        twice from the same ``dstate`` draws the same batches and
        successive refreshes draw fresh ones.

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
        gen.set_state(self._refresh_rng(dstate))
        state, dirty, dirty_dev = _refresh(TrainState(params, dstate.step),
                                           gen, indices, values, plan.cfg,
                                           num_steps)
        return (self._lift_eval_params(plan, dstate, state, gen.get_state()),
                dirty, dirty_dev)

    # -- introspection -------------------------------------------------------

    def lower_step(self, plan, dstate: DistState):
        """The reference returns the XLA ``Lowered`` of one compiled step
        for its HLO analyses; eager PyTorch has no lowered program."""
        raise NotImplementedError(
            f"{self.name}: lower_step returns XLA's lowered HLO, which has "
            "no PyTorch counterpart (the port's steps run eagerly)")

    # -- checkpointing (uniform across strategies) ---------------------------

    def checkpoint_tree(self, plan, dstate: DistState) -> DistState:
        """The tree of tensors ``save`` writes for ``dstate``."""
        return checkpoint_tree(dstate)

    def save(self, plan, ckpt, dstate: DistState,
             blocking: bool = True) -> None:
        ckpt.save(dstate.step, self.checkpoint_tree(plan, dstate),
                  blocking=blocking)

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
# the mesh strategies' shared state handling
# ---------------------------------------------------------------------------

class MeshStrategy(DistStrategy):
    """Per-worker state (``sync`` and the strata flavors).

    At rest each worker holds its part on its device; a checkpoint holds
    the reference's global layout (``_globalize``: one set of factors, the
    residuals stacked (M, …) a mode, the (M, ·) generator states) and
    ``restore`` re-shards it (``_localize``).
    """

    needs_mesh = True

    @abc.abstractmethod
    def _globalize(self, plan, dstate: DistState) -> DistState:
        """``dstate`` in the global layout, in fresh tensors."""

    @abc.abstractmethod
    def _localize(self, plan, gstate: DistState) -> DistState:
        """The inverse of ``_globalize``."""

    def nnz_per_step(self, plan) -> int:
        # every worker draws its own |Ψ|
        return plan.cfg.batch_size * plan.mesh.size

    def _refresh_rng(self, dstate: DistState) -> torch.Tensor:
        return dstate.rng[0].clone()

    def _worker_rng(self, dstate: DistState, rng0: torch.Tensor
                    ) -> torch.Tensor:
        rng = dstate.rng.clone()
        rng[0] = rng0
        return rng

    def checkpoint_tree(self, plan, dstate: DistState) -> DistState:
        return checkpoint_tree(self._globalize(plan, dstate))

    def restore(self, plan, ckpt, like: DistState,
                step: int | None = None) -> DistState:
        restored, _ = ckpt.restore(
            checkpoint_tree(self._globalize(plan, like)), step)
        return self._localize(plan,
                              restored._replace(step=int(restored.step)))


def worker_rng(generator: torch.Generator, mesh) -> torch.Tensor:
    """(M, ·) generator states: worker 0 the state of ``generator``, worker
    m > 0 a fresh generator on its device seeded from ``generator``'s
    initial seed and m."""
    if generator.device.type != mesh.devices[0].type:
        raise ValueError(f"the sampling generator is on {generator.device}, "
                         f"the mesh's workers on {mesh.devices[0].type}")
    seed = generator.initial_seed()
    states = [generator.get_state()]
    for m in range(1, mesh.size):
        g = torch.Generator(device=mesh.devices[m])
        g.manual_seed((seed + m * _WORKER_SEED_STRIDE) % 2 ** 63)
        states.append(g.get_state())
    return torch.stack(states)


def stack_ef(ef: tuple, mesh) -> tuple:
    """Per-worker residual tuples → one (M, …) tensor a mode on worker 0's
    device (the reference's at-rest layout); ``()`` stays ``()``."""
    if not ef:
        return ()
    dev0 = mesh.devices[0]
    return tuple(torch.stack([e[n].to(dev0) for e in ef])
                 for n in range(len(ef[0])))


def unstack_ef(ef: tuple, mesh) -> tuple:
    """The inverse of ``stack_ef``: worker m's residuals copied onto its
    device."""
    if not ef:
        return ()
    from .collectives import copy_to

    return tuple(tuple(copy_to(e[m], d) for e in ef)
                 for m, d in enumerate(mesh.devices))


class WorkerDraws:
    """One generator a worker; ``draw`` sets each to its state in
    ``rng``, draws (B,) int64 picks in [0, high_m) on the worker's device,
    and returns them with the advanced states."""

    def __init__(self, mesh):
        self.gens = [torch.Generator(device=d) for d in mesh.devices]

    def draw(self, rng: torch.Tensor, highs: Sequence[int], batch: int
             ) -> tuple[list[torch.Tensor], torch.Tensor]:
        picks, states = [], []
        for g, state, high in zip(self.gens, rng, highs):
            # a fresh tensor: set_state does not honour a view's offset
            g.set_state(state.clone())
            picks.append(torch.randint(0, high, (batch,), generator=g,
                                       device=g.device))
            states.append(g.get_state())
        return picks, torch.stack(states)


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


def resolve_strategy_name(name: str | None = None,
                          mode: str | None = None) -> str:
    """explicit ``name`` > deprecated ``mode`` > $REPRO_DIST_STRATEGY >
    local.  ``mode`` is the pre-registry ``--mode`` flag; passing it warns
    ``DeprecationWarning``."""
    if name:
        return name
    if mode:
        warnings.warn(
            "--mode is deprecated; use --strategy "
            f"{'/'.join(available_strategies())}",
            DeprecationWarning, stacklevel=2)
        return mode
    return os.environ.get(ENV_VAR) or DEFAULT_STRATEGY


def get_strategy(name: str | None = None,
                 mode: str | None = None) -> DistStrategy:
    """The strategy registered under the resolved name
    (``resolve_strategy_name``)."""
    resolved = resolve_strategy_name(name, mode)
    try:
        return _REGISTRY[resolved]
    except KeyError:
        raise KeyError(
            f"unknown distributed strategy {resolved!r}; "
            f"available: {available_strategies()}") from None


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def compressed_reduce(dense, ef, mesh=None, traffic=None):
    """int8 error-feedback quantize → (sum over the workers) → dequantize.

    With ``mesh=None``, ``dense``/``ef`` are matching tuples of tensors and
    nothing is summed (one device: the quantization round trip and the
    residual carry still apply, so ``local --compress`` is the numerics
    reference for the distributed compressed paths).  With a mesh they are
    sequences of M such tuples, one a worker: each worker quantizes its
    own part against its own residuals, and the dequantized parts are
    summed in fixed worker order (``collectives.psum``).  Returns
    ``(summed, new_ef)`` in the shape it was given.

    What it moves goes into ``traffic`` (``collectives.Traffic``) as the
    ``psum`` of the dequantized parts: each worker dequantizes its int8
    payload before the sum, as the reference does before its
    ``jax.lax.psum``, so the wire carries f32, the bytes of the
    uncompressed sum.  Compression changes the values summed, not the
    bytes counted.
    """
    from repro_torch.optim.compression import compress_ef, decompress

    def one(parts, res):
        out, new_ef = [], []
        for g, e in zip(parts, res):
            q, scale, ne = compress_ef(g, e)
            out.append(decompress(q, scale))
            new_ef.append(ne)
        return tuple(out), tuple(new_ef)

    if mesh is None:
        return one(dense, ef)
    from .collectives import psum

    deq, new_ef = zip(*(one(d, e) for d, e in zip(dense, ef)))
    return psum(deq, mesh, traffic), list(new_ef)


__all__ = [
    "ENV_VAR",
    "DEFAULT_STRATEGY",
    "DistState",
    "DistStrategy",
    "MeshStrategy",
    "WorkerDraws",
    "checkpoint_tree",
    "register_strategy",
    "available_strategies",
    "resolve_strategy_name",
    "get_strategy",
    "compressed_reduce",
    "stack_ef",
    "unstack_ef",
    "worker_rng",
]
