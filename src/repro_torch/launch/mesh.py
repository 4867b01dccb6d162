"""Worker meshes (counterpart of ``repro.launch.mesh``).

The reference is single-controller: one process drives a ``jax`` mesh
through ``shard_map``.  The port keeps that shape with an in-process mesh:
a ``Mesh`` is the ordered tuple of its M workers' devices, with the
reference's axis names, and the multi-device strategies
(``repro_torch.distributed``) keep each worker's shards on its device and
move data between workers with the explicit copies of
``distributed.collectives``.  Several workers may share one device: on one
card the strategies run their M-worker schedule all the same, their
rotations copying between buffers of that card.

Building a mesh touches no device state beyond counting the cards.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.device import resolve_device

FORCE_ENV_VAR = "REPRO_FORCE_HOST_DEVICES"   # the reference tier's devices
AXES = ("data", "model")
PRODUCTION_DEVICES = (256, 512)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """M workers in order: ``devices[m]`` is worker m's device.

    ``shape`` follows ``axis_names``; the workers are laid out row-major
    over it (``data`` major, as ``jax.make_mesh`` lays out its devices).
    """

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]
    axis_names: tuple[str, ...] = AXES

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match its "
                             f"axes {self.axis_names}")
        size = 1
        for s in self.shape:
            size *= s
        if size != len(self.devices) or size < 1:
            raise ValueError(f"mesh shape {self.shape} holds {size} workers, "
                             f"{len(self.devices)} devices given")

    @property
    def size(self) -> int:
        """Number of workers (the reference's ``mesh.devices.size``)."""
        return len(self.devices)

    def distinct_devices(self) -> tuple[torch.device, ...]:
        """The devices the workers use, each once, in worker order."""
        return tuple(dict.fromkeys(self.devices))


def _visible(device: torch.device) -> list[torch.device]:
    """The devices workers may be placed on, ``device`` first."""
    if device.type != "cuda":
        return [device]
    first = device.index if device.index is not None else 0
    n = torch.cuda.device_count()
    return [torch.device("cuda", (first + i) % n) for i in range(n)]


def make_host_mesh(model_parallel: int = 1, *, num_workers: int | None = None,
                   device: str | torch.device | None = None) -> Mesh:
    """A (data, model) mesh of workers placed round-robin over the visible
    devices.

    ``num_workers`` defaults to ``$REPRO_FORCE_HOST_DEVICES`` (the variable
    the reference's test tier sets to fake host devices) and, when that is
    unset, to the number of visible cards (one on the CPU).  ``device``
    (default: the current card) names the first worker's device; with
    ``device="cpu"`` every worker is on the CPU.  So on one H100 four
    workers share ``cuda:0``.  ``model_parallel`` workers form the model
    axis; the worker count is cut to a multiple of it.
    """
    pool = _visible(resolve_device(device))
    n = num_workers or int(os.environ.get(FORCE_ENV_VAR) or 0) or len(pool)
    if n < 1:
        raise ValueError(f"a mesh needs at least one worker, got {n}")
    mp = max(1, min(model_parallel, n))
    n = n // mp * mp
    return Mesh(tuple(pool[m % len(pool)] for m in range(n)), (n // mp, mp))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16×16 single-pod (256 devices) or 2×16×16 multi-pod
    (512) mesh, over the visible cards; raises ``ValueError`` unless
    exactly that many are visible."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    want = PRODUCTION_DEVICES[int(multi_pod)]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have != want:
        raise ValueError(f"the production mesh {shape} needs {want} visible "
                         f"devices, {have} are visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(want)), shape,
                axes)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (pod composes with data)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
