"""Checkpointing with a two-phase commit and asynchronous writes.

Counterpart of ``repro.checkpoint.manager``, with the same layout
(npy-per-leaf):

    <dir>/step_000000123.tmp/     # leaves + staged manifest, written first
        leaf_000000.npy ...
        manifest.json.staged
    <dir>/step_000000123/         # os.replace'd into place
        manifest.json             # commit marker, os.replace'd LAST

A step is committed if and only if ``manifest.json`` exists in its final
directory: the marker lands in one atomic ``os.replace`` after every leaf
is in place, so a kill at any point of a save leaves ``latest_step()`` on
the previous commit (markerless debris is swept by the next save's gc).
Re-saving an existing step decommits it first (marker unlink, also
atomic).  ``keep`` bounds the committed steps on disk; ``save(...,
blocking=False)`` copies the leaves to the host at once and writes them
on a background thread, which ``wait()`` joins, raising what the write
raised (the next ``save`` waits first).

A tree is a tensor, or a module (its ``state_dict``), a named tuple, a
mapping, a list or a tuple of trees; its leaves are named by their dotted
paths (``params.embed.embedding``, ``opt.m.layers.0.ln1.scale``) and
written in name order, with the names in the manifest.  numpy has no
bfloat16: a bf16 leaf is stored as its ``uint16`` view, with
``"bfloat16"`` in the manifest, and restored bit for bit.  ``restore``
copies the leaves into the tensors of the tree it is given, on their
devices (a second copy of a full-width training state would not fit the
card), and raises on a name, shape or dtype mismatch before it copies
anything.  The reference's elastic re-placement onto another mesh waits
for sharded training (ROADMAP.md).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

BF16 = "bfloat16"


def flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """name → tensor leaf of ``tree``, in name order."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            out[path] = node
            return
        if isinstance(node, nn.Module):
            items = node.state_dict(keep_vars=True).items()
        elif hasattr(node, "_asdict"):
            items = node._asdict().items()
        elif isinstance(node, Mapping):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            raise TypeError(f"checkpoint leaf {path or '<root>'} is a "
                            f"{type(node).__name__}, not a tensor")
        for key, val in items:
            walk(val, f"{path}.{key}" if path else str(key))

    walk(tree, prefix)
    return dict(sorted(out.items()))


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (never a view of its storage) and its dtype
    name."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16), BF16
    a = t.to("cpu", copy=True).numpy()
    return a, str(a.dtype)


def from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor of a loaded leaf ``a`` whose manifest dtype is
    ``dtype`` (a bf16 leaf arrives as its ``uint16`` view)."""
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _dtype_name(t: torch.Tensor) -> str:
    return BF16 if t.dtype == torch.bfloat16 else str(
        torch.empty((), dtype=t.dtype).numpy().dtype)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        leaves = [(name, *_to_host(t)) for name, t in flatten(tree).items()]
        if blocking:
            self._write(step, leaves)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_reporting, args=(step, leaves),
                daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the background write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _write_reporting(self, step: int, leaves: list) -> None:
        try:
            self._write(step, leaves)
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            self._error = e

    def _write(self, step: int, leaves: list) -> None:
        tmp = self.dir / f"step_{step:09d}.tmp"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {
            "step": step,
            "num_leaves": len(leaves),
            "written_at": time.time(),
            "leaves": [{"name": name, "shape": list(a.shape), "dtype": dt}
                       for name, a, dt in leaves],
        }
        for i, (_, a, _) in enumerate(leaves):
            np.save(tmp / f"leaf_{i:06d}.npy", a)
        # the manifest is the commit marker: stage it under a non-marker
        # name so the step cannot look committed until the very last rename
        (tmp / "manifest.json.staged").write_text(json.dumps(manifest))
        if final.exists():
            # decommit (atomic marker unlink) BEFORE clearing: a kill
            # mid-rmtree leaves an uncommitted dir, never a corrupt commit
            (final / "manifest.json").unlink(missing_ok=True)
            shutil.rmtree(final)
        os.replace(tmp, final)
        # atomic commit: the marker appears only with every leaf in place
        os.replace(final / "manifest.json.staged", final / "manifest.json")
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
        # crash debris: staging dirs and markerless (uncommitted) steps.
        # No writer is concurrent here — save() serializes on wait() and
        # _gc runs on the writing thread — so anything markerless is dead.
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and (
                    p.name.endswith(".tmp")
                    or not (p / "manifest.json").exists()):
                shutil.rmtree(p, ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") \
                    and not p.name.endswith(".tmp") \
                    and (p / "manifest.json").exists():
                out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _committed(self, step: int | None) -> tuple[Path, dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        return d, json.loads((d / "manifest.json").read_text())

    def load_leaves(self, step: int | None = None
                    ) -> tuple[dict, list[np.ndarray]]:
        """Raw (manifest, leaves) of a committed step, in the manifest's
        order; a bf16 leaf is its ``uint16`` view."""
        d, manifest = self._committed(step)
        leaves = [np.load(d / f"leaf_{i:06d}.npy")
                  for i in range(manifest["num_leaves"])]
        return manifest, leaves

    def restore(self, like: Any, step: int | None = None
                ) -> tuple[Any, int]:
        """Copy a committed step (default: the latest) into the tensors of
        ``like`` → (like, step).  Raises ``ValueError`` before copying
        anything when the names, shapes or dtypes differ."""
        d, manifest = self._committed(step)
        leaves = flatten(like)
        saved = manifest["leaves"]
        names = [s["name"] for s in saved]
        if names != list(leaves):
            raise ValueError(
                f"checkpoint has {len(names)} leaves, the state "
                f"{len(leaves)}: incompatible state structure (only in the "
                f"checkpoint {sorted(set(names) - set(leaves))[:5]}, only "
                f"in the state {sorted(set(leaves) - set(names))[:5]})")
        for s, t in zip(saved, leaves.values()):
            if tuple(s["shape"]) != tuple(t.shape) \
                    or s["dtype"] != _dtype_name(t):
                raise ValueError(
                    f"{s['name']}: {s['dtype']}{s['shape']} in the "
                    f"checkpoint, {_dtype_name(t)}{list(t.shape)} in the "
                    "state")
        with torch.no_grad():
            for i, (s, t) in enumerate(zip(saved, leaves.values())):
                t.copy_(from_host(np.load(d / f"leaf_{i:06d}.npy"),
                                  s["dtype"]))
        return like, manifest["step"]
