"""Logical-axis → mesh-axis rules, and the layouts they give a leaf.

The port's own copy of ``repro.distributed.sharding``.  Each parameter or
cache leaf carries logical axis names (``models.param_axes``,
``cache_axes_tree``).  Rules map logical names to mesh axes; a rule binds
a dimension only when the dimension divides by the mesh axes' extent
(otherwise that dimension is replicated) and no mesh axis is used twice in
one spec.

The policies, as in the reference:

* ``tp``         tensor parallelism only: heads/kv_heads/mlp/experts/vocab
                 on ``model``; everything else replicated per data shard.
* ``fsdp_tp``    additionally shards ``embed`` over ``data`` (ZeRO-3/FSDP);
                 the AdamW moments take the same layouts.
* ``fsdp_tp_v2`` adds ``head_dim_kv`` and ``kv_lora`` on ``model``.  Both
                 name only cache leaves (``CACHE_AXES``), so its parameter
                 layouts are fsdp_tp's.
* ``zero3``      no tensor parallelism: ``embed`` over ``data``, ``vocab``
                 and ``experts`` on ``model``.
* ``zero3_dp``   zero3 with the batch split over ``model`` too.

The reference hands a ``PartitionSpec`` to XLA.  Here ``spec_for``
returns ``P``, a tuple of the same entries (``None``, an axis name or a
tuple of names, trailing ``None``s dropped), and a ``Layout`` turns a spec
on a ``launch.mesh.Mesh`` into each worker's index slices — the ones
``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the
reference's device m — with ``shard``/``unshard`` to move a full tensor
to the workers and back.  A ``ShardedTensor`` is one leaf held that way:
its workers' parts and its layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

RULES_TP: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "cache_batch": ("pod", "data"),
}

RULES_FSDP_TP = dict(RULES_TP, embed=("data",))

# when kv_heads does not divide the model axis the KV cache would be
# replicated: shard head_dim of the cache and the MLA latent instead
RULES_FSDP_TP_V2 = dict(
    RULES_FSDP_TP,
    head_dim_kv=("model",),
    kv_lora=("model",),
)

# no tensor parallelism for dense training: parameters and moments shard
# over data (ZeRO-3); vocab stays on `model` (logits memory)
RULES_ZERO3 = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "embed": ("data",),
    "cache_batch": ("pod", "data"),
    "mlp": (),
    "heads": (),
    "kv_heads": (),
    "experts": ("model",),
}

# zero3, and data-parallel over the `model` axis too
RULES_ZERO3_DP = dict(RULES_ZERO3, batch=("pod", "data", "model"),
                      cache_batch=("pod", "data", "model"))

POLICIES = {"tp": RULES_TP, "fsdp_tp": RULES_FSDP_TP,
            "fsdp_tp_v2": RULES_FSDP_TP_V2, "zero3": RULES_ZERO3,
            "zero3_dp": RULES_ZERO3_DP}

BATCH_AXES_BY_POLICY = {
    "zero3_dp": ("pod", "data", "model"),
}


class P(tuple):
    """A partition spec: one entry a dimension (``None``, an axis name or a
    tuple of names), trailing ``None``s dropped — the entries of the
    reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _mesh_sizes(mesh) -> dict[str, int]:
    shape = getattr(mesh, "shape", None)
    if not isinstance(shape, tuple):       # a reference-style stub mesh
        shape = tuple(mesh.devices.shape)
    return dict(zip(mesh.axis_names, shape))


def spec_for(axes: Sequence[str | None], shape: Sequence[int], mesh,
             rules: Mapping[str, tuple[str, ...]]) -> P:
    """The spec of a leaf, honouring divisibility and axis uniqueness."""
    used: set[str] = set()
    entries: list[Any] = []
    sizes = _mesh_sizes(mesh)
    for dim, name in zip(shape, axes):
        assign: tuple[str, ...] = ()
        if name is not None and name in rules:
            cand = tuple(a for a in rules[name]
                         if a in sizes and a not in used)
            total = math.prod(sizes[a] for a in cand)
            if cand and dim % total == 0 and dim >= total:
                assign = cand
                used.update(cand)
        if not assign:
            entries.append(None)
        elif len(assign) == 1:
            entries.append(assign[0])
        else:
            entries.append(assign)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A leaf of ``shape`` laid out by ``spec`` over ``mesh``'s workers."""

    shape: tuple[int, ...]
    spec: P
    mesh: Any

    def __post_init__(self) -> None:
        sizes = _mesh_sizes(self.mesh)
        for dim, entry in zip(self.shape, self.spec):
            n = math.prod(sizes[a] for a in entry_axes(entry))
            if dim % n:
                raise ValueError(f"spec {self.spec} does not divide "
                                 f"{self.shape}")

    def coords(self, m: int) -> dict[str, int]:
        """Worker m's coordinate on each mesh axis (row-major workers)."""
        out = {}
        for name, size in reversed(list(zip(self.mesh.axis_names,
                                            self.mesh.shape))):
            out[name] = m % size
            m //= size
        return out

    def axes(self) -> tuple[str, ...]:
        """The mesh axes the spec binds."""
        return tuple(a for e in self.spec for a in entry_axes(e))

    def index(self, m: int) -> tuple[slice, ...]:
        """Worker m's slice of every dimension (the axes of a tuple entry
        split the dimension major to minor)."""
        sizes = _mesh_sizes(self.mesh)
        c = self.coords(m)
        out = []
        for d, dim in enumerate(self.shape):
            entry = self.spec[d] if d < len(self.spec) else None
            k, n = 0, 1
            for a in entry_axes(entry):
                k, n = k * sizes[a] + c[a], n * sizes[a]
            step = dim // n
            out.append(slice(k * step, (k + 1) * step))
        return tuple(out)

    def part_shape(self) -> tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.index(0))

    def owners(self) -> list[int]:
        """The workers counted once for the leaf's elements: index 0 on
        every mesh axis the leaf is replicated over."""
        bound = set(self.axes())
        return [m for m in range(self.mesh.size)
                if all(v == 0 for a, v in self.coords(m).items()
                       if a not in bound)]

    def shard(self, full: torch.Tensor) -> list[torch.Tensor]:
        """``full`` (any device) → each worker's part, a new contiguous
        tensor on the worker's device."""
        if tuple(full.shape) != self.shape:
            raise ValueError(f"shape {tuple(full.shape)}, layout "
                             f"{self.shape}")
        return [full[self.index(m)].to(dev, copy=True).contiguous()
                for m, dev in enumerate(self.mesh.devices)]

    def unshard(self, parts: Sequence[torch.Tensor],
                device=None) -> torch.Tensor:
        """The workers' parts → the full tensor on ``device`` (default:
        worker 0's), each part written in worker order."""
        device = parts[0].device if device is None else device
        full = torch.empty(self.shape, dtype=parts[0].dtype, device=device)
        for m, part in enumerate(parts):
            full[self.index(m)] = part.to(device)
        return full

    def part_bytes(self, itemsize: int) -> int:
        return math.prod(self.part_shape()) * itemsize


class ShardedTensor:
    """One leaf held as its workers' parts (``parts[m]`` on worker m's
    device) on ``layout``."""

    __slots__ = ("parts", "layout")

    def __init__(self, parts: Sequence[torch.Tensor], layout: Layout):
        self.parts = list(parts)
        self.layout = layout

    @property
    def shape(self) -> tuple[int, ...]:
        return self.layout.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def full(self, device=None) -> torch.Tensor:
        return self.layout.unshard([p.detach() for p in self.parts], device)

    def __repr__(self) -> str:
        return (f"ShardedTensor({self.layout.shape}, {self.layout.spec}, "
                f"{len(self.parts)} parts, {self.dtype})")


def shardings_for_tree(axes: Mapping[str, tuple], shapes: Mapping[str, Any],
                       mesh, policy: str = "fsdp_tp") -> dict[str, Layout]:
    """{leaf name: Layout} from {name: logical axes} and {name: shape}."""
    rules = POLICIES[policy]
    return {n: Layout(tuple(shapes[n]),
                      spec_for(ax, tuple(shapes[n]), mesh, rules), mesh)
            for n, ax in axes.items()}


def batch_spec(mesh, batch_size: int, extra_dims: int = 1,
               policy: str = "fsdp_tp") -> P:
    """Shard the leading batch dim over the policy's batch axes when
    divisible, else replicate it."""
    wanted = BATCH_AXES_BY_POLICY.get(policy, ("pod", "data"))
    axes = tuple(a for a in mesh.axis_names if a in wanted)
    sizes = _mesh_sizes(mesh)
    total = math.prod(sizes[a] for a in axes)
    if batch_size % total != 0:
        return P(*([None] * (1 + extra_dims)))
    lead = axes if len(axes) > 1 else axes[0]
    return P(lead, *([None] * extra_dims))


def replicated(mesh) -> P:
    return P()


# Serving: ROW mode shards each C^(n) table (I_n, R) over data; BATCH
# mode replicates the tables and splits the request batch
RULES_SERVE: dict[str, tuple[str, ...]] = {"serve_rows": ("data",)}


def serve_row_spec(mesh, shape: Sequence[int]) -> P:
    """The row-sharded spec of a (rows, R) serving table (replicated when
    the rows do not divide the data axis)."""
    return spec_for(("serve_rows", None), shape, mesh, RULES_SERVE)


def serve_table_replication(mesh) -> P:
    """The batch-sharded serving layout of the tables: a full replica on
    every worker."""
    return replicated(mesh)


# Cache leaves use positional axis conventions:
CACHE_AXES = {
    # attention caches ("head_dim_kv"/"kv_lora" only bind under *_v2 rules)
    "k": ("cache_batch", None, "kv_heads", "head_dim_kv"),
    "v": ("cache_batch", None, "kv_heads", "head_dim_kv"),
    "c_kv": ("cache_batch", None, "kv_lora"),
    "k_pe": ("cache_batch", None, None),
    # ssm caches
    "conv": ("cache_batch", None, "mlp"),
    "ssm": ("cache_batch", "heads", None, None),
    "C": ("cache_batch", "heads", None, None),
    "n": ("cache_batch", "heads", None),
    "m": ("cache_batch", "heads"),
    "c": ("cache_batch", "heads", None),
    "h": ("cache_batch", "heads", None),
}


def cache_axes_tree(cache: Any) -> Any:
    """Logical axes of a cache tree by leaf key name; a leaf with more
    dimensions than its key's axes (a stacked group) is padded with
    leading ``None``s."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if isinstance(v, dict):
                    out[k] = walk(v)
                elif isinstance(v, (list, tuple)):
                    out[k] = type(v)(walk(e) for e in v)
                else:
                    ax = CACHE_AXES.get(k)
                    if ax is None:
                        out[k] = tuple([None] * v.ndim)
                    else:
                        out[k] = (None,) * (v.ndim - len(ax)) + tuple(ax)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(e) for e in node)
        if node is None:
            return None
        return tuple([None] * node.ndim)

    return walk(cache)
