"""The port's sharding rules against the reference's
(``repro.distributed.sharding``), on the CPU.

``spec_for`` entry for entry on every leaf of full and reduced
``qwen3_14b`` (Tucker rank 0 and 512) × every policy × seven mesh shapes:
the reference's shapes and axes from ``jax.eval_shape``
(``repro.launch.steps.model_shapes``, its stacked layer groups' leading
``"layers"`` entry dropped), the port's from a model on the ``meta``
device — neither side allocates 14B parameters.  The reference's own spec
tests (``tests/test_distributed.py``) ported; ``param_axes`` against the
reference's ``axes_tree``; ``Layout`` on the port's mesh.
"""
import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.qwen3_14b import CONFIG as J_CONFIG
from repro.configs.qwen3_14b import REDUCED as J_REDUCED
from repro.distributed import sharding as j_sharding
from repro.launch.steps import model_shapes
from repro_torch.configs.qwen3_14b import CONFIG, REDUCED
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (CACHE_AXES, RULES_FSDP_TP,
                                              RULES_TP, Layout, P,
                                              cache_axes_tree, spec_for)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import init_cache, init_model, param_axes
from repro_torch.models.blocks import group_specs, layer_specs

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (2, 4)]
CONFIGS = {"full": (J_CONFIG, CONFIG), "reduced": (J_REDUCED, REDUCED)}


class FakeMesh:
    """The reference tests' stub: axis names and a device grid."""
    axis_names = ("data", "model")

    def __init__(self, shape=(4, 2)):
        self.devices = np.zeros(shape)


def _port_mesh(shape) -> Mesh:
    return Mesh((torch.device("cpu"),) * (shape[0] * shape[1]), shape)


def _reference_leaves(jc) -> dict:
    """{port name: (logical axes, shape)} from the reference's eval_shape,
    each stacked group's leaf unstacked (its "layers" axis dropped)."""
    shapes, axes = model_shapes(jc)

    def flat(sh, ax, prefix=""):
        out = {}
        for k in sh:
            if isinstance(sh[k], dict):
                out.update(flat(sh[k], ax[k], f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = (tuple(ax[k]), tuple(sh[k].shape))
        return out

    leaves = flat({k: v for k, v in shapes.items() if k != "groups"},
                  {k: v for k, v in axes.items() if k != "groups"})
    li = 0
    for (_, count), gs, ga in zip(group_specs(layer_specs(jc)),
                                  shapes["groups"], axes["groups"]):
        for name, (ax, shape) in flat(gs, ga).items():
            if count > 1:
                assert ax[0] == "layers" and shape[0] == count
                ax, shape = ax[1:], shape[1:]
            for j in range(count):
                leaves[f"layers.{li + j}.{name}"] = (ax, shape)
        li += count
    return leaves


_LEAVES: dict = {}


def _pair_leaves(which: str, rank: int):
    key = (which, rank)
    if key not in _LEAVES:
        jc, tc = (dataclasses.replace(c, tucker_rank=rank)
                  for c in CONFIGS[which])
        model = init_model(tc, device="meta")
        port = {n: (p.axes, tuple(p.shape))
                for n, p in model.named_parameters()}
        _LEAVES[key] = (_reference_leaves(jc), port)
    return _LEAVES[key]


@pytest.mark.parametrize("policy", sorted(sharding.POLICIES))
@pytest.mark.parametrize("which,rank", [("full", 0), ("full", 512),
                                        ("reduced", 0), ("reduced", 512)])
def test_spec_for_matches_reference_on_every_leaf(which, rank, policy):
    ref, port = _pair_leaves(which, rank)
    assert set(ref) == set(port)
    rules_j = j_sharding.POLICIES[policy]
    rules_t = sharding.POLICIES[policy]
    assert rules_j == rules_t
    for shape in MESHES:
        jm, tm = FakeMesh(shape), _port_mesh(shape)
        for name, (axes, dims) in port.items():
            assert (axes, dims) == ref[name], name
            want = tuple(j_sharding.spec_for(axes, dims, jm, rules_j))
            got = spec_for(axes, dims, tm, rules_t)
            assert isinstance(got, P)
            assert tuple(got) == want, (name, shape)
            # the stacked leaf's spec is the same with its layer entry
            stacked = tuple(j_sharding.spec_for(("layers",) + axes,
                                                (3,) + dims, jm, rules_j))
            assert stacked[1:] == want


@pytest.mark.parametrize("which,rank", [("full", 512), ("reduced", 8),
                                        ("reduced", 0)])
def test_param_axes_are_the_reference_axes_tree(which, rank):
    jc, tc = (dataclasses.replace(c, tucker_rank=rank)
              for c in CONFIGS[which])
    ref = _reference_leaves(jc)
    axes = param_axes(init_model(tc, device="meta"))
    assert axes == {n: a for n, (a, _) in ref.items()}
    assert axes["layers.0.mixer.wq"] == ("embed", "heads", "head_dim")
    assert axes["embed.embedding"] == ("vocab", "embed")
    assert axes["lm_head"] == ("embed", "vocab")
    if rank:
        assert axes["layers.0.ffn.up.u1"] == ("embed", None)
        assert axes["layers.0.ffn.up.u2"] == ("mlp", None)
        assert axes["layers.0.ffn.down.u1"] == ("mlp", None)
        assert axes["layers.0.ffn.gate.g"] == (None, None)


@pytest.mark.parametrize("shape", MESHES)
def test_fsdp_tp_v2_parameter_layouts_are_fsdp_tp(shape):
    """``head_dim_kv`` and ``kv_lora`` name only cache leaves."""
    tc = dataclasses.replace(CONFIG, tucker_rank=512)
    model = init_model(tc, device="meta")
    axes = param_axes(model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mesh = _port_mesh(shape)
    assert sharding.shardings_for_tree(axes, shapes, mesh, "fsdp_tp_v2") \
        == sharding.shardings_for_tree(axes, shapes, mesh, "fsdp_tp")


# --- the reference's own spec tests ------------------------------------------

def test_spec_for_divisibility():
    mesh = FakeMesh()
    assert spec_for(("embed", "mlp"), (64, 128), mesh, RULES_TP) \
        == P(None, "model")
    assert spec_for(("embed", "kv_heads", None), (64, 3, 16), mesh,
                    RULES_TP) == P()
    assert spec_for(("batch", None), (8, 5), mesh, RULES_TP) == P("data")


def test_spec_for_axis_uniqueness():
    sp = spec_for(("mlp", "vocab"), (128, 128), FakeMesh(), RULES_TP)
    assert sp == P("model")


def test_spec_for_fsdp_adds_embed_sharding():
    sp = spec_for(("embed", "mlp"), (64, 128), FakeMesh(), RULES_FSDP_TP)
    assert sp == P("data", "model")


def test_cache_axes_tree_structure():
    cache = [
        {"attn": {"k": torch.zeros((2, 8, 4, 16)),
                  "v": torch.zeros((2, 8, 4, 16))}},
        {"ssm": {"conv": torch.zeros((2, 3, 32)),
                 "ssm": torch.zeros((2, 4, 8, 16))}},
    ]
    axes = cache_axes_tree(cache)
    assert axes[0]["attn"]["k"] == CACHE_AXES["k"]
    assert axes[1]["ssm"]["conv"] == CACHE_AXES["conv"]
    stacked = [{"attn": {"k": torch.zeros((5, 2, 8, 4, 16))}}]
    assert cache_axes_tree(stacked)[0]["attn"]["k"] == (None,) \
        + CACHE_AXES["k"]


def test_cache_axes_tree_of_the_port_caches_is_the_reference():
    tc = dataclasses.replace(REDUCED, tucker_rank=8)
    caches = init_cache(tc, 2, 16, device="cpu")
    got = cache_axes_tree(caches)
    want = j_sharding.cache_axes_tree(
        [{"attn": {k: np.zeros(tuple(v.shape)) for k, v in c["attn"].items()}}
         for c in caches])
    assert got == want
    assert all(c["attn"]["k"] == CACHE_AXES["k"] for c in got)


@pytest.mark.parametrize("policy", sorted(sharding.POLICIES))
@pytest.mark.parametrize("shape", MESHES)
def test_batch_spec_matches_reference(policy, shape):
    for b in (1, 2, 3, 4, 8, 12):
        want = tuple(j_sharding.batch_spec(FakeMesh(shape), b, 1, policy))
        assert tuple(sharding.batch_spec(_port_mesh(shape), b, 1,
                                         policy)) == want


def test_serve_row_spec_matches_reference():
    for rows in (8, 9, 480_192):
        want = tuple(j_sharding.spec_for(("serve_rows", None), (rows, 4),
                                         FakeMesh(), j_sharding.RULES_SERVE))
        assert tuple(sharding.serve_row_spec(FakeMesh(), (rows, 4))) == want
    assert tuple(JP()) == tuple(sharding.replicated(FakeMesh()))


# --- Layout -----------------------------------------------------------------

def test_layout_slices_shard_and_unshard():
    mesh = _port_mesh((2, 4))
    lay = Layout((8, 6, 4), P(("data", "model"), None, None), mesh)
    full = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    parts = lay.shard(full)
    assert [p.shape for p in parts] == [(1, 6, 4)] * 8
    assert [lay.index(m)[0] for m in range(8)] == [slice(m, m + 1)
                                                   for m in range(8)]
    assert torch.equal(lay.unshard(parts), full)
    rep = Layout((4, 8), P(None, "model"), mesh)
    assert rep.owners() == [0, 1, 2, 3]         # data index 0 only
    assert rep.index(5) == (slice(0, 4), slice(2, 4))
    assert Layout((4,), P(), mesh).owners() == [0]
    with pytest.raises(ValueError, match="does not divide"):
        Layout((6,), P("model"), mesh)


def test_sharded_tensor_round_trip():
    mesh = _port_mesh((2, 2))
    lay = Layout((4, 6), P("data", "model"), mesh)
    full = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    st = sharding.ShardedTensor(lay.shard(full), lay)
    assert st.shape == (4, 6) and st.dtype == torch.float32
    assert torch.equal(st.full(), full)
    assert lay.part_bytes(4) == 2 * 3 * 4
