"""Sharded LM training on the in-process mesh against the live JAX
reference, on CPU workers.

Reduced ``qwen3_14b`` (2 layers, d_model 64, 4 heads over 2 KV heads,
vocab 512) with ``tucker_rank`` 8.  The reference's sharded jitted step
does not run on the installed JAX (its embedding gather raises
``ShardingTypeError``, ROADMAP.md), so the sharded steps are held to its
*unsharded* jitted step, which GSPMD computes up to summation order; the
reference's ``build_state`` does run, and its per-device shards are the
placement's oracle.

Tolerances, as ``tests/test_torch_lm_train.py``'s: max |Δ| over
max |reference| per leaf, f32 1e-5, bf16 2⁻⁵; the (1, 1) mesh against the
port's own ``make_train_step``, a repeated sharded run, checkpoints and the
driver's resume: bitwise.
"""
import dataclasses
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.configs.qwen3_14b import REDUCED as J_REDUCED
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.data.pipeline import TokenPipelineConfig as JTokenPipelineConfig
from repro.launch import steps as j_steps
from repro.models import init_model as j_init_model
from repro.models import unbox
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.configs.qwen3_14b import REDUCED
from repro_torch.distributed.collectives import Traffic
from repro_torch.distributed.sharding import Layout, P, ShardedTensor
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import Mesh
from repro_torch.models.convert import (flat_from_tree,
                                        train_state_from_numpy)
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FailureInjector

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
CPU = torch.device("cpu")
# (mesh shape, policy): the four policy/mesh pairs of sharded training, and
# one worker
PAIRS = [((2, 2), "fsdp_tp"), ((1, 4), "tp"), ((4, 1), "zero3"),
         ((2, 2), "zero3_dp"), ((1, 1), "fsdp_tp")]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
# global batch: 4 in f32, so every policy splits it over its data workers;
# in bf16 ``tests/test_torch_lm_train.py``'s 2, on which its 2⁻⁵ was set
# (there zero3 at (4, 1) and zero3_dp replicate the batch).  At batch 4 the
# bf16 second moment of ``layers.0.ln2.scale`` sits at 0.0278 of its
# largest for the unsharded port itself and at 0.0313 / 0.0339 under
# fsdp_tp / tp: residual-stream roundings flipped by the sums' order
BATCH = {"float32": 4, "bfloat16": 2}
_CACHE: dict = {}


def _mesh(shape) -> Mesh:
    return Mesh((CPU,) * (shape[0] * shape[1]), shape)


def _pair(dtype: str):
    """(reference cfg, port cfg, reference params as numpy), cached."""
    if dtype not in _CACHE:
        jc = dataclasses.replace(J_REDUCED, tucker_rank=8, dtype=dtype)
        tc = dataclasses.replace(REDUCED, tucker_rank=8, dtype=dtype)
        tree = jax.tree.map(np.asarray,
                            unbox(j_init_model(jax.random.PRNGKey(0), jc)))
        _CACHE[dtype] = (jc, tc, tree)
    return _CACHE[dtype]


def _batches(jc, n: int = 3, seq: int = 64) -> list:
    batch = BATCH[jc.dtype]
    pipe = JTokenPipeline(JTokenPipelineConfig(
        vocab_size=jc.vocab_size, seq_len=seq, global_batch=batch))
    return [pipe.global_batch(i) for i in range(n)]


def _port_state(tc, tree):
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)
    return train_state_from_numpy(tc, (tree, (np.int32(0), zeros, zeros)),
                                  "cpu")


def _reference_run(dtype: str) -> tuple[list, dict]:
    """Three steps of the reference's unsharded jitted step: the metrics of
    each, then every parameter and moment by port name."""
    key = ("ref", dtype)
    if key not in _CACHE:
        jc, tc, tree = _pair(dtype)
        jstate = j_steps.TrainState(
            jax.tree.map(jnp.asarray, tree),
            j_adamw.init(jax.tree.map(jnp.asarray, tree)))
        step = jax.jit(j_steps.make_train_step(
            jc, j_adamw.AdamWConfig(**OPT)))
        metrics = []
        for b in _batches(jc):
            jstate, m = step(jstate, {k: jnp.asarray(v)
                                      for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        host = lambda t: flat_from_tree(   # noqa: E731
            tc, jax.tree.map(np.asarray, t))
        leaves = {}
        for pre, t in (("params", jstate.params), ("opt.m", jstate.opt.m),
                       ("opt.v", jstate.opt.v)):
            leaves.update({f"{pre}.{n}": a for n, a in host(t).items()})
        _CACHE[key] = (metrics, leaves)
    return _CACHE[key]


def _sharded_run(dtype: str, shape, policy: str, n: int = 3):
    jc, tc, tree = _pair(dtype)
    state, layouts = train.shard_state(_port_state(tc, tree), tc,
                                       _mesh(shape), policy)
    step = steps.make_sharded_train_step(
        tc, adamw.AdamWConfig(**OPT), _mesh(shape), layouts, policy=policy)
    metrics = []
    for b in _batches(jc)[:n]:
        state, m = step(state, train.device_batch(b, CPU))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, step


def _full(t) -> torch.Tensor:
    return (t.full("cpu") if isinstance(t, ShardedTensor) else t).detach()


def _rel(got: torch.Tensor, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert not any(launch_counts().values())  # CPU: the plain versions


# --- step parity ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,policy", PAIRS, ids=lambda v: str(v))
def test_sharded_steps_match_reference_unsharded_step(dtype, shape, policy):
    """Three sharded steps against the reference's unsharded jitted step
    from one state, on ``TokenPipeline`` batches (``BATCH``): loss,
    grad norm and lr of each step, then every parameter and moment."""
    want_m, want = _reference_run(dtype)
    state, got_m, _ = _sharded_run(dtype, shape, policy)
    for g, w in zip(got_m, want_m):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(g[k] - w[k]) <= TOL[dtype] * abs(w[k]), k
    leaves = flatten(state)
    assert int(state.opt.step) == 3
    for name, w in want.items():
        assert _rel(_full(leaves[name]), w) <= TOL[dtype], name


# --- bitwise pairs ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_worker_mesh_is_make_train_step_bitwise(dtype):
    """A (1, 1) mesh runs the unsharded model's ops in its order: three
    steps equal ``make_train_step``'s in every loss bit and leaf."""
    jc, tc, tree = _pair(dtype)
    state = _port_state(tc, tree)
    step = steps.make_train_step(tc, adamw.AdamWConfig(**OPT))
    losses = []
    for b in _batches(jc):
        state, m = step(state, train.device_batch(b, CPU))
        losses.append(float(m["loss"]))
    sharded, got_m, s_step = _sharded_run(dtype, (1, 1), "fsdp_tp")
    assert [m["loss"] for m in got_m] == losses
    assert not any(s_step.traffic.as_dict().values())
    want, got = flatten(state), flatten(sharded)
    assert list(want) == list(got)
    for name, t in want.items():
        assert torch.equal(_full(got[name]), t.detach()), name


@pytest.mark.parametrize("shape,policy", PAIRS[:4], ids=lambda v: str(v))
def test_sharded_run_repeats_its_bits(shape, policy):
    a, ma, _ = _sharded_run("float32", shape, policy)
    b, mb, _ = _sharded_run("float32", shape, policy)
    assert ma == mb
    fa, fb = flatten(a), flatten(b)
    for name in fa:
        for x, y in zip(getattr(fa[name], "parts", [fa[name]]),
                        getattr(fb[name], "parts", [fb[name]])):
            assert torch.equal(x, y), name


def test_replicated_parts_stay_equal():
    """A leaf replicated over an axis is one parameter: every copy takes
    the same gradient sum, so the copies keep the same bits."""
    state, _, _ = _sharded_run("float32", (2, 2), "zero3")
    for name, t in state.params.items():
        lay = t.layout
        for m in range(lay.mesh.size):
            for w in range(m):
                if lay.index(w) == lay.index(m):
                    assert torch.equal(t.parts[w], t.parts[m]), name


# --- Traffic ----------------------------------------------------------------

def _expected_traffic(tc, layouts, mesh, policy, batch, seq) -> dict:
    """Bytes a worker a step by the reference's rules, from the shapes:
    each leaf all-gathered over its bound axes but a ``model`` dimension
    kept (tp policies) — a matrix other than the embedding once more in the
    backward, where its gathered copy is made again — reduce-scattered
    back, and its gradient all-reduced over the workers holding the same
    part; the activations' psums over
    ``model`` (embedding rows, attention and FFN outputs, the
    cross-entropy's sum of exponentials and gold logit, forward and
    backward) and the max (forward)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    tp = policy != "zero3_dp"
    out = dict(all_gather_bytes=0.0, reduce_scatter_bytes=0.0,
               all_reduce_bytes=0.0)
    for name, lay in layouts.items():
        again = len(lay.shape) >= 2 and name != "embed.embedding"
        bound = {d: [e] if isinstance(e, str) else list(e or ())
                 for d, e in enumerate(lay.spec)}
        split = int(np.prod([sizes[a] for ax in bound.values() for a in ax]))
        g = int(np.prod([sizes[a] for ax in bound.values() for a in ax
                         if not (tp and a == "model")]))
        part = int(np.prod(lay.shape)) * 4 // split
        rep = mesh.size // split
        out["all_gather_bytes"] += (1 + again) * part * g * (g - 1) / g
        out["reduce_scatter_bytes"] += part * (g - 1)
        out["all_reduce_bytes"] += 2 * part * (rep - 1) / rep
    mp = sizes["model"]
    if tp and mp > 1:
        bw = batch // sizes["data"]
        act = bw * seq * tc.d_model * 4
        row = bw * seq * 4
        ar = lambda b: 2 * b * (mp - 1) / mp   # noqa: E731
        heads = layouts["layers.0.mixer.wq"].spec[1:2] == ("model",)
        mlp = layouts["layers.0.ffn.up.u2"].spec[:1] == ("model",)
        out["all_reduce_bytes"] += (
            2 * ar(act)                                      # embedding
            + tc.num_layers * 2 * (heads + mlp) * ar(act)    # wo, down
            + ar(row) + 2 * 2 * ar(row))                     # max, sums
    return out


@pytest.mark.parametrize("shape,policy", PAIRS[:4], ids=lambda v: str(v))
def test_traffic_bytes_match_the_formula(shape, policy):
    jc, tc, _ = _pair("float32")
    _, _, step = _sharded_run("float32", shape, policy, n=1)
    want = _expected_traffic(tc, train.layouts_for(tc, _mesh(shape), policy),
                             _mesh(shape), policy, BATCH["float32"], 64)
    got = step.traffic.as_dict()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k
    assert got["all_reduce_bytes"] > 0
    assert (got["all_gather_bytes"] > 0) == (policy != "tp")


def test_traffic_rules_per_collective():
    t = Traffic()
    t.add_all_gather(1024, 4)
    t.add_reduce_scatter(256, 4)
    t.add_all_reduce(1000, 2)
    t.add_all_gather(64, 1)
    assert (t.all_gather_bytes, t.reduce_scatter_bytes,
            t.all_reduce_bytes) == (768.0, 768, 1000.0)


# --- elastic restore ---------------------------------------------------------

def _leaves_full(state) -> dict:
    return {k: _full(v).clone() for k, v in flatten(state).items()}


def test_elastic_restore_across_meshes_and_policies(tmp_path):
    """A checkpoint of a (2, 2) fsdp_tp state (after two steps) restores
    into a (4, 1) zero3 state, into one device, and a one-device checkpoint
    back into (2, 2) fsdp_tp: every leaf bitwise; the files of a sharded
    and an unsharded checkpoint of one state are the same."""
    jc, tc, _ = _pair("float32")
    src, _, _ = _sharded_run("float32", (2, 2), "fsdp_tp", n=2)
    want = _leaves_full(src)
    ck = CheckpointManager(tmp_path / "a")
    ck.save(5, src)
    gen = lambda s: torch.Generator().manual_seed(s)   # noqa: E731
    for shape, policy in (((4, 1), "zero3"), ((1, 4), "tp")):
        dst, layouts = train.build_state(gen(7), tc, _mesh(shape), policy)
        dst, step = ck.restore(dst, shardings=train.state_shardings(layouts))
        assert step == 5
        got = _leaves_full(dst)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    one = steps.init_train_state(tc, gen(7), CPU)
    one, _ = ck.restore(one)
    for k, v in _leaves_full(one).items():
        assert torch.equal(v, want[k]), k
    ck1 = CheckpointManager(tmp_path / "b")
    ck1.save(5, one)
    m0, l0 = ck.load_leaves(5)
    m1, l1 = ck1.load_leaves(5)
    assert m0["leaves"] == m1["leaves"]
    assert all(np.array_equal(a, b) for a, b in zip(l0, l1))
    back, _ = train.build_state(gen(9), tc, _mesh((2, 2)), "fsdp_tp")
    back, _ = ck1.restore(back)
    for k, v in _leaves_full(back).items():
        assert torch.equal(v, want[k]), k


def test_restore_mismatch_raises_before_any_copy(tmp_path):
    jc, tc, _ = _pair("float32")
    src, _, _ = _sharded_run("float32", (2, 2), "fsdp_tp", n=1)
    ck = CheckpointManager(tmp_path)
    ck.save(1, src)
    other = dataclasses.replace(tc, tucker_rank=4)
    dst, layouts = train.build_state(torch.Generator().manual_seed(3),
                                     other, _mesh((4, 1)), "zero3")
    before = _leaves_full(dst)
    with pytest.raises(ValueError, match="ffn"):
        ck.restore(dst)
    same, lay2 = train.build_state(torch.Generator().manual_seed(3), tc,
                                   _mesh((4, 1)), "zero3")
    before2 = _leaves_full(same)
    wrong = train.state_shardings(train.layouts_for(tc, _mesh((2, 2)),
                                                    "fsdp_tp"))
    with pytest.raises(ValueError, match="layout"):
        ck.restore(same, shardings=wrong)
    for b, st in ((before, dst), (before2, same)):
        for k, v in _leaves_full(st).items():
            assert torch.equal(v, b[k]), k


# --- the launcher ------------------------------------------------------------

ARGS = ["--arch", "qwen3_14b", "--reduced", "--tucker-rank", "8",
        "--batch", "4", "--seq", "32", "--ckpt-every", "4", "--log-every",
        "4", "--device", "cpu", "--backend", "torch", "--mesh", "host",
        "--policy", "fsdp_tp", "--model-parallel", "2"]


def _final(res) -> dict:
    return _leaves_full(res["state"])


def test_sharded_driver_resumes_bitwise(tmp_path, monkeypatch):
    """``--mesh host`` on four CPU workers ((2, 2), fsdp_tp): 10 steps; the
    same after a failure at step 6 (restored from step 4, replayed); and 4
    steps, then ``--resume`` to 10.  Every final leaf and loss bitwise."""
    monkeypatch.setenv("REPRO_FORCE_HOST_DEVICES", "4")
    full = train.main(ARGS + ["--steps", "10", "--ckpt-dir",
                              str(tmp_path / "a")])
    assert full["mesh_shape"] == (2, 2) and full["policy"] == "fsdp_tp"
    assert full["state_bytes_per_worker"] == full["layout_state_bytes"]
    assert full["traffic_per_step"]["all_gather_bytes"] > 0
    hist = full["history"]
    assert all(np.isfinite(m["loss"]) for m in hist.values())
    assert hist[10]["loss"] < hist[1]["loss"]
    failed = train.main(ARGS + ["--steps", "10", "--ckpt-dir",
                                str(tmp_path / "b")],
                        injector=FailureInjector({6}))
    assert failed["stats"].restarts == 1
    first = train.main(ARGS + ["--steps", "4", "--ckpt-dir",
                               str(tmp_path / "c")])
    resumed = train.main(ARGS + ["--steps", "10", "--resume", "--ckpt-dir",
                                 str(tmp_path / "c")])
    assert resumed["started"] == 4
    want = _final(full)
    for res in (failed, resumed):
        got = _final(res)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for i in range(1, 11):
        assert failed["history"][i]["loss"] == hist[i]["loss"]
        assert (first if i <= 4 else resumed)["history"][i]["loss"] == \
            hist[i]["loss"]


def test_sharded_driver_without_mesh_is_the_single_device_path(tmp_path):
    res = train.main(ARGS[:-6] + ["--steps", "2", "--ckpt-dir",
                                  str(tmp_path)])
    assert "layouts" not in res
    assert not isinstance(res["state"].params, dict)


def test_production_meshes_raise_off_their_device_count(tmp_path):
    args = ARGS[:-6] + ["--steps", "1", "--ckpt-dir", str(tmp_path)]
    for mesh in ("single", "multi"):
        with pytest.raises(ValueError, match="production mesh"):
            train.main(args + ["--mesh", mesh])


# --- placement against the reference's build_state ---------------------------

_PLACEMENT = """
    import dataclasses, jax, numpy as np
    from repro.configs.qwen3_14b import REDUCED
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import build_state
    from repro_torch.configs.qwen3_14b import REDUCED as T_REDUCED
    from repro_torch.models.convert import flat_from_tree

    jc = dataclasses.replace(REDUCED, tucker_rank=8)
    tc = dataclasses.replace(T_REDUCED, tucker_rank=8)
    mesh = make_host_mesh(2)
    assert mesh.devices.shape == (2, 2)
    import torch
    from jax.sharding import NamedSharding, PartitionSpec
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import layouts_for

    tmesh = Mesh((torch.device("cpu"),) * 4, (2, 2))
    out = {{}}
    for policy in {policies!r}:
        # Layout.index is devices_indices_map for device m
        for name, lay in layouts_for(tc, tmesh, policy).items():
            imap = NamedSharding(mesh, PartitionSpec(*lay.spec)
                                 ).devices_indices_map(lay.shape)
            for m, dev in enumerate(mesh.devices.flat):
                want = tuple(slice(*s.indices(n)[:2])
                             for s, n in zip(imap[dev], lay.shape))
                assert lay.index(m) == want, (policy, name, m)
        with mesh:
            state, _ = build_state(jax.random.PRNGKey(0), jc, mesh, policy)
        if policy == {policies!r}[0]:
            full = flat_from_tree(tc, jax.tree.map(np.asarray, state.params))
            out.update({{"full/" + k: v for k, v in full.items()}})
        for m, dev in enumerate(mesh.devices.flat):
            part = jax.tree.map(
                lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                          if s.device == dev)), state.params)
            for k, v in flat_from_tree(tc, part).items():
                out[f"{{policy}}/{{m}}/{{k}}"] = v
    np.savez({path!r}, **out)
    print("placed")
"""


def test_placement_is_the_reference_build_state_bitwise(tmp_path):
    """Each worker's parts of every parameter, under all five policies on
    a (2, 2) mesh, bitwise the reference's ``addressable_shards`` of its
    device m (``mesh.devices.flat`` order) from ``build_state``; and every
    ``Layout.index(m)`` the reference's ``devices_indices_map`` there."""
    from repro_torch.distributed.sharding import POLICIES

    policies = sorted(POLICIES)
    path = str(tmp_path / "placed.npz")
    run_with_devices(textwrap.dedent(_PLACEMENT).format(
        policies=policies, path=path), num_devices=4)
    got = np.load(path)
    jc, tc, _ = _pair("float32")
    full = {k[5:]: got[k] for k in got.files if k.startswith("full/")}
    zeros = {k: np.zeros_like(v) for k, v in full.items()}
    from repro_torch.models.convert import tree_from_flat

    one = train_state_from_numpy(tc, (tree_from_flat(tc, full), (
        np.int32(0), tree_from_flat(tc, zeros), tree_from_flat(tc, zeros))),
        "cpu")
    for policy in policies:
        state, layouts = train.shard_state(one, tc, _mesh((2, 2)), policy)
        for name, t in state.params.items():
            for m, part in enumerate(t.parts):
                want = got[f"{policy}/{m}/{name}"]
                assert tuple(part.shape) == want.shape, (policy, name)
                assert np.array_equal(part.detach().numpy(), want), \
                    (policy, name, m)
