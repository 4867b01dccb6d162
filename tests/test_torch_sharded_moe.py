"""Sharded training of the MoE and MLA models on the in-process mesh, CPU.

Reduced DeepSeek-V2-Lite (MLA, a dense first layer, MoE layers with two
shared experts) and Qwen3-MoE (GQA with 2 KV heads, which do not divide
``model`` = 4; MoE without shared experts), global batch 4 × 32.  The
sharded steps are held to the reference's *unsharded* jitted step with its
dispatch fill corrected (``test_torch_moe._fixed_dispatch``; its own
routed experts add 0, ROADMAP.md Queue 3): GSPMD runs that function with
the batch split, so its MoE dispatch is the global batch's, and the port's
sharded dispatch must give the same ``keep`` and ``slot``.  At the
configs' capacity factor 1.25 the global dispatch drops picks, and a
per-data-shard capacity would keep another set: the check tells the two
apart.  The expert-parallel island (``moe_sharded``) is held to the
reference's own ``moe_ffn_sharded``, its source exec'd with that one fill
corrected, in a subprocess with four JAX devices.

Tolerances are ``tests/test_torch_moe_train.py``'s (1e-5 of each leaf's
largest, its ``ADAM_FLOOR`` rule for the parameters after AdamW steps) and,
under ``mixed_precision``, ``tests/test_torch_mixed_precision.py``'s (2⁻⁵,
the reference's picks fed, each flip of the port's own within its
``ROUTE_MARGIN``, and the reference's f32 gradient as the yardstick where
its own bf16 gradient strays).  Each MoE comparison first asserts that
the picks agree.
"""
import contextlib
import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.launch import steps as j_steps
from repro.models import loss_fn as j_loss_fn
from repro.models import moe as j_moe
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint.manager import flatten
from repro_torch.distributed.collectives import prefix_counts
from repro_torch.distributed.sharded_lm import TP_AXES, ShardedLM
from repro_torch.distributed.sharding import (Layout, ShardedTensor,
                                              batch_spec, entry_axes)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe
from repro_torch.models.convert import flat_from_tree, train_state_from_numpy
from repro_torch.optim import adamw

from test_torch_lm_train import _fed_batches
from test_torch_mixed_precision import (MIXED, ROUTE_MARGIN, _exact_grads,
                                        _record_picks)
from test_torch_moe import _fixed_dispatch
from test_torch_moe_models import _pair
from test_torch_moe_train import ADAM_FLOOR, TOL

MIXED_TOL = 2.0 ** -5
CPU = torch.device("cpu")
DS, QM = "deepseek_v2_lite_16b", "qwen3_moe_30b_a3b"
B, SEQ = 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
RUNS = [(DS, (2, 2), "fsdp_tp"), (DS, (1, 4), "tp"), (DS, (4, 1), "zero3"),
        (DS, (2, 2), "zero3"), (DS, (2, 2), "zero3_dp"),
        (DS, (2, 2), "fsdp_tp_v2"),
        (QM, (1, 4), "tp"), (QM, (2, 2), "zero3_dp")]
_CACHE: dict = {}


@pytest.fixture(autouse=True)
def _fixed_reference_no_launches(monkeypatch):
    monkeypatch.setattr(j_moe, "_dispatch_indices", _fixed_dispatch)
    reset_launch_counts()
    yield
    assert not any(launch_counts().values())  # CPU: the plain versions


def _mesh(shape) -> Mesh:
    return Mesh((CPU,) * (shape[0] * shape[1]), shape)


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _full(t) -> torch.Tensor:
    return (t.full("cpu") if isinstance(t, ShardedTensor) else t).detach()


def _port_state(tc, tree):
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)
    return train_state_from_numpy(tc, (tree, (np.int32(0), zeros, zeros)),
                                  "cpu")


def _batches(jc, n: int = 3) -> list:
    return _fed_batches(jc, n, batch=B, seq=SEQ)


def _reference_run(arch: str, monkeypatch) -> dict:
    """Three steps of the reference's unsharded jitted step, fill
    corrected, once per arch: each step's metrics and each MoE call's
    picks, then every parameter and moment, and the first step's v."""
    if arch not in _CACHE:
        jc, tc, tree, _ = _pair(arch)
        rec: list = []
        monkeypatch.setattr(j_moe, "moe_ffn", _record_picks(rec))
        jstate = j_steps.TrainState(
            jax.tree.map(jnp.asarray, tree),
            j_adamw.init(jax.tree.map(jnp.asarray, tree)))
        step = jax.jit(j_steps.make_train_step(jc, j_adamw.AdamWConfig(
            **OPT)))
        flat = lambda t: flat_from_tree(   # noqa: E731
            tc, jax.tree.map(np.asarray, t))
        metrics, picks, first_v = [], [], None
        for b in _batches(jc):
            jstate, m = step(jstate, {k: jnp.asarray(v)
                                      for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            jax.effects_barrier()
            picks.append([ids[:, :tc.top_k] for ids, _ in rec])
            rec.clear()
            first_v = flat(jstate.opt.v) if first_v is None else first_v
        leaves = {f"{pre}.{n}": a for pre, t in (
            ("params", jstate.params), ("opt.m", jstate.opt.m),
            ("opt.v", jstate.opt.v)) for n, a in flat(t).items()}
        _CACHE[arch] = dict(metrics=metrics, picks=picks, leaves=leaves,
                            first_v=first_v)
    return _CACHE[arch]


@contextlib.contextmanager
def _route_tap(record: list | None = None, feed=None):
    """Every ``moe.route`` call appends its picks to ``record``; with
    ``feed`` (a function of the call's index → picks) the call takes those
    experts, its gates from its own logits at them, and the tokens whose
    own picks differ are returned with the call's logits."""
    real, calls, flips = moe.route, [0], []

    def tap(params, cfg, xt):
        logits, gates, ids = real(params, cfg, xt)
        if feed is not None:
            fed = feed(calls[0])
            flips.extend((logits[t], fed[t]) for t in
                         (ids != fed).any(-1).nonzero()[:, 0].tolist())
            ids, gates = fed, moe.gates(cfg, logits, fed)
        calls[0] += 1
        if record is not None:
            record.append(ids)
        return logits, gates, ids

    moe.route = tap
    try:
        yield flips
    finally:
        moe.route = real


def _rows(mesh, policy: str) -> list[slice]:
    """Each worker's rows of the global batch."""
    lay = Layout((B, SEQ), batch_spec(mesh, B, 1, policy), mesh)
    return [lay.index(m)[0] for m in range(mesh.size)]


def _global_picks(calls: list, rows: list[slice]) -> list:
    """One step's route calls (layer-major, then worker order) → each
    layer's picks over the global batch, the slices in order."""
    M = len(rows)
    first = {}
    for m, r in enumerate(rows):
        first.setdefault(r.start, m)
    return [torch.cat([calls[i + first[s]] for s in sorted(first)]).numpy()
            for i in range(0, len(calls), M)]


def _sharded_run(arch: str, shape, policy: str, **change):
    """Three sharded steps from the reference's weights: the state, each
    step's metrics and global picks, the step's ``Traffic``."""
    key = ("run", arch, shape, policy, tuple(sorted(change.items())))
    if key not in _CACHE:
        jc, tc, tree, _ = _pair(arch)
        tc = dataclasses.replace(tc, **change)
        mesh = _mesh(shape)
        state, layouts = train.shard_state(_port_state(tc, tree), tc, mesh,
                                           policy)
        step = steps.make_sharded_train_step(
            tc, adamw.AdamWConfig(**OPT), mesh, layouts, policy=policy)
        metrics, picks = [], []
        for b in _batches(jc):
            calls: list = []
            with _route_tap(calls):
                state, m = step(state, train.device_batch(b, CPU))
            metrics.append({k: float(v) for k, v in m.items()})
            picks.append(_global_picks(calls, _rows(mesh, policy)))
        _CACHE[key] = (state, metrics, picks, step.traffic.as_dict())
    return _CACHE[key]


# --- the steps against the reference ------------------------------------------

@pytest.mark.parametrize("arch,shape,policy", RUNS, ids=str)
def test_sharded_steps_match_fixed_reference(arch, shape, policy,
                                             monkeypatch):
    """Three sharded steps against the reference's unsharded jitted step
    (fill corrected) from one state on its pipeline's batches: the picks
    of every MoE call first, bitwise; then each step's loss, grad norm
    and lr; then every moment within 1e-5 of its leaf's largest, and the
    parameters by ``ADAM_FLOOR``'s rule."""
    want = _reference_run(arch, monkeypatch)
    state, metrics, picks, _ = _sharded_run(arch, shape, policy)
    _, tc, _, _ = _pair(arch)
    # the global dispatch drops picks, and data shards' own would keep
    # another set: the comparison tells the two apart
    ids = torch.from_numpy(np.stack(want["picks"][0]))
    T = B * SEQ
    keeps = [moe.dispatch_indices(i, tc.num_experts,
                                  moe.capacity(tc, T))[1] for i in ids]
    halves = [torch.cat([moe.dispatch_indices(
        i[h * T // 2:(h + 1) * T // 2], tc.num_experts,
        moe.capacity(tc, T // 2))[1] for h in range(2)]) for i in ids]
    assert any(not k.all() for k in keeps)
    assert any(not torch.equal(k, h) for k, h in zip(keeps, halves))
    for got, exp in zip(picks, want["picks"]):
        assert len(got) == len(exp) == tc.num_layers - tc.first_k_dense
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g, e)
    for g, w in zip(metrics, want["metrics"]):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(g[k] - w[k]) <= TOL * abs(w[k]), k
    leaves = flatten(state)
    assert int(state.opt.step) == 3
    for name, w in want["leaves"].items():
        got = _full(leaves[name])
        if not name.startswith("params."):
            assert _rel(got, w) <= TOL, name
            continue
        v = want["first_v"][name[len("params."):]]
        set_by_g = np.sqrt(v) >= ADAM_FLOOR * np.sqrt(v).max()
        err = np.abs(got.numpy() - w)
        assert err[set_by_g].max(initial=0.0) <= TOL * np.abs(w).max(), name
        assert err.max() <= OPT["lr"], name


# --- the dispatch -------------------------------------------------------------

DISPATCH_MESHES = [((2, 2), "fsdp_tp"), ((1, 4), "tp"), ((4, 1), "zero3"),
                   ((2, 2), "zero3"), ((2, 2), "zero3_dp"), ((2, 2), "fsdp_tp_v2"),
                   ((1, 1), "fsdp_tp")]


@pytest.mark.parametrize("shape,policy", DISPATCH_MESHES, ids=str)
def test_sharded_dispatch_is_the_unsharded_one_bitwise(shape, policy):
    """Each worker's dispatch of its rows' picks, through the step's own
    ``MoESplit`` (the count exchange, the experts it holds): ``keep`` and
    ``slot`` bitwise the unsharded ``dispatch_indices``' at those rows, and
    its index matrix the unsharded one's rows of its experts (arrival
    indices shifted by the slice's start)."""
    _, tc, _, _ = _pair(DS)
    tc = dataclasses.replace(tc, capacity_factor=0.75)
    mesh = _mesh(shape)
    lm = ShardedLM(tc, mesh, train.layouts_for(tc, mesh, policy), policy)
    blay = Layout((B, SEQ), batch_spec(mesh, B, 1, policy), mesh)
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    E, K, T = tc.num_experts, tc.top_k, B * SEQ
    ids = torch.from_numpy(np.stack([rng.permutation(E)[:K]
                                     for _ in range(T)]))
    C = moe.capacity(tc, T)
    w_idx, w_keep, w_slot = moe.dispatch_indices(ids, E, C)
    assert not w_keep.all()
    split = lm._moe_split(1, blay, SEQ)
    rows = _rows(mesh, policy)
    mine = [ids[r.start * SEQ:r.stop * SEQ] for r in rows]
    if split is None:                   # one worker: the unsharded path
        assert mesh.size == 1
        return
    assert split.tokens == T
    offsets = (split.exchange([torch.bincount(i.reshape(-1), minlength=E)
                               .int() for i in mine])
               if split.exchange is not None else [None] * mesh.size)
    for m, (r, i) in enumerate(zip(rows, mine)):
        lo, n = split.experts[m]
        idx, keep, slot = moe.dispatch_indices(i, E, C, offsets[m], (lo, n))
        t0, t1 = r.start * SEQ, r.stop * SEQ
        assert torch.equal(keep, w_keep[t0:t1]), m
        assert torch.equal(slot, w_slot[t0:t1]), m
        want = w_idx[lo:lo + n]
        inside = (want >= t0 * K) & (want < t1 * K)
        assert torch.equal(idx, torch.where(inside, want - t0 * K,
                                            (t1 - t0) * K)), m


def test_prefix_counts_by_slice_order():
    c = [torch.tensor([1, 2]), torch.tensor([1, 2]), torch.tensor([3, 0]),
         torch.tensor([3, 0])]
    got = prefix_counts(c, [0, 0, 1, 1])
    assert [g.tolist() for g in got] == [[0, 0], [0, 0], [1, 2], [1, 2]]
    got = prefix_counts([c[2], c[0], c[1]], [2, 0, 1])
    assert [g.tolist() for g in got] == [[2, 4], [0, 0], [1, 2]]


# --- one worker ---------------------------------------------------------------

@pytest.mark.parametrize("moe_sharded", [False, True])
@pytest.mark.parametrize("arch", [DS, QM])
def test_one_worker_mesh_is_make_train_step(arch, moe_sharded):
    """A (1, 1) mesh: three steps bitwise ``make_train_step``'s without
    the island; with it, within 1e-6 (on one worker the island is
    ``moe_ffn``)."""
    jc, tc, tree, _ = _pair(arch)
    tc = dataclasses.replace(tc, moe_sharded=moe_sharded)
    state = _port_state(tc, tree)
    step = steps.make_train_step(tc, adamw.AdamWConfig(**OPT))
    losses = []
    for b in _batches(jc):
        state, m = step(state, train.device_batch(b, CPU))
        losses.append(float(m["loss"]))
    sharded, got_m, _, traffic = _sharded_run(arch, (1, 1), "fsdp_tp",
                                              moe_sharded=moe_sharded)
    assert not any(traffic.values())
    want, got = flatten(state), flatten(sharded)
    assert list(want) == list(got)
    if not moe_sharded:
        assert [m["loss"] for m in got_m] == losses
        for name, t in want.items():
            assert torch.equal(_full(got[name]), t.detach()), name
        return
    for g, w in zip(got_m, losses):
        assert abs(g["loss"] - w) <= 1e-6 * abs(w)
    for name, t in want.items():
        assert _rel(_full(got[name]), t.detach().numpy()) <= 1e-6, name


# --- the island against the reference's -------------------------------------

_ISLAND = """
    import dataclasses, inspect, sys
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, {tests!r})
    from repro.configs import get_config
    from repro.models import moe
    from repro.models.layers import unbox
    from test_torch_moe import _fixed_dispatch

    moe._dispatch_indices = _fixed_dispatch
    src = inspect.getsource(moe.moe_ffn_sharded)
    fault = "jnp.full((E_loc + 1, cap), T * K, jnp.int32)"
    assert src.count(fault) == 1
    ns = dict(vars(moe))
    exec(src.replace(fault, "jnp.full((E_loc + 1, cap), -1, jnp.int32)"),
         ns)
    island = ns["moe_ffn_sharded"]
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {{}}
    for arch in {archs!r}:
        base = get_config(arch, reduced=True)
        rng = np.random.default_rng(len(arch))
        x = rng.normal(size=({B}, 16, base.d_model)).astype(np.float32)
        gy = rng.normal(size=x.shape).astype(np.float32)
        p = jax.tree.map(np.asarray, unbox(moe.init_moe(
            jax.random.PRNGKey(7), base)))
        for k, v in jax.tree_util.tree_leaves_with_path(p):
            out[f"{{arch}}/p/" + "/".join(str(q.key) for q in k)] = v
        out[f"{{arch}}/x"], out[f"{{arch}}/gy"] = x, gy
        for cf in (base.capacity_factor, 8.0):
            cfg = dataclasses.replace(base, capacity_factor=cf)
            with mesh:
                y, vjp = jax.jit(lambda p, x: jax.vjp(
                    lambda a, b: island(a, cfg, b, mesh), p, x))(p, x)
                gp, gx = jax.jit(vjp)(gy)
                dense = jax.jit(lambda p, x: moe.moe_ffn(p, cfg, x))(p, x)
            y, dense = np.asarray(y), np.asarray(dense)
            rel = np.abs(y - dense).max() / np.abs(dense).max()
            print(arch, cf, "island against moe_ffn", rel)
            if cf == 8.0:   # the reference's own claim, live experts
                assert rel <= 1e-5, rel
                continue
            assert rel > 1e-3   # a shard's capacity drops another set
            out[f"{{arch}}/y"], out[f"{{arch}}/gx"] = y, np.asarray(gx)
            for k, v in jax.tree_util.tree_leaves_with_path(gp):
                out[f"{{arch}}/gp/" + "/".join(str(q.key) for q in k)] = \\
                    np.asarray(v)
    np.savez({path!r}, **out)
"""


def _island_layer(arch: str, arrays, policy: str, cf: float | None = None):
    """The port's island for MoE layer 1 of the reduced ``arch`` on a
    (2, 2) mesh under ``policy``, its weights ``arrays``' → (y (B, 16, d),
    dx, {leaf: gradient}) for the cotangent ``gy``, with the rows of each
    batch slice counted once."""
    _, tc, tree, _ = _pair(arch)
    change = dict(moe_sharded=True)
    if cf is not None:
        change["capacity_factor"] = cf
    tc = dataclasses.replace(tc, **change)
    mesh = _mesh((2, 2))
    state = _port_state(tc, tree)
    named = dict(state.params.named_parameters())
    with torch.no_grad():
        for k in arrays.files:
            if k.startswith(f"{arch}/p/"):
                leaf = "layers.1.ffn." + k[len(f"{arch}/p/"):].replace("/",
                                                                      ".")
                named[leaf].copy_(torch.from_numpy(arrays[k]))
    sharded, layouts = train.shard_state(state, tc, mesh, policy)
    lm = ShardedLM(tc, mesh, layouts, policy)
    x, gy = (torch.from_numpy(arrays[f"{arch}/{k}"]) for k in ("x", "gy"))
    S = x.shape[1]
    blay = Layout(tuple(x.shape[:2]), batch_spec(mesh, x.shape[0], 1,
                                                 policy), mesh)
    w = lm.gather(sharded.params, "layers.1.")
    local = [lm._local_layer(w[m], 1, m).ffn for m in range(mesh.size)]
    rows = [blay.index(m)[0] for m in range(mesh.size)]
    xs = [x[r].clone().requires_grad_(True) for r in rows]
    ys = moe.moe_ffn_workers(local, tc, xs, lm._moe_split(1, blay, S))
    y = torch.empty_like(x)
    total = 0
    for m in blay.owners():
        y[rows[m]] = ys[m].detach()
        total = total + (ys[m] * gy[rows[m]]).sum()
    names = [n for n in layouts if n.startswith("layers.1.ffn.")]
    parts = [p for n in names for p in sharded.params[n].parts]
    got = iter(torch.autograd.grad(total, xs + parts))
    dx = torch.zeros_like(x)
    for r in rows:
        dx[r] += next(got)
    grads = {n: ShardedTensor([next(got) for _ in sharded.params[n].parts],
                              layouts[n]).full("cpu") for n in names}
    return y, dx, grads, (tc, state, x, rows)


def test_island_matches_reference_island(tmp_path):
    """The port's island (mesh (2, 2); fsdp_tp, whose layouts split the
    experts and the shared MLP over ``model``, and zero3_dp, whose batch
    is split over ``model`` too and whose leaves the island narrows
    itself) against the reference's ``moe_ffn_sharded`` exec'd with its
    fill corrected in a 4-device subprocess: the output, dx and every
    gradient within 1e-5.  Also the port's island on each data shard is
    its ``moe_ffn`` there; and at capacity factor 8 (nothing drops) the
    island is the unsharded ``moe_ffn``, as the reference's own test
    claims, here with live experts on both sides."""
    import os

    path = str(tmp_path / "island.npz")
    run_with_devices(textwrap.dedent(_ISLAND).format(
        tests=os.path.dirname(__file__), archs=(DS, QM), B=B, path=path),
        num_devices=4)
    arrays = np.load(path)
    for arch in (DS, QM):
        for policy in ("fsdp_tp", "zero3_dp"):
            y, dx, grads, (tc, state, x, rows) = _island_layer(
                arch, arrays, policy)
            assert _rel(y, arrays[f"{arch}/y"]) <= TOL, (arch, policy)
            assert _rel(dx, arrays[f"{arch}/gx"]) <= TOL, (arch, policy)
            for k in arrays.files:
                if k.startswith(f"{arch}/gp/"):
                    leaf = "layers.1.ffn." + k[len(f"{arch}/gp/"):].replace(
                        "/", ".")
                    assert _rel(grads[leaf], arrays[k]) <= TOL, (arch,
                                                                 policy, leaf)
            assert grads["layers.1.ffn.wi"].abs().max() > 0
        layer = state.params.layers[1].ffn
        with torch.no_grad():
            for h in range(2):      # the data shards' rows
                r = slice(h * B // 2, (h + 1) * B // 2)
                assert _rel(y[r], moe.moe_ffn(layer, tc, x[r]).numpy()
                            ) <= TOL, (arch, h)
        y8, _, _, (tc8, state8, _, _) = _island_layer(arch, arrays,
                                                      "fsdp_tp", cf=8.0)
        with torch.no_grad():
            dense = moe.moe_ffn(state8.params.layers[1].ffn, tc8, x)
        assert _rel(y8, dense.numpy()) <= TOL, arch


# --- mixed precision ---------------------------------------------------------

def _step_grads(state, metrics, opt) -> dict:
    """One AdamW step's gradients, from its first moments: m = (1 − b1)·g
    scaled by min(1, clip / (‖g‖ + 1e-9)), ‖g‖ the step's grad norm."""
    gnorm = float(metrics["grad_norm"])
    scale = min(1.0, opt.grad_clip / (gnorm + 1e-9)) * (1 - opt.b1)
    return {n[len("opt.m."):]: _full(t) / scale
            for n, t in flatten(state).items() if n.startswith("opt.m.")}


def test_mixed_precision_sharded_matches_reference(monkeypatch):
    """DeepSeek-V2-Lite under ``mixed_precision`` on fsdp_tp (2, 2): one
    sharded step against the reference's jitted unsharded mixed step (its
    fill corrected; under GSPMD its sharded step is that function), by
    ``tests/test_torch_mixed_precision.py``'s rule: each worker fed the
    reference's picks at its rows (a pick of its own that differs within
    ``ROUTE_MARGIN`` of the token's best score), loss and grad norm within
    2⁻⁵, and each gradient leaf (from the step's first moments) within 2⁻⁵
    of the reference's largest — or, where the reference is off its own f32
    gradient of the bf16-rounded weights on the same routes
    (``_exact_grads``, ``jax.grad``) by more than 2⁻⁶, within 2⁻⁵ of that
    and no farther from it than the reference.  The port's unsharded mixed
    step on the same picks is held the same way, and the sharded step's
    loss and grad norm to it within 2⁻⁵, and each gradient leaf within 2⁻⁵
    of its, or where the two bf16 runs lie farther apart, no farther from
    the f32 gradient than it (or within 2⁻⁵ of that).  The masters and the
    moments stay f32, the gathered copies are bf16, and ``Traffic``'s
    all-gather bytes are exactly half the f32 run's."""
    jc, tc, tree, _ = _pair(DS)
    mixed_j = dataclasses.replace(jc, **MIXED)
    mixed = dataclasses.replace(tc, **MIXED)
    raw = _batches(jc, 1)[0]
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    batch = train.device_batch(raw, CPU)
    opt = adamw.AdamWConfig(**OPT)
    rec: list = []
    monkeypatch.setattr(j_moe, "moe_ffn", _record_picks(rec))
    want_loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, mixed_j, b)))(tree, jb)
    jax.effects_barrier()
    assert len(rec) == tc.num_layers - tc.first_k_dense
    want = flat_from_tree(tc, jax.tree.map(np.asarray, jgrads))
    want_norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                  for g in want.values())))
    picks = [torch.tensor(ids[:, :tc.top_k], dtype=torch.long)
             for ids, _ in rec]

    one = _port_state(mixed, tree)
    with _route_tap(feed=lambda c: picks[c]) as one_flips:
        one, one_m = steps.make_train_step(mixed, opt)(one, batch)
    mesh = _mesh((2, 2))
    rows = _rows(mesh, "fsdp_tp")
    M = mesh.size

    def feed(c):       # call c: layer c // M, worker c % M's rows
        r = rows[c % M]
        return picks[c // M][r.start * SEQ:r.stop * SEQ]

    traffic = {}
    for cfg in (tc, mixed):
        state, layouts = train.shard_state(_port_state(cfg, tree), cfg,
                                           mesh, "fsdp_tp")
        step = steps.make_sharded_train_step(cfg, opt, mesh, layouts,
                                             policy="fsdp_tp")
        if cfg is tc:
            step(state, batch)
        else:
            gathered = []
            real = ShardedLM._gather_leaf

            def spy(self, params, name):
                out = real(self, params, name)
                gathered.append((name, {t.dtype for t in out}))
                return out

            ShardedLM._gather_leaf = spy
            try:
                with _route_tap(feed=feed) as flips:
                    state, got_m = step(state, batch)
            finally:
                ShardedLM._gather_leaf = real
        traffic[cfg.mixed_precision] = step.traffic.all_gather_bytes
    margins = []
    for logits, _ in one_flips + flips:
        top = torch.softmax(logits.detach(), -1).sort(
            descending=True).values
        gaps = top[:mixed.top_k] - top[1:mixed.top_k + 1]
        margins.append(float(gaps.min() / top[0]))
    print(f"{len(margins)} picks fed against the port's own, margins "
          f"{margins}")
    assert all(m <= ROUTE_MARGIN for m in margins), margins
    assert traffic[True] > 0 and traffic[True] * 2 == traffic[False]
    assert gathered and all(d == {torch.bfloat16} for _, d in gathered)
    for name, t in flatten(state).items():
        assert t.dtype == torch.float32 or name == "opt.step", name

    got, unsharded = _step_grads(state, got_m, opt), _step_grads(one, one_m,
                                                                 opt)
    assert set(got) == set(want) == set(unsharded)
    exact = None
    for run, (m, g) in (("sharded", (got_m, got)),
                        ("unsharded", (one_m, unsharded))):
        assert abs(float(m["loss"]) - float(want_loss)) <= MIXED_TOL * float(
            want_loss), run
        assert abs(float(m["grad_norm"]) - want_norm) <= MIXED_TOL * \
            want_norm, run
        for name, w in want.items():
            if _rel(g[name], w) <= MIXED_TOL:
                continue
            if exact is None:
                exact = flat_from_tree(tc, jax.tree.map(
                    np.asarray, _exact_grads(mixed_j, tree, jb, rec,
                                             monkeypatch)))
            off = _rel(torch.tensor(w), exact[name])
            port = _rel(g[name], exact[name])
            print(f"{run} {name}: the reference is off the f32 gradient by "
                  f"{off:.4f}, the port by {port:.4f}")
            assert off > MIXED_TOL / 2 and port <= min(MIXED_TOL, off), (
                run, name)
    for k in ("loss", "grad_norm"):
        assert abs(float(got_m[k]) - float(one_m[k])) <= MIXED_TOL * abs(
            float(one_m[k])), k
    for name, w in unsharded.items():
        if _rel(got[name], w.numpy()) <= MIXED_TOL:
            continue
        # the two bf16 runs farther apart (each is held to the reference
        # above): the sharded one no farther from the f32 gradient than the
        # unsharded one, or within 2⁻⁵ of it
        if exact is None:
            exact = flat_from_tree(tc, jax.tree.map(
                np.asarray, _exact_grads(mixed_j, tree, jb, rec,
                                         monkeypatch)))
        far = _rel(got[name], exact[name])
        near = _rel(w, exact[name])
        print(f"{name}: the sharded step is off the unsharded one by "
              f"{_rel(got[name], w.numpy()):.4f}; off the f32 gradient "
              f"{far:.4f}, the unsharded one {near:.4f}")
        assert far <= max(MIXED_TOL, near), name


# --- Traffic -----------------------------------------------------------------

def _expected_traffic(tc, mesh, policy: str) -> dict:
    """Bytes a worker a step by the reference's rules, from the layouts:
    each leaf all-gathered over its bound axes but a ``model`` dimension of
    a tensor-parallel logical axis kept (tp policies), a matrix other than
    the embedding once more in the backward, reduce-scattered back, and its
    gradient all-reduced over the workers holding the same part; the
    activations' psums over ``model`` (embedding rows, the attention's and
    every FFN's partial outputs, forward and backward, the cross-entropy's
    max, sum of exponentials and gold logit); the MoE's count exchange, E
    int32 from each other batch slice a layer."""
    from repro_torch.models import init_model, param_axes

    layouts = train.layouts_for(tc, mesh, policy)
    axes = param_axes(init_model(tc, device="meta"))
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    tp = policy != "zero3_dp"
    out = dict(all_gather_bytes=0.0, reduce_scatter_bytes=0.0,
               all_reduce_bytes=0.0, count_bytes=0.0)
    for name, lay in layouts.items():
        again = len(lay.shape) >= 2 and name != "embed.embedding"
        bound = [(a, ax) for e, ax in zip(lay.spec, axes[name])
                 for a in ([e] if isinstance(e, str) else list(e or ()))]
        split = int(np.prod([sizes[a] for a, _ in bound]))
        g = int(np.prod([sizes[a] for a, ax in bound
                         if not (tp and a == "model" and ax in TP_AXES)]))
        part = int(np.prod(lay.shape)) * 4 // split
        rep = mesh.size // split
        out["all_gather_bytes"] += (1 + again) * part * g * (g - 1) / g
        out["reduce_scatter_bytes"] += part * (g - 1)
        out["all_reduce_bytes"] += 2 * part * (rep - 1) / rep
    mp = sizes["model"]
    slices = sizes["data"] if tp else mesh.size
    moe_layers = tc.num_layers - tc.first_k_dense
    out["count_bytes"] = moe_layers * tc.num_experts * 4 * (slices - 1)
    if tp and mp > 1:
        bw = B // sizes["data"]
        act = bw * SEQ * tc.d_model * 4
        row = bw * SEQ * 4
        ar = lambda b: 2 * b * (mp - 1) / mp   # noqa: E731

        def on_model(name, d):
            spec = layouts[name].spec
            return d < len(spec) and "model" in entry_axes(spec[d])

        partial = sum(
            on_model(f"layers.{i}.mixer.wq", 1)
            + any(on_model(n, d) for n, d in (
                (f"layers.{i}.ffn.wi", 0 if i >= tc.first_k_dense else 1),
                (f"layers.{i}.ffn.shared.wi", 1)) if n in layouts)
            for i in range(tc.num_layers))
        out["all_reduce_bytes"] += (2 * ar(act) + 2 * partial * ar(act)
                                    + ar(row) + 2 * 2 * ar(row))
    return out


@pytest.mark.parametrize("arch,shape,policy", RUNS, ids=str)
def test_traffic_bytes_match_the_formula(arch, shape, policy):
    """The MLA and MoE leaves' gathers, the partial outputs' psums and the
    count exchange, a step and worker, from the layouts' shapes."""
    _, tc, _, _ = _pair(arch)
    *_, traffic = _sharded_run(arch, shape, policy)
    want = _expected_traffic(tc, _mesh(shape), policy)
    for k, v in want.items():
        assert traffic[k] / 3 == pytest.approx(v, rel=1e-12), k
    assert traffic["count_bytes"] > 0 or shape == (1, 4)


@pytest.mark.parametrize("shape,policy", [((1, 1), "fsdp_tp"),
                                          ((2, 2), "zero3_dp")], ids=str)
def test_sharded_step_frees_its_graph(shape, policy):
    """Once a sharded step's state is dropped, nothing of it stays alive:
    DeepSeek-V2-Lite's router softmax ranks the picks on a branch the
    backward never runs, and a saved output of it must not hold the graph
    (and so every parameter above it) in a reference cycle."""
    import gc
    import weakref

    _, tc, _, _ = _pair(DS)
    mesh = _mesh(shape)
    toks = torch.randint(0, tc.vocab_size, (B, SEQ + 1),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def step():
        state, layouts = train.build_state(torch.Generator().manual_seed(0),
                                           tc, mesh, policy)
        step = steps.make_sharded_train_step(tc, adamw.AdamWConfig(), mesh,
                                             layouts, policy=policy)
        _, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
        return [weakref.ref(p) for t in state.params.values()
                for p in t.parts]

    refs = step()
    gc.collect()
    assert not [r for r in refs if r() is not None]
