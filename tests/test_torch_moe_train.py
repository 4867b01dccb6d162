"""MoE and MLA training in the port against the live JAX reference, CPU.

Reduced DeepSeek-V2-Lite (MLA, a dense first layer, MoE layers with
shared experts) and Qwen3-MoE (GQA with qk-norm, MoE), f32 stream: the
MoE layer's and the MLA layer's gradients, ``flash_attention_bwd_ref`` at
v narrower than q·k (MLA's (192, 128) included), three ``make_train_step``
steps against the reference's jitted step, the train state through
``models.convert``, and ``launch/train.run`` resumed bitwise.  The
reference runs with its dispatch fill corrected
(``test_torch_moe._fixed_dispatch``): as it stands its routed experts add
0 and take no gradient, the router none either (ROADMAP.md, Queue 3).
Every reference function is ``jax.jit``-ed.  On the CPU the port takes
its kernels' plain versions.

Tolerance 1e-5 of each output's or leaf's largest reference value (f32
products summed in another order), as ``tests/test_torch_lm_train.py``.
After AdamW steps the parameters are held there where every step was set
by the gradient to f32 accuracy: where the reference's first-step √v̂
(its gradient's magnitude) is at least ``ADAM_FLOOR`` of its leaf's
largest.  A step is lr·m̂/(√v̂ + ε), and the gradients agree to ~1e-6 of
their leaf's largest, so an element's step carries that error over its
own √v̂: at a gradient near 0 (next to ε = 1e-8, too) the two packages'
noise, not their arithmetic, sets it, and the parameter keeps the
difference.  There each parameter is held within lr of the reference's,
the most one step can move it.
Each MoE comparison first asserts that both packages pick the same
experts: a flipped pick would be a different result, not an error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as j_steps
from repro.models import attention as j_attn
from repro.models import flash as j_flash
from repro.models import moe as j_moe
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint.manager import flatten
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.launch import steps, train
from repro_torch.models import attention, moe
from repro_torch.models.convert import (flat_from_tree,
                                        train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import adamw

from test_torch_lm_train import _fed_batches
from test_torch_moe import CASES, _fixed_dispatch, _layer
from test_torch_moe_models import _mla, _pair

TOL = 1e-5
ADAM_FLOOR = 1e-2   # of a leaf's largest √v̂: a step's error ≤ 1e-4·lr
ARCHS = ("deepseek_v2_lite_16b", "qwen3_moe_30b_a3b")


@pytest.fixture(autouse=True)
def _fixed_reference_no_launches(monkeypatch):
    monkeypatch.setattr(j_moe, "_dispatch_indices", _fixed_dispatch)
    reset_launch_counts()
    yield
    assert not any(launch_counts().values())  # CPU: the plain versions


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _grads(module: torch.nn.Module, x: torch.Tensor, out: torch.Tensor,
           gy: np.ndarray) -> dict:
    names = [n for n, _ in module.named_parameters()]
    got = torch.autograd.grad(out, [x, *module.parameters()],
                              torch.from_numpy(gy))
    return dict(zip(["x", *names], got))


# --- the MoE layer -----------------------------------------------------------

@pytest.mark.parametrize("case", ["deepseek", "qwen3_moe", "deepseek_drops"])
def test_moe_layer_gradients_match_fixed_reference(case):
    """Output and gradients in x, router, wi, wg, wo and the shared MLP
    against ``jax.vjp`` of the fixed ``moe_ffn``; the gradient reaches the
    router through the gates only, and the dropped picks take none
    (``deepseek_drops`` drops picks at capacity factor 0.25)."""
    base, jbase, change = CASES[case]
    cfg = dataclasses.replace(base, **change)
    jcfg = dataclasses.replace(jbase, **change)
    tree, layer = _layer(cfg, jcfg, seed=len(case))
    rng = np.random.default_rng(len(case) + 1)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)

    def ref(p, xx, g):
        y, vjp = jax.vjp(lambda a, b: j_moe.moe_ffn(a, jcfg, b), p, xx)
        return y, vjp(g)

    want, (w_p, w_x) = jax.jit(ref)(tree, jnp.asarray(x), jnp.asarray(gy))
    xt = jnp.asarray(x).reshape(-1, cfg.d_model)
    logits = xt @ tree["router"]
    if cfg.router_softmax_then_topk:
        logits = jax.nn.softmax(logits, axis=-1)
    j_ids = jax.lax.top_k(logits, cfg.top_k)[1]
    for p in layer.parameters():
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    _, _, ids = moe.route(layer, cfg, tx.detach().reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    _, keep, _ = moe.dispatch_indices(ids, cfg.num_experts,
                                      moe.capacity(cfg, 32))
    if cfg.capacity_factor < 1:
        assert not keep.all()          # this case drops picks
    out = moe.moe_ffn(layer, cfg, tx)
    assert _rel(out, want) <= TOL
    got = _grads(layer, tx, out, gy)
    want_g = {"x": w_x, **_flat(w_p)}
    assert set(got) == set(want_g)
    for name, g in got.items():
        assert _rel(g, want_g[name]) <= TOL, name
    for name in ("router", "wi", "wg", "wo"):
        assert got[name].abs().max() > 0, name


# --- MLA without a cache -----------------------------------------------------

@pytest.mark.parametrize("S", [16, 1040])   # 1040² > 1024²: the flash region
def test_mla_layer_gradients_match_reference(S):
    """Output and gradients in x and every MLA leaf, the decompress route
    at (D, Dv) = (24, 16) (k_pe's gradient summed over the heads by
    autograd): in the dense block and in the flash region, whose
    backward is ``flash_attention_bwd_ref`` at Dv ≠ D."""
    jc, tc, tree, layer = _mla()
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, tc.d_model)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    pos = np.arange(S)

    def ref(p, xx, g):
        y, vjp = jax.vjp(lambda a, b: j_attn.mla_attention(
            a, jc, b, jnp.asarray(pos))[0], p, xx)
        return y, vjp(g)

    want, (w_p, w_x) = jax.jit(ref)(tree, jnp.asarray(x), jnp.asarray(gy))
    for p in layer.parameters():
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = attention.mla_attention(layer, tc, tx, torch.from_numpy(pos))
    assert _rel(out, want) <= TOL
    got = _grads(layer, tx, out, gy)
    want_g = {"x": w_x, **_flat(w_p)}
    assert set(got) == set(want_g)
    for name, g in got.items():
        assert _rel(g, want_g[name]) <= TOL, name


@pytest.mark.parametrize("B,S,Kv,G,D,Dv,causal,chunk", [
    (1, 128, 2, 1, 192, 128, True, 64),    # MLA's widths
    (1, 128, 1, 2, 192, 128, False, 64),
    (2, 96, 2, 2, 24, 16, True, 32),       # the reduced config's
    (1, 64, 2, 3, 24, 16, False, 32),      # non-causal at a chunk multiple
])
def test_flash_bwd_ref_at_mla_widths_matches_reference(B, S, Kv, G, D, Dv,
                                                       causal, chunk):
    """``flash_attention_bwd_ref`` with v narrower than q and k against
    ``jax.vjp`` of the reference's custom-VJP flash attention."""
    rng = np.random.default_rng(D + Dv + S)
    q = rng.normal(size=(B, S, Kv, G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Kv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Kv, Dv)).astype(np.float32)
    dout = rng.normal(size=(B, S, Kv, G, Dv)).astype(np.float32)

    def ref(a, b, c, g):
        y, vjp = jax.vjp(lambda a, b, c: j_flash.flash_attention(
            a, b, c, causal, chunk, chunk), a, b, c)
        return y, vjp(g)

    want, wants = jax.jit(ref)(q, k, v, dout)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tq = tq.reshape(B, S, Kv * G, D)
    o, lse = flash_attention_ref(tq, tk, tv, causal, return_lse=True)
    assert _rel(o.reshape(want.shape), want) <= TOL
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(
        dout).reshape(B, S, Kv * G, Dv), causal)
    assert [tuple(g.shape) for g in got] == [(B, S, Kv * G, D), k.shape,
                                             v.shape]
    for g, w in zip(got, wants):
        assert _rel(g.reshape(w.shape), w) <= TOL


# --- the training step, the state, the driver --------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_fixed_reference(arch):
    """Three steps of ``make_train_step`` against the reference's jitted
    step with the fix, from one state, on the reference pipeline's
    batches: each step's loss, grad norm and lr, then every parameter and
    moment."""
    jc, tc, tree, _ = _pair(arch)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    jstate = j_steps.TrainState(
        jax.tree.map(jnp.asarray, tree),
        j_adamw.init(jax.tree.map(jnp.asarray, tree)))
    j_step = jax.jit(j_steps.make_train_step(
        jc, j_adamw.AdamWConfig(**opt_cfg.__dict__)))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)
    state = train_state_from_numpy(tc, (tree, (np.int32(0), zeros, zeros)),
                                   "cpu")
    step = steps.make_train_step(tc, opt_cfg)
    flat = lambda t: flat_from_tree(   # noqa: E731
        tc, jax.tree.map(np.asarray, t))
    first_v = None
    for batch in _fed_batches(jc, 3, seq=32):
        jstate, jm = j_step(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        first_v = flat(jstate.opt.v) if first_v is None else first_v
        state, m = step(state, train.device_batch(batch, "cpu"))
        for name in ("loss", "grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) <= TOL * abs(
                float(jm[name])), name
    p, (st, mm, vv) = train_state_to_numpy(state, tc)
    assert int(st) == int(jstate.opt.step) == 3
    for got, want in ((mm, jstate.opt.m), (vv, jstate.opt.v)):
        g, w = flat_from_tree(tc, got), flat(want)
        assert set(g) == set(w)
        for name in w:
            assert _rel(torch.from_numpy(g[name]), w[name]) <= TOL, name
    g, w = flat_from_tree(tc, p), flat(jstate.params)
    for name, v in first_v.items():
        set_by_g = np.sqrt(v) >= ADAM_FLOOR * np.sqrt(v).max()
        err = np.abs(g[name] - w[name])
        assert err[set_by_g].max(initial=0.0) <= TOL * np.abs(
            w[name]).max(), name
        assert err.max() <= opt_cfg.lr, name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_round_trip_through_convert(arch):
    """A MoE/MLA train state (parameters, step, m and v) into the port
    and back, bitwise."""
    _, tc, tree, _ = _pair(arch)
    rng = np.random.default_rng(1)
    m = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     tree)
    v = jax.tree.map(lambda a: rng.random(size=a.shape).astype(np.float32),
                     tree)
    state = train_state_from_numpy(tc, (tree, (np.int32(7), m, v)), "cpu")
    names = dict(state.params.named_parameters())
    assert any(".ffn.router" in n for n in names)
    assert set(state.opt.m) == set(names) == set(state.opt.v)
    back_p, (back_s, back_m, back_v) = train_state_to_numpy(state, tc)
    assert int(back_s) == 7
    for got, want in ((back_p, tree), (back_m, m), (back_v, v)):
        lg = jax.tree_util.tree_leaves_with_path(got)
        lw = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in lg] == [p for p, _ in lw]
        for (_, a), (_, b) in zip(lg, lw):
            assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_trains_and_resumes_bitwise(arch, tmp_path):
    """``launch/train.main`` on the reduced config: 2 steps; then 1 step
    and ``--resume`` to 2.  Finite losses, and the resumed run's final
    state and losses bit for bit the uninterrupted run's."""
    args = ["--arch", arch, "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-every", "1", "--log-every", "1", "--device", "cpu"]
    full = train.main(args + ["--steps", "2", "--ckpt-dir",
                              str(tmp_path / "a")])
    assert all(np.isfinite(h["loss"]) for h in full["history"].values())
    first = train.main(args + ["--steps", "1", "--ckpt-dir",
                               str(tmp_path / "b")])
    resumed = train.main(args + ["--steps", "2", "--resume", "--ckpt-dir",
                                 str(tmp_path / "b")])
    assert resumed["started"] == 1 and sorted(resumed["history"]) == [2]
    assert first["history"][1]["loss"] == full["history"][1]["loss"]
    assert resumed["history"][2]["loss"] == full["history"][2]["loss"]
    a, b = flatten(full["state"]), flatten(resumed["state"])
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
