"""The port's LM training path against the live JAX reference, on the CPU.

Reduced ``qwen3_14b`` (2 layers, d_model 64, 4 heads over 2 KV heads,
vocab 512) with ``tucker_rank`` 8.  The reference's weights and optimizer
state go into the port through ``models.convert``; tokens come from the
reference's ``TokenPipeline`` or numpy.  The port runs its default
``"cuda"`` backend, which on CPU tensors takes the kernels' plain versions
(the ``"torch"`` backend where a test says so); the reference runs its
default (``"xla"`` ``tucker_matmul``, its custom-VJP flash attention).

Tolerances, max |Δ| over max |reference| per output or gradient leaf:

* f32: 1e-5 (``loss_fn`` and its gradients, the flash and Tucker
  gradients: the same f32 products summed in another order); the
  parameters after three AdamW steps: 1e-5 as well.
* bf16: 2⁻⁵, as ``tests/test_torch_lm_model.py`` sets it: the residual
  stream rounds to bf16 after every sublayer, and a last-bit difference in
  an f32 sublayer flips such a rounding.
* the token pipeline and the driver's resume: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen3_14b import REDUCED as J_REDUCED
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.data.pipeline import TokenPipelineConfig as JTokenPipelineConfig
from repro.launch import steps as j_steps
from repro.models import flash as j_flash
from repro.models import init_model as j_init_model
from repro.models import layers as j_layers
from repro.models import loss_fn as j_loss_fn
from repro.models import unbox
from repro.optim import adamw as j_adamw
from repro_torch.configs.qwen3_14b import REDUCED
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import steps, train
from repro_torch.models import flash, loss_fn
from repro_torch.models.convert import (flat_from_tree, params_from_numpy,
                                        train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.models.layers import TuckerLinear, tucker_linear
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FailureInjector

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
FLASH_SEQ = 1088   # 1088² > 1024²: the flash region on both sides
_MODELS: dict = {}


def _pair(dtype: str, rank: int = 8):
    """(reference cfg, port cfg, reference params), cached."""
    key = (rank, dtype)
    if key not in _MODELS:
        jc = dataclasses.replace(J_REDUCED, tucker_rank=rank, dtype=dtype)
        tc = dataclasses.replace(REDUCED, tucker_rank=rank, dtype=dtype)
        tree = jax.tree.map(np.asarray,
                            unbox(j_init_model(jax.random.PRNGKey(0), jc)))
        _MODELS[key] = (jc, tc, tree)
    return _MODELS[key]


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert not any(launch_counts().values())  # CPU: the plain versions


# --- the data pipeline ------------------------------------------------------

@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_token_pipeline_is_the_reference_bitwise(num_shards):
    cfg = dict(vocab_size=512, seq_len=33, global_batch=8, seed=3)
    port = TokenPipeline(TokenPipelineConfig(**cfg), 0, num_shards)
    ref = JTokenPipeline(JTokenPipelineConfig(**cfg), 0, num_shards)
    assert np.array_equal(port.probs, ref.probs)
    for step in (0, 1, 7, 1000):
        for shard in range(num_shards):
            got = TokenPipeline(port.cfg, shard, num_shards).batch(step)
            want = JTokenPipeline(ref.cfg, shard, num_shards).batch(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype == np.int32
                assert np.array_equal(got[k], want[k])
        got, want = port.global_batch(step), ref.global_batch(step)
        for k in ("tokens", "labels"):
            assert np.array_equal(got[k], want[k])


# --- the two autograd Functions -------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("B,S,Kv,G,D,causal,chunk", [
    (2, 256, 2, 3, 16, True, 64),     # GQA, four chunks
    (1, 192, 1, 1, 32, True, 64),     # G = 1, three chunks
    (2, 128, 2, 2, 16, False, 64),    # non-causal at a chunk multiple
    (1, 128, 2, 1, 80, False, 64),    # HuBERT's head width, non-causal
])
def test_flash_attention_vjp_matches_reference(backend, B, S, Kv, G, D,
                                               causal, chunk):
    rng = np.random.default_rng(S + D)
    q = rng.normal(size=(B, S, Kv, G, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Kv, D)).astype(np.float32)
            for _ in range(2))
    dout = rng.normal(size=(B, S, Kv, G, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: j_flash.flash_attention(
        a, b, c, causal, chunk, chunk), q, k, v)
    wants = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, causal, backend=backend)
    assert _rel(out, want) <= TOL["float32"]
    out.backward(torch.from_numpy(dout))
    for t, w in zip((tq, tk, tv), wants):
        assert _rel(t.grad, w) <= TOL["float32"]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_tucker_matmul_gradients_match_reference(backend, xdtype):
    """dx, dU1, dG and dU2 of ``tucker_linear`` against ``jax.grad`` of the
    reference's (``"xla"``), x in f32 or bf16 with f32 factors; dx comes
    back in x's dtype (bf16: one bf16 ulp, 2⁻⁸)."""
    rng = np.random.default_rng(7)
    M, K, R, N = 48, 40, 8, 56
    x = rng.normal(size=(2, M // 2, K)).astype(np.float32)
    fac = {"u1": rng.normal(size=(K, R)).astype(np.float32),
           "g": rng.normal(size=(R, R)).astype(np.float32),
           "u2": rng.normal(size=(N, R)).astype(np.float32)}
    gy = rng.normal(size=(2, M // 2, N)).astype(np.float32)
    jdt = jnp.bfloat16 if xdtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x, jdt)

    def f(p, xx):
        return jnp.sum(j_layers.tucker_linear(p, xx) * gy)

    want_p, want_x = jax.grad(f, argnums=(0, 1))(fac, jx)
    mod = TuckerLinear(K, N, R, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for name, val in fac.items():
            getattr(mod, name).copy_(torch.from_numpy(val))
    for p in mod.parameters():
        p.requires_grad_(True)
    tx = torch.from_numpy(x).to(getattr(torch, xdtype)).requires_grad_(True)
    y = tucker_linear(mod, tx, backend)
    assert y.dtype == torch.float32
    y.backward(torch.from_numpy(gy))
    assert tx.grad.dtype == tx.dtype
    xtol = 2.0 ** -8 if xdtype == "bfloat16" else TOL["float32"]
    assert _rel(tx.grad, np.asarray(want_x, np.float32)) <= xtol
    for name in ("u1", "g", "u2"):
        assert _rel(getattr(mod, name).grad, want_p[name]) <= TOL["float32"]


# --- loss_fn and the training step -----------------------------------------

def _grads_by_name(tc, jgrads) -> dict:
    return flat_from_tree(tc, jax.tree.map(np.asarray, jgrads))


@pytest.mark.parametrize("S", [64, FLASH_SEQ])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(dtype, S, monkeypatch):
    jc, tc, tree = _pair(dtype)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    labels[1, :5] = -100
    want_loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, jc, b)))(
        tree, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    calls = {"n": 0}
    real = flash.FlashAttention.apply

    def spy(*a):
        calls["n"] += 1
        return real(*a)

    monkeypatch.setattr(flash.FlashAttention, "apply", spy)
    model = params_from_numpy(tc, tree, "cpu")
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = loss_fn(model, tc, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - float(want_loss)) <= TOL[dtype] * float(
        want_loss)
    want = _grads_by_name(tc, jgrads)
    assert set(want) == set(params)
    for (name, _), g in zip(params.items(), grads):
        assert _rel(g, want[name]) <= TOL[dtype], name
    assert calls["n"] == (tc.num_layers if S == FLASH_SEQ else 0)


def _fed_batches(jc, n, batch=2, seq=64):
    pipe = JTokenPipeline(JTokenPipelineConfig(
        vocab_size=jc.vocab_size, seq_len=seq, global_batch=batch))
    return [pipe.global_batch(i) for i in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_reference(dtype):
    """Three steps of ``make_train_step`` against the reference's jitted
    step, from one state, on the reference pipeline's batches: the loss,
    grad norm and lr of each step, then every parameter and moment."""
    jc, tc, tree = _pair(dtype)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    jstate = j_steps.TrainState(
        jax.tree.map(jnp.asarray, tree),
        j_adamw.init(jax.tree.map(jnp.asarray, tree)))
    j_step = jax.jit(j_steps.make_train_step(
        jc, j_adamw.AdamWConfig(**opt_cfg.__dict__)))
    state = train_state_from_numpy(
        tc, (tree, (np.int32(0), *[jax.tree.map(
            lambda a: np.zeros(a.shape, np.float32), tree)] * 2)), "cpu")
    step = steps.make_train_step(tc, opt_cfg)
    for batch in _fed_batches(jc, 3):
        jstate, jm = j_step(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        state, m = step(state, train.device_batch(batch, "cpu"))
        for name in ("loss", "grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) <= TOL[dtype] * abs(
                float(jm[name])), name
    p, (st, mm, vv) = train_state_to_numpy(state, tc)
    assert int(st) == int(jstate.opt.step) == 3
    for got, want in ((p, jstate.params), (mm, jstate.opt.m),
                      (vv, jstate.opt.v)):
        g, w = flat_from_tree(tc, got), _grads_by_name(tc, want)
        for name in w:
            assert _rel(torch.from_numpy(g[name]), w[name]) <= TOL[dtype], \
                name


def test_train_state_round_trip_through_convert():
    jc, tc, tree = _pair("float32")
    rng = np.random.default_rng(0)
    m = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     tree)
    v = jax.tree.map(lambda a: rng.random(size=a.shape).astype(np.float32),
                     tree)
    state = train_state_from_numpy(tc, (tree, (np.int32(5), m, v)), "cpu")
    assert int(state.opt.step) == 5 and state.opt.step.dtype == torch.int32
    assert all(p.requires_grad for p in state.params.parameters())
    assert set(state.opt.m) == set(dict(state.params.named_parameters()))
    back_p, (back_s, back_m, back_v) = train_state_to_numpy(state, tc)
    assert int(back_s) == 5
    for got, want in ((back_p, tree), (back_m, m), (back_v, v)):
        lg = jax.tree_util.tree_leaves_with_path(got)
        lw = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in lg] == [p for p, _ in lw]
        for (_, a), (_, b) in zip(lg, lw):
            assert a.shape == b.shape and np.array_equal(a, b)


# --- the driver -------------------------------------------------------------

ARGS = ["--arch", "qwen3_14b", "--reduced", "--tucker-rank", "8",
        "--batch", "2", "--seq", "32", "--ckpt-every", "4", "--log-every",
        "4", "--device", "cpu"]


def _final(res) -> dict:
    from repro_torch.checkpoint.manager import flatten

    return {k: v.detach().clone() for k, v in flatten(res["state"]).items()}


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_driver_resume_is_bitwise(tmp_path, backend):
    """10 uninterrupted steps; the same after a failure at step 6
    (restored from step 4 and replayed); and 4 steps, then ``--resume``
    to 10.  Every final leaf and every loss bit for bit."""
    args = ARGS + ["--backend", backend]
    full = train.main(args + ["--steps", "10", "--ckpt-dir",
                              str(tmp_path / "a")])
    assert full["started"] == 0 and len(full["history"]) == 10
    assert all(np.isfinite(m["loss"]) for m in full["history"].values())
    failed = train.main(args + ["--steps", "10", "--ckpt-dir",
                                str(tmp_path / "b")],
                        injector=FailureInjector({6}))
    assert failed["stats"].restarts == 1
    _same(_final(full), _final(failed))
    first = train.main(args + ["--steps", "4", "--ckpt-dir",
                               str(tmp_path / "c")])
    assert len(first["history"]) == 4
    resumed = train.main(args + ["--steps", "10", "--resume", "--ckpt-dir",
                                 str(tmp_path / "c")])
    assert resumed["started"] == 4 and sorted(resumed["history"]) == list(
        range(5, 11))
    _same(_final(full), _final(resumed))
    for i in range(1, 11):
        want = full["history"][i]["loss"]
        assert failed["history"][i]["loss"] == want
        got = (first if i <= 4 else resumed)["history"][i]["loss"]
        assert got == want


def test_driver_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                             tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.run(REDUCED, steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "qwen3_14b", "--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    res = train.run(REDUCED, steps=1, batch=2, seq=16, device="cpu",
                    ckpt_dir=str(tmp_path))
    assert res["device"] == "cpu" and res["peak_device_bytes"] is None


def test_train_lm_example_both_variants_learn(capsys):
    """``python -m repro_torch.examples.train_lm`` on its default (the
    reduced ``qwen3_14b``), dense and Tucker-compressed at rank 16, for
    30 steps: both losses fall (the example's own assert) and the Tucker
    model has fewer parameters."""
    from repro_torch.examples import train_lm

    res = train_lm.main(["--steps", "30", "--seq", "32", "--device", "cpu"])
    for first, last, _ in res.values():
        assert last < first
    assert res["tucker"][2] < res["dense"][2]
    assert "compression: " in capsys.readouterr().out
