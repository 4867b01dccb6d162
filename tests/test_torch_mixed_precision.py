"""``mixed_precision`` in the port against the live JAX reference, CPU.

The reference's ``_cast_params``: with ``mixed_precision`` and
``dtype="bfloat16"`` every f32 parameter is used as a bf16 copy in
``forward`` and ``decode_step`` (router, norm scales, Tucker factors,
embedding and head included), and the f32 masters take the gradients.
Reduced ``qwen3_14b`` with Tucker FFNs (rank 8) and the reduced MoE models
(DeepSeek-V2-Lite with MLA, Qwen3-MoE), the reference with its dispatch
fill corrected (``test_torch_moe._fixed_dispatch``; ROADMAP.md, Queue 3),
every reference function ``jax.jit``-ed.  The bf16 flash kernels are
reached only this way (the port keeps f32 masters, and
``chunked_attention`` promotes q, k and v to one dtype), so
``FlashAttention`` is held in bf16 against the reference's custom-VJP
flash attention at the widths of both models (on the CPU, the kernels'
plain versions, which widen bf16 to f32 as the kernels do).

Tolerance 2⁻⁵ of each output's or gradient leaf's largest reference
value, ``tests/test_torch_lm_train.py``'s bf16 rule: the residual stream
and the weights round to bf16, and a last-bit difference in an f32
product flips such a rounding.  Routes: the bf16 streams differ in their
last bits, so a token whose best router scores lie within a few bf16
ulps of each other may pick other experts in the two packages, which is
a different result, not an error.  So the port is fed the reference's
picks (``moe.route`` wrapped here: the gates are still the port's own,
from its router logits at those experts), and each pick that the port
would have made otherwise is reported with its margin, which must lie
within ``ROUTE_MARGIN``.

Gradients: the reference differentiates in bf16 too, and its own sums
(a norm scale's gradient over every token, say) can land farther than
2⁻⁵ from the exact gradient.  The yardstick is then the reference's own
f32 gradient (``jax.grad`` of its ``loss_fn`` with ``dtype="float32"`` and
``mixed_precision`` off) of the same bf16-rounded weights on the same
routes (its ``jax.lax.top_k`` fed the recorded picks, its layer scans
unrolled so that each MoE layer takes its own): a leaf the port misses the
reference's by more than 2⁻⁵ must lie within 2⁻⁵ of the yardstick, and
no farther from it than the reference's does, where the reference is off
it by more than 2⁻⁶ — else the leaf fails.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs.qwen3_14b import REDUCED as J_QWEN
from repro.models import flash as j_flash
from repro.models import forward as j_forward
from repro.models import init_model as j_init_model
from repro.models import loss_fn as j_loss_fn
from repro.models import model as j_model
from repro.models import moe as j_moe
from repro.models import unbox
from repro_torch.configs.qwen3_14b import REDUCED as T_QWEN
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import steps
from repro_torch.models import flash, forward, loss_fn, moe
from repro_torch.models.convert import flat_from_tree, params_from_numpy
from repro_torch.models.model import cast_params
from repro_torch.optim import adamw

from test_torch_moe import _fixed_dispatch
from test_torch_moe_models import _pair as _moe_pair

TOL = 2.0 ** -5
# a flipped pick: the closest two of the reference's K + 1 best router
# scores within this share of the token's best (a few bf16 ulps)
ROUTE_MARGIN = 2.0 ** -6
MIXED = dict(dtype="bfloat16", mixed_precision=True)
CASES = ("qwen3_14b", "deepseek_v2_lite_16b", "qwen3_moe_30b_a3b")
SEQ = 64


@pytest.fixture(autouse=True)
def _fixed_reference_no_launches(monkeypatch):
    monkeypatch.setattr(j_moe, "_dispatch_indices", _fixed_dispatch)
    reset_launch_counts()
    yield
    assert not any(launch_counts().values())  # CPU: the plain versions


@functools.lru_cache(maxsize=None)
def _qwen_pair():
    """Reduced ``qwen3_14b`` at Tucker rank 8, f32: (reference cfg, port
    cfg, reference params), the init jitted (the eager one takes ~10 s)."""
    jc = dataclasses.replace(J_QWEN, tucker_rank=8, dtype="float32")
    tc = dataclasses.replace(T_QWEN, tucker_rank=8, dtype="float32")
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: unbox(j_init_model(k, jc)))(jax.random.PRNGKey(0)))
    return jc, tc, tree


def _mixed(name: str):
    """(reference cfg, port cfg, reference f32 params) under mixed
    precision."""
    if name == "qwen3_14b":
        jc, tc, tree = _qwen_pair()
    else:
        jc, tc, tree, _ = _moe_pair(name)
    return (dataclasses.replace(jc, **MIXED), dataclasses.replace(tc, **MIXED),
            tree)


_RECORDED_FROM = j_moe.moe_ffn


def _record_picks(rec: list, orig=_RECORDED_FROM):
    """The reference's ``moe_ffn`` recording each call's K + 1 best router
    scores and their experts (after the softmax where the config takes
    it first), in call order."""

    def spy(p, cfg, x):
        s = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p[
            "router"].astype(jnp.float32)
        if cfg.router_softmax_then_topk:
            s = jax.nn.softmax(s, axis=-1)
        vals, ids = jax.lax.top_k(s, cfg.top_k + 1)
        jax.debug.callback(lambda i, v: rec.append(
            (np.asarray(i), np.asarray(v))), ids, vals, ordered=True)
        return orig(p, cfg, x)

    return spy


@contextlib.contextmanager
def _fed_routes(picks: list, flips: list):
    """The port's MoE calls take the experts of ``picks`` (one
    ``_record_picks`` entry a call, in order), gates from their own
    router logits; tokens whose own picks differ go to ``flips``."""
    real, calls = moe.route, iter(picks)

    def fed(params, cfg, xt):
        logits, _, own = real(params, cfg, xt)
        ids_np, vals = next(calls)
        ids = torch.tensor(ids_np[:, :cfg.top_k], dtype=torch.long)
        for t in (own != ids).any(-1).nonzero()[:, 0].tolist():
            gaps = vals[t, :-1] - vals[t, 1:]
            flips.append(float(gaps.min() / vals[t, 0]))
        return logits, moe.gates(cfg, logits, ids), ids

    moe.route = fed
    try:
        yield
    finally:
        moe.route = real


class _Over:
    """``base`` with the attributes in ``over`` replaced."""

    def __init__(self, base, **over):
        self._base = base
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _unrolled_scan(f, init, xs):
    """``jax.lax.scan`` as a Python loop: the body is traced once a layer."""
    carry, ys = init, []
    for i in range(jax.tree.leaves(xs)[0].shape[0]):
        carry, y = f(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def _exact_grads(jc, tree: dict, jb: dict, picks: list, monkeypatch) -> dict:
    """The reference's f32 gradients of the bf16-rounded weights on the
    recorded routes: the yardstick of the bf16 gradients, as a tree."""
    cfg = dataclasses.replace(jc, dtype="float32", mixed_precision=False)
    rounded = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16).astype(
        jnp.float32), tree)
    calls = iter(picks)

    def fed_top_k(x, k):
        ids = jnp.asarray(next(calls)[0][:, :k])
        return jnp.take_along_axis(x, ids, axis=-1), ids

    monkeypatch.setattr(j_moe, "moe_ffn", _RECORDED_FROM)
    monkeypatch.setattr(j_moe, "jax", _Over(jax, lax=_Over(
        jax.lax, top_k=fed_top_k)))
    if picks:   # a scanned layer group traces its body once
        monkeypatch.setattr(j_model, "jax", _Over(jax, lax=_Over(
            jax.lax, scan=_unrolled_scan)))
    grads = jax.jit(jax.grad(lambda p, b: j_loss_fn(p, cfg, b)))(rounded, jb)
    assert next(calls, None) is None   # one fed call a MoE layer
    return grads


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_package_import_sets_f32_matmul_flags():
    """TF32 off for matmuls and cuDNN, and cuBLAS's reduced-precision
    reduction of bf16 GEMMs off: every dot accumulates in f32."""
    assert repro_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert (torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction is False)


def test_cast_params_is_a_bf16_view_of_the_masters():
    """Every f32 leaf comes back bf16, the masters stay f32 and untouched;
    without ``mixed_precision`` (or in f32) the model itself comes back."""
    jc, tc, tree = _mixed("deepseek_v2_lite_16b")
    model = params_from_numpy(tc, tree, "cpu")
    view = cast_params(model, tc)
    assert view is not model
    masters = dict(model.named_parameters())
    cast = dict(view.named_parameters())
    assert set(cast) == set(masters)
    for name, p in masters.items():
        assert p.dtype == torch.float32 and cast[name].dtype == torch.bfloat16
        assert torch.equal(cast[name], p.bfloat16())
    assert view.layers[1].ffn.router.dtype == torch.bfloat16
    for change in ({"mixed_precision": False}, {"dtype": "float32"}):
        assert cast_params(model, dataclasses.replace(tc, **change)) is model


@pytest.mark.parametrize("B,S,Kv,G,D,Dv,causal", [
    (2, 256, 2, 2, 16, 16, True),      # GQA
    (1, 192, 2, 1, 24, 16, True),      # MLA's reduced widths
    (1, 128, 1, 2, 192, 128, False),   # MLA's, non-causal
])
def test_flash_attention_in_bf16_matches_reference(B, S, Kv, G, D, Dv,
                                                   causal):
    """bf16 q, k, v through ``FlashAttention``: the output (bf16) and
    dq, dk, dv (bf16, as the inputs) against ``jax.vjp`` of the
    reference's flash attention on the same bf16 values."""
    rng = np.random.default_rng(S + D)
    bf = lambda *s: torch.from_numpy(   # noqa: E731
        rng.normal(size=s).astype(np.float32)).bfloat16()
    q, k, v = bf(B, S, Kv, G, D), bf(B, S, Kv, D), bf(B, S, Kv, Dv)
    dout = bf(B, S, Kv, G, Dv)
    j = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]

    def ref(a, b, c, g):
        y, vjp = jax.vjp(lambda a, b, c: j_flash.flash_attention(
            a, b, c, causal, 64, 64), a, b, c)
        return y, vjp(g)

    want, wants = jax.jit(ref)(*j, jnp.asarray(dout.float().numpy(),
                                               jnp.bfloat16))
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, causal)
    assert out.dtype == torch.bfloat16
    assert _rel(out, want) <= TOL
    out.backward(dout)
    for t, w in zip((tq, tk, tv), wants):
        assert t.grad.dtype == torch.bfloat16
        assert _rel(t.grad, w) <= TOL


@pytest.mark.parametrize("case", CASES)
def test_mixed_precision_matches_reference(case, monkeypatch):
    """The forward's logits, then ``loss_fn``'s value and every gradient
    (the f32 masters') against the reference's at 2⁻⁵; then one step of
    ``make_train_step`` moves the f32 masters, which stay f32."""
    jc, tc, tree = _mixed(case)
    S = SEQ
    rng = np.random.default_rng(S + len(case))
    toks = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    recorded: list = []
    monkeypatch.setattr(j_moe, "moe_ffn", _record_picks(recorded))
    # one compile: the forward's MoE calls record first, then the loss's
    want_logits, (want_loss, jgrads) = jax.jit(lambda p, b: (
        j_forward(p, jc, b),
        jax.value_and_grad(lambda q: j_loss_fn(q, jc, b))(p)))(tree, jb)
    jax.effects_barrier()
    moe_layers = tc.num_layers - tc.first_k_dense if tc.num_experts else 0
    assert len(recorded) == 2 * moe_layers
    picks = {"forward": recorded[:moe_layers], "loss": recorded[moe_layers:]}
    flips: list = []
    model = params_from_numpy(tc, tree, "cpu")
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    with torch.no_grad(), _fed_routes(picks["forward"], flips):
        logits = forward(model, tc, batch)
    assert logits.dtype == torch.bfloat16
    assert _rel(logits, want_logits) <= TOL
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    with _fed_routes(picks["loss"], flips):
        loss = loss_fn(model, tc, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    print(f"{case}: {len(flips)} picks fed against the port's own, "
          f"margins {flips}")
    assert all(m <= ROUTE_MARGIN for m in flips), flips
    assert abs(loss.item() - float(want_loss)) <= TOL * float(want_loss)
    want = flat_from_tree(tc, jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(params)
    exact = None
    for (name, p), g in zip(params.items(), grads):
        assert g.dtype == torch.float32 == p.dtype
        if _rel(g, want[name]) <= TOL:
            continue
        if exact is None:
            exact = flat_from_tree(tc, jax.tree.map(np.asarray, _exact_grads(
                jc, tree, jb, picks["loss"], monkeypatch)))
        off = _rel(torch.tensor(want[name]), exact[name])
        port = _rel(g, exact[name])
        print(f"{case} {name}: the reference is off the f32 gradient by "
              f"{off:.4f}, the port by {port:.4f}")
        assert off > TOL / 2 and port <= min(TOL, off), name

    before = {n: p.detach().clone() for n, p in params.items()}
    state = steps.TrainState(model, adamw.init(model))
    state, m = steps.make_train_step(tc, adamw.AdamWConfig(lr=1e-3))(
        state, batch)
    assert np.isfinite(float(m["loss"]))
    after = dict(state.params.named_parameters())
    assert all(p.dtype == torch.float32 for p in after.values())
    assert any(not torch.equal(after[n], before[n]) for n in before)
