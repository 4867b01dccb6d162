"""The dense Qwen2.5-14B, DeepSeek-67B and StarCoder2-15B in the port
against the live JAX reference, on the CPU.

Each architecture's REDUCED config (f32): the reference's weights
(``unbox(init_model(PRNGKey(0), cfg))``, jitted), with every bias and norm
leaf moved off its init (zeros and ones would hide QKV bias, LayerNorm's
bias and the norms' scales), go into the port through
``models.convert``; tokens and labels come from numpy.  One jitted
reference call an architecture (a module-scoped fixture) gives the
logits, the loss, every gradient leaf and one AdamW step's parameters, m
and v, which the tests below share.  The port's prefill and greedy
decode are held against that full forward's logits at the same
positions.  On the CPU the port takes its kernels' plain versions.

Tolerance ``TOL``: 1e-5 of each output's or leaf's largest reference
value (f32 products summed in another order, as
``tests/test_torch_lm_model.py``).  After the AdamW step the parameters
are held there where the gradient set the step to f32 accuracy (√v̂ at
least ``ADAM_FLOOR`` of its leaf's largest), and within lr elsewhere, as
``tests/test_torch_moe_train.py`` explains.
"""
import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import forward as j_forward
from repro.models import init_model as j_init_model
from repro.models import layers as j_layers
from repro.models import loss_fn as j_loss_fn
from repro.models import unbox
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import steps
from repro_torch.models import decode_step, forward, init_cache, loss_fn
from repro_torch.models import layers
from repro_torch.models.convert import (flat_from_tree, params_from_numpy,
                                        train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import adamw

TOL = 1e-5
ADAM_FLOOR = 1e-2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=2)   # step 1 at full lr
ARCHS = ("qwen2_5_14b", "deepseek_67b", "starcoder2_15b")
B, S, PROMPT = 2, 24, 20   # decode positions PROMPT..S-1 on fed tokens
MOVED = ("bq", "bk", "bv", "bias", "scale")   # leaves moved off their init


class Run(NamedTuple):
    jc: object
    tc: object
    tree: dict       # the reference's parameters, numpy leaves
    batch: dict      # numpy inputs
    ref: dict        # the reference's results, numpy leaves


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert not any(launch_counts().values())  # CPU: the plain versions


def rel(got, want) -> float:
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def moved_tree(jc, seed: int) -> dict:
    """The reference's jitted init, every ``MOVED`` leaf moved off its
    constant init by a seeded normal draw (scales around 1); cached, and
    read only."""
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: unbox(j_init_model(k, jc)))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = getattr(path[-1], "key", None)
        if name not in MOVED:
            return leaf
        noise = 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        return leaf + noise
    return jax.tree_util.tree_map_with_path(move, tree)


def reference_results(jc, tree: dict, batch: dict) -> dict:
    """One jitted call: the logits, the loss and its gradients, and one
    AdamW step from fresh moments (``OPT``)."""
    opt_cfg = j_adamw.AdamWConfig(**OPT)

    def run(params, b):
        logits = j_forward(params, jc, b)
        loss, grads = jax.value_and_grad(j_loss_fn)(params, jc, b)
        new, opt, _ = j_adamw.update(grads, j_adamw.init(params), params,
                                     opt_cfg)
        return dict(logits=logits, loss=loss, grads=grads, params=new,
                    m=opt.m, v=opt.v)
    out = jax.jit(run)(jax.tree.map(jnp.asarray, tree),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, out)


def make_run(arch: str, batch: dict, seed: int) -> Run:
    jc = j_get_config(arch, reduced=True)
    tc = get_config(arch, reduced=True)
    tree = moved_tree(jc, seed)
    return Run(jc, tc, tree, batch, reference_results(jc, tree, batch))


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def check_forward(run: Run) -> torch.Tensor:
    model = params_from_numpy(run.tc, run.tree, "cpu")
    logits = forward(model, run.tc, to_torch(run.batch))
    assert logits.dtype == torch.float32
    assert rel(logits, run.ref["logits"]) <= TOL
    return logits


def check_gradients(run: Run) -> None:
    state = train_state_from_numpy(run.tc, (run.tree, zero_moments(run)),
                                   "cpu")
    names = dict(state.params.named_parameters())
    loss = loss_fn(state.params, run.tc, to_torch(run.batch))
    assert abs(loss.item() - float(run.ref["loss"])) <= TOL * abs(
        float(run.ref["loss"]))
    got = dict(zip(names, torch.autograd.grad(loss, list(names.values()))))
    want = flat_from_tree(run.tc, run.ref["grads"])
    assert set(got) == set(want)
    for name, g in got.items():
        assert rel(g, want[name]) <= TOL, name


def zero_moments(run: Run) -> tuple:
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), run.tree)
    return np.int32(0), zeros, zeros


def check_adamw_step(run: Run) -> None:
    state = train_state_from_numpy(run.tc, (run.tree, zero_moments(run)),
                                   "cpu")
    opt_cfg = adamw.AdamWConfig(**OPT)
    state, metrics = steps.make_train_step(run.tc, opt_cfg)(
        state, to_torch(run.batch))
    assert abs(float(metrics["loss"]) - float(run.ref["loss"])) <= TOL * abs(
        float(run.ref["loss"]))
    p, (step, m, v) = train_state_to_numpy(state, run.tc)
    assert int(step) == 1
    for got, name in ((m, "m"), (v, "v")):
        g, w = flat_from_tree(run.tc, got), flat_from_tree(run.tc,
                                                           run.ref[name])
        assert set(g) == set(w)
        for leaf in w:
            assert rel(g[leaf], w[leaf]) <= TOL, (name, leaf)
    g, w = flat_from_tree(run.tc, p), flat_from_tree(run.tc,
                                                     run.ref["params"])
    for leaf, vv in flat_from_tree(run.tc, run.ref["v"]).items():
        set_by_g = np.sqrt(vv) >= ADAM_FLOOR * np.sqrt(vv).max()
        err = np.abs(g[leaf] - w[leaf])
        assert err[set_by_g].max(initial=0.0) <= TOL * np.abs(
            w[leaf]).max(), leaf
        assert err.max() <= opt_cfg.lr, leaf


def check_prefill_and_decode(run: Run, prefill: dict, text0: int,
                             fed: np.ndarray) -> None:
    """``prefill`` (its positions 0..P−1 of the reference's forward) then
    the fed tokens one a step: each step's logits against the full
    forward's at its position, and the greedy pick its logits' argmax."""
    model = params_from_numpy(run.tc, run.tree, "cpu")
    P = text0 + prefill["tokens"].shape[1]
    caches = init_cache(run.tc, B, P + fed.shape[1], dtype=torch.float32,
                        device="cpu")
    last, caches = steps.make_prefill_step(run.tc)(model, to_torch(prefill),
                                                   caches)
    want = run.ref["logits"]
    assert rel(last, want[:, P - 1]) <= TOL
    serve = steps.make_decode_step(run.tc)
    index = P
    for i in range(fed.shape[1]):
        tok = torch.from_numpy(fed[:, i:i + 1])
        got, _ = decode_step(model, run.tc, {"tokens": tok}, caches, index)
        assert rel(got[:, 0], want[:, index]) <= TOL
        pick, caches, index = serve(model, caches, index, {"tokens": tok})
        assert torch.equal(pick[:, 0], got[:, 0].argmax(-1).int())
    assert index == P + fed.shape[1]


def token_batch(vocab: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -100                     # ignored positions
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": labels}


@pytest.fixture(scope="module", params=ARCHS)
def run(request) -> Run:
    arch = request.param
    return make_run(arch, token_batch(512, ARCHS.index(arch)),
                    seed=ARCHS.index(arch) + 10)


def test_forward_matches_reference(run):
    check_forward(run)


def test_loss_and_gradients_match_reference(run):
    check_gradients(run)


def test_adamw_step_matches_reference(run):
    check_adamw_step(run)


def test_prefill_and_decode_match_the_full_forward(run):
    toks = run.batch["tokens"]
    check_prefill_and_decode(run, {"tokens": toks[:, :PROMPT]}, 0,
                             toks[:, PROMPT:])


# --- each layer type's new parts ---------------------------------------------

def test_qkv_bias_is_read():
    """Qwen2.5's q, k and v biases are parameters of the port's GQA at the
    reference's shapes, and the logits depend on them (so the parity above
    holds them: it runs with them moved off zero)."""
    tc = get_config("qwen2_5_14b", reduced=True)
    jc = j_get_config("qwen2_5_14b", reduced=True)
    assert tc.qkv_bias and get_config("qwen2_5_14b").qkv_bias
    tree = moved_tree(jc, 10)
    model = params_from_numpy(tc, tree, "cpu")
    mixer = model.layers[0].mixer
    H, Kv, hd = tc.num_heads, tc.num_kv_heads, tc.head_dim
    assert (mixer.bq.shape, mixer.bk.shape, mixer.bv.shape) == (
        (H, hd), (Kv, hd), (Kv, hd))
    assert mixer.bq.axes == ("heads", "head_dim")
    batch = to_torch(token_batch(tc.vocab_size, 0))
    with_bias = forward(model, tc, batch)
    with torch.no_grad():
        for layer in model.layers:
            for name in ("bq", "bk", "bv"):
                getattr(layer.mixer, name).zero_()
    assert rel(forward(model, tc, batch), with_bias) > 1e-3


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_layernorm_and_plain_mlp_match_reference(act):
    """StarCoder2's LayerNorm (with its bias) and its ungated MLP (tanh
    GELU; jax.nn.gelu's default), against the reference's functions on
    the same numpy inputs; the silu case is the gated MLP the other
    configs take."""
    rng = np.random.default_rng(5)
    d, f = 48, 80
    x = rng.normal(size=(3, 7, d)).astype(np.float32)
    ln = {"scale": 1 + 0.1 * rng.normal(size=d).astype(np.float32),
          "bias": 0.1 * rng.normal(size=d).astype(np.float32)}
    w = {k: rng.normal(size=s).astype(np.float32) / np.sqrt(s[0])
         for k, s in (("wi", (d, f)), ("wo", (f, d)), ("wg", (d, f)))}
    if act == "gelu":
        del w["wg"]
    want_ln, want_mlp = jax.jit(lambda x_, ln_, w_: (
        j_layers.layernorm(ln_, x_, 1e-6), j_layers.mlp(w_, x_, act)))(
        x, ln, w)
    port_ln = layers.LayerNorm(d, "cpu")
    mlp = layers.MLP(d, f, act != "gelu", torch.Generator().manual_seed(0),
                     "cpu")
    with torch.no_grad():
        for mod, vals in ((port_ln, ln), (mlp, w)):
            for name, val in vals.items():
                getattr(mod, name).copy_(torch.from_numpy(val))
    tx = torch.from_numpy(x)
    assert rel(layers.layernorm(port_ln, tx, 1e-6), want_ln) <= TOL
    assert rel(layers.mlp(mlp, tx, act), want_mlp) <= TOL
    if act == "gelu":   # StarCoder2's config builds both
        model = params_from_numpy(
            get_config("starcoder2_15b", reduced=True),
            moved_tree(j_get_config("starcoder2_15b", reduced=True), 12),
            "cpu")
        assert isinstance(model.layers[0].ln1, layers.LayerNorm)
        assert not hasattr(model.layers[0].ffn, "wg")


def test_rope_theta_1e6_matches_reference():
    """Qwen2.5's full config rotates with theta 1e6 (its reduced config
    keeps the default 1e4): ``apply_rope`` at both against the
    reference's at positions below 256, and the port's frequencies
    within 1e-7 of the exact ones (float64) for any position.  Farther
    out the two packages part by the position times an ulp: their f32
    ``theta ** (2i / D)`` differ in the last bit in about a third of the
    64 frequencies (each within 1e-7 of exact), which gives 3.5e-5 of the
    output at position 1,000 and 1.4e-3 at 32,767."""
    assert get_config("qwen2_5_14b").rope_theta == 1e6
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 3, 128)).astype(np.float32)
    pos = np.array([0, 1, 2, 17, 64, 100, 128, 200, 255], np.int32)
    for theta in (1e6, 1e4):
        want = jax.jit(lambda a, p, t=theta: j_layers.apply_rope(a, p, t))(
            x, pos)
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta)
        assert rel(got, want) <= TOL
        exact = 1.0 / theta ** (np.arange(0, 128, 2) / 128)
        for freqs in (layers.rope_freqs(128, theta).numpy(),
                      np.asarray(jax.jit(lambda t=theta: j_layers.rope_freqs(
                          128, t))())):
            assert (np.abs(freqs - exact) / exact).max() <= 1e-7


def test_configs_are_the_reference_configs_with_their_parts():
    """The three full configs' distinguishing fields, as the reference
    sets them (every field: ``test_torch_lm_model.py``)."""
    q, d, s = (get_config(a) for a in ARCHS)
    assert (q.qkv_bias, q.rope_theta, q.norm_type) == (True, 1e6, "rmsnorm")
    assert (d.num_layers, d.d_model, d.head_dim, d.qkv_bias) == (
        95, 8192, 128, False)
    assert (s.norm_type, s.activation, s.num_kv_heads) == (
        "layernorm", "gelu", 4)
    for cfg in (q, d, s):
        assert cfg.head_dim == 128 and cfg.dtype == "bfloat16"
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            j_get_config(cfg.arch_id))
