"""The port's MLA attention and its MoE models against the live reference.

CPU, f32.  ``mla_attention`` against ``repro.models.attention`` without a
cache (S = 16: the dense block; S = 1100: Sq·Sk > 1024², the flash
region), prefill into a cache then 4 fed decode steps, and the absorbed
decode against the decompressing one; then the reduced DeepSeek-V2-Lite
(MLA, a dense first layer, MoE layers with shared experts) and Qwen3-MoE
(GQA with qk-norm, MoE) through ``forward``, the prefill step,
``decode_step`` and ``launch.serve.run``.  The reference runs with its
dispatch fill corrected (``test_torch_moe._fixed_dispatch``: its own
routed experts add 0, ROADMAP.md Queue 3).  The weights are the
reference's (``models.convert.params_from_numpy``), tokens from numpy.

Tolerance 1e-5 of the largest reference value: f32 products summed in
another order.  Decode against forward runs at a capacity factor at
which nothing drops: the two see different token counts T, so different
capacities, and a drop in one that the other keeps is a different result,
not an error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.deepseek_v2_lite_16b import CONFIG as J_DS_FULL
from repro.configs.deepseek_v2_lite_16b import REDUCED as J_DS
from repro.configs.qwen3_moe_30b_a3b import CONFIG as J_QM_FULL
from repro.configs.qwen3_moe_30b_a3b import REDUCED as J_QM
from repro.launch import steps as j_steps
from repro.models import attention as j_attn
from repro.models import decode_step as j_decode_step
from repro.models import flash as j_flash
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_model as j_init_model
from repro.models import moe as j_moe
from repro.models import unbox
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import serve, steps
from repro_torch.models import (attention, decode_step, flash, forward,
                                init_cache)
from repro_torch.models.blocks import group_specs, layer_specs
from repro_torch.models.convert import params_from_numpy, params_to_numpy

from test_torch_moe import _fixed_dispatch

TOL = 1e-5
PROMPT = 1100   # Sq·Sk = 1100·1104 > 1024²: the online-softmax region
FED = 4
ARCHS = {"deepseek_v2_lite_16b": J_DS, "qwen3_moe_30b_a3b": J_QM}
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def _fixed_reference_no_launches(monkeypatch):
    monkeypatch.setattr(j_moe, "_dispatch_indices", _fixed_dispatch)
    reset_launch_counts()
    yield
    assert not any(launch_counts().values())  # CPU: the plain versions


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the calls of both sides' flash region."""
    calls = {"jax": 0, "port": 0}
    j_orig, t_orig = j_flash.flash_attention, flash.flash_attention

    def j_spy(*a, **k):
        calls["jax"] += 1
        return j_orig(*a, **k)

    def t_spy(*a, **k):
        calls["port"] += 1
        return t_orig(*a, **k)

    monkeypatch.setattr(j_flash, "flash_attention", j_spy)
    monkeypatch.setattr(flash, "flash_attention", t_spy)
    return calls


def _close(port: torch.Tensor, want, tol: float = TOL) -> float:
    port = port.float().numpy()
    want = np.asarray(want, np.float32)
    assert port.shape == want.shape
    assert np.isfinite(port).all()
    rel = np.abs(port - want).max() / np.abs(want).max()
    assert rel <= tol, rel
    return rel


def _pair(arch: str, **change):
    """(reference cfg, port cfg, reference params, port model), cached."""
    key = (arch, tuple(sorted(change.items())))
    if key not in _MODELS:
        jc = dataclasses.replace(ARCHS[arch], **change)
        tc = dataclasses.replace(get_config(arch, reduced=True), **change)
        # jitted: the eager init's values, bitwise, in half its time
        tree = jax.tree.map(np.asarray, jax.jit(
            lambda k: unbox(j_init_model(k, jc)))(jax.random.PRNGKey(0)))
        _MODELS[key] = (jc, tc, tree, params_from_numpy(tc, tree, "cpu"))
    return _MODELS[key]


# ---------------------------------------------------------------------------
# MLA alone
# ---------------------------------------------------------------------------

def _mla(absorb: bool = False):
    """(reference cfg, port cfg, reference MLA params, port MLA)."""
    jc = dataclasses.replace(J_DS, mla_absorb=absorb)
    tc = dataclasses.replace(get_config("deepseek_v2_lite_16b", reduced=True),
                             mla_absorb=absorb)
    tree = jax.tree.map(np.asarray, unbox(
        j_attn.init_mla(jax.random.PRNGKey(3), jc)))
    layer = attention.init_mla(tc, torch.Generator().manual_seed(3), "cpu")
    state = layer.state_dict()
    flat = {"kv_norm.scale": tree["kv_norm"]["scale"],
            **{k: v for k, v in tree.items() if k != "kv_norm"}}
    assert set(state) == set(flat)
    with torch.no_grad():
        for name, t in state.items():
            t.copy_(torch.from_numpy(np.array(flat[name])))
    return jc, tc, tree, layer


def _x(S: int, B: int = 2, seed: int = 0):
    return np.random.default_rng(seed).normal(size=(B, S, 64)).astype(
        np.float32)


@pytest.mark.parametrize("S", [16, PROMPT])
def test_mla_attention_without_cache_matches_reference(S, flash_calls):
    jc, tc, tree, layer = _mla()
    x = _x(S, seed=S)
    pos = np.arange(S)
    want, _ = j_attn.mla_attention(tree, jc, jnp.asarray(x),
                                   jnp.asarray(pos))
    got, cache = attention.mla_attention(layer, tc, torch.from_numpy(x),
                                         torch.from_numpy(pos))
    assert cache is None
    _close(got, want)
    assert flash_calls["port"] == (1 if S == PROMPT else 0)
    assert (flash_calls["jax"] > 0) == (S == PROMPT)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_prefill_and_decode_match_reference(absorb, flash_calls):
    """Prefill of 1100 positions into a cache of 1104 (the flash kernel at
    (D, Dv) = (24, 16) on the port, the reference's scan), then 4 decode
    steps, absorbed or decompressed as the config asks."""
    jc, tc, tree, layer = _mla(absorb)
    B = 2
    x = _x(PROMPT + FED, B, seed=9)
    j_cache = j_attn.init_mla_cache(jc, B, PROMPT + FED, jnp.float32)
    cache = attention.init_mla_cache(tc, B, PROMPT + FED, torch.float32,
                                     "cpu")
    spans = [(0, PROMPT)] + [(PROMPT + i, PROMPT + i + 1)
                             for i in range(FED)]
    for lo, hi in spans:
        pos = np.arange(lo, hi)
        want, j_cache = j_attn.mla_attention(
            tree, jc, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos),
            cache=j_cache, cache_index=jnp.asarray(lo, jnp.int32))
        got, out_cache = attention.mla_attention(
            layer, tc, torch.from_numpy(x[:, lo:hi]), torch.from_numpy(pos),
            cache=cache, cache_index=lo)
        assert out_cache is cache          # written in place
        _close(got, want)
    for name in ("c_kv", "k_pe"):
        _close(cache[name], j_cache[name])
    assert flash_calls["port"] == 1 and flash_calls["jax"] == 0


def test_mla_absorbed_decode_matches_decompressed():
    _, tc_dec, _, layer = _mla(False)
    tc_abs = dataclasses.replace(tc_dec, mla_absorb=True)
    B, S = 2, 40
    x = torch.from_numpy(_x(S, B, seed=2))
    caches = {c: attention.init_mla_cache(c, B, S, torch.float32, "cpu")
              for c in (tc_dec, tc_abs)}
    for lo, hi in [(0, 30)] + [(i, i + 1) for i in range(30, S)]:
        pos = torch.arange(lo, hi)
        dec, _ = attention.mla_attention(layer, tc_dec, x[:, lo:hi], pos,
                                         cache=caches[tc_dec], cache_index=lo)
        ab, _ = attention.mla_attention(layer, tc_abs, x[:, lo:hi], pos,
                                        cache=caches[tc_abs], cache_index=lo)
        # S ≤ 16 takes the absorbed route; the 30-position prefill does not
        _close(ab, dec.numpy())


@pytest.mark.parametrize("kv_valid,q_offset", [(None, 0), (1090, 7)])
def test_flash_plain_at_mla_widths_matches_reference(kv_valid, q_offset):
    """The flash kernel's plain version at (D, Dv) = (24, 16) against the
    reference's chunked attention: its custom-VJP flash (no cache) and its
    scan (a cache)."""
    rng = np.random.default_rng(q_offset)
    B, S, H = 1, PROMPT, 2
    q = rng.normal(size=(B, S, H, 24)).astype(np.float32)
    k = rng.normal(size=(B, S + 4, H, 24)).astype(np.float32)
    v = rng.normal(size=(B, S + 4, H, 16)).astype(np.float32)
    if kv_valid is None:
        k, v = k[:, :S], v[:, :S]
    want = j_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=jnp.asarray(q_offset) if kv_valid else 0,
        kv_valid_len=kv_valid)
    got = flash_attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                              True, kv_len=kv_valid, q_offset=q_offset)
    assert got.shape == (B, S, H, 16)
    _close(got, want)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, PROMPT])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_fixed_reference(arch, S, flash_calls):
    jc, tc, tree, model = _pair(arch)
    toks = np.random.default_rng(S).integers(
        0, jc.vocab_size, (2, S)).astype(np.int32)
    want = jax.jit(lambda p, b: j_forward(p, jc, b))(
        tree, {"tokens": jnp.asarray(toks)})
    got = forward(model, tc, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert flash_calls["port"] == (tc.num_layers if S == PROMPT else 0)
    assert (flash_calls["jax"] > 0) == (S == PROMPT)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_steps_match_fixed_reference(arch, flash_calls):
    """Prefill of a 1100-token prompt into a cache of 1104, then 4 decode
    steps on fed tokens (T = 2 a step: capacity 1, so picks drop on both
    sides alike), through both sides' step functions and
    ``decode_step``."""
    jc, tc, tree, model = _pair(arch)
    B = 2
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (B, PROMPT + FED)).astype(np.int32)
    j_caches = j_init_cache(jc, B, PROMPT + FED, dtype=jnp.float32)
    caches = init_cache(tc, B, PROMPT + FED, dtype=torch.float32,
                        device="cpu")
    want_last, j_caches = jax.jit(j_steps.make_prefill_step(jc))(
        tree, {"tokens": jnp.asarray(toks[:, :PROMPT])}, j_caches)
    last, caches = steps.make_prefill_step(tc)(
        model, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, caches)
    _close(last, want_last)
    assert flash_calls["port"] == tc.num_layers and flash_calls["jax"] == 0

    j_step = jax.jit(lambda p, b, c, i: j_decode_step(p, jc, b, c, i))
    serve_step = steps.make_decode_step(tc)
    index = PROMPT
    for i in range(FED):
        fed = toks[:, PROMPT + i:PROMPT + i + 1]
        want, j_caches = j_step(tree, {"tokens": jnp.asarray(fed)}, j_caches,
                                jnp.asarray(index, jnp.int32))
        got, _ = decode_step(model, tc, {"tokens": torch.from_numpy(fed)},
                             [{"attn": {k: v.clone() for k, v in
                                        c["attn"].items()}} for c in caches],
                             index)
        tok, caches, index = serve_step(model, caches, index,
                                        {"tokens": torch.from_numpy(fed)})
        _close(got, want)
        np.testing.assert_array_equal(
            tok[:, 0].numpy(), np.asarray(want[:, -1]).argmax(-1))
    assert index == PROMPT + FED
    # the filled caches against the reference's stacked groups
    li = 0
    for (_, count), group in zip(group_specs(layer_specs(tc)), j_caches):
        for name, want_c in group["attn"].items():
            got_c = torch.stack([caches[li + j]["attn"][name]
                                 for j in range(count)])
            _close(got_c if count > 1 else got_c[0], want_c)
        li += count


@pytest.mark.parametrize("arch,absorb", [("deepseek_v2_lite_16b", False),
                                         ("deepseek_v2_lite_16b", True),
                                         ("qwen3_moe_30b_a3b", False)])
def test_decode_matches_forward_when_nothing_drops(arch, absorb):
    """A capacity factor of E / K gives every expert room for every token
    at any T, so forward (T = 2·S) and decode (T = 2) route alike."""
    cfg0 = get_config(arch, reduced=True)
    _, tc, _, model = _pair(arch, capacity_factor=float(
        cfg0.num_experts / cfg0.top_k))
    tc_run = dataclasses.replace(tc, mla_absorb=absorb)
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab_size, (B, S)).astype(np.int64))
    full = forward(model, tc_run, {"tokens": toks})
    caches = init_cache(tc_run, B, S + 2, dtype=torch.float32, device="cpu")
    lg, caches = decode_step(model, tc_run, {"tokens": toks[:, :6]}, caches,
                             0)
    _close(lg, full[:, :6].numpy())
    for i in range(6, S):
        lg, caches = decode_step(model, tc_run, {"tokens": toks[:, i:i + 1]},
                                 caches, i)
        _close(lg[:, 0], full[:, i].numpy())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_run_matches_fixed_reference(arch):
    """``launch.serve.run`` at the reduced size on the CPU: its prefill's
    last-position logits against the reference's prefill step on the same
    prompts, and greedy tokens finite and in range."""
    jc, tc, tree, model = _pair(arch)
    B, P = 2, 24
    res = serve.run(tc, batch=B, prompt_len=P, gen=3, seed=5, device="cpu",
                    backend="cuda", params=model)
    prompts = torch.randint(0, tc.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(5))
    want, _ = jax.jit(j_steps.make_prefill_step(jc))(
        tree, {"tokens": jnp.asarray(prompts.numpy().astype(np.int32))},
        j_init_cache(jc, B, P + 3, dtype=jnp.float32))
    _close(res["last_logits"], want)
    assert res["finite"] and res["generated"].shape == (B, 3)
    np.testing.assert_array_equal(res["generated"][:, 0].numpy(),
                                  np.asarray(want).argmax(-1))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_round_trip_through_the_reference_tree(arch):
    """The groups are DeepSeek-V2-Lite's ('mla+mlp', 1), ('mla+moe', 2) at
    the reduced depth and Qwen3-MoE's ('gqa+moe', 2); params_from_numpy
    then params_to_numpy gives back the reference's tree bitwise."""
    jc, tc, tree, model = _pair(arch)
    want_groups = {"deepseek_v2_lite_16b": [("mla+mlp", 1), ("mla+moe", 2)],
                   "qwen3_moe_30b_a3b": [("gqa+moe", 2)]}[arch]
    assert group_specs(layer_specs(tc)) == want_groups
    back = params_to_numpy(model, tc)
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert g.shape == w.shape and np.array_equal(g, w), path
    # the full configs' groups
    full = {"deepseek_v2_lite_16b": [("mla+mlp", 1), ("mla+moe", 26)],
            "qwen3_moe_30b_a3b": [("gqa+moe", 48)]}[arch]
    assert group_specs(layer_specs(get_config(arch))) == full


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_match_the_reference_configs(arch):
    want = {"deepseek_v2_lite_16b": (J_DS_FULL, J_DS),
            "qwen3_moe_30b_a3b": (J_QM_FULL, J_QM)}[arch]
    for reduced, ref_cfg in zip((False, True), want):
        assert dataclasses.asdict(get_config(arch, reduced=reduced)) \
            == dataclasses.asdict(ref_cfg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_parameter_axes_match_the_reference(arch):
    """Every leaf's logical axes are the reference's Boxed axes (without
    the stacked groups' leading "layers")."""
    from repro.models.layers import Boxed
    from repro_torch.models import param_axes

    jc, tc, _, model = _pair(arch)
    boxed = j_init_model(jax.random.PRNGKey(0), jc)
    got = param_axes(model)
    want = {}
    li = 0
    for (_, count), group in zip(group_specs(layer_specs(tc)),
                                 boxed["groups"]):
        leaves = jax.tree_util.tree_leaves_with_path(
            group, is_leaf=lambda b: isinstance(b, Boxed))
        for path, b in leaves:
            name = ".".join(str(k.key) for k in path)
            for j in range(count):
                want[f"layers.{li + j}.{name}"] = (
                    b.axes[1:] if count > 1 else b.axes)
        li += count
    assert {k: v for k, v in got.items() if k.startswith("layers.")} == want
