"""The port's LM serving path against the live JAX reference, on the CPU.

Reduced ``qwen3_14b`` (2 layers, d_model 64, 4 heads over 2 KV heads,
vocab 512) with ``tucker_rank`` 8 (Tucker FFNs) and 0 (dense FFNs), in
f32 and in ``dtype="bfloat16"``.  The reference's weights
(``unbox(init_model(PRNGKey(0), cfg))``, numpy leaves) go into the port
through ``models.convert.params_from_numpy``; tokens come from numpy.  The
port runs its default ``"cuda"`` backend, which on CPU tensors takes the
kernels' plain versions; the reference runs its default (``"xla"``
``tucker_matmul``, jnp attention), jitted as its serve driver jits it.

Tolerances, max |Δ| over max |reference logit|, with their reasons:

* f32: 1e-5.  Every product is f32 on both sides, summed in another
  order; two layers and the head keep that near 1e-6.
* bf16: 2⁻⁵.  The residual stream is rounded to bf16 after every
  sublayer and the head runs in bf16: a last-bit difference in an f32
  sublayer output flips a bf16 rounding (2⁻⁸ of that value), and such
  flips pass through the later layers into the logits, whose own bf16
  ulp is 2⁻⁸ to 2⁻⁷ of the largest.  2⁻⁵ is a few ulps of the largest
  logit.  Greedy tokens are compared in f32 only: bf16 logits tie often.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen3_14b import REDUCED as J_REDUCED
from repro.launch import steps as j_steps
from repro.models import decode_step as j_decode_step
from repro.models import flash as j_flash
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_model as j_init_model
from repro.models import loss_fn as j_loss_fn
from repro.models import unbox
from repro_torch.configs import PORTED_ARCHS, get_config, require_ported
from repro_torch.configs.qwen3_14b import REDUCED
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import steps
from repro_torch.models import (decode_step, flash, forward, init_cache,
                                init_model, loss_fn)
from repro_torch.models.convert import params_from_numpy, params_to_numpy

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
PROMPT = 1100   # Sq·Sk = 1100·1104 > 1024²: the online-softmax region
FED = 4         # decode steps on fed tokens
_MODELS: dict = {}


def _pair(rank: int, dtype: str):
    """(reference cfg, port cfg, reference params, port model), cached."""
    key = (rank, dtype)
    if key not in _MODELS:
        jc = dataclasses.replace(J_REDUCED, tucker_rank=rank, dtype=dtype)
        tc = dataclasses.replace(REDUCED, tucker_rank=rank, dtype=dtype)
        tree = jax.tree.map(np.asarray,
                            unbox(j_init_model(jax.random.PRNGKey(0), jc)))
        _MODELS[key] = (jc, tc, tree, params_from_numpy(tc, tree, "cpu"))
    return _MODELS[key]


def _close(port: torch.Tensor, want, dtype: str) -> float:
    port = port.float().numpy()
    want = np.asarray(want, np.float32)
    assert port.shape == want.shape
    assert np.isfinite(port).all()
    rel = np.abs(port - want).max() / np.abs(want).max()
    assert rel <= TOL[dtype], rel
    return rel


@pytest.fixture(autouse=True)
def _no_launches():
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


@pytest.mark.parametrize("S", [16, PROMPT])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [8, 0])
def test_forward_and_loss_match_reference(rank, dtype, S, flash_calls):
    jc, tc, tree, model = _pair(rank, dtype)
    rng = np.random.default_rng(S + rank)
    toks = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    labels[0, :3] = -100                       # ignored positions
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want_logits, want_loss = jax.jit(lambda p, b: (
        j_forward(p, jc, b), j_loss_fn(p, jc, b)))(tree, jbatch)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    logits = forward(model, tc, batch)
    assert logits.dtype == (torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
    _close(logits, want_logits, dtype)
    loss = loss_fn(model, tc, batch)
    assert abs(loss.item() - float(want_loss)) <= TOL[dtype] * float(
        want_loss)
    # S = 1100 reaches the flash region on both sides (once per layer);
    # S = 16 the dense block
    want_calls = tc.num_layers if S == PROMPT else 0
    assert flash_calls["port"] == 2 * want_calls   # forward + loss_fn
    assert (flash_calls["jax"] > 0) == (want_calls > 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [8, 0])
def test_prefill_and_decode_steps_match_reference(rank, dtype, flash_calls):
    """Prefill of a 1100-token prompt into a cache of 1104, then 4 decode
    steps on fed tokens, through both sides' step functions; the decode
    logits through ``decode_step``."""
    jc, tc, tree, model = _pair(rank, dtype)
    B = 2
    rng = np.random.default_rng(rank + 1)
    toks = rng.integers(0, jc.vocab_size, (B, PROMPT + FED)).astype(np.int32)
    j_caches = j_init_cache(jc, B, PROMPT + FED, dtype=jnp.float32)
    caches = init_cache(tc, B, PROMPT + FED, dtype=torch.float32,
                        device="cpu")
    want_last, j_caches = jax.jit(j_steps.make_prefill_step(jc))(
        tree, {"tokens": jnp.asarray(toks[:, :PROMPT])}, j_caches)
    last, caches = steps.make_prefill_step(tc)(
        model, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, caches)
    _close(last, want_last, dtype)
    # a cache from index 0 takes the reference's scan and the port's kernel
    assert flash_calls["port"] == tc.num_layers and flash_calls["jax"] == 0

    j_step = jax.jit(lambda p, b, c, i: j_decode_step(p, jc, b, c, i))
    j_serve = jax.jit(j_steps.make_decode_step(jc))
    serve = steps.make_decode_step(tc)
    index = PROMPT
    for i in range(FED):
        fed = toks[:, PROMPT + i:PROMPT + i + 1]
        want, _ = j_step(tree, {"tokens": jnp.asarray(fed)}, j_caches,
                         jnp.asarray(index, jnp.int32))
        want_tok, j_caches, _ = j_serve(tree, j_caches,
                                        jnp.asarray(index, jnp.int32),
                                        {"tokens": jnp.asarray(fed)})
        got, _ = decode_step(model, tc, {"tokens": torch.from_numpy(fed)},
                             caches, index)
        tok, caches, index = serve(model, caches, index,
                                   {"tokens": torch.from_numpy(fed)})
        _close(got, want, dtype)
        assert tok.shape == (B, 1) and tok.dtype == torch.int32
        assert torch.equal(tok[:, 0], got[:, -1].float().argmax(-1).int())
        if dtype == "float32":
            np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    assert index == PROMPT + FED
    # the filled caches: the reference stacks its one group's two layers
    (group,) = j_caches
    for name in ("k", "v"):
        want_kv = np.asarray(group["attn"][name])
        got_kv = torch.stack([c["attn"][name] for c in caches]).numpy()
        assert np.abs(got_kv - want_kv).max() <= TOL[dtype] * np.abs(
            want_kv).max()


def test_params_round_trip_through_the_reference_tree():
    """params_from_numpy then params_to_numpy gives back the reference's
    tree, bitwise: groups restacked, every name and shape kept."""
    for rank in (8, 0):
        jc, tc, tree, model = _pair(rank, "float32")
        back = params_to_numpy(model, tc)
        flat_want = jax.tree_util.tree_leaves_with_path(tree)
        flat_got = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, g), (_, w) in zip(flat_got, flat_want):
            assert g.shape == w.shape and np.array_equal(g, w), path
    # a 3-layer config stacks three identical layers into one group
    jc = dataclasses.replace(J_REDUCED, tucker_rank=4, num_layers=3)
    tc = dataclasses.replace(REDUCED, tucker_rank=4, num_layers=3)
    tree = jax.tree.map(np.asarray,
                        unbox(j_init_model(jax.random.PRNGKey(1), jc)))
    assert tree["groups"][0]["ffn"]["up"]["u1"].shape == (3, 64, 4)
    model = params_from_numpy(tc, tree, "cpu")
    assert np.array_equal(model.layers[2].ffn.up.u1.numpy(),
                          tree["groups"][0]["ffn"]["up"]["u1"][2])
    back = params_to_numpy(model, tc)
    assert np.array_equal(back["groups"][0]["mixer"]["wq"],
                          tree["groups"][0]["mixer"]["wq"])


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_full_config_matches_the_reference_config(arch):
    """The port's copy of each ported config is the reference's, full and
    reduced, field by field."""
    from repro.configs import get_config as j_get_config

    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced=reduced)) == \
            dataclasses.asdict(j_get_config(arch, reduced=reduced))


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_125m"])
def test_unported_architectures_raise_naming_the_roadmap(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_config(arch)


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "qwen3_moe_30b_a3b"])
def test_moe_architectures_load_and_serve(arch):
    """Lifted from the refusals above: both MoE configs load, full and
    reduced, and the reduced one serves on the CPU."""
    from repro_torch.launch import serve

    assert get_config(arch).num_experts > 0
    res = serve.run(get_config(arch, reduced=True), batch=2, prompt_len=8,
                    gen=2, device="cpu", backend="torch")
    assert res["finite"] and res["generated"].shape == (2, 2)


@pytest.mark.parametrize("case", [
    "internvl2_2b", "hubert_xlarge", "frontend=vision", "encoder_only"])
def test_frontend_and_encoder_configs_load_and_run(case):
    """Lifted from the refusals below: InternVL2-2B and HuBERT-XLarge load,
    full and reduced, and so do the reduced Qwen3-14B with a vision
    frontend and encoder-only; on the CPU a config with a decode path
    serves, and an encoder-only one takes a forward and is refused by
    ``serve.run`` in the reference's words."""
    from repro_torch.launch import serve

    changes = {"frontend=vision": dict(frontend="vision", frontend_dim=32,
                                       num_patches=4),
               "encoder_only": dict(encoder_only=True)}
    if case in changes:
        cfg = require_ported(dataclasses.replace(REDUCED, **changes[case]))
    else:
        full = get_config(case)
        assert full.frontend in ("vision", "audio") and full.num_layers > 2
        cfg = get_config(case, reduced=True)
    if cfg.has_decode:
        res = serve.run(cfg, batch=2, prompt_len=8, gen=2, device="cpu",
                        backend="torch")
        assert res["finite"] and res["generated"].shape == (2, 2)
        return
    model = init_model(cfg, device="cpu")
    batch = ({"frames": torch.randn(2, 8, cfg.frontend_dim)}
             if cfg.frontend == "audio"
             else {"tokens": torch.randint(0, cfg.vocab_size, (2, 8))})
    logits = forward(model, cfg, batch)
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="encoder-only — no decode path"):
        serve.run(cfg, batch=2, prompt_len=8, gen=2, device="cpu",
                  backend="torch")


@pytest.mark.parametrize("change", [
    {"dtype": "float16"}, {"shared_attn_every": 2}, {"mixer": "mamba2"},
    {"mixer": "xlstm"}])
def test_unported_parts_of_a_config_raise(change):
    cfg = dataclasses.replace(REDUCED, **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        require_ported(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "qwen3_moe_30b_a3b"])
def test_moe_sharded_config_runs_on_a_one_worker_mesh(arch):
    """Lifted from the refusals above: ``moe_sharded`` (the expert-parallel
    island) inits, and one sharded step on a (1, 1) mesh runs it with a
    finite loss."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import adamw

    cfg = require_ported(dataclasses.replace(get_config(arch, reduced=True),
                                             moe_sharded=True))
    mesh = Mesh((torch.device("cpu"),), (1, 1))
    state, layouts = train.build_state(torch.Generator().manual_seed(0), cfg,
                                       mesh, "fsdp_tp")
    toks = torch.randint(0, cfg.vocab_size, (2, 17))
    _, m = steps.make_sharded_train_step(cfg, adamw.AdamWConfig(), mesh,
                                         layouts)(
        state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"]))


def test_mixed_precision_config_runs():
    """Lifted from the refusals above: ``mixed_precision`` (bf16) inits,
    and its forward runs on bf16 copies of the f32 weights."""
    cfg = require_ported(dataclasses.replace(
        REDUCED, mixed_precision=True, dtype="bfloat16"))
    model = init_model(cfg, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    logits = forward(model, cfg, {"tokens": torch.randint(
        0, cfg.vocab_size, (2, 8))})
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()


MLA = dict(use_mla=True, kv_lora_rank=32, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16)
MOE = dict(num_experts=4, top_k=2, moe_d_ff=32)


@pytest.mark.parametrize("change", [MLA, MOE], ids=["use_mla", "num_experts"])
def test_mla_and_moe_parts_of_a_config_run(change):
    """Lifted from the refusals above: MLA attention and MoE FFNs in the
    reduced Qwen3-14B init and run a forward on the CPU."""
    cfg = require_ported(dataclasses.replace(REDUCED, **change))
    model = init_model(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    logits = forward(model, cfg, {"tokens": toks})
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("entry", ["train_run", "make_train_step"])
@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "qwen3_moe_30b_a3b"])
def test_mla_and_moe_train_on_one_device(arch, entry, tmp_path):
    """Lifted from the refusals below: ``launch/train.run`` and
    ``make_train_step`` train the reduced MoE configs one step, with a
    finite loss."""
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    cfg = get_config(arch, reduced=True)
    if entry == "train_run":
        res = train.run(cfg, steps=1, batch=2, seq=16, device="cpu",
                        ckpt_dir=str(tmp_path))
        loss = res["history"][1]["loss"]
    else:
        state = steps.init_train_state(
            cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 17))
        _, m = steps.make_train_step(cfg, adamw.AdamWConfig())(
            state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        loss = float(m["loss"])
    assert np.isfinite(loss)


@pytest.mark.parametrize("entry", ["make_sharded_train_step", "ShardedLM"])
@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "qwen3_moe_30b_a3b"])
def test_mla_and_moe_training_raise_naming_the_roadmap(arch, entry):
    """Lifted from the refusals: sharded training of MLA and MoE builds
    and takes one step on a (1, 2) CPU mesh (the heads, experts and
    vocab split over ``model``), with a finite loss."""
    from repro_torch.distributed.sharded_lm import ShardedLM
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import adamw

    cfg = get_config(arch, reduced=True)
    mesh = Mesh((torch.device("cpu"),) * 2, (1, 2))
    state, layouts = train.build_state(torch.Generator().manual_seed(0), cfg,
                                       mesh, "tp")
    toks = torch.randint(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if entry == "make_sharded_train_step":
        step = steps.make_sharded_train_step(cfg, adamw.AdamWConfig(), mesh,
                                             layouts, policy="tp")
        _, m = step(state, batch)
        loss = m["loss"]
    else:
        loss = ShardedLM(cfg, mesh, layouts, "tp").loss(state.params, batch)
        loss.backward()
        assert all(p.grad is not None for t in state.params.values()
                   for p in t.parts)
    assert np.isfinite(loss.item())

