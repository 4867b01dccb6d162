"""InternVL2-2B's vision frontend and HuBERT-XLarge's audio encoder in the
port against the live JAX reference, on the CPU.

Both REDUCED configs (f32), as ``tests/test_torch_dense_archs.py`` holds
the dense ones, with its helpers: one jitted reference call an
architecture gives the logits, the loss, every gradient leaf and one
AdamW step, and the port is held to them within ``TOL`` (1e-5 of each
output's or leaf's largest).  InternVL2's batch is 8 patch embeddings
before 16 text tokens, its labels on the text alone; HuBERT's is 24
frames with labels on every frame.  InternVL2's prefill (patches and
text) and text decode are held against the full forward; HuBERT is held
non-causal in the flash region too (2,048 frames, a multiple of the
reference's 1,024-key chunks, where its flash attention is right).

The reference's non-causal flash attention pads the keys to a chunk
multiple and masks the padding only under causal masking
(``src/repro/models/flash.py::_fwd_impl``): ``test_reference_non_causal_
padding_fault`` records it, and the port's attention equals a dense f32
recompute there.  Every other parity test here is held to the reference
only where it is right: a sequence of at most 1,024 positions (its dense
block) or a multiple of its chunk.  ``input_specs`` is held to the
reference's for every ported architecture and shape cell.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import steps as j_steps
from repro.models import flash as j_flash
from repro_torch.configs import PORTED_ARCHS, SHAPES, get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import steps, train
from repro_torch.models import flash, forward, loss_fn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import cross_entropy_loss

from test_torch_dense_archs import (TOL, check_adamw_step, check_forward,
                                    check_gradients,
                                    check_prefill_and_decode, make_run,
                                    moved_tree, rel, to_torch)

ARCHS = ("internvl2_2b", "hubert_xlarge")
B, T, S_AUDIO, LONG = 2, 16, 24, 2048   # T text tokens after the patches


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert not any(launch_counts().values())  # CPU: the plain versions


def frontend_batch(cfg, seed: int, frames: int = S_AUDIO,
                   batch: int = B) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        out = {"frames": rng.normal(size=(batch, frames, cfg.frontend_dim)
                                    ).astype(np.float32)}
        n = frames
    else:
        out = {"patches": rng.normal(size=(batch, cfg.num_patches,
                                           cfg.frontend_dim)
                                     ).astype(np.float32),
               "tokens": rng.integers(0, cfg.vocab_size, (batch, T)
                                      ).astype(np.int32)}
        n = T
    labels = rng.integers(0, cfg.vocab_size, (batch, n)).astype(np.int32)
    labels[0, :3] = -100                     # ignored positions
    out["labels"] = labels
    return out


@functools.lru_cache(maxsize=None)
def run_of(arch: str):
    cfg = get_config(arch, reduced=True)
    return make_run(arch, frontend_batch(cfg, ARCHS.index(arch)),
                    seed=ARCHS.index(arch) + 20)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    run = run_of(arch)
    logits = check_forward(run)
    n = (T + run.tc.num_patches if run.tc.frontend == "vision"
         else S_AUDIO)
    assert logits.shape == (B, n, run.tc.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    check_gradients(run_of(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches_reference(arch):
    check_adamw_step(run_of(arch))


def test_vision_prefill_and_text_decode_match_the_full_forward():
    """The patches and the first 12 text tokens through
    ``make_prefill_step``, then the last 4 text tokens decoded from cache
    index P + 12: each step's logits those of the reference's forward over
    the patches and all 16 tokens, at the same position."""
    run = run_of("internvl2_2b")
    toks = run.batch["tokens"]
    check_prefill_and_decode(
        run, {"patches": run.batch["patches"], "tokens": toks[:, :12]},
        run.tc.num_patches, toks[:, 12:])


def test_vision_loss_reads_the_text_positions():
    """The labels cover the text: ``loss_fn`` is the cross-entropy of the
    logits after the P patch positions."""
    run = run_of("internvl2_2b")
    model = params_from_numpy(run.tc, run.tree, "cpu")
    batch = to_torch(run.batch)
    logits = forward(model, run.tc, batch)
    P = run.tc.num_patches
    assert logits.shape[1] == P + T
    want = cross_entropy_loss(logits[:, P:], batch["labels"])
    assert torch.equal(loss_fn(model, run.tc, batch), want)


def test_vision_config_trains_on_text_alone():
    """A text-only batch (``launch/train.run``'s, as the reference's
    ``launch/train.py`` trains InternVL2) leaves ``frontend.proj`` unread:
    it takes a zero gradient, as under ``jax.grad``, and AdamW still decays
    it — the reference's ``adamw.update`` of that leaf with a zero
    gradient."""
    from repro.optim import adamw as j_adamw
    from repro_torch.optim import adamw

    from test_torch_dense_archs import OPT, zero_moments
    from repro_torch.models.convert import train_state_from_numpy

    run = run_of("internvl2_2b")
    state = train_state_from_numpy(run.tc, (run.tree, zero_moments(run)),
                                   "cpu")
    batch = {k: torch.from_numpy(run.batch[k]) for k in ("tokens",
                                                         "labels")}
    state, m = steps.make_train_step(run.tc, adamw.AdamWConfig(**OPT))(
        state, batch)
    assert np.isfinite(float(m["loss"]))
    proj = np.array(run.tree["frontend"]["proj"])
    want, opt, _ = jax.jit(lambda p: j_adamw.update(
        {"proj": jnp.zeros_like(p)}, j_adamw.init({"proj": p}), {"proj": p},
        j_adamw.AdamWConfig(**OPT)))(proj)
    got = state.params.frontend.proj.detach()
    assert not torch.equal(got, torch.from_numpy(proj))   # decayed
    assert rel(got, want["proj"]) <= TOL
    assert not state.opt.m["frontend.proj"].any()


def test_frontends_own_their_parameters():
    """The audio frontend has a projection and no token embedding; the
    vision frontend has both, each with the reference's shape and axes."""
    for arch in ARCHS:
        run = run_of(arch)
        model = params_from_numpy(run.tc, run.tree, "cpu")
        names = dict(model.named_parameters())
        proj = names["frontend.proj"]
        assert proj.shape == (run.tc.frontend_dim, run.tc.d_model)
        assert proj.axes == (None, "embed")
        has_embed = "embed.embedding" in names
        assert has_embed == (run.tc.frontend == "vision")
        assert ("embed" in run.tree) == has_embed


def test_hubert_is_bidirectional():
    """Negating the last frame changes position 0's output, in the dense
    block (16 frames) and in the flash region (1,100 frames); a causal
    model's position 0 would not move."""
    run = run_of("hubert_xlarge")
    model = params_from_numpy(run.tc, run.tree, "cpu")
    rng = np.random.default_rng(10)
    for n in (16, 1100):
        frames = torch.from_numpy(rng.normal(
            size=(1, n, run.tc.frontend_dim)).astype(np.float32))
        flipped = frames.clone()
        flipped[:, -1] = -frames[:, -1]
        out1 = forward(model, run.tc, {"frames": frames})
        out2 = forward(model, run.tc, {"frames": flipped})
        assert not torch.allclose(out1[:, 0], out2[:, 0])
        causal = dataclasses.replace(run.tc, encoder_only=False)
        assert torch.equal(forward(model, causal, {"frames": frames})[:, 0],
                           forward(model, causal, {"frames": flipped})[:, 0])


def test_hubert_flash_region_matches_reference(monkeypatch):
    """2,048 frames (S·S above the reference's 1,024² dense block, a
    multiple of its chunk): the non-causal flash region on both sides,
    once a layer in the port's forward; the logits, the loss and every
    gradient leaf."""
    calls = []
    orig = flash.flash_attention

    def spy(q, k, v, causal=True, **kw):
        calls.append(causal)
        return orig(q, k, v, causal, **kw)

    monkeypatch.setattr(flash, "flash_attention", spy)
    jc = j_get_config("hubert_xlarge", reduced=True)
    tc = get_config("hubert_xlarge", reduced=True)
    run = make_run("hubert_xlarge", frontend_batch(tc, 7, frames=LONG,
                                                   batch=1), seed=20)
    check_forward(run)
    assert calls == [False] * tc.num_layers
    check_gradients(run)
    assert run.tree is moved_tree(jc, 20)   # the weights of the tests above


def test_reference_non_causal_padding_fault():
    """At S = 100 with 64-key chunks, non-causal, the reference pads the
    keys to 128 and leaves the 28 zero keys unmasked: its output is not
    the dense f32 softmax attention's.  The port's flash attention (the
    plain version here; the kernels mask every key at or past kv_len) is,
    within 1e-5, and so are its gradients."""
    rng = np.random.default_rng(80)
    Bq, S, Kv, G, D = 1, 100, 2, 1, 80
    q = rng.normal(size=(Bq, S, Kv, G, D)).astype(np.float32)
    k, v = (rng.normal(size=(Bq, S, Kv, D)).astype(np.float32)
            for _ in range(2))
    got_ref = np.asarray(jax.jit(lambda a, b, c: j_flash.flash_attention(
        a, b, c, False, 64, 64))(q, k, v))
    tq, tk, tv = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (q, k, v))
    logits = torch.einsum("bqkgd,bskd->bkgqs", tq, tk) / np.sqrt(D)
    dense = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(logits, -1), tv)
    assert rel(got_ref, dense.detach()) > 1e-2        # the fault
    pq, pk, pv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash.flash_attention(pq, pk, pv, False)
    assert rel(out, dense.detach()) <= TOL
    gy = rng.normal(size=dense.shape)
    want = torch.autograd.grad(dense, (tq, tk, tv), torch.from_numpy(gy))
    got = torch.autograd.grad(out, (pq, pk, pv),
                              torch.from_numpy(gy.astype(np.float32)))
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("cell", list(J_SHAPES))
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_input_specs_match_reference(arch, cell):
    """Every input's name, shape and dtype, in the reference's order, at
    the full config's width."""
    want = j_steps.input_specs(j_get_config(arch), J_SHAPES[cell])
    got = steps.input_specs(get_config(arch), SHAPES[cell])
    assert list(got) == list(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == tuple(w.shape), name
        assert str(got[name].dtype).removeprefix("torch.") == str(
            jnp.dtype(w.dtype)), name


def test_concretize_draws_the_reference_ranges():
    """The port's shape cells are the reference's; ``concretize`` draws
    the specs from its generator: the same seed the same batch, integers
    in [0, 128), floats standard normal."""
    assert {k: dataclasses.asdict(c) for k, c in SHAPES.items()} == {
        k: dataclasses.asdict(c) for k, c in J_SHAPES.items()}
    cfg = get_config("internvl2_2b", reduced=True)
    cell = dataclasses.replace(SHAPES["train_4k"], seq_len=4096,
                               global_batch=2)
    specs = steps.input_specs(cfg, cell)
    a, b = (steps.concretize(specs, torch.Generator().manual_seed(3))
            for _ in range(2))
    for name, s in specs.items():
        assert a[name].shape == s.shape and a[name].dtype == s.dtype
        assert torch.equal(a[name], b[name])
    for name in ("tokens", "labels"):
        assert a[name].min() >= 0 and a[name].max() == 127
    p = a["patches"]
    assert abs(p.mean().item()) < 0.05 and abs(p.std().item() - 1) < 0.05


def test_hubert_trains_through_make_train_step_only(tmp_path):
    """``launch/train.run`` feeds tokens only (the reference's launcher
    too), so it refuses the audio config and names the way it trains;
    that way, one step on an ``input_specs`` batch, runs; a frontend's
    config is refused on a mesh, naming the roadmap."""
    from repro_torch.distributed.sharded_lm import ShardedLM
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import adamw

    cfg = get_config("hubert_xlarge", reduced=True)
    with pytest.raises(ValueError, match="make_train_step"):
        train.run(cfg, steps=1, device="cpu", ckpt_dir=str(tmp_path))
    cell = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                               global_batch=2)
    batch = steps.concretize(steps.input_specs(cfg, cell),
                             torch.Generator().manual_seed(0))
    batch["labels"] %= cfg.vocab_size   # the reduced head has 64 classes
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    _, m = steps.make_train_step(cfg, adamw.AdamWConfig())(state, batch)
    assert np.isfinite(float(m["loss"]))
    mesh = Mesh((torch.device("cpu"),) * 2, (1, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train.run(get_config("internvl2_2b", reduced=True), steps=1,
                  device="cpu", mesh=mesh, ckpt_dir=str(tmp_path))
    for arch in ARCHS:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ShardedLM(get_config(arch, reduced=True), mesh, {}, "tp")
