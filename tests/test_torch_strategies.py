"""The port's strategy layer, int8 error feedback and ``std_train``'s
checkpoints, against the live JAX reference on the CPU.

* The registry: ``local`` registered and the default; ``KeyError`` for a
  name nobody knows, ``NotImplementedError`` (naming ROADMAP.md) for the
  reference's unported strategies.
* ``compress_ef``/``decompress`` bitwise equal to ``repro.optim.compression``
  in f32 (the same operations in the same order; both round half to even);
  ``compression_ratio`` equal.
* The ``local`` fed-batch step (``step_batch``), uncompressed and
  compressed, over a 12-step trajectory against the reference assembled
  from its pieces (``step_gradients``, ``scatter_row_grads``,
  ``compressed_reduce(axis=None)``, ``_sgd_update``, ``dynamic_lr``):
  rtol 1e-4, atol 1e-6, as the port's other trajectory tests (each op
  agrees to ~1e-6 relative; 12 dependent steps compound it).
* Save at step 6, restore into a fresh state, steps 6 → 10: bitwise equal
  to the uninterrupted run (``tests/test_strategies.py:110-149`` for
  ``local``; the reference allows 1e-6 there, the port's generator state
  makes it exact).
* ``std_train.main``: an interrupted run resumed with ``--resume`` ends on
  the uninterrupted run's bits; an uninterrupted run draws exactly the
  batches of one generator stepping ``sgd_step`` (what the driver drew
  before the strategy layer); the stale-checkpoint warning; the
  reference's flags that are not ported refused.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fasttucker as jft
from repro.data import synthetic as jsyn
from repro.distributed.base import compressed_reduce as j_compressed_reduce
from repro.optim import compression as jcomp
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import fasttucker as ft
from repro_torch.core.sptensor import SparseTensor
from repro_torch.distributed import base, local
from repro_torch.distributed import available_strategies, get_strategy
from repro_torch.launch import std_train
from repro_torch.optim import compression

DIMS = (18, 15, 12)
J = 3
BATCH = 128
STEPS = 12


@pytest.fixture(scope="module")
def tiny():
    t = jsyn.planted_tensor(DIMS, 2500, noise=0.05, seed=0)
    idx, val = np.asarray(t.indices), np.asarray(t.values)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(STEPS):
        pick = rng.integers(0, len(val), BATCH)
        batches.append((idx[pick], val[pick]))
    jcfg = jft.FastTuckerConfig(dims=DIMS, ranks=(J,) * 3, core_rank=J,
                                batch_size=BATCH)
    params0 = jft.init_params(jax.random.PRNGKey(0), jcfg)
    return SparseTensor.from_numpy(idx, val, DIMS, "cpu"), params0, batches


def _cfg(**kw):
    return ft.FastTuckerConfig(dims=DIMS, ranks=(J,) * 3, core_rank=J,
                               batch_size=BATCH, **kw)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_has_local_only():
    assert available_strategies() == ("local",)
    st = get_strategy("local")
    assert st.name == "local" and not st.needs_mesh
    assert isinstance(st, local.LocalStrategy)
    assert get_strategy() is st


def test_unknown_strategy_lists_available():
    with pytest.raises(KeyError, match="available"):
        get_strategy("nope")


@pytest.mark.parametrize("name", ["sync", "strata", "strata_overlap"])
def test_unported_strategies_raise_not_implemented(name):
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md, Queue 1 item 4"):
        get_strategy(name)


def test_register_twice_refused():
    with pytest.raises(ValueError, match="already registered"):
        base.register_strategy(local.LocalStrategy())


def test_device_axis_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        base.compressed_reduce((torch.ones(2, 2),), (torch.zeros(2, 2),),
                               axis="data")


def test_compress_refused_under_gauss_seidel(tiny):
    tensor, _, _ = tiny
    with pytest.raises(ValueError, match="jacobi"):
        get_strategy("local").prepare(
            tensor, _cfg(update_order="gauss_seidel"), compress=True)


# ---------------------------------------------------------------------------
# int8 error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,mag", [((64, 16), 1.0), ((97, 5), 1e-5),
                                       ((3, 40, 7), 100.0)])
def test_compress_ef_bitwise_reference(shape, mag):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    g = (rng.normal(size=shape) * mag).astype(np.float32)
    e = (rng.normal(size=shape) * mag * 1e-2).astype(np.float32)
    g[..., 1, :] = 0.0   # an all-zero row: scale is the 1e-12 guard
    e[..., 1, :] = 0.0
    jq, js, je = jcomp.compress_ef(jnp.asarray(g), jnp.asarray(e))
    q, s, ne = compression.compress_ef(torch.tensor(g), torch.tensor(e))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(ne.numpy(), np.asarray(je))
    assert np.array_equal(compression.decompress(q, s).numpy(),
                          np.asarray(jcomp.decompress(jq, js)))


def test_compression_roundtrip_accuracy():
    """The reference's own check (``tests/test_optim.py``): row error at
    most max|row|/127, and the residual is exactly g − deq."""
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.normal(size=(64, 16)).astype(np.float32))
    q, scale, new_e = compression.compress_ef(g, torch.zeros_like(g))
    deq = compression.decompress(q, scale)
    err = (deq - g).abs().amax(dim=1)
    bound = g.abs().amax(dim=1) / 127.0 + 1e-6
    assert bool((err <= bound * 1.01).all())
    assert torch.equal(new_e, g - deq)


@pytest.mark.parametrize("shape", [(1024, 64), (480189, 4), (7, 3)])
def test_compression_ratio_equal(shape):
    assert compression.compression_ratio(shape) == \
        jcomp.compression_ratio(shape)
    assert compression.compression_ratio(shape, 2) == \
        jcomp.compression_ratio(shape, 2)


def test_compressed_reduce_bitwise_reference():
    rng = np.random.default_rng(3)
    dense = [rng.normal(size=(n, 4)).astype(np.float32) for n in (9, 5)]
    ef = [rng.normal(size=(n, 4)).astype(np.float32) * 1e-3 for n in (9, 5)]
    jo, je = j_compressed_reduce(tuple(map(jnp.asarray, dense)),
                                 tuple(map(jnp.asarray, ef)), None)
    o, e = base.compressed_reduce(tuple(map(torch.tensor, dense)),
                                  tuple(map(torch.tensor, ef)))
    for a, b in zip(o + e, jo + je):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the local fed-batch step against the reference's pieces
# ---------------------------------------------------------------------------

def _reference_local(params0, batches, compress, jcfg):
    @jax.jit
    def step(params, ef, idx, val, t):
        layout = jft.batch_layout(idx, jcfg)
        grads = jft.step_gradients(params, idx, val, jcfg, layout=layout)
        lr_a = jft.dynamic_lr(jcfg.alpha_a, jcfg.beta_a, t)
        lr_b = jft.dynamic_lr(jcfg.alpha_b, jcfg.beta_b, t)
        if not compress:
            return jft._apply_updates(params, idx, grads, lr_a, lr_b,
                                      backend=jcfg.backend,
                                      layout=layout), ef
        dense = jft.scatter_row_grads(params.factors, idx, grads.row_grads,
                                      backend=jcfg.backend, layout=layout)
        dense, ef = j_compressed_reduce(dense, ef, None)
        factors = tuple(jft._sgd_update(f, lr_a, g)
                        for f, g in zip(params.factors, dense))
        core = tuple(jft._sgd_update(b, lr_b, g)
                     for b, g in zip(params.core_factors, grads.core_grads))
        return jft.FastTuckerParams(factors, core), ef

    params = params0
    ef = tuple(jnp.zeros(f.shape, jnp.float32) for f in params0.factors)
    for t, (idx, val) in enumerate(batches):
        params, ef = step(params, ef, jnp.asarray(idx), jnp.asarray(val),
                          jnp.asarray(t, jnp.int32))
    return params


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("port,refb,kw", [
    ("torch", "xla", {}),
    ("cuda", "xla", {}),
    ("torch", "xla", dict(sorted_batches=True, phase_split=True)),
])
def test_local_step_batch_matches_reference(tiny, compress, port, refb, kw):
    tensor, params0, batches = tiny
    jcfg = jft.FastTuckerConfig(dims=DIMS, ranks=(J,) * 3, core_rank=J,
                                batch_size=BATCH, backend=refb, **kw)
    want = _reference_local(params0, batches, compress, jcfg)
    st = get_strategy("local")
    plan = st.prepare(tensor, _cfg(backend=port, **kw), compress=compress)
    ds = st.init(plan, ft.TrainState(ft.params_from_numpy(params0, "cpu"),
                                     0), torch.Generator())
    assert len(ds.ef) == (3 if compress else 0)
    for idx, val in batches:
        ds = local.step_batch(plan, ds, torch.tensor(idx), torch.tensor(val))
    assert ds.step == STEPS
    got = st.eval_params(plan, ds)
    for g, w, p0 in zip(got.factors + got.core_factors,
                        want.factors + want.core_factors,
                        params0.factors + params0.core_factors):
        assert not np.array_equal(np.asarray(w), np.asarray(p0))  # it moved
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_compressed_step_differs_from_uncompressed(tiny):
    """The quantization round trip is really applied (and the EF residual
    is non-zero after a step)."""
    tensor, params0, batches = tiny
    st = get_strategy("local")
    out = {}
    for compress in (False, True):
        plan = st.prepare(tensor, _cfg(backend="torch"), compress=compress)
        ds = st.init(plan, ft.TrainState(
            ft.params_from_numpy(params0, "cpu"), 0), torch.Generator())
        out[compress] = local.step_batch(plan, ds,
                                         *map(torch.tensor, batches[0]))
    assert not torch.equal(out[False].params.factors[0],
                           out[True].params.factors[0])
    assert all(e.abs().max() > 0 for e in out[True].ef)
    assert all(e.dtype == torch.float32 for e in out[True].ef)


def test_ef_residuals_f32_under_bf16_storage(tiny):
    tensor, _, _ = tiny
    st = get_strategy("local")
    cfg = _cfg(backend="torch", dtype="bfloat16")
    plan = st.prepare(tensor, cfg, compress=True)
    ds = st.init(plan, ft.init_state(torch.Generator().manual_seed(0), cfg,
                                     "cpu"), torch.Generator())
    ds = st.make_step(plan)(ds)
    assert ds.params.factors[0].dtype == torch.bfloat16
    assert all(e.dtype == torch.float32 for e in ds.ef)


# ---------------------------------------------------------------------------
# checkpoints: save at 6, restore, 6 -> 10 bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_save_restore_bitwise(tmp_path, tiny, compress, dtype):
    tensor, _, _ = tiny
    cfg = _cfg(backend="torch", dtype=dtype)
    st = get_strategy("local")
    plan = st.prepare(tensor, cfg, None, compress=compress, seed=0)

    def fresh(seed):
        gen = torch.Generator().manual_seed(seed)
        return st.init(plan, ft.init_state(gen, cfg, "cpu"), gen)

    step = st.make_step(plan)
    ds = fresh(0)
    while ds.step < 6:
        ds = step(ds)
    ckpt = CheckpointManager(tmp_path / "local")
    st.save(plan, ckpt, ds)
    assert ckpt.latest_step() == 6
    ds_cont = ds
    while ds_cont.step < 10:
        ds_cont = step(ds_cont)
    ds_res = st.restore(plan, ckpt, fresh(9))
    assert ds_res.step == 6 and isinstance(ds_res.step, int)
    assert torch.equal(ds_res.rng, ds.rng)
    while ds_res.step < 10:
        ds_res = step(ds_res)
    for a, b in zip(ds_cont.params.factors + ds_cont.params.core_factors
                    + ds_cont.ef,
                    ds_res.params.factors + ds_res.params.core_factors
                    + ds_res.ef):
        assert torch.equal(a, b)
    assert torch.equal(ds_cont.rng, ds_res.rng)
    p = st.eval_params(plan, ds_cont)
    assert [f.shape[0] for f in p.factors] == list(DIMS)


def test_generator_state_draws_one_stream(tiny):
    """``make_step`` draws what one generator advancing step by step draws:
    the same batches as ``fasttucker.sgd_step`` from that generator."""
    tensor, _, _ = tiny
    cfg = _cfg(backend="torch")
    st = get_strategy("local")
    plan = st.prepare(tensor, cfg)
    gen = torch.Generator().manual_seed(4)
    state = ft.init_state(gen, cfg, "cpu")
    ds = st.init(plan, state, gen)
    step = st.make_step(plan)
    for _ in range(5):
        ds = step(ds)
        state = ft.sgd_step(state, gen, tensor.indices, tensor.values, cfg)
    for a, b in zip(ds.params.factors + ds.params.core_factors,
                    state.params.factors + state.params.core_factors):
        assert torch.equal(a, b)
    assert torch.equal(ds.rng, gen.get_state())


# ---------------------------------------------------------------------------
# std_train: --resume, --compress, refused flags
# ---------------------------------------------------------------------------

BASE = ["--dims", "30,25,20", "--nnz", "3000", "--rank", "3",
        "--core-rank", "3", "--batch", "128", "--eval-every", "4",
        "--seed", "2", "--device", "cpu"]


def _final(res):
    p = res["state"].params
    return p.factors + p.core_factors + res["dstate"].ef


@pytest.mark.parametrize("flags", [
    ["--backend", "torch"],
    ["--backend", "cuda", "--compress"],
    ["--backend", "torch", "--sorted-batches", "--phase-split", "--dtype",
     "bfloat16", "--compress"],
])
def test_std_train_resume_bitwise(tmp_path, flags):
    whole = std_train.main(BASE + flags + [
        "--steps", "12", "--ckpt-dir", str(tmp_path / "a")])
    assert whole["resumed_from"] is None and whole["ckpt_bytes"] > 0
    assert CheckpointManager(tmp_path / "a").all_steps() == [4, 8, 12]
    # killed after the step-8 commit ...
    std_train.main(BASE + flags + ["--steps", "8", "--ckpt-dir",
                                   str(tmp_path / "b")])
    # ... and resumed
    res = std_train.main(BASE + flags + [
        "--steps", "12", "--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert res["resumed_from"] == 8
    assert [h["step"] for h in res["history"]] == [8, 12]
    assert res["history"][-1] == whole["history"][-1]
    for a, b in zip(_final(whole), _final(res)):
        assert torch.equal(a, b)
    assert torch.equal(whole["dstate"].rng, res["dstate"].rng)


def test_std_train_resume_warns_at_steps(tmp_path, caplog):
    args = BASE + ["--backend", "torch", "--steps", "4", "--ckpt-dir",
                   str(tmp_path)]
    first = std_train.main(args)
    with caplog.at_level(logging.WARNING, logger="repro_torch.std"):
        again = std_train.main(args + ["--resume"])
    assert any("nothing to train" in r.getMessage() for r in caplog.records)
    assert again["resumed_from"] == 4
    assert [h["step"] for h in again["history"]] == [4]
    for a, b in zip(_final(first), _final(again)):
        assert torch.equal(a, b)


def test_std_train_without_resume_starts_over(tmp_path):
    args = BASE + ["--backend", "torch", "--steps", "4", "--ckpt-dir",
                   str(tmp_path)]
    std_train.main(args)
    res = std_train.main(args)
    assert res["resumed_from"] is None
    assert [h["step"] for h in res["history"]] == [0, 4]


def test_std_train_draws_the_generator_stream():
    """An uninterrupted ``--strategy local`` run ends on the bits of one
    generator stepping ``sgd_step`` from the cold init (the driver's loop
    before the strategy layer)."""
    res = std_train.main(BASE + ["--backend", "torch", "--steps", "8",
                                 "--strategy", "local"])
    train_t, cfg = res["train"], res["cfg"]
    gen = torch.Generator().manual_seed(2)
    state = ft.init_state(gen, cfg, "cpu")
    for _ in range(8):
        state = ft.sgd_step(state, gen, train_t.indices, train_t.values, cfg)
    got = res["state"].params
    for a, b in zip(got.factors + got.core_factors,
                    state.params.factors + state.params.core_factors):
        assert torch.equal(a, b)


def test_std_train_compress_converges():
    res = std_train.main(BASE + ["--backend", "torch", "--steps", "40",
                                 "--eval-every", "20", "--compress"])
    rmse = [h["rmse"] for h in res["history"]]
    assert all(np.isfinite(rmse)) and rmse[-1] < rmse[0], rmse
    assert res["strategy"] == "local" and len(res["dstate"].ef) == 3


@pytest.mark.parametrize("flag", ["--mode=local", "--donate=on",
                                  "--warm-start", "--adaptive-rank",
                                  "--out-of-core"])
def test_std_train_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        std_train.main(BASE + ["--steps", "4", flag])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_std_train_refuses_unported_strategy():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        std_train.main(BASE + ["--steps", "4", "--strategy", "strata"])
