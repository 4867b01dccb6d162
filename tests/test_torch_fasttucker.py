"""The port's FastTucker slice against the live JAX reference, on the CPU.

* ``planted_tensor``, ``ratings_tensor`` and ``split``: bitwise equal.
* ``params_from_numpy`` / ``params_to_numpy``: bitwise round trip.
* ``dynamic_lr`` and ``init_scale``: exactly equal (f32 arithmetic).
* autograd of the port's ``sampled_loss`` against its hand-derived
  ``batch_gradients`` (the reference's own check,
  ``tests/test_fasttucker.py::test_grads_match_autodiff``, same tolerance:
  rtol 3e-4, atol 1e-5).
* A 20-step trajectory on fed batches from the same initial parameters:
  the reference steps with ``batch_gradients`` + ``_apply_updates`` +
  ``dynamic_lr`` (``sgd_step``'s jacobi branch without its sampler), the
  port with ``sgd_step_batch``.  Tolerance rtol 1e-4, atol 1e-6: each op
  agrees to ~1e-6 relative (f32 reductions in another order), and 20
  dependent steps compound that.
* ``predict`` and ``rmse_mae`` on the final parameters: rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fasttucker as jft
from repro.core import metrics as jmetrics
from repro.core.sptensor import SparseTensor as JSparseTensor
from repro.data import synthetic as jsyn
from repro_torch.core import fasttucker as ft
from repro_torch.core import metrics
from repro_torch.core.sptensor import SparseTensor
from repro_torch.data import synthetic

DIMS = (60, 50, 40)
RANKS = (4, 5, 6)   # ragged J_n
R = 4
BATCH = 256
STEPS = 20
PAIRS = [("torch", "xla"), ("cuda", "pallas_interpret"), ("cuda", "xla")]


def test_planted_ratings_and_split_bitwise():
    for port_fn, ref_fn, kw, dims, nnz in [
            (synthetic.planted_tensor, jsyn.planted_tensor,
             dict(rank=4, core_rank=3, noise=0.05, seed=3), (30, 20, 10),
             2000),
            # 50 of 60 cells: the first draw has duplicates, so the
            # rejection loop of _unique_indices runs too
            (synthetic.planted_tensor, jsyn.planted_tensor, dict(seed=1),
             (5, 4, 3), 50),
            (synthetic.ratings_tensor, jsyn.ratings_tensor, dict(seed=5),
             (30, 20, 10), 2000)]:
        p = port_fn(dims, nnz, device="cpu", **kw)
        r = ref_fn(dims, nnz, **kw)
        assert p.dims == r.dims
        assert np.array_equal(p.indices.numpy(), np.asarray(r.indices))
        assert np.array_equal(p.values.numpy(), np.asarray(r.values))
        for seed in (0, 4):
            for pt, rt in zip(p.split(0.1, seed=seed), r.split(0.1, seed=seed)):
                assert np.array_equal(pt.indices.numpy(),
                                      np.asarray(rt.indices))
                assert np.array_equal(pt.values.numpy(),
                                      np.asarray(rt.values))
    assert p.indices.dtype == torch.int32 and p.values.dtype == torch.float32


def test_params_numpy_round_trip():
    cfg = jft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R)
    jparams = jft.init_params(jax.random.PRNGKey(0), cfg)
    back = ft.params_to_numpy(ft.params_from_numpy(jparams, "cpu"))
    for a, b in zip(back.factors + back.core_factors,
                    jparams.factors + jparams.core_factors):
        assert a.dtype == np.float32
        assert np.array_equal(a, np.asarray(b))


def test_dynamic_lr_and_init_scale_exact():
    t = np.arange(0, 20000, dtype=np.int32)
    for alpha, beta in [(0.006, 0.05), (0.0045, 0.1)]:
        want = np.asarray(jft.dynamic_lr(alpha, beta, jnp.asarray(t)))
        got = np.array([ft.dynamic_lr(alpha, beta, int(s)).item()
                        for s in t], np.float32)
        assert np.array_equal(got, want)
    for ranks, core in [(RANKS, R), ((8, 8, 8), 8), ((4, 4, 4, 4), 16)]:
        dims = (10,) * len(ranks)
        assert ft.init_scale(ft.FastTuckerConfig(
            dims=dims, ranks=ranks, core_rank=core, backend="torch")) == \
            jft.init_scale(jft.FastTuckerConfig(dims=dims, ranks=ranks,
                                                core_rank=core))


@pytest.fixture(scope="module")
def data():
    tensor = jsyn.planted_tensor(DIMS, 6000, rank=4, core_rank=R, noise=0.02,
                                 seed=7)
    train, test = tensor.split(0.1)
    cfg = jft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                               batch_size=BATCH)
    params0 = jft.init_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(11)
    idx_all = np.asarray(train.indices)
    val_all = np.asarray(train.values)
    picks = [rng.integers(0, train.nnz, BATCH) for _ in range(STEPS)]
    batches = [(idx_all[p], val_all[p]) for p in picks]
    return train, test, params0, batches


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("row_mean", [True, False])
def test_autograd_matches_hand_gradients(data, backend, row_mean):
    _, _, params0, batches = data
    idx, val = (torch.tensor(x) for x in batches[0])
    params = ft.params_from_numpy(params0, "cpu")
    leaves = [t.requires_grad_() for t in
              params.factors + params.core_factors]
    ft.sampled_loss(params, idx, val, 0.01, 0.02, row_mean=row_mean,
                    backend=backend).backward()
    with torch.no_grad():
        hand = ft.batch_gradients(params, idx, val, 0.01, 0.02,
                                  row_mean=row_mean, backend=backend)
        dense = ft.scatter_row_grads(params.factors, idx, hand.row_grads,
                                     backend=backend)
    core_scale = 1.0 if row_mean else BATCH  # see sampled_loss docstring
    for n in range(3):
        np.testing.assert_allclose(leaves[n].grad.numpy(), dense[n].numpy(),
                                   rtol=3e-4, atol=1e-5)
        np.testing.assert_allclose(leaves[3 + n].grad.numpy(),
                                   hand.core_grads[n].numpy() * core_scale,
                                   rtol=3e-4, atol=1e-5)


def _reference_trajectory(params0, batches, backend):
    cfg = jft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                               batch_size=BATCH, backend=backend)

    @jax.jit
    def step(params, idx, val, t):
        lr_a = jft.dynamic_lr(cfg.alpha_a, cfg.beta_a, t)
        lr_b = jft.dynamic_lr(cfg.alpha_b, cfg.beta_b, t)
        grads = jft.batch_gradients(params, idx, val, cfg.lambda_a,
                                    cfg.lambda_b, backend=backend)
        return jft._apply_updates(params, idx, grads, lr_a, lr_b,
                                  backend=backend)

    params = params0
    for t, (idx, val) in enumerate(batches):
        params = step(params, jnp.asarray(idx), jnp.asarray(val),
                      jnp.asarray(t, jnp.int32))
    return params


def _port_trajectory(params0, batches, backend):
    cfg = ft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                              batch_size=BATCH, backend=backend)
    state = ft.TrainState(ft.params_from_numpy(params0, "cpu"), 0)
    for idx, val in batches:
        state = ft.sgd_step_batch(state, torch.tensor(idx), torch.tensor(val),
                                  cfg)
    assert state.step == len(batches)
    return state.params


@pytest.mark.parametrize("port,refb", PAIRS)
def test_trajectory_predict_and_rmse_match_reference(data, port, refb):
    train, test, params0, batches = data
    want = _reference_trajectory(params0, batches, refb)
    got = _port_trajectory(params0, batches, port)
    for g, w, p0 in zip(got.factors + got.core_factors,
                        want.factors + want.core_factors,
                        params0.factors + params0.core_factors):
        assert not np.array_equal(np.asarray(w), np.asarray(p0))  # it moved
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)

    idx = np.asarray(test.indices)
    np.testing.assert_allclose(
        ft.predict(got, torch.tensor(idx), backend=port).numpy(),
        np.asarray(jft.predict(want, jnp.asarray(idx), backend=refb)),
        rtol=1e-5, atol=1e-5)
    port_test = SparseTensor.from_numpy(idx, np.asarray(test.values),
                                        test.dims, "cpu")
    r, m = metrics.rmse_mae(got, port_test,
                            lambda p, i: ft.predict(p, i, backend=port),
                            chunk=256)
    jr, jm = jmetrics.rmse_mae(
        want, JSparseTensor(test.indices, test.values, test.dims),
        lambda p, i: jft.predict(p, i, backend=refb), chunk=256)
    np.testing.assert_allclose([r.item(), m.item()], [float(jr), float(jm)],
                               rtol=1e-5)
    assert r.dtype == torch.float32


def test_same_batches_same_step_on_both_port_backends(data):
    """The "cuda" backend's CPU path and the "torch" oracle agree to f32
    rounding over the whole fed-batch trajectory (rtol 1e-5)."""
    _, _, params0, batches = data
    a = _port_trajectory(params0, batches, "cuda")
    b = _port_trajectory(params0, batches, "torch")
    for x, y in zip(a.factors + a.core_factors, b.factors + b.core_factors):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_sgd_step_samples_on_the_generator():
    t = synthetic.planted_tensor(DIMS, 3000, seed=2, device="cpu")
    cfg = ft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                              batch_size=64, backend="torch")
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        st = ft.init_state(gen, cfg, "cpu")
        for _ in range(3):
            st = ft.sgd_step(st, gen, t.indices, t.values, cfg)
        runs.append(st)
    assert runs[0].step == 3
    for x, y in zip(runs[0].params.factors, runs[1].params.factors):
        assert torch.equal(x, y)  # same generator seed, same trajectory
