"""Port backends against the reference backends through the registry API.

Both port backends (``"torch"``, and ``"cuda"``, whose wrappers take their
plain versions on CPU tensors) against the reference's ``"xla"`` and
``"pallas_interpret"`` backends, through the tuple-of-modes API with
ragged J_n, masks and ``err_override``; ``KruskalPredict``'s gradients
against ``jax.grad`` of the reference's ``sampled_loss``; and the f32
cancellation trap of the autograd backward.

Tolerance: rtol 1e-5, atol 1e-5 per op (the reference's own cross-backend
tolerance, ``tests/test_dispatch.py``): the reductions run in another order
and the backends divide by ρ/δ where the kernels multiply by 1/ρ, 1/δ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fasttucker as jft
from repro.kernels import dispatch as jdispatch
from repro_torch.core import fasttucker as ft
from repro_torch.kernels import dispatch

PAIRS = [("torch", "xla"), ("cuda", "pallas_interpret"), ("cuda", "xla")]


def _problem(N, seed=0, B=173):
    """Ragged J_n = 3, 5, 7, 9; magnitudes O(1) like real factor inits."""
    rng = np.random.default_rng(seed)
    ranks = tuple(3 + 2 * n for n in range(N))
    R = 4
    rows = tuple(rng.normal(0, 0.4, (B, j)).astype(np.float32)
                 for j in ranks)
    cfs = tuple(rng.normal(0, 0.4, (j, R)).astype(np.float32)
                for j in ranks)
    val = rng.normal(size=B).astype(np.float32)
    return rows, cfs, val


def _t(xs):
    return tuple(torch.tensor(x) for x in xs)


def _j(xs):
    return tuple(jnp.asarray(x) for x in xs)


def _assert_close(port, ref, rtol=1e-5, atol=1e-5):
    pl, rl = list(port), list(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        if isinstance(p, tuple):
            _assert_close(p, r, rtol, atol)
        else:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                       rtol=rtol, atol=atol)


@pytest.mark.parametrize("port,refb", PAIRS)
@pytest.mark.parametrize("N", [3, 4])
@pytest.mark.parametrize("row_mean", [False, True])
def test_kruskal_grad_parity(port, refb, N, row_mean):
    rows, cfs, val = _problem(N)
    got = dispatch.get_backend(port).kruskal_grad(
        _t(rows), _t(cfs), torch.tensor(val), lambda_a=0.01, lambda_b=0.02,
        row_mean=row_mean)
    want = jdispatch.get_backend(refb).kruskal_grad(
        _j(rows), _j(cfs), jnp.asarray(val), lambda_a=0.01, lambda_b=0.02,
        row_mean=row_mean)
    _assert_close(got, want)


@pytest.mark.parametrize("port,refb", PAIRS)
def test_kruskal_grad_masked_and_override(port, refb):
    rows, cfs, val = _problem(3, seed=3)
    mask = np.concatenate([np.ones(131, bool), np.zeros(42, bool)])
    g = np.random.default_rng(4).normal(size=val.shape).astype(np.float32)
    for kw_port, kw_ref in [
            ({"mask": torch.tensor(mask)}, {"mask": jnp.asarray(mask)}),
            ({"err_override": torch.tensor(g), "core_mean": False},
             {"err_override": jnp.asarray(g), "core_mean": False})]:
        got = dispatch.get_backend(port).kruskal_grad(
            _t(rows), _t(cfs), torch.tensor(val), lambda_a=0.01,
            lambda_b=0.02, **kw_port)
        want = jdispatch.get_backend(refb).kruskal_grad(
            _j(rows), _j(cfs), jnp.asarray(val), lambda_a=0.01,
            lambda_b=0.02, **kw_ref)
        _assert_close(got, want)


@pytest.mark.parametrize("port,refb", PAIRS)
def test_contract_and_scatter_parity(port, refb):
    rows, cfs, _ = _problem(4, seed=6)
    _assert_close(dispatch.get_backend(port).kruskal_contract(_t(rows),
                                                              _t(cfs)),
                  jdispatch.get_backend(refb).kruskal_contract(_j(rows),
                                                               _j(cfs)))
    rng = np.random.default_rng(7)
    grads = rng.normal(size=(173, 5)).astype(np.float32)
    idx = rng.integers(0, 40, 173).astype(np.int32)
    _assert_close([dispatch.get_backend(port).scatter_accum(
                      torch.tensor(grads), torch.tensor(idx), 40)],
                  [jdispatch.get_backend(refb).scatter_accum(
                      jnp.asarray(grads), jnp.asarray(idx), 40)])


def _params_and_batch(seed=0, dims=(30, 20, 10), ranks=(3, 4, 5), R=4,
                      B=64):
    rng = np.random.default_rng(seed)
    factors = tuple(rng.uniform(0, 0.8, (d, j)).astype(np.float32)
                    for d, j in zip(dims, ranks))
    cores = tuple(rng.uniform(0, 0.8, (j, R)).astype(np.float32)
                  for j in ranks)
    idx = np.stack([rng.integers(0, d, B) for d in dims], 1).astype(np.int32)
    val = rng.normal(size=B).astype(np.float32)
    return jft.FastTuckerParams(factors, cores), idx, val


@pytest.mark.parametrize("port,refb", PAIRS)
def test_kruskal_predict_grads_match_jax_grad(port, refb):
    jparams, idx, val = _params_and_batch()
    params = ft.params_from_numpy(jparams, "cpu")
    params = ft.FastTuckerParams(
        tuple(f.requires_grad_() for f in params.factors),
        tuple(b.requires_grad_() for b in params.core_factors))
    loss = ft.sampled_loss(params, torch.tensor(idx), torch.tensor(val),
                           0.01, 0.02, backend=port)
    loss.backward()
    loss = loss.detach()
    want = jax.grad(lambda p: jft.sampled_loss(
        p, jnp.asarray(idx), jnp.asarray(val), 0.01, 0.02,
        backend=refb))(jft.FastTuckerParams(
            _j(jparams.factors), _j(jparams.core_factors)))
    np.testing.assert_allclose(loss.item(), float(jft.sampled_loss(
        jparams, jnp.asarray(idx), jnp.asarray(val), 0.01, 0.02,
        backend=refb)), rtol=1e-5)
    _assert_close([p.grad for p in params.factors + params.core_factors],
                  list(want.factors) + list(want.core_factors), rtol=1e-4)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_backward_does_not_cancel_small_cotangent(backend):
    """pred ≈ 1.6e4 and ḡ = 1e-6: ḡ is below ulp(pred) (~1e-3), so forming
    the residual as pred − (pred − ḡ) would give exactly 0.  The backward
    passes val = −ḡ with pred_coef = 0 and keeps ḡ exact."""
    rows = tuple(torch.full((1, 2), 10.0, requires_grad=True)
                 for _ in range(3))
    cores = tuple(torch.ones((2, 2)) for _ in range(3))
    pred = dispatch.kruskal_predict(backend, rows, cores)
    assert pred.item() == 16000.0          # 2 · (20·20·20)
    g = torch.tensor([1e-6])
    assert ((pred - (pred - g)) == 0).all()  # the trap this avoids
    pred.backward(g)
    # ∂pred/∂a^(0)_j = Σ_r pexc[0][r]·B[0][j][r] = 2 · 400
    expected = np.float32(1e-6) * np.float32(800.0)
    for r in rows:
        np.testing.assert_allclose(r.grad.numpy(), np.full((1, 2), expected),
                                   rtol=1e-6)
    # the reference's custom VJP gives the same
    jg = jax.grad(lambda rs: jnp.vdot(jdispatch.kruskal_predict(
        "pallas_interpret", rs, tuple(jnp.ones((2, 2)) for _ in range(3))),
        jnp.asarray([1e-6], jnp.float32)))(
        tuple(jnp.full((1, 2), 10.0) for _ in range(3)))
    for r, w in zip(rows, jg):
        np.testing.assert_allclose(r.grad.numpy(), np.asarray(w), rtol=1e-6)


def test_backend_resolution(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert dispatch.resolve_backend_name() == "cuda"
    monkeypatch.setenv(dispatch.ENV_VAR, "torch")
    assert dispatch.resolve_backend_name() == "torch"
    assert dispatch.resolve_backend_name("cuda") == "cuda"
    with pytest.raises(KeyError, match="unknown kernel backend"):
        dispatch.get_backend("pallas")
