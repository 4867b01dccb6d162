"""Widths up to 64 and the ordered unsorted scatter, against the live JAX
reference on the CPU.

* ``ref.scatter_accum_ref`` (the plain version of the unsorted scatter, and
  the wrapper's CPU path) folds each row's hits from 0 in ascending batch
  position: bitwise equal to the reference's ``"xla"`` scatter
  (``jax.ops.segment_sum``) and to its ``scatter_accum_ref``, ids out of
  range, one row hit by every id, and the Netflix mode-2 shape included;
  within 2e-5 of the reference's Pallas kernel in interpret mode (a one-hot
  product that sums duplicates in its own order, 1–2 ulps off on the
  installed JAX).
* ``kruskal_contract`` and ``kruskal_grad`` (their plain paths) at
  J = R ∈ {48, 64} against the reference's oracles and Pallas kernels in
  interpret mode: rtol 1e-5, atol 1e-6 (f32 dots over up to 64 terms in
  another order; pred summed along another chain by the Pallas kernels).
* One fed-batch ``sgd_step_batch`` at rank 48 on both port backends
  against the reference's jitted step: rtol 1e-5, atol 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fasttucker as jft
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.kernels.kruskal_contract import kruskal_contract as j_contract
from repro.kernels.kruskal_grad import kruskal_grad as j_grad
from repro.kernels.scatter_accum import scatter_accum as j_scatter
from repro_torch.core import fasttucker as ft
from repro_torch.kernels import (dispatch, kruskal_contract, kruskal_grad,
                                 launch_counts, ref, reset_launch_counts,
                                 scatter_accum)

RTOL, ATOL = 1e-5, 1e-6

# (B, J, rows, draw of the ids)
SCATTER_CASES = {
    "outside": (300, 4, 50, lambda rng, B, rows: rng.integers(-4, rows + 4,
                                                              B)),
    "all_equal": (512, 3, 40, lambda rng, B, rows: np.full(B, 17)),
    "one_row": (64, 7, 1, lambda rng, B, rows: rng.integers(-1, 2, B)),
    "netflix_mode2": (4096, 4, 2182,
                      lambda rng, B, rows: rng.integers(0, rows, B)),
    "wide": (257, 64, 30, lambda rng, B, rows: rng.integers(0, rows, B)),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_ref_is_the_reference_segment_sum_bitwise(case):
    B, J, rows, draw = SCATTER_CASES[case]
    rng = np.random.default_rng(B + J)
    g = rng.normal(size=(B, J)).astype(np.float32)
    idx = draw(rng, B, rows).astype(np.int32)
    want = np.asarray(jdispatch.get_backend("xla").scatter_accum(
        jnp.asarray(g), jnp.asarray(idx), rows))
    np.testing.assert_array_equal(
        np.asarray(jref.scatter_accum_ref(jnp.asarray(g), jnp.asarray(idx),
                                          rows)), want)
    reset_launch_counts()
    tg, ti = torch.tensor(g), torch.tensor(idx)
    for got in (ref.scatter_accum_ref(tg, ti, rows),
                scatter_accum.scatter_accum(tg, ti, rows),
                dispatch.get_backend("torch").scatter_accum(tg, ti, rows),
                dispatch.get_backend("cuda").scatter_accum(tg, ti, rows)):
        assert got.dtype == torch.float32 and got.shape == (rows, J)
        np.testing.assert_array_equal(got.numpy(), want)
    assert launch_counts()["scatter_accum"] == 0   # CPU: the plain path


@pytest.mark.parametrize("case", ["outside", "all_equal", "netflix_mode2"])
def test_scatter_ref_near_the_pallas_kernel(case):
    B, J, rows, draw = SCATTER_CASES[case]
    rng = np.random.default_rng(B + J)
    g = rng.normal(size=(B, J)).astype(np.float32)
    idx = draw(rng, B, rows).astype(np.int32)
    want = np.asarray(j_scatter(jnp.asarray(g), jnp.asarray(idx), rows,
                                block_i=256, block_b=512, interpret=True))
    got = ref.scatter_accum_ref(torch.tensor(g), torch.tensor(idx), rows)
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-5 * np.abs(want).max(), err


def _inputs(N, B, J, R, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.5, (N, B, J)).astype(np.float32)
    # scaled so that each of the N mode products stays near unit size
    b = (rng.normal(0, 0.5, (N, J, R)) / np.sqrt(J)).astype(np.float32)
    val = rng.normal(size=B).astype(np.float32)
    mask = (rng.random(B) > 0.2).astype(np.float32)
    scal = np.array([1.0, 1.0 / mask.sum(), 0.01, 0.02, 1.0], np.float32)
    return a, b, val, mask, scal


def _close(port, want):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("N", [3, 4])
@pytest.mark.parametrize("JR", [48, 64])
def test_contract_matches_reference_at_width(N, JR):
    a, b, *_ = _inputs(N, 96, JR, JR, seed=N + JR)
    pred, pexc = kruskal_contract.kruskal_contract(torch.tensor(a),
                                                   torch.tensor(b))
    for want in (j_contract(jnp.asarray(a), jnp.asarray(b), block_b=64,
                            interpret=True),
                 jref.kruskal_contract_ref(jnp.asarray(a), jnp.asarray(b))):
        _close(pred, want[0])
        _close(pexc, want[1])
    only, none = kruskal_contract.kruskal_contract(
        torch.tensor(a), torch.tensor(b), want_pexc=False)
    assert none is None and torch.equal(only, pred)


FLAGS = [
    # (consume c, row_modes, want_core, emit_c)
    (False, None, True, False),     # the joint pass
    (False, None, False, True),     # factor phase
    (True, (), True, False),        # core phase
    (True, (1,), False, False),     # Gauss-Seidel: one mode's rows
]


@pytest.mark.parametrize("consume,row_modes,want_core,emit_c", FLAGS)
@pytest.mark.parametrize("JR", [48, 64])
def test_grad_matches_reference_at_width(consume, row_modes, want_core,
                                         emit_c, JR):
    a, b, val, mask, scal = _inputs(3, 80, JR, JR, seed=JR)
    c = np.einsum("nbj,njr->nbr", a, b) if consume else None
    got = kruskal_grad.kruskal_grad(
        torch.tensor(a), torch.tensor(b), torch.tensor(val),
        torch.tensor(mask), torch.tensor(scal),
        None if c is None else torch.tensor(c),
        row_modes=row_modes, want_core=want_core, emit_c=emit_c)
    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(val),
            jnp.asarray(mask), jnp.asarray(scal),
            None if c is None else jnp.asarray(c))
    flags = dict(row_modes=row_modes, want_core=want_core, emit_c=emit_c)
    for want in (jref.kruskal_grad_ref(*args, **flags),
                 j_grad(*args, **flags, block_b=64, interpret=True)):
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                _close(g, w)


def test_sgd_step_matches_reference_at_rank_48():
    dims, ranks, core, batch = (40, 30, 20), (48, 48, 48), 48, 128
    jcfg = jft.FastTuckerConfig(dims=dims, ranks=ranks, core_rank=core,
                                batch_size=batch)
    params0 = jft.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(48)
    idx = np.stack([rng.integers(0, d, batch) for d in dims],
                   1).astype(np.int32)
    val = rng.normal(size=batch).astype(np.float32)

    @jax.jit
    def step(params, idx, val):
        t = jnp.asarray(0, jnp.int32)
        lr_a = jft.dynamic_lr(jcfg.alpha_a, jcfg.beta_a, t)
        lr_b = jft.dynamic_lr(jcfg.alpha_b, jcfg.beta_b, t)
        grads = jft.batch_gradients(params, idx, val, jcfg.lambda_a,
                                    jcfg.lambda_b, backend="xla")
        return jft._apply_updates(params, idx, grads, lr_a, lr_b,
                                  backend="xla")

    want = step(params0, jnp.asarray(idx), jnp.asarray(val))
    for backend in ("torch", "cuda"):
        cfg = ft.FastTuckerConfig(dims=dims, ranks=ranks, core_rank=core,
                                  batch_size=batch, backend=backend)
        st = ft.sgd_step_batch(
            ft.TrainState(ft.params_from_numpy(params0, "cpu"), 0),
            torch.tensor(idx), torch.tensor(val), cfg)
        for g, w, p0 in zip(st.params.factors + st.params.core_factors,
                            want.factors + want.core_factors,
                            params0.factors + params0.core_factors):
            assert not np.array_equal(np.asarray(w), np.asarray(p0))
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-7)
