"""Port kernels (plain path on CPU tensors) against the JAX reference kernels.

The same numpy inputs go to the port's ``kruskal_contract`` /
``kruskal_grad`` / ``scatter_accum`` wrappers on CPU tensors (which take
the plain PyTorch version) and to the reference's Pallas kernels in
interpret mode and its jnp oracles (``repro.kernels.ref``).

Tolerance: rtol 1e-5, atol 1e-6 (f32).  The dots run in another order
(torch.bmm against XLA's einsum and the Pallas dot), and the Pallas kernels
sum ``pred`` along the prefix chain ((c0·c1)·c2)… where the port and
``repro.kernels.ref`` take pexc[0]·c[0] — a few ulps apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.kruskal_contract import kruskal_contract as j_contract
from repro.kernels.kruskal_grad import kruskal_grad as j_grad
from repro.kernels.scatter_accum import scatter_accum as j_scatter
from repro_torch.kernels import (kruskal_contract, kruskal_grad,
                                 launch_counts, ref, reset_launch_counts,
                                 scatter_accum)

RTOL, ATOL = 1e-5, 1e-6


def _inputs(N, B, J, R, seed, pred_coef=1.0):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.5, (N, B, J)).astype(np.float32)
    b = rng.normal(0, 0.5, (N, J, R)).astype(np.float32)
    val = rng.normal(size=B).astype(np.float32)
    mask = (rng.random(B) > 0.2).astype(np.float32)
    scal = np.array([1.0, 1.0 / mask.sum(), 0.01, 0.02, pred_coef],
                    np.float32)
    return a, b, val, mask, scal


def _close(port, want):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    # CPU tensors take the plain path: no kernel was launched
    assert launch_counts() == {"kruskal_contract": 0, "kruskal_grad": 0,
                               "scatter_accum": 0}


@pytest.mark.parametrize("N,B,J,R", [(3, 173, 4, 4), (4, 300, 8, 5),
                                     (3, 64, 5, 8)])
def test_contract_matches_reference(N, B, J, R):
    a, b, *_ = _inputs(N, B, J, R, seed=N + B)
    pred, pexc = kruskal_contract.kruskal_contract(torch.tensor(a),
                                                   torch.tensor(b))
    for want in (j_contract(jnp.asarray(a), jnp.asarray(b), block_b=128,
                            interpret=True),
                 jref.kruskal_contract_ref(jnp.asarray(a), jnp.asarray(b))):
        _close(pred, want[0])
        _close(pexc, want[1])


FLAGS = [
    # (consume c, row_modes, want_core, emit_c)
    (False, None, True, False),     # the joint pass of the training step
    (False, None, False, True),     # factor phase: emit the mode products
    (True, (), True, False),        # core phase: consume them
    (True, (1,), False, False),     # Gauss-Seidel: one mode's rows
    (False, (2, 0), True, True),
    (True, (0, 1, 2), False, True),
]


@pytest.mark.parametrize("consume,row_modes,want_core,emit_c", FLAGS)
@pytest.mark.parametrize("pred_coef", [1.0, 0.0])
def test_grad_matches_oracle_every_flag(consume, row_modes, want_core,
                                        emit_c, pred_coef):
    a, b, val, mask, scal = _inputs(3, 173, 6, 4, seed=11,
                                    pred_coef=pred_coef)
    c = np.einsum("nbj,njr->nbr", a, b) if consume else None
    got = kruskal_grad.kruskal_grad(
        torch.tensor(a), torch.tensor(b), torch.tensor(val),
        torch.tensor(mask), torch.tensor(scal),
        None if c is None else torch.tensor(c),
        row_modes=row_modes, want_core=want_core, emit_c=emit_c)
    want = jref.kruskal_grad_ref(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(val), jnp.asarray(mask),
        jnp.asarray(scal), None if c is None else jnp.asarray(c),
        row_modes=row_modes, want_core=want_core, emit_c=emit_c)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w)


@pytest.mark.parametrize("consume,row_modes,want_core,emit_c",
                         [FLAGS[0], FLAGS[2], FLAGS[3], FLAGS[4]])
def test_grad_matches_pallas_interpret(consume, row_modes, want_core,
                                       emit_c):
    # B = 173 is not a multiple of the 128-sample tile: padded rows too
    a, b, val, mask, scal = _inputs(3, 173, 6, 4, seed=5)
    c = np.einsum("nbj,njr->nbr", a, b) if consume else None
    got = kruskal_grad.kruskal_grad(
        torch.tensor(a), torch.tensor(b), torch.tensor(val),
        torch.tensor(mask), torch.tensor(scal),
        None if c is None else torch.tensor(c),
        row_modes=row_modes, want_core=want_core, emit_c=emit_c)
    want = j_grad(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(val), jnp.asarray(mask),
        jnp.asarray(scal), None if c is None else jnp.asarray(c),
        row_modes=row_modes, want_core=want_core, emit_c=emit_c,
        block_b=128, interpret=True)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w)


@pytest.mark.parametrize("B,J,rows", [(300, 4, 50), (129, 7, 200),
                                      (64, 3, 1)])
def test_scatter_matches_reference_dropping_out_of_range(B, J, rows):
    rng = np.random.default_rng(B)
    g = rng.normal(size=(B, J)).astype(np.float32)
    idx = rng.integers(-4, rows + 4, B).astype(np.int32)  # some outside
    got = scatter_accum.scatter_accum(torch.tensor(g), torch.tensor(idx),
                                      rows)
    for want in (j_scatter(jnp.asarray(g), jnp.asarray(idx), rows,
                           block_i=64, block_b=128, interpret=True),
                 jref.scatter_accum_ref(jnp.asarray(g), jnp.asarray(idx),
                                        rows)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-5)
    assert got.shape == (rows, J)


def test_plain_versions_are_the_wrappers_cpu_path():
    a, b, val, mask, scal = _inputs(4, 97, 5, 3, seed=2)
    t = [torch.tensor(x) for x in (a, b, val, mask, scal)]
    assert all(torch.equal(x, y) for x, y in zip(
        kruskal_contract.kruskal_contract(t[0], t[1]),
        ref.kruskal_contract_ref(t[0], t[1])))
    got = kruskal_grad.kruskal_grad(*t)
    want = ref.kruskal_grad_ref(*t)
    assert all(torch.equal(x, y) for x, y in zip(got[:4], want[:4]))
