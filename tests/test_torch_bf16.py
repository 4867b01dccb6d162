"""bf16 parameter storage in the port, against the live JAX reference, CPU.

The reference's rule: parameters are stored in bf16, but every dot, residual
and gradient is f32, and each update is applied in f32 and rounded back
(``repro/core/fasttucker.py:561-568``).

* Storage dtypes: bf16 params (the f32 init rounded), f32 gradients, bf16
  after a step.
* The kernels' plain paths on bf16 inputs against the reference's Pallas
  kernels in interpret mode on the same bf16 values: rtol 1e-5, atol 1e-6,
  the f32 tolerance, since both compute in f32 on the same inputs.
* A 20-step trajectory against the reference at rtol 2⁻⁶ (four bf16 ulps of
  2⁻⁸ relative), atol 1e-6: one f32 rounding difference can move a value
  to the neighbouring bf16 number.
* RMSE after 150 steps within the reference's own band of the f32 run
  (``tests/test_phase_split.py:231``): ≤ 1.6× f32 + 0.02, and ≤ 0.35× the
  initial error.
* ``predict`` accumulates in f32 on both backends and agrees with the
  reference's (rtol 1e-5, atol 1e-5).
* The CLI with ``--sorted-batches --phase-split --dtype bfloat16``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fasttucker as jft
from repro.kernels.kruskal_contract import kruskal_contract as j_contract
from repro.kernels.kruskal_grad import kruskal_grad as j_grad
from repro_torch.core import fasttucker as ft
from repro_torch.core.metrics import rmse_mae
from repro_torch.data import synthetic
from repro_torch.kernels import kruskal_contract, kruskal_grad
from repro_torch.launch import std_train
from test_torch_phase_split import (BATCH, DIMS, RANKS, R, STEPS, leaves,
                                    port_trajectory, reference_trajectory)

BF16_RTOL = 2.0 ** -6


def _cfg(**kw):
    base = dict(dims=DIMS, ranks=RANKS, core_rank=R, batch_size=BATCH,
                backend="torch")
    base.update(kw)
    return ft.FastTuckerConfig(**base)


def test_storage_dtypes_and_f32_grads():
    cfg = _cfg(dtype="bfloat16")
    assert cfg.param_dtype == torch.bfloat16
    p16 = ft.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    p32 = ft.init_params(torch.Generator().manual_seed(0), _cfg(), "cpu")
    for a, b in zip(leaves(p16), leaves(p32)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))  # f32 draw, rounded
    rng = np.random.default_rng(0)
    idx = torch.tensor(np.stack([rng.integers(0, d, BATCH) for d in DIMS],
                                1).astype(np.int32))
    val = torch.tensor(rng.normal(size=BATCH).astype(np.float32))
    for backend in ("torch", "cuda"):
        g = ft.batch_gradients(p16, idx, val, 0.01, 0.02, backend=backend)
        for t in g.row_grads + g.core_grads + (g.err, g.pred):
            assert t.dtype == torch.float32  # every accumulator stays f32
        st = ft.sgd_step_batch(ft.TrainState(p16, 0), idx, val,
                               _cfg(dtype="bfloat16", backend=backend,
                                    sorted_batches=True, phase_split=True))
        assert all(t.dtype == torch.bfloat16 for t in leaves(st.params))
    back = ft.params_to_numpy(p16)
    assert all(x.dtype == np.float32 for x in leaves(back))


def _bf16_inputs(N, B, J, Rk, seed):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.normal(0, 0.5, (N, B, J)), jnp.bfloat16)
    b = jnp.asarray(rng.normal(0, 0.5, (N, J, Rk)), jnp.bfloat16)
    val = rng.normal(size=B).astype(np.float32)
    mask = (rng.random(B) > 0.2).astype(np.float32)
    scal = np.array([1.0, 1.0 / mask.sum(), 0.01, 0.02, 1.0], np.float32)
    return a, b, val, mask, scal


def _t(x):
    """A jnp bf16 array as the same-valued torch bf16 tensor."""
    return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("consume,row_modes,want_core,emit_c", [
    (False, None, True, False), (False, None, False, True),
    (True, (), True, False), (True, (1,), False, False)])
def test_kernels_match_reference_bf16_interpret(consume, row_modes,
                                                want_core, emit_c):
    a, b, val, mask, scal = _bf16_inputs(3, 173, 6, 4, seed=9)
    pred, pexc = kruskal_contract.kruskal_contract(_t(a), _t(b))
    jpred, jpexc = j_contract(a, b, block_b=128, interpret=True)
    for g, w in ((pred, jpred), (pexc, jpexc)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    c = (jnp.einsum("nbj,njr->nbr", a, b, preferred_element_type=jnp.float32)
         if consume else None)
    got = kruskal_grad.kruskal_grad(
        _t(a), _t(b), torch.tensor(val), torch.tensor(mask),
        torch.tensor(scal), None if c is None else torch.tensor(np.asarray(c)),
        row_modes=row_modes, want_core=want_core, emit_c=emit_c)
    want = j_grad(a, b, jnp.asarray(val), jnp.asarray(mask),
                  jnp.asarray(scal), c, row_modes=row_modes,
                  want_core=want_core, emit_c=emit_c, block_b=128,
                  interpret=True)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


@pytest.fixture(scope="module")
def problem():
    tensor = synthetic.planted_tensor(DIMS, 6000, rank=4, core_rank=R,
                                      noise=0.02, seed=7, device="cpu")
    jcfg = jft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                                dtype="bfloat16")
    params0 = jft.init_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(11)
    idx_all, val_all = tensor.indices.numpy(), tensor.values.numpy()
    batches = [(idx_all[p], val_all[p]) for p in
               (rng.integers(0, tensor.nnz, BATCH) for _ in range(STEPS))]
    return tensor, params0, batches


@pytest.mark.parametrize("port,refb", [("torch", "xla"),
                                       ("cuda", "pallas_interpret")])
@pytest.mark.parametrize("kw", [{}, {"sorted_batches": True,
                                     "phase_split": True},
                                {"update_order": "gauss_seidel"}],
                         ids=["joint", "sorted-split", "gauss-seidel"])
def test_trajectory_matches_reference_bf16(problem, port, refb, kw):
    _, params0, batches = problem
    want = reference_trajectory(params0, batches, backend=refb,
                                dtype="bfloat16", **kw)
    got = port_trajectory(params0, batches, port, dtype="bfloat16", **kw)
    moved = 0
    for g, w, p0 in zip(leaves(got), leaves(want), leaves(params0)):
        assert g.dtype == torch.bfloat16
        w32, p32 = np.asarray(w, np.float32), np.asarray(p0, np.float32)
        moved += not np.array_equal(w32, p32)
        np.testing.assert_allclose(g.float().numpy(), w32, rtol=BF16_RTOL,
                                   atol=1e-6)
    assert moved >= 3  # every factor matrix moved


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_rmse_within_band_of_f32(backend):
    # the reference's own setting for this band (tests/test_phase_split.py)
    dims = (40, 32, 24)
    tensor = synthetic.planted_tensor(dims, 4000, rank=4, core_rank=4,
                                      noise=0.05, seed=13, device="cpu")

    def rmse(params):
        return float(rmse_mae(params, tensor,
                              lambda p, i: ft.predict(p, i, backend))[0])

    r_init, r = None, {}
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dims=dims, ranks=(4, 4, 4), core_rank=4, backend=backend,
                   dtype=dtype, sorted_batches=True)
        gen = torch.Generator().manual_seed(0)
        state = ft.init_state(gen, cfg, "cpu")
        r_init = r_init or rmse(state.params)
        for _ in range(150):
            state = ft.sgd_step(state, gen, tensor.indices, tensor.values,
                                cfg)
        r[dtype] = rmse(state.params)
    assert math.isfinite(r["bfloat16"])
    assert r["bfloat16"] <= 1.6 * r["float32"] + 0.02, r
    assert r["bfloat16"] <= 0.35 * r_init, (r, r_init)


def test_predict_accumulates_f32(problem):
    tensor, params0, _ = problem
    params = ft.params_from_numpy(params0, "cpu", "bfloat16")
    idx = tensor.indices[:64]
    want = np.asarray(jft.predict(params0, jnp.asarray(idx.numpy()),
                                  backend="xla"))
    for backend in ("torch", "cuda"):
        pred = ft.predict(params, idx, backend=backend)
        assert pred.dtype == torch.float32
        np.testing.assert_allclose(pred.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)


def test_cli_sorted_phase_split_bf16():
    res = std_train.main([
        "--dims", "60,50,40", "--nnz", "8000", "--rank", "4",
        "--core-rank", "4", "--steps", "60", "--batch", "256",
        "--eval-every", "20", "--seed", "0", "--device", "cpu",
        "--sorted-batches", "--phase-split", "--dtype", "bfloat16"])
    cfg = res["cfg"]
    assert cfg.sorted_batches and cfg.phase_split and cfg.dtype == "bfloat16"
    assert all(t.dtype == torch.bfloat16 for t in leaves(res["state"].params))
    rmse = [h["rmse"] for h in res["history"]]
    assert [h["step"] for h in res["history"]] == [0, 20, 40, 60]
    assert all(math.isfinite(r) for r in rmse)
    assert rmse[-1] < 0.6 * rmse[0], rmse
