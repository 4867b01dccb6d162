"""The port's whole single-device step against the live JAX reference, CPU.

* ``factor_phase_gradients`` / ``core_phase_gradients`` against the
  reference's (rtol 1e-5, atol 1e-5, its own cross-backend tolerance), and
  the pair equal to the port's joint pass bitwise.
* 20-step fed-batch trajectories for {jacobi, gauss_seidel} × {joint,
  phase-split} × {unsorted, sorted}: the port's ``sgd_step_batch``
  against ``reference_trajectory``, which runs the body of the
  reference's ``sgd_step`` (``repro/core/fasttucker.py:693-737``) on the
  same fed batches.  Tolerance rtol 1e-4, atol 1e-6: each op agrees to
  ~1e-6 relative (f32 sums in another order) and 20 dependent steps
  compound that.
* The port's own bitwise pairs, on ``"torch"`` and on ``"cuda"``'s CPU
  path: jacobi phase-split equals joint; Gauss–Seidel phase-split equals
  joint (the mode products refreshed by ``mode_dot`` are the bits the
  joint pass forms itself, since both are one f32 matmul on the CPU);
  ``factor_phase_step`` then ``core_phase_step`` equals one joint
  ``sgd_step``.
* ``update_core=False`` against the reference, with the core untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fasttucker as jft
from repro_torch.core import fasttucker as ft
from repro_torch.data import synthetic

DIMS = (60, 50, 40)
RANKS = (4, 5, 6)   # ragged J_n
R = 4
BATCH = 256
STEPS = 20
PAIRS = [("torch", "xla"), ("cuda", "pallas_interpret")]
GRID = [(order, split, srt) for order in ("jacobi", "gauss_seidel")
        for split in (False, True) for srt in (False, True)]


def reference_trajectory(params0, batches, update_core=True, **cfg_kw):
    """The reference's ``sgd_step`` body on fed ``(idx, val)`` batches."""
    cfg = jft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                               batch_size=BATCH, **cfg_kw)
    common = dict(backend=cfg.backend, accum_dtype=cfg.accum_dtype)

    @jax.jit
    def step(params, idx, val, t):
        layout = jft.batch_layout(idx, cfg)
        lr_a = jft.dynamic_lr(cfg.alpha_a, cfg.beta_a, t)
        lr_b = jft.dynamic_lr(cfg.alpha_b, cfg.beta_b, t)
        if cfg.update_order == "gauss_seidel":
            gs = (jft._gauss_seidel_phase_split if cfg.phase_split
                  else jft._gauss_seidel_joint)
            return gs(params, idx, val, lr_a, lr_b, cfg, True, update_core,
                      layout=layout)
        if cfg.phase_split:
            fg, inter = jft.factor_phase_gradients(
                params, idx, val, cfg.lambda_a, cfg.lambda_b, layout=layout,
                **common)
            new = jft._apply_updates(
                params, idx, fg, lr_a, lr_b, update_factors=True,
                update_core=False, backend=cfg.backend, layout=layout)
            if update_core:
                cg = jft.core_phase_gradients(
                    params, idx, val, cfg.lambda_a, cfg.lambda_b,
                    intermediates=inter, **common)
                new = jft._apply_updates(
                    new, idx, cg, lr_a, lr_b, update_factors=False,
                    update_core=True, backend=cfg.backend, layout=layout)
            return new
        grads = jft.batch_gradients(params, idx, val, cfg.lambda_a,
                                    cfg.lambda_b, layout=layout, **common)
        return jft._apply_updates(
            params, idx, grads, lr_a, lr_b, update_factors=True,
            update_core=update_core, backend=cfg.backend, layout=layout)

    params = params0
    for t, (idx, val) in enumerate(batches):
        params = step(params, jnp.asarray(idx), jnp.asarray(val),
                      jnp.asarray(t, jnp.int32))
    return params


def port_trajectory(params0, batches, backend, update_core=True,
                    dtype="float32", **cfg_kw):
    cfg = ft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                              batch_size=BATCH, backend=backend, dtype=dtype,
                              **cfg_kw)
    state = ft.TrainState(ft.params_from_numpy(params0, "cpu", dtype), 0)
    for idx, val in batches:
        state = ft.sgd_step_batch(state, torch.tensor(idx), torch.tensor(val),
                                  cfg, update_core=update_core)
    assert state.step == len(batches)
    return state.params


def leaves(params):
    return list(params.factors) + list(params.core_factors)


@pytest.fixture(scope="module")
def data():
    # the port's generator: the reference's tensor bit for bit
    # (test_torch_fasttucker), without its compile time
    tensor = synthetic.planted_tensor(DIMS, 6000, rank=4, core_rank=R,
                                      noise=0.02, seed=7, device="cpu")
    train, _ = tensor.split(0.1)
    cfg = jft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                               batch_size=BATCH)
    params0 = jft.init_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(11)
    idx_all = train.indices.numpy()
    val_all = train.values.numpy()
    picks = [rng.integers(0, train.nnz, BATCH) for _ in range(STEPS)]
    batches = [(idx_all[p], val_all[p]) for p in picks]
    return train, params0, batches


@pytest.mark.parametrize("port,refb", PAIRS)
def test_phase_gradients_match_reference_and_joint(data, port, refb):
    _, params0, batches = data
    idx, val = batches[0]
    params = ft.params_from_numpy(params0, "cpu")
    t_idx, t_val = torch.tensor(idx), torch.tensor(val)
    fg, inter = ft.factor_phase_gradients(params, t_idx, t_val, 0.01, 0.02,
                                          backend=port)
    cg = ft.core_phase_gradients(params, t_idx, t_val, 0.01, 0.02,
                                 backend=port, intermediates=inter)
    assert fg.core_grads == () and cg.row_grads == ()
    jfg, jinter = jft.factor_phase_gradients(
        params0, jnp.asarray(idx), jnp.asarray(val), 0.01, 0.02,
        backend=refb)
    jcg = jft.core_phase_gradients(
        params0, jnp.asarray(idx), jnp.asarray(val), 0.01, 0.02,
        backend=refb, intermediates=jinter)
    for g, w in zip(fg.row_grads + cg.core_grads + inter.c
                    + (inter.pred, inter.err),
                    jfg.row_grads + jcg.core_grads + jinter.c
                    + (jinter.pred, jinter.err)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    joint = ft.batch_gradients(params, t_idx, t_val, 0.01, 0.02,
                               backend=port)
    for x, y in zip(joint.row_grads + joint.core_grads,
                    fg.row_grads + cg.core_grads):
        assert torch.equal(x, y)
    assert torch.equal(joint.err, inter.err)
    routed = ft.step_gradients(params, t_idx, t_val, ft.FastTuckerConfig(
        dims=DIMS, ranks=RANKS, core_rank=R, backend=port, lambda_a=0.01,
        lambda_b=0.02, phase_split=True))
    for x, y in zip(routed.row_grads + routed.core_grads
                    + (routed.err, routed.pred),
                    joint.row_grads + joint.core_grads
                    + (joint.err, joint.pred)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("order,phase_split,sorted_batches", GRID)
@pytest.mark.parametrize("port,refb", PAIRS)
def test_trajectory_matches_reference(data, port, refb, order, phase_split,
                                      sorted_batches):
    _, params0, batches = data
    kw = dict(update_order=order, phase_split=phase_split,
              sorted_batches=sorted_batches)
    want = reference_trajectory(params0, batches, backend=refb, **kw)
    got = port_trajectory(params0, batches, port, **kw)
    for g, w, p0 in zip(leaves(got), leaves(want), leaves(params0)):
        assert not np.array_equal(np.asarray(w), np.asarray(p0))  # it moved
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("order", ["jacobi", "gauss_seidel"])
def test_phase_split_bitwise_equals_joint(data, backend, order):
    _, params0, batches = data
    for srt in (False, True):
        joint = port_trajectory(params0, batches[:8], backend,
                                update_order=order, sorted_batches=srt)
        split = port_trajectory(params0, batches[:8], backend,
                                update_order=order, sorted_batches=srt,
                                phase_split=True)
        for x, y in zip(leaves(joint), leaves(split)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("sorted_batches", [False, True])
def test_phase_steps_bitwise_equal_joint_step(data, backend, sorted_batches):
    train, params0, _ = data
    indices, values = train.indices, train.values
    cfg = ft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                              batch_size=BATCH, backend=backend,
                              sorted_batches=sorted_batches)
    state = ft.TrainState(ft.params_from_numpy(params0, "cpu"), 3)
    joint = ft.sgd_step(state, torch.Generator().manual_seed(5), indices,
                        values, cfg)
    st1, idx, val, inter = ft.factor_phase_step(
        state, torch.Generator().manual_seed(5), indices, values, cfg)
    assert st1.step == 3  # the counter advances in the core phase
    split = ft.core_phase_step(st1, idx, val, cfg, inter)
    assert split.step == joint.step == 4
    for x, y in zip(leaves(joint.params), leaves(split.params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("port,refb", PAIRS)
@pytest.mark.parametrize("phase_split", [False, True])
def test_update_core_false_matches_reference(data, port, refb, phase_split):
    _, params0, batches = data
    want = reference_trajectory(params0, batches[:8], update_core=False,
                                backend=refb, phase_split=phase_split)
    got = port_trajectory(params0, batches[:8], port, update_core=False,
                          phase_split=phase_split)
    for g, p0 in zip(got.core_factors, params0.core_factors):
        np.testing.assert_array_equal(g.numpy(), np.asarray(p0))
    for g, w in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
