"""The paper's baselines in the port — cuTucker (the full core), P-Tucker
ALS and Vest CCD — and the Fig. 3–4 accuracy benchmark, against the live
JAX reference on the CPU.

Tolerances (relative to the largest magnitude of the compared output):

* cuTucker ``batch_gradients`` (``einsum`` and ``kron``), ``predict`` and
  ``sampled_loss``: 1e-5 (one f32 contraction in another order; ~3e-7
  measured).
* A 20-step fed-batch cuTucker trajectory: rtol 1e-4, atol 1e-6, as the
  port's FastTucker trajectory tests.
* CCD: 1e-5 for one mode, 1e-4 for an epoch (three sweeps in sequence).
* ALS: 2e-3.  Each row is a J×J solve whose Gram matrix has a condition
  number up to ~5e3 at these shapes, so f32 accumulation in another order
  moves the solution by ~1e-4–6e-4 of the largest entry; the reference
  and the port are each ~1e-4–3.5e-4 from a float64 solve of the same
  system.
* The ports of ``tests/test_fasttucker.py:124-190`` and
  ``tests/test_system.py:29`` keep the reference's own bounds.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import als as jals
from repro.core import ccd as jccd
from repro.core import cutucker as jcu
from repro.core import fasttucker as jft
from repro.core.kruskal import kruskal_to_core
from repro.core.sptensor import SparseTensor as JSparseTensor
from repro.data import synthetic as jsyn
from repro_torch.benchmarks import bench_accuracy
from repro_torch.benchmarks.common import validate_bench_accuracy
from repro_torch.core import als, ccd
from repro_torch.core import cutucker as cu
from repro_torch.core import fasttucker as ft
from repro_torch.core.metrics import rmse_mae
from repro_torch.core.sptensor import SparseTensor
from repro_torch.data.synthetic import planted_tensor

ROOT = Path(__file__).resolve().parents[1]
DIMS = (60, 50, 40)
RANK_SETS = [(4, 4, 4), (3, 4, 5)]


@pytest.fixture(scope="module")
def jtensor():
    return jsyn.planted_tensor(DIMS, 8000, rank=4, core_rank=4, noise=0.02,
                               seed=7)


@pytest.fixture(scope="module")
def tensor(jtensor):
    return SparseTensor.from_numpy(np.asarray(jtensor.indices),
                                   np.asarray(jtensor.values), DIMS, "cpu")


def _jparams(ranks, seed=0):
    return jcu.init_params(jax.random.PRNGKey(seed),
                           jcu.CuTuckerConfig(dims=DIMS, ranks=ranks))


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# cuTucker against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", RANK_SETS)
@pytest.mark.parametrize("contraction", ["einsum", "kron"])
@pytest.mark.parametrize("row_mean", [False, True])
def test_cutucker_gradients_match_reference(jtensor, ranks, contraction,
                                            row_mean):
    jp = _jparams(ranks)
    p = cu.params_from_numpy(jp, "cpu")
    idx, val = np.asarray(jtensor.indices[:256]), np.asarray(
        jtensor.values[:256])
    jg = jcu.batch_gradients(jp, jnp.asarray(idx), jnp.asarray(val), 0.01,
                             0.02, contraction, row_mean=row_mean)
    g = cu.batch_gradients(p, torch.tensor(idx), torch.tensor(val), 0.01,
                           0.02, contraction, row_mean=row_mean)
    for a, b in zip(g.row_grads, jg.row_grads):
        _close(a, b, 1e-5)
    _close(g.core_grad, jg.core_grad, 1e-5)
    _close(g.err, jg.err, 1e-5)


@pytest.mark.parametrize("ranks", RANK_SETS)
@pytest.mark.parametrize("row_mean", [False, True])
def test_cutucker_predict_and_loss_match_reference(jtensor, ranks, row_mean):
    jp = _jparams(ranks, seed=3)
    p = cu.params_from_numpy(jp, "cpu")
    idx, val = np.asarray(jtensor.indices[:300]), np.asarray(
        jtensor.values[:300])
    _close(cu.predict(p, torch.tensor(idx)),
           jcu.predict(jp, jnp.asarray(idx)), 1e-5)
    got = cu.sampled_loss(p, torch.tensor(idx), torch.tensor(val), 0.01,
                          0.02, row_mean=row_mean)
    want = jcu.sampled_loss(jp, jnp.asarray(idx), jnp.asarray(val), 0.01,
                            0.02, row_mean=row_mean)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_cutucker_params_round_trip_and_init_range():
    jp = _jparams((3, 4, 5))
    back = cu.params_to_numpy(cu.params_from_numpy(jp, "cpu"))
    for a, b in zip(back.factors + (back.core,), jp.factors + (jp.core,)):
        assert np.array_equal(a, np.asarray(b))
    cfg = cu.CuTuckerConfig(dims=DIMS, ranks=(3, 4, 5), backend="torch")
    p = cu.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    s = cu.init_scale(cfg)
    assert [tuple(f.shape) for f in p.factors] == [(60, 3), (50, 4), (40, 5)]
    assert tuple(p.core.shape) == (3, 4, 5)
    # the reference's draw has the same range: U(0, 2s)
    hi = max(float(jnp.max(x)) for x in jp.factors + (jp.core,))
    for t in p.factors + (p.core,):
        assert 0 <= t.min() and t.max() < 2 * s
    assert hi < 2 * s and hi > 1.5 * s


def _reference_cu_trajectory(jp, batches, ccfg, update_core):
    @jax.jit
    def step(params, idx, val, t):
        grads = jcu.batch_gradients(params, idx, val, ccfg.lambda_a,
                                    ccfg.lambda_g, ccfg.contraction)
        lr_a = jft.dynamic_lr(ccfg.alpha_a, ccfg.beta_a, t)
        lr_g = jft.dynamic_lr(ccfg.alpha_g, ccfg.beta_g, t)
        dense = jft.scatter_row_grads(params.factors, idx, grads.row_grads)
        factors = tuple(f - lr_a * g for f, g in zip(params.factors, dense))
        core = params.core - lr_g * grads.core_grad if update_core \
            else params.core
        return jcu.CuTuckerParams(factors, core)

    params = jp
    for t, (idx, val) in enumerate(batches):
        params = step(params, jnp.asarray(idx), jnp.asarray(val),
                      jnp.asarray(t, jnp.int32))
    return params


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("contraction,update_core", [
    ("einsum", True), ("kron", True), ("einsum", False)])
def test_cutucker_trajectory_matches_reference(jtensor, backend, contraction,
                                               update_core):
    ranks = (3, 4, 5)
    jp = _jparams(ranks, seed=4)
    rng = np.random.default_rng(11)
    idx_all, val_all = np.asarray(jtensor.indices), np.asarray(
        jtensor.values)
    batches = []
    for _ in range(20):
        pick = rng.integers(0, len(val_all), 256)
        batches.append((idx_all[pick], val_all[pick]))
    jcfg = jcu.CuTuckerConfig(dims=DIMS, ranks=ranks, batch_size=256,
                              contraction=contraction)
    want = _reference_cu_trajectory(jp, batches, jcfg, update_core)
    cfg = cu.CuTuckerConfig(dims=DIMS, ranks=ranks, batch_size=256,
                            contraction=contraction, backend=backend)
    st = cu.CuState(cu.params_from_numpy(jp, "cpu"), 0)
    for idx, val in batches:
        st = cu.sgd_step_batch(st, torch.tensor(idx), torch.tensor(val), cfg,
                               update_core=update_core)
    assert st.step == 20
    for g, w, p0 in zip(st.params.factors + (st.params.core,),
                        want.factors + (want.core,), jp.factors + (jp.core,)):
        if update_core or w.ndim == 2:
            assert not np.array_equal(np.asarray(w), np.asarray(p0))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    if not update_core:
        assert np.array_equal(st.params.core.numpy(), np.asarray(jp.core))


def test_cutucker_sgd_step_draws_from_generator(tensor):
    cfg = cu.CuTuckerConfig(dims=DIMS, ranks=(4, 4, 4), batch_size=128,
                            backend="torch")
    a = cu.init_state(torch.Generator().manual_seed(0), cfg, "cpu")
    b = a
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for _ in range(3):
        a = cu.sgd_step(a, ga, tensor.indices, tensor.values, cfg)
        b = cu.sgd_step(b, gb, tensor.indices, tensor.values, cfg)
    assert a.step == 3
    for x, y in zip(a.params.factors + (a.params.core,),
                    b.params.factors + (b.params.core,)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="contraction"):
        cu.CuTuckerConfig(dims=DIMS, ranks=(4, 4, 4), contraction="dense")


# ---------------------------------------------------------------------------
# ALS and CCD against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", RANK_SETS)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_als_and_ccd_update_mode_match_reference(jtensor, tensor, ranks,
                                                 mode):
    jp = _jparams(ranks)
    p = cu.params_from_numpy(jp, "cpu")
    want = jals.als_update_mode(jp, jtensor.indices, jtensor.values, mode,
                                DIMS[mode], 0.01)
    # a chunk that splits the nonzeros unevenly exercises the chunking
    got = als.als_update_mode(p, tensor.indices, tensor.values, mode,
                              DIMS[mode], 0.01, chunk=3000)
    _close(got, want, 2e-3)
    want = jccd.ccd_update_mode(jp, jtensor.indices, jtensor.values, mode,
                                DIMS[mode], 0.01)
    got = ccd.ccd_update_mode(p, tensor.indices, tensor.values, mode,
                              DIMS[mode], 0.01, chunk=3000)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("ranks", RANK_SETS)
def test_als_and_ccd_epochs_match_reference(jtensor, tensor, ranks):
    jp = _jparams(ranks, seed=2)
    p = cu.params_from_numpy(jp, "cpu")
    jt = JSparseTensor(jtensor.indices, jtensor.values, DIMS)
    want = jals.als_epoch(jp, jt, jals.ALSConfig(dims=DIMS, ranks=ranks))
    got = als.als_epoch(p, tensor, als.ALSConfig(dims=DIMS, ranks=ranks))
    for g, w in zip(got.factors, want.factors):
        _close(g, w, 2e-3)
    assert got.core is p.core
    want = jccd.ccd_epoch(jp, jt, jccd.CCDConfig(dims=DIMS, ranks=ranks))
    got = ccd.ccd_epoch(p, tensor, ccd.CCDConfig(dims=DIMS, ranks=ranks))
    for g, w in zip(got.factors, want.factors):
        _close(g, w, 1e-4)


def test_unobserved_rows_keep_their_values(tensor):
    """Rows with no nonzero keep their previous value (both solvers)."""
    ranks = (4, 4, 4)
    p = cu.params_from_numpy(_jparams(ranks), "cpu")
    keep = tensor.indices[:, 0] >= 5      # rows 0-4 of mode 0 unobserved
    sub = SparseTensor(tensor.indices[keep], tensor.values[keep], DIMS)
    for fn in (als.als_update_mode, ccd.ccd_update_mode):
        a = fn(p, sub.indices, sub.values, 0, DIMS[0], 0.01)
        assert torch.equal(a[:5], p.factors[0][:5])
        assert not torch.equal(a[5:], p.factors[0][5:])


# ---------------------------------------------------------------------------
# the reference's own baseline checks (tests/test_fasttucker.py:124-190)
# ---------------------------------------------------------------------------

def test_cutucker_grads_match_autograd(tensor):
    ccfg = cu.CuTuckerConfig(dims=DIMS, ranks=(4, 4, 4), batch_size=128,
                             backend="torch")
    params = cu.init_params(torch.Generator().manual_seed(0), ccfg, "cpu")
    idx, val = tensor.indices[:128], tensor.values[:128]
    leaves = [t.clone().requires_grad_() for t in
              params.factors + (params.core,)]
    p = cu.CuTuckerParams(tuple(leaves[:3]), leaves[3])
    cu.sampled_loss(p, idx, val, 0.01, 0.02, row_mean=True).backward()
    hand = cu.batch_gradients(params, idx, val, 0.01, 0.02, row_mean=True)
    dense = ft.scatter_row_grads(params.factors, idx, hand.row_grads,
                                 backend="torch")
    for n in range(3):
        np.testing.assert_allclose(leaves[n].grad.numpy(), dense[n].numpy(),
                                   rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(leaves[3].grad.numpy(),
                               hand.core_grad.numpy(), rtol=3e-4, atol=1e-5)


def test_cutucker_kron_equals_einsum(tensor):
    """The literal Kronecker coefficient path == the efficient contraction."""
    ccfg = cu.CuTuckerConfig(dims=DIMS, ranks=(3, 4, 5), batch_size=64,
                             backend="torch")
    params = cu.init_params(torch.Generator().manual_seed(1), ccfg, "cpu")
    idx, val = tensor.indices[:64], tensor.values[:64]
    g1 = cu.batch_gradients(params, idx, val, 0.01, 0.01, "einsum")
    g2 = cu.batch_gradients(params, idx, val, 0.01, 0.01, "kron")
    np.testing.assert_allclose(g1.err.numpy(), g2.err.numpy(), rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(g1.row_grads, g2.row_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("method", ["als", "ccd"])
def test_exact_epochs_reduce_loss(tensor, method):
    mod, cfg_cls = {"als": (als, als.ALSConfig),
                    "ccd": (ccd, ccd.CCDConfig)}[method]
    epoch = getattr(mod, f"{method}_epoch")
    ccfg = cu.CuTuckerConfig(dims=DIMS, ranks=(4, 4, 4), backend="torch")
    params = cu.init_params(torch.Generator().manual_seed(2), ccfg, "cpu")
    train_t, test_t = tensor.split(0.1, seed=1)
    r0, _ = rmse_mae(params, test_t, mod.predict)
    for _ in range(3):
        params = epoch(params, train_t, cfg_cls(dims=DIMS, ranks=(4, 4, 4)))
    r1, _ = rmse_mae(params, test_t, mod.predict)
    assert float(r1) < float(r0)
    if method == "als":
        assert float(r1) < 0.2  # exact row solves converge fast


def test_fasttucker_representable_by_cutucker():
    """The Kruskal core is a subspace of full cores: predictions agree when
    the full core is the materialized Kruskal core."""
    cfg = ft.FastTuckerConfig(dims=DIMS, ranks=(3, 3, 3), core_rank=2,
                              batch_size=32, backend="torch")
    params = ft.init_params(torch.Generator().manual_seed(9), cfg, "cpu")
    t = planted_tensor(DIMS, 500, seed=11, device="cpu")
    idx = t.indices[:100]
    core = torch.einsum("ar,br,cr->abc", *params.core_factors)
    # the same dense core as the reference's kruskal_to_core
    want = kruskal_to_core(tuple(jnp.asarray(b.numpy())
                                 for b in params.core_factors))
    np.testing.assert_allclose(core.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    pred_fast = ft.predict(params, idx, backend="torch")
    pred_full = cu.predict(cu.CuTuckerParams(params.factors, core), idx)
    np.testing.assert_allclose(pred_fast.numpy(), pred_full.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_fasttucker_matches_cutucker_accuracy():
    """Paper Fig. 3 (the port of ``tests/test_system.py:29``): the Kruskal
    core (R = J) reaches the full core's accuracy."""
    dims = (150, 120, 90)
    t = planted_tensor(dims, 40_000, rank=4, core_rank=4, noise=0.05,
                       seed=9, device="cpu")
    train_t, test_t = t.split(0.1, seed=9)
    fcfg = ft.FastTuckerConfig(dims=dims, ranks=(4, 4, 4), core_rank=4,
                               batch_size=2048, backend="torch")
    _, fhist = ft.train(torch.Generator().manual_seed(1), train_t, fcfg,
                        num_steps=400, eval_every=400, test=test_t)
    ccfg = cu.CuTuckerConfig(dims=dims, ranks=(4, 4, 4), batch_size=2048,
                             backend="torch")
    cstate = cu.init_state(torch.Generator().manual_seed(1), ccfg, "cpu")
    gen = torch.Generator().manual_seed(2)
    for _ in range(400):
        cstate = cu.sgd_step(cstate, gen, train_t.indices, train_t.values,
                             ccfg)
    crmse, _ = rmse_mae(cstate.params, test_t, cu.predict)
    frmse = fhist[-1]["rmse"]
    assert abs(frmse - float(crmse)) < 0.15, (frmse, float(crmse))


# ---------------------------------------------------------------------------
# bench_accuracy
# ---------------------------------------------------------------------------

def test_bench_accuracy_smoke_validates(tmp_path):
    out = tmp_path / bench_accuracy.OUT_NAME
    doc = bench_accuracy.main(["--smoke", "--device", "cpu", "--backend",
                               "torch", "--out", str(out)])
    assert doc["schema"] == "bench_accuracy/v1" and doc["smoke"]
    assert doc["platform"] == "cpu"
    assert doc["config"]["dims"] == list(bench_accuracy.SMOKE["dims"])
    assert {(r["model"], r["variant"]) for r in doc["results"]} == {
        ("fasttucker", "factor+core"), ("fasttucker", "factor_only"),
        ("cutucker", "baseline")}
    validate_bench_accuracy(json.loads(out.read_text()))


def test_bench_accuracy_configs_are_the_reference_ones():
    import benchmarks.bench_accuracy as ref
    assert bench_accuracy.FULL == ref.FULL
    assert bench_accuracy.SMOKE == ref.SMOKE


def test_bench_accuracy_refuses_the_reference_name(tmp_path):
    with pytest.raises(ValueError, match="BENCH_torch_accuracy.json"):
        bench_accuracy.run(smoke=True, out_path=str(
            tmp_path / "BENCH_accuracy.json"), device="cpu")


def _acc_doc():
    def r(model, variant, rmse):
        return {"model": model, "variant": variant, "rank": 4,
                "rmse": rmse, "mae": rmse * 0.8}
    return {"schema": "bench_accuracy/v1",
            "config": {"dims": [8, 8, 8], "nnz": 100, "steps": 10,
                       "seed": 0, "value_rms": 3.0},
            "results": [r("fasttucker", "factor+core", 0.25),
                        r("fasttucker", "factor_only", 0.26),
                        r("cutucker", "baseline", 0.24)]}


def _mutations():
    def set_(i, key, v):
        def f(d):
            d["results"][i][key] = v
        return f

    def drop_baseline(d):
        d["results"] = d["results"][:2]

    def schema(d):
        d["schema"] = "bench_accuracy/v0"

    def no_rms(d):
        del d["config"]["value_rms"]

    return [("ok", lambda d: None), ("fc_worse", set_(0, "rmse", 0.30)),
            ("fc_slack", set_(0, "rmse", 0.263)),
            ("vs_cutucker", set_(2, "rmse", 0.20)),
            ("zero_pred", set_(0, "rmse", 3.5)),
            ("rank_type", set_(1, "rank", 4.0)),
            ("mae_zero", set_(1, "mae", 0.0)),
            ("no_baseline", drop_baseline), ("schema", schema),
            ("no_rms", no_rms)]


@pytest.mark.parametrize("name,mutate", _mutations(),
                         ids=[m[0] for m in _mutations()])
def test_validator_agrees_with_reference(name, mutate):
    from benchmarks.common import validate_bench_accuracy as ref_validate

    def outcome(fn, doc):
        try:
            fn(doc)
            return None
        except ValueError as e:
            return str(e)

    doc = _acc_doc()
    mutate(doc)
    got, want = (outcome(validate_bench_accuracy, doc),
                 outcome(ref_validate, doc))
    assert got == want
    assert (got is None) == (name in ("ok", "fc_slack"))


def test_validator_accepts_the_reference_document():
    validate_bench_accuracy(json.loads(
        (ROOT / "BENCH_accuracy.json").read_text()))


def test_quickstart_example_runs():
    """``python -m repro_torch.examples.quickstart --device cpu``: the
    reference example's tensor, steps and bound (RMSE < 0.25)."""
    from repro_torch.examples import quickstart

    assert quickstart.main(["--device", "cpu", "--backend", "torch"]) < 0.25
