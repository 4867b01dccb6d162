"""The port's sketched warm start (``repro_torch.core.sketch``) against the
live reference (``repro.core.sketch``), and the reference's own contracts
on the port.

Parity goes through fed inputs: the reference derives every draw from one
key and a salt per stage (``src/repro/core/sketch.py:75-81``); ``_ref_draws``
rebuilds those draws into the port's ``SketchDraws``, so both packages run
the same numbers through their own code.  Tolerances (each against the
largest entry of the leaf compared):

* stage 1 (range finder): 1e-5 — the products against identity factors
  are exact on both sides, so only the two QR factorizations (LAPACK
  Householder here, XLA's on the reference) differ, ~4e-7 measured; the
  column signs agree;
* the ridge solve, damping and rebalance: 1e-5 — one f32 Gram, solve or
  norm summed in another order;
* stage 2 (core LS sweeps): 1e-4 — Gauss–Seidel sweeps that feed each
  solve into the next design;
* one refine pass: 2e-3, the port's ALS bound against the reference
  (per-row Gram condition numbers up to ~5e3;
  ``tests/test_torch_baselines.py``);
* the whole warm start: 5e-3 — its refine passes each start from the
  last one's ALS solves, so the epoch's rounding differences compound;
  over six keys at these shapes 2.3e-4 to 1.6e-3 with the default
  refinement and up to 3.6e-3 with ``sketch_refine_batch`` = 1200 (thinner
  row solves).  The predictions on the nonzeros are held to 1e-3 of the
  largest (≤ 1.2e-4 measured).  With a mode narrower than J (the fill
  columns, (30, 24, 3)) the per-row normal equations reach condition
  numbers ~4e5, so two f32 implementations part along the ill-determined
  directions (O(1) in the factors) while the model they define does not:
  there only the predictions are compared, within 1e-2 (≤ 2.3e-3 measured
  over six keys).

Both port backends run: ``"torch"`` and ``"cuda"`` (its plain versions on
CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FastTuckerConfig as JConfig
from repro.core import sketch as js
from repro.core.fasttucker import init_scale as j_init_scale
from repro.data.synthetic import planted_tensor as j_planted
from repro_torch.benchmarks import bench_convergence
from repro_torch.benchmarks.common import validate_bench_convergence
from repro_torch.core import fasttucker as ft
from repro_torch.core import sketch as ps
from repro_torch.core.metrics import rmse_mae
from repro_torch.core.sptensor import SparseTensor
from repro_torch.data.synthetic import planted_tensor
from repro_torch.launch import std_train

DIMS = (30, 24, 18)
NNZ = 2_000
BACKENDS = ["torch", "cuda"]
BASE_CFG = dict(dims=DIMS, ranks=(4,) * 3, core_rank=4, batch_size=256,
                sketch_batch=512, sketch_refine_passes=2)


def _cfgs(backend="torch", **kw):
    base = dict(BASE_CFG, **kw)
    return JConfig(**base), ft.FastTuckerConfig(backend=backend, **base)


@pytest.fixture(scope="module")
def jdata():
    return j_planted(DIMS, NNZ, rank=4, core_rank=4, seed=0)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _tensor(jt):
    return SparseTensor.from_numpy(np.asarray(jt.indices),
                                   np.asarray(jt.values), jt.dims, "cpu")


def _ref_draws(key, cfg, indices, values) -> ps.SketchDraws:
    """The reference's draws of ``sketched_init_params(key, …)``, rebuilt
    from its salts (sketch.py:75-81) into the port's ``SketchDraws``."""
    N, B = cfg.order, cfg.sketch_batch_size
    R_s = max(cfg.ranks) + cfg.sketch_oversample
    s = j_init_scale(cfg)
    indices, values = np.asarray(indices), np.asarray(values)

    def samp(k, b):
        pick = np.asarray(jax.random.randint(k, (b,), 0, values.shape[0]))
        return _t(indices[pick]), _t(values[pick], torch.float32)

    def unif(k, shape):
        return _t(jax.random.uniform(k, shape, minval=0.0, maxval=2 * s,
                                     dtype=jnp.float32))

    gk = jax.random.split(jax.random.fold_in(key, js._SALT_GAUSS), N)
    gauss = tuple(_t(jax.random.normal(gk[n], (cfg.dims[n], R_s),
                                       jnp.float32)) for n in range(N))
    k = jax.random.fold_in(key, js._SALT_SAMPLES)
    rs = [samp(jax.random.fold_in(k, p), B) for p in range(cfg.sketch_passes)]
    range_samples = (torch.cat([i for i, _ in rs]),
                     torch.cat([v for _, v in rs]))
    fk = jax.random.split(jax.random.fold_in(key, js._SALT_FILL), N)
    fill = []
    for n in range(N):
        short = cfg.ranks[n] - min(cfg.dims[n], R_s, cfg.ranks[n])
        fill.append(unif(fk[n], (cfg.dims[n], short)) if short
                    else torch.zeros((cfg.dims[n], 0)))
    bk = jax.random.split(jax.random.fold_in(key, js._SALT_CORE), N)
    core0 = tuple(unif(bk[n], (cfg.ranks[n], cfg.core_rank))
                  for n in range(N))
    ks = jax.random.fold_in(key, js._SALT_CORE_SAMPLES)
    core_samples = tuple(samp(jax.random.fold_in(ks, sw * N + n), B)
                         for sw in range(cfg.sketch_core_sweeps)
                         for n in range(N))
    damp = samp(jax.random.fold_in(key, js._SALT_DAMP), B)
    cap = (samp(jax.random.fold_in(key, js._SALT_REFINE - 1),
                cfg.sketch_refine_batch)
           if cfg.sketch_refine_batch else None)
    refine = tuple(samp(jax.random.fold_in(key, js._SALT_REFINE + p), B)
                   for p in range(cfg.sketch_refine_passes))
    return ps.SketchDraws(gauss, range_samples, tuple(fill), core0,
                          core_samples, damp, cap, refine)


def _close(got, want, rel, what=""):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, (what, err, scale)


def _close_all(got, want, rel):
    for n, (g, w) in enumerate(zip(got, want)):
        _close(g, w, rel, f"leaf {n}")


def _leaves(p):
    return tuple(p.factors) + tuple(p.core_factors)


def _same_bits(p, q):
    for a, b in zip(_leaves(p), _leaves(q)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# each stage fed the reference's own inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dims", [DIMS, (30, 24, 3)],
                         ids=["dims", "fill_columns"])
def test_range_finder_matches_reference(jdata, backend, dims):
    """Stage 1 from the reference's Gaussians and samples; at (30, 24, 3)
    mode 2 has fewer rows than J = 4, and its missing column is the fed
    fill, exactly."""
    jt = jdata if dims == DIMS else j_planted(dims, NNZ, rank=4,
                                              core_rank=4, seed=0)
    jcfg, pcfg = _cfgs(backend, dims=dims)
    key = jax.random.PRNGKey(3)
    d = _ref_draws(key, jcfg, jt.indices, jt.values)
    want = js.sketch_range_finders(key, jcfg, jt.indices, jt.values)
    got = ps.sketch_range_finders(pcfg, d.gauss, *d.range_samples, d.fill)
    _close_all(got, want, 1e-5)
    for n, f in enumerate(d.fill):
        if f.shape[1]:
            assert torch.equal(got[n][:, -f.shape[1]:], f)
            assert dims[n] < pcfg.ranks[n]


@pytest.mark.parametrize("backend", BACKENDS)
def test_core_ls_matches_reference(jdata, backend):
    """Stage 2 from the reference's warm factors, core start and draws."""
    jcfg, pcfg = _cfgs(backend)
    key = jax.random.PRNGKey(4)
    d = _ref_draws(key, jcfg, jdata.indices, jdata.values)
    facs = js.sketch_range_finders(key, jcfg, jdata.indices, jdata.values)
    want = js.sketch_core_factors(key, jcfg, facs, jdata.indices,
                                  jdata.values)
    got = ps.sketch_core_factors(pcfg, tuple(_t(f) for f in facs), d.core0,
                                 d.core_samples)
    _close_all(got, want, 1e-4)


def test_ridge_damp_rebalance_match_reference(jdata):
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(0)
    D = rng.normal(0, 0.05, (700, 16)).astype(np.float32)
    val = rng.normal(size=700).astype(np.float32)
    _close(ps._ridge_core_solve(pcfg, 1, _t(D), _t(val)),
           js._ridge_core_solve(jcfg, 1, jnp.asarray(D), jnp.asarray(val)),
           1e-5, "ridge")
    facs = tuple(rng.normal(0, 0.3, (n, 4)).astype(np.float32) for n in DIMS)
    core = tuple(rng.normal(0, 3.0, (4, 4)).astype(np.float32)
                 for _ in DIMS)
    idx = np.asarray(jdata.indices[:500])
    val = np.asarray(jdata.values[:500])
    want = js._damp_core(jcfg, tuple(map(jnp.asarray, facs)),
                         tuple(map(jnp.asarray, core)), idx, val)
    got = ps._damp_core(pcfg, tuple(map(_t, facs)), tuple(map(_t, core)),
                        _t(idx), _t(val))
    _close_all(got, want, 1e-5)
    wa, wb = js._rebalance(jcfg, tuple(map(jnp.asarray, facs)),
                           tuple(map(jnp.asarray, core)))
    ga, gb = ps._rebalance(pcfg, tuple(map(_t, facs)), tuple(map(_t, core)))
    _close_all(ga + gb, wa + wb, 1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_refine_pass_matches_reference(jdata, backend):
    """One alternating-LS pass (an ALS factor epoch over all nonzeros,
    then a core-LS sweep over a fed draw) from the same iterate."""
    jcfg, pcfg = _cfgs(backend)
    key = jax.random.PRNGKey(5)
    facs = js.sketch_range_finders(key, jcfg, jdata.indices, jdata.values)
    core = js.sketch_core_factors(key, jcfg, facs, jdata.indices,
                                  jdata.values)
    facs, core = js._rebalance(jcfg, facs, core)
    d = _ref_draws(key, jcfg, jdata.indices, jdata.values)
    sidx, sval = d.refine_samples[0]
    wf, wc = js._refine_pass(facs, core, jdata.indices,
                             jdata.values.astype(jnp.float32),
                             jnp.asarray(sidx.numpy()),
                             jnp.asarray(sval.numpy()), jcfg)
    t = _tensor(jdata)
    gf, gc = ps._refine_pass(tuple(map(_t, facs)), tuple(map(_t, core)),
                             t.indices, t.values, sidx, sval, pcfg)
    _close_all(gf + gc, wf + wc, 2e-3)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kw,leaf_tol,pred_tol", [
    ({}, 5e-3, 1e-3), ({"sketch_refine_batch": 1200}, 5e-3, 1e-3),
    ({"dims": (30, 24, 3)}, None, 1e-2)],
    ids=["default", "refine_cap", "fill_columns"])
def test_warm_start_matches_reference(jdata, backend, kw, leaf_tol,
                                      pred_tol):
    """The whole warm start from the reference's draws against
    ``repro.core.sketch.sketched_init_params(key, …)``."""
    jt = (jdata if "dims" not in kw
          else j_planted(kw["dims"], NNZ, rank=4, core_rank=4, seed=0))
    jcfg, pcfg = _cfgs(backend, **kw)
    key = jax.random.PRNGKey(3)
    d = _ref_draws(key, jcfg, jt.indices, jt.values)
    want = js.sketched_init_params(key, jcfg, jt.indices, jt.values)
    t = _tensor(jt)
    got = ps.sketched_init_from_draws(d, pcfg, t.indices, t.values)
    if leaf_tol is not None:
        _close_all(_leaves(got), _leaves(want), leaf_tol)
    _close(ft.predict(got, t.indices, "torch"),
           js_predict(want, jt.indices), pred_tol, "predictions")


def js_predict(params, indices):
    from repro.core import fasttucker as jft

    return jft.predict(params, indices)


def test_bf16_storage_rounds_the_f32_warm_start(jdata):
    t = _tensor(jdata)
    _, c32 = _cfgs()
    _, c16 = _cfgs(dtype="bfloat16")
    p32 = ps.sketched_init_params(torch.Generator().manual_seed(1), c32,
                                  t.indices, t.values)
    p16 = ps.sketched_init_params(torch.Generator().manual_seed(1), c16,
                                  t.indices, t.values)
    for a, b in zip(_leaves(p32), _leaves(p16)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.bfloat16(), b)


# ---------------------------------------------------------------------------
# the reference's own contracts on the port (tests/test_sketch.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tensor(jdata):
    return _tensor(jdata)


def _warm(cfg, t, seed=3, **kw):
    return ps.sketched_init_params(torch.Generator().manual_seed(seed), cfg,
                                   t.indices, t.values, **kw)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_range_finder_orthonormal(tensor, seed):
    _, cfg = _cfgs()
    d = ps.draw_sketch(torch.Generator().manual_seed(seed), cfg,
                       tensor.indices, tensor.values)
    for n, a in enumerate(ps.sketch_range_finders(cfg, d.gauss,
                                                  *d.range_samples, d.fill)):
        assert a.shape == (DIMS[n], 4)
        torch.testing.assert_close(a.T @ a, torch.eye(4), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_start_bitwise_deterministic(tensor, backend):
    _, cfg = _cfgs(backend)
    _same_bits(_warm(cfg, tensor), _warm(cfg, tensor))


@pytest.mark.parametrize("num_shards", [2, 3, 4, 5, 6, 7])
def test_warm_start_shard_invariant(tensor, num_shards):
    _, cfg = _cfgs("cuda")
    _same_bits(_warm(cfg, tensor),
               _warm(cfg, tensor, num_shards=num_shards))


def test_different_seeds_differ(tensor):
    _, cfg = _cfgs()
    assert not torch.equal(_warm(cfg, tensor, 0).factors[0],
                           _warm(cfg, tensor, 1).factors[0])


def test_cold_init_ignores_data_bitwise(tensor):
    _, cfg = _cfgs()
    _same_bits(ft.init_params(torch.Generator().manual_seed(0), cfg, "cpu"),
               ft.init_params(torch.Generator().manual_seed(0), cfg, "cpu",
                              tensor.indices, tensor.values))


def test_sketched_init_requires_data():
    _, cfg = _cfgs(init="sketched")
    with pytest.raises(ValueError, match="sketched"):
        ft.init_params(torch.Generator().manual_seed(0), cfg, "cpu")


def test_sketched_init_rejects_bad_indices():
    _, cfg = _cfgs(init="sketched")
    with pytest.raises(ValueError, match="indices"):
        ps.sketched_init_params(torch.Generator().manual_seed(0), cfg,
                                torch.zeros((10, 2), dtype=torch.int32),
                                torch.ones(10))


def test_warm_step_offset_only_for_sketched(tensor):
    _, warm_cfg = _cfgs(init="sketched", warm_step_offset=7)
    warm = ft.init_state(torch.Generator().manual_seed(0), warm_cfg, "cpu",
                         tensor.indices, tensor.values)
    assert warm.step == 7
    _, cold_cfg = _cfgs(warm_step_offset=7)
    assert ft.init_state(torch.Generator().manual_seed(0), cold_cfg,
                         "cpu").step == 0


def test_init_state_sketched_matches_direct_call(tensor):
    _, cfg = _cfgs(init="sketched")
    state = ft.init_state(torch.Generator().manual_seed(2), cfg, "cpu",
                          tensor.indices, tensor.values)
    _same_bits(state.params, _warm(cfg, tensor, 2))


def test_warm_params_survive_local_strategy_roundtrip(tensor):
    from repro_torch.distributed import get_strategy

    train_t, _ = tensor.split(0.2)
    _, cfg = _cfgs(init="sketched")
    state0 = ft.init_state(torch.Generator().manual_seed(0), cfg, "cpu",
                           train_t.indices, train_t.values)
    strategy = get_strategy("local")
    plan = strategy.prepare(train_t, cfg, None, seed=0)
    dstate = strategy.init(plan, state0, torch.Generator().manual_seed(1))
    _same_bits(strategy.eval_params(plan, dstate), state0.params)


def test_warm_start_beats_cold_sgd():
    """At (48, 40, 32) the warm start's step-0 RMSE beats a cold run 30
    SGD steps in (the reference's own shape: at smaller ones the sampled
    row solves condition poorly on unlucky seeds)."""
    dims = (48, 40, 32)
    t = planted_tensor(dims, 8_000, rank=4, core_rank=4, seed=0,
                       device="cpu")
    train_t, test_t = t.split(0.2)
    cfg = ft.FastTuckerConfig(dims=dims, ranks=(4,) * 3, core_rank=4,
                              batch_size=512, sketch_batch=2048,
                              sketch_refine_passes=4, backend="torch")
    warm = ps.sketched_init_params(torch.Generator().manual_seed(0), cfg,
                                   train_t.indices, train_t.values)
    predict = lambda p, i: ft.predict(p, i, "torch")  # noqa: E731
    warm_rmse, _ = rmse_mae(warm, test_t, predict)
    gen = torch.Generator().manual_seed(0)
    state = ft.init_state(gen, cfg, "cpu")
    for _ in range(30):
        state = ft.sgd_step(state, gen, train_t.indices, train_t.values, cfg)
    cold_rmse, _ = rmse_mae(state.params, test_t, predict)
    assert float(warm_rmse) < float(cold_rmse), (warm_rmse, cold_rmse)


@pytest.mark.parametrize("rank,backend,refused", [
    (61, "cuda", True), (60, "cuda", False), (61, "torch", False)])
def test_sketch_width_refused_above_64_on_cuda(rank, backend, refused):
    """R_s = rank + 4: the "cuda" kruskal_grad takes at most 64."""
    kw = dict(dims=(80, 70, 66), ranks=(rank,) * 3, core_rank=4,
              backend=backend, init="sketched")
    if refused:
        with pytest.raises(ValueError, match="R_s .* 65 is above 64"):
            ft.FastTuckerConfig(**kw)
    else:
        assert ps.sketch_width(ft.FastTuckerConfig(**kw)) == rank + 4


# ---------------------------------------------------------------------------
# std_train --warm-start
# ---------------------------------------------------------------------------

STD = ["--dims", "40,30,20", "--nnz", "4000", "--rank", "4", "--core-rank",
       "4", "--batch", "256", "--steps", "20", "--eval-every", "10",
       "--device", "cpu", "--backend", "torch", "--sketch-batch", "1024",
       "--sketch-refine-passes", "2"]


def test_std_train_warm_start_same_batches_as_cold():
    cold = std_train.main(STD)
    warm = std_train.main(STD + ["--warm-start"])
    assert cold["init"] == "random" and warm["init"] == "sketched"
    assert cold["warm_start_seconds"] is None
    ws = warm["warm_start_seconds"]
    assert set(ws) == {"draw", "range_finder", "core_ls", "damp_rebalance",
                       "refine", "total"}
    # the warm start draws from its own generator: the batch stream is the
    # cold run's, so both runs end on the same generator state
    assert torch.equal(cold["dstate"].rng, warm["dstate"].rng)
    assert warm["history"][0]["rmse"] < cold["history"][0]["rmse"]
    assert all(np.isfinite(h["rmse"]) for h in warm["history"])


def test_std_train_warm_step_offset_starts_the_schedule_there():
    res = std_train.main(STD + ["--warm-start", "--warm-step-offset", "5",
                                "--steps", "25"])
    assert [h["step"] for h in res["history"]] == [5, 10, 20, 25]


def test_std_train_refuses_a_sketch_wider_than_64_on_cuda():
    with pytest.raises(ValueError, match="R_s"):
        std_train.main(STD + ["--backend", "cuda", "--warm-start",
                              "--sketch-oversample", "61"])


# ---------------------------------------------------------------------------
# bench_convergence
# ---------------------------------------------------------------------------

def test_bench_convergence_smoke_validates(tmp_path):
    out = tmp_path / bench_convergence.OUT_NAME
    doc = bench_convergence.run(smoke=True, out_path=str(out),
                                device="cpu", backend="torch")
    assert out.exists()
    assert [(c["backend"], c["strategy"]) for c in doc["configs"]] == [
        ("torch", "local"), ("torch", "strata")]
    assert doc["devices"] == bench_convergence.DEVICES
    for c in doc["configs"]:
        assert (c["sketched"]["steps_to_target"]
                < c["cold"]["steps_to_target"])
        assert c["sketched"]["init_s"] > 0


def test_bench_convergence_configs_are_the_reference_ones():
    import benchmarks.bench_convergence as ref

    assert bench_convergence.DEVICES == ref.DEVICES
    for mine, theirs in ((bench_convergence.FULL, ref.FULL),
                         (bench_convergence.SMOKE, ref.SMOKE)):
        assert mine == [{k: v for k, v in c.items() if k != "backend"}
                        for c in theirs]


def test_bench_convergence_refuses_the_reference_name(tmp_path):
    with pytest.raises(ValueError, match="reference"):
        bench_convergence.run(smoke=True, device="cpu",
                              out_path=str(tmp_path / "BENCH_convergence.json"))


def _arm(steps, wall, final, reached=True):
    return {"reached": reached, "steps_to_target": steps,
            "wallclock_s_to_target": wall, "init_s": 0.1,
            "final_rmse": final,
            "trajectory": [[0, 1.0], [steps or 10, final]]}


def _conv_doc():
    base = {"name": "c", "backend": "xla", "dims": [8, 8, 8], "nnz": 100,
            "rank": 4, "core_rank": 4, "batch": 32, "seed": 0,
            "target_rmse": 0.3, "horizon_steps": 100, "eval_every": 10}
    return {"schema": "bench_convergence/v1", "smoke": False, "configs": [
        {**base, "strategy": s, "cold": _arm(80, 2.0, 0.29),
         "sketched": _arm(0, 0.5, 0.05), "speedup_vs_cold": 80.0,
         "wallclock_speedup_vs_cold": 4.0} for s in ("local", "strata")]}


def _conv_mutations():
    def arm(i, side, key, v):
        def f(d):
            d["configs"][i][side][key] = v
        return f

    def cfg(i, key, v):
        def f(d):
            d["configs"][i][key] = v
        return f

    def schema(d):
        d["schema"] = "bench_convergence/v0"

    def drop(key):
        def f(d):
            del d["configs"][0][key]
        return f

    def smoke_wall(d):
        d["smoke"] = True
        d["configs"][0]["wallclock_speedup_vs_cold"] = 0.8

    def bad_traj(d):
        d["configs"][1]["cold"]["trajectory"] = [[0, -1.0]]

    return [("ok", lambda d: None), ("schema", schema),
            ("not_reached", arm(0, "sketched", "reached", False)),
            ("warm_slower", arm(0, "sketched", "steps_to_target", 90)),
            ("speedup", cfg(0, "speedup_vs_cold", 0.9)),
            ("warm_worse", arm(0, "sketched", "final_rmse", 0.4)),
            ("wall", cfg(1, "wallclock_speedup_vs_cold", 0.8)),
            ("smoke_wall_ok", smoke_wall), ("bad_traj", bad_traj),
            ("rank_type", cfg(0, "rank", 4.0)), ("no_cold", drop("cold"))]


@pytest.mark.parametrize("name,mutate", _conv_mutations(),
                         ids=[m[0] for m in _conv_mutations()])
def test_convergence_validator_agrees_with_reference(name, mutate):
    """On documents the reference's coverage accepts (local and strata on
    xla) the two validators say the same, word for word."""
    from benchmarks.common import validate_bench_convergence as ref_validate

    def outcome(fn, doc):
        try:
            fn(doc)
            return None
        except ValueError as e:
            return str(e)

    doc = _conv_doc()
    mutate(doc)
    got, want = (outcome(validate_bench_convergence, doc),
                 outcome(ref_validate, doc))
    assert got == want
    assert (got is None) == (name in ("ok", "smoke_wall_ok"))


def test_convergence_validator_asks_for_local_only():
    """The restored coverage clause: a local and a strata* config on the
    document's backend.  A local config alone is refused, on the port's
    backend as the reference refuses it on xla; local and strata on
    ``"cuda"`` pass where the reference asks for ``"xla"``; a strata config
    on another backend than the local one does not cover it."""
    from benchmarks.common import validate_bench_convergence as ref_validate

    doc = _conv_doc()
    doc["configs"] = doc["configs"][:1]
    doc["configs"][0]["backend"] = "cuda"
    with pytest.raises(ValueError, match="cover.*strata"):
        validate_bench_convergence(doc)
    with pytest.raises(ValueError, match="cover"):
        ref_validate(doc)
    doc = _conv_doc()
    for c in doc["configs"]:
        c["backend"] = "cuda"
    validate_bench_convergence(doc)
    with pytest.raises(ValueError, match="cover"):
        ref_validate(doc)
    doc["configs"][1]["backend"] = "torch"
    with pytest.raises(ValueError, match=r"\('cuda', 'strata'\)"):
        validate_bench_convergence(doc)
    doc["configs"][0]["strategy"] = "strata"
    with pytest.raises(ValueError, match=r"\('cuda', 'local'\)"):
        validate_bench_convergence(doc)


def test_convergence_validator_accepts_the_reference_document():
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    validate_bench_convergence(json.loads(
        (root / "BENCH_convergence.json").read_text()))


def test_sketch_draws_layout(tensor):
    """``draw_sketch`` fills every field at the config's shapes."""
    _, cfg = _cfgs(sketch_refine_batch=300, dims=(30, 24, 3))
    t = _tensor(j_planted((30, 24, 3), NNZ, rank=4, core_rank=4, seed=0))
    d = ps.draw_sketch(torch.Generator().manual_seed(0), cfg, t.indices,
                       t.values)
    R_s = ps.sketch_width(cfg)
    assert [g.shape for g in d.gauss] == [(n, R_s) for n in (30, 24, 3)]
    assert d.range_samples[0].shape == (2 * 512, 3)
    assert [f.shape[1] for f in d.fill] == [0, 0, 1]
    assert len(d.core_samples) == cfg.sketch_core_sweeps * 3
    assert d.refine_cap[0].shape == (300, 3)
    assert len(d.refine_samples) == cfg.sketch_refine_passes
    assert dataclasses.replace(cfg).sketch_batch_size == 512


def test_warm_start_at_netflix_sparsity_tracks_the_reference():
    """At the Netflix tensor's density, cut by 10 in each mode (48,019 ×
    1,777 × 218, 990,721 nonzeros, 0.005 %) with the reference's defaults
    (sketch batch = the batch, 4096): the sampled sketch captures nothing,
    and the alternating refinement does not recover from it, in the
    reference as in the port — both land above the zero predictor.  From
    the same draws the two agree: held-out RMSE within 1e-3 relative,
    predictions within 1e-2 of the largest (6.6e-4 measured)."""
    from repro.core import fasttucker as jft
    from repro.core import rmse_mae as j_rmse_mae

    dims = (48_019, 1_777, 218)
    jtr, jte = j_planted(dims, 990_721, rank=4, core_rank=4,
                         seed=0).split(0.1)
    jcfg, pcfg = _cfgs("cuda", dims=dims, batch_size=4096, sketch_batch=0,
                       sketch_refine_passes=4)
    key = jax.random.PRNGKey(0)
    want = js.sketched_init_params(key, jcfg, jtr.indices, jtr.values)
    tr, te = _tensor(jtr), _tensor(jte)
    got = ps.sketched_init_from_draws(
        _ref_draws(key, jcfg, jtr.indices, jtr.values), pcfg, tr.indices,
        tr.values)
    r_want = float(j_rmse_mae(want, jte, jft.predict)[0])
    r_got = float(rmse_mae(got, te, lambda p, i: ft.predict(p, i))[0])
    zero = float(te.values.pow(2).mean().sqrt())
    assert abs(r_got - r_want) <= 1e-3 * r_want, (r_got, r_want)
    assert r_got > zero and r_want > zero, (r_got, r_want, zero)
    _close(ft.predict(got, te.indices), js_predict(want, jte.indices),
           1e-2, "predictions")
