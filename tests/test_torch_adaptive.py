"""The port's adaptive core rank (``repro_torch.core.adaptive``) against the
live reference (``repro.core.adaptive``), the ALS/CCD ordered segment sums
it refines through, and ``std_train --adaptive-rank``.

Tolerances: the controller and the pad/truncate transitions are exact
(pure Python decisions; column selection and concatenation of the same
numbers), so they are held bitwise.  ``refine_factors`` runs the port's
ALS and CCD: ALS within 2e-3 of each factor's largest entry (per-row Gram
condition numbers ~5e3, the bound of ``tests/test_torch_baselines.py``),
CCD within 1e-4 (its epoch bound there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FastTuckerConfig as JConfig
from repro.core import adaptive as jad
from repro.core import fasttucker as jft
from repro.core.sptensor import SparseTensor as JSparseTensor
from repro.data.synthetic import planted_tensor as j_planted
from repro_torch.core import adaptive as ad
from repro_torch.core import als, ccd
from repro_torch.core import fasttucker as ft
from repro_torch.core.cutucker import CuTuckerParams
from repro_torch.core.metrics import rmse_mae
from repro_torch.core.sptensor import SparseTensor
from repro_torch.launch import std_train

DIMS = (30, 24, 18)


def _cfgs(backend="torch", **kw):
    base = dict(dims=DIMS, ranks=(4,) * 3, core_rank=4, batch_size=256)
    base.update(kw)
    return JConfig(**base), ft.FastTuckerConfig(backend=backend, **base)


@pytest.fixture(scope="module")
def jdata():
    return j_planted(DIMS, 2_000, rank=4, core_rank=4, seed=0)


@pytest.fixture(scope="module")
def tensor(jdata):
    return SparseTensor.from_numpy(np.asarray(jdata.indices),
                                   np.asarray(jdata.values), DIMS, "cpu")


def _jparams(seed=0, **kw):
    jcfg, _ = _cfgs(**kw)
    return jft.init_params(jax.random.PRNGKey(seed), jcfg)


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# RankController: the reference's decisions on the same RMSE sequences
# ---------------------------------------------------------------------------

def _sequences():
    rng = np.random.default_rng(0)
    noisy = [list(1.0 / (1 + 0.1 * np.arange(40)) * (1 + 0.01 * rng.normal(
        size=40))) for _ in range(3)]
    return [
        ("plateau", dict(rank=4, max_rank=16), [1.0, 0.999, 0.999]),
        ("reset", dict(rank=4, max_rank=16), [1.0, 0.5, 0.499, 0.4]),
        ("unpaid", dict(rank=4, max_rank=16, patience=1, grow_gain=0.02),
         [1.0, 1.0, 0.995, 0.995, 0.1]),
        ("paid", dict(rank=4, max_rank=8, patience=1, grow_gain=0.02),
         [1.0, 1.0, 0.5, 0.5]),
        ("flat", dict(rank=2, max_rank=16, tol=0.05), [0.3] * 12),
    ] + [(f"noisy{i}", dict(rank=2, max_rank=32, tol=0.02, patience=2),
          seq) for i, seq in enumerate(noisy)]


@pytest.mark.parametrize("name,kw,seq", _sequences(),
                         ids=[s[0] for s in _sequences()])
def test_controller_decisions_equal_reference(name, kw, seq):
    kw = dict(kw)
    r, m = kw.pop("rank"), kw.pop("max_rank")
    mine, theirs = ad.RankController(r, m, **kw), jad.RankController(r, m,
                                                                    **kw)
    for x in seq:
        got, want = mine.observe(x), theirs.observe(x)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for attr in ("rank", "best", "stale", "grew_from", "pre_grow_best",
                 "done", "history"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr


@pytest.mark.parametrize("args,kw", [
    ((0, 4), {}), ((8, 4), {}), ((4, 8), {"tol": 0.0}),
    ((4, 8), {"patience": 0}), ((4, 8), {"grow_gain": -0.1})])
def test_controller_refuses_what_the_reference_refuses(args, kw):
    with pytest.raises(ValueError):
        jad.RankController(*args, **kw)
    with pytest.raises(ValueError):
        ad.RankController(*args, **kw)


# ---------------------------------------------------------------------------
# resize_core_rank and core_column_energy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("boost,new_rank", [
    ([10.0, 1.0, 5.0, 1.0], 2), ([1.0, 3.0, 2.0, 0.5], 3),
    ([1.0, 1.0, 1.0, 1.0], 2)], ids=["top2", "top3", "ties"])
def test_resize_shrink_bitwise_reference(boost, new_rank):
    jp = _jparams()
    jcfg, pcfg = _cfgs()
    b = jnp.asarray(boost, jnp.float32)
    jp = jft.FastTuckerParams(jp.factors,
                              tuple(c * b[None, :] for c in jp.core_factors))
    want, wcfg = jad.resize_core_rank(jp, jcfg, new_rank,
                                      jax.random.PRNGKey(1))
    pp = ft.params_from_numpy(jp, "cpu")
    got, gcfg = ad.resize_core_rank(pp, pcfg, new_rank)
    assert gcfg.core_rank == wcfg.core_rank == new_rank
    _equal(got.core_factors, want.core_factors)
    assert got.factors is pp.factors
    np.testing.assert_allclose(
        ad.core_column_energy(pp.core_factors).numpy(),
        np.asarray(jad.core_column_energy(jp.core_factors)), rtol=1e-6)


@pytest.mark.parametrize("new_rank,grow_scale", [(8, 0.1), (5, 0.5)])
def test_resize_grow_with_fed_pad_bitwise_reference(new_rank, grow_scale):
    """The reference's pad columns, drawn from its key as it draws them,
    fed to the port: the grown factors are the same bits."""
    jp = _jparams()
    jcfg, pcfg = _cfgs()
    key = jax.random.PRNGKey(7)
    want, _ = jad.resize_core_rank(jp, jcfg, new_rank, key, grow_scale)
    s = grow_scale * jft.init_scale(dataclasses.replace(
        jcfg, core_rank=new_rank))
    keys = jax.random.split(key, jcfg.order)
    pad = [torch.from_numpy(np.array(jax.random.uniform(
        keys[n], (b.shape[0], new_rank - 4), minval=0.0, maxval=2 * s,
        dtype=jnp.float32))) for n, b in enumerate(jp.core_factors)]
    got, gcfg = ad.resize_core_rank(ft.params_from_numpy(jp, "cpu"), pcfg,
                                    new_rank, grow_scale=grow_scale, pad=pad)
    assert gcfg.core_rank == new_rank
    _equal(got.core_factors, want.core_factors)


def test_resize_grow_from_generator():
    _, cfg = _cfgs()
    p = ft.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    grown, gcfg = ad.resize_core_rank(p, cfg, 8,
                                      torch.Generator().manual_seed(1))
    again, _ = ad.resize_core_rank(p, cfg, 8,
                                   torch.Generator().manual_seed(1))
    assert gcfg.core_rank == 8 and gcfg.dims == cfg.dims
    for old, new, rep in zip(p.core_factors, grown.core_factors,
                             again.core_factors):
        assert new.shape == (4, 8) and torch.equal(new, rep)
        assert torch.equal(new[:, :4], old)
        # damped (grow_scale × the cold scale), not dead
        assert 0.0 < float(new[:, 4:].max()) < float(old.max())
    assert grown.factors is p.factors


def test_resize_noop_and_validation():
    _, cfg = _cfgs()
    p = ft.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    same, scfg = ad.resize_core_rank(p, cfg, 4)
    assert same is p and scfg.core_rank == 4
    with pytest.raises(ValueError):
        ad.resize_core_rank(p, cfg, 0)
    with pytest.raises(ValueError, match="generator"):
        ad.resize_core_rank(p, cfg, 8)


# ---------------------------------------------------------------------------
# refine_factors through the repaired ALS/CCD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("method,tol", [("als", 2e-3), ("ccd", 1e-4)])
def test_refine_factors_matches_reference(jdata, tensor, backend, method,
                                          tol):
    jp = _jparams(seed=2)
    jcfg, pcfg = _cfgs(backend)
    jt = JSparseTensor(jdata.indices, jdata.values, DIMS)
    want = jad.refine_factors(jp, jcfg, jt, method=method, passes=2)
    pp = ft.params_from_numpy(jp, "cpu")
    got = ad.refine_factors(pp, pcfg, tensor, method=method, passes=2)
    for g, w in zip(got.factors, want.factors):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= tol * np.abs(w).max()
    assert got.core_factors is pp.core_factors


def test_refine_factors_improves_fit(tensor):
    train_t, test_t = tensor.split(0.2)
    _, cfg = _cfgs()
    p = ft.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    predict = lambda q, i: ft.predict(q, i, "torch")  # noqa: E731
    before, _ = rmse_mae(p, test_t, predict)
    for method in ("als", "ccd"):
        after, _ = rmse_mae(ad.refine_factors(p, cfg, train_t, method,
                                              passes=2), test_t, predict)
        assert float(after) < float(before), method
    with pytest.raises(ValueError, match="method"):
        ad.refine_factors(p, cfg, train_t, method="nope")


# ---------------------------------------------------------------------------
# ALS/CCD: ordered segment sums
# ---------------------------------------------------------------------------

def _sequential_fold(bk, x, seg, num_rows, out):
    """out += the segment sum of x, each row's terms added one at a time
    in sorted position order, in f32 (numpy): the fold by definition."""
    xs = x.numpy()
    acc = np.zeros((num_rows, xs.shape[1]), dtype=np.float32)
    for p, r in enumerate(seg.tolist()):
        acc[r] = acc[r] + xs[p]
    out += torch.from_numpy(acc)


def _cu_params(ranks, seed=0):
    g = torch.Generator().manual_seed(seed)
    facs = tuple(torch.rand((n, j), generator=g) for n, j in zip(DIMS,
                                                               ranks))
    return CuTuckerParams(facs, torch.rand(ranks, generator=g) * 0.5)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_als_ccd_fold_in_stable_sorted_order_bitwise(tensor, backend,
                                                     monkeypatch):
    """The port's ALS and CCD epochs, bitwise equal to the same epochs with
    every segment sum a sequential f32 fold in stable-sorted order (ALS in
    three chunks)."""
    p = _cu_params((4, 4, 4))
    acfg = als.ALSConfig(dims=DIMS, ranks=(4, 4, 4))
    ccfg = ccd.CCDConfig(dims=DIMS, ranks=(4, 4, 4))
    got_a = als.als_epoch(p, tensor, acfg, chunk=700, backend=backend)
    got_c = ccd.ccd_epoch(p, tensor, ccfg, backend=backend)
    monkeypatch.setattr(als, "ordered_fold", _sequential_fold)
    monkeypatch.setattr(ccd, "ordered_fold", _sequential_fold)
    want_a = als.als_epoch(p, tensor, acfg, chunk=700, backend=backend)
    want_c = ccd.ccd_epoch(p, tensor, ccfg, backend=backend)
    for g, w in zip(got_a.factors + got_c.factors,
                    want_a.factors + want_c.factors):
        assert torch.equal(g, w)


def test_als_gram_column_slices_bitwise_unsliced(tensor, monkeypatch):
    """At J = 12 the 144-wide Gram rows fold in three slices (64, 64, 16),
    one segment_reduce call each, plus one for the right-hand side; the
    sums equal the unsliced fold bit for bit."""
    from repro_torch.kernels import dispatch

    p = _cu_params((12, 12, 12), seed=1)
    bk = dispatch.get_backend("torch")
    calls = []
    real = type(bk).segment_reduce

    def counted(self, g, idx, n):
        calls.append(g.shape[1])
        return real(self, g, idx, n)

    monkeypatch.setattr(type(bk), "segment_reduce", counted)
    sliced = als.normal_equations(p, tensor.indices, tensor.values, 0,
                                  DIMS[0], chunk=1_200, backend="torch")
    assert calls == [64, 64, 16, 12] * 2      # two chunks of 1,200 in 2,000
    monkeypatch.setattr(als, "FOLD_WIDTH", 1 << 20)
    whole = als.normal_equations(p, tensor.indices, tensor.values, 0,
                                 DIMS[0], chunk=1_200, backend="torch")
    assert calls[8:] == [144, 12] * 2
    for a, b in zip(sliced, whole):
        assert torch.equal(a, b)


def test_als_ccd_reuse_a_given_order(tensor):
    """A precomputed per-mode order gives the bits of the epoch's own sort
    (the warm start's four refine passes sort once)."""
    from repro_torch.core.sampling import sorted_batch_order

    p = _cu_params((4, 4, 4), seed=3)
    order = sorted_batch_order(tensor.indices)
    for mod, cfg in ((als, als.ALSConfig(DIMS, (4, 4, 4))),
                     (ccd, ccd.CCDConfig(DIMS, (4, 4, 4)))):
        epoch = getattr(mod, f"{mod.__name__.rsplit('.', 1)[1]}_epoch")
        a = epoch(p, tensor, cfg, backend="torch")
        b = epoch(p, tensor, cfg, backend="torch", order=order)
        for x, y in zip(a.factors, b.factors):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# std_train --adaptive-rank
# ---------------------------------------------------------------------------

STD = ["--dims", "60,50,40", "--nnz", "8000", "--rank", "4", "--core-rank",
       "2", "--batch", "256", "--steps", "60", "--eval-every", "10",
       "--device", "cpu", "--backend", "torch"]


@pytest.mark.parametrize("refine", ["als", "ccd"])
def test_std_train_adaptive_rank_transitions(refine):
    plain = std_train.main(STD)
    res = std_train.main(STD + ["--adaptive-rank", "--max-core-rank", "8",
                                "--plateau-tol", "0.5",
                                "--plateau-patience", "1", "--refine",
                                refine])
    ranks = res["rank_history"]
    assert ranks and ranks[0]["action"] == "grow" and ranks[0]["rank"] == 4
    assert all(r["step"] % 10 == 0 and r["step"] < 60 for r in ranks)
    assert all(r["rank"] <= 8 for r in ranks)
    assert res["cfg"].core_rank == ranks[-1]["rank"]
    assert res["state"].params.core_factors[0].shape[1] == ranks[-1]["rank"]
    assert all(np.isfinite(h["rmse"]) for h in res["history"])
    assert plain["rank_history"] == []
    # a transition draws from the warm-start generator, never the batch
    # stream: both runs end on the same sampling state
    assert torch.equal(plain["dstate"].rng, res["dstate"].rng)


def test_std_train_adaptive_refusals(tmp_path):
    with pytest.raises(SystemExit, match="ckpt-dir"):
        std_train.main(STD + ["--adaptive-rank", "--ckpt-dir",
                              str(tmp_path)])
    with pytest.raises(SystemExit, match="above 64"):
        std_train.main(STD + ["--adaptive-rank", "--backend", "cuda",
                              "--core-rank", "32"])
    # the plain backend takes any width
    res = std_train.main(STD + ["--adaptive-rank", "--core-rank", "32",
                                "--steps", "2", "--eval-every", "1"])
    assert res["cfg"].core_rank in (32, 64, 128)
