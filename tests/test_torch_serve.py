"""The port's Tucker serving engine against the live JAX reference, on the CPU.

The same numpy parameters (the reference's ``init_params`` draws, carried
across with the port's ``params_from_numpy``) go to both packages'
``TuckerServer``; the reference runs on ``"xla"`` and, where its tests do,
``"pallas_interpret"``; the port on ``"torch"`` and on ``"cuda"`` (whose
wrappers take their plain versions on CPU tensors).  Tolerances:
predictions and slices within 1e-5 of the largest magnitude (f32 sums in
another order), top-k ids equal with scores within 1e-5.

Also the ports of the reference's own serving contracts
(``tests/test_serve.py`` without the sharded tests,
``tests/test_online_refresh.py:53-228``) on the port's objects:
bucketing invariance, chunking above the ladder, empty and invalid
queries, the checkpoint round trip through ``std_train --ckpt-dir``, the
row patch bitwise equal to a rebuild, the in-flight generation, top-k ties
in ascending id, the online refresh step against the reference's pieces,
and the ``serve_tucker`` CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fasttucker as jft
from repro.core.kruskal import dense_reconstruct as j_dense_reconstruct
from repro.serve import TuckerServer as JServer
from repro.serve import bucket_for as j_bucket_for
from repro.serve import bucket_ladder as j_bucket_ladder
from repro.serve import split_batch as j_split_batch
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import fasttucker as ft
from repro_torch.core.kruskal import (dense_reconstruct, mode_product_rows,
                                      mode_products)
from repro_torch.core.sptensor import SparseTensor
from repro_torch.data.synthetic import planted_tensor
from repro_torch.distributed import get_strategy
from repro_torch.launch import serve_tucker, std_train
from repro_torch.serve import (TuckerServer, bucket_for, bucket_ladder,
                               engine, load_params_from_checkpoint,
                               split_batch)

DIMS = (7, 6, 5)
BACKENDS = ("torch", "cuda")


def _jparams(dims=DIMS, ranks=(3, 4, 2), core_rank=3, seed=0):
    cfg = jft.FastTuckerConfig(dims=dims, ranks=ranks, core_rank=core_rank,
                               batch_size=32)
    return jft.init_params(jax.random.PRNGKey(seed), cfg)


def _tparams(jparams, dtype="float32"):
    return ft.params_from_numpy(jparams, device="cpu", dtype=dtype)


def _all_indices(dims):
    grids = np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")
    return np.stack(grids, -1).reshape(-1, len(dims)).astype(np.int32)


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.fixture(scope="module")
def tiny():
    jp = _jparams()
    params = _tparams(jp)
    dense = _np(dense_reconstruct(params.factors, params.core_factors))
    return jp, params, dense, _all_indices(DIMS)


# ---------------------------------------------------------------------------
# predict against the reference and the dense tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jbackend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_predict_matches_reference_and_dense(tiny, backend, jbackend):
    jp, params, dense, idx = tiny
    got = _np(TuckerServer(params, backend=backend).predict(idx))
    want = np.asarray(JServer(jp, backend=jbackend).predict(idx))
    _close(got, want)
    _close(got, dense[tuple(idx.T)])
    # the port's dense oracle against the reference's
    _close(dense, np.asarray(j_dense_reconstruct(jp.factors,
                                                 jp.core_factors)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_predict_matches_reference_order4(backend):
    dims = (5, 4, 3, 3)
    jp = _jparams(dims, ranks=(2, 3, 2, 2), core_rank=2, seed=3)
    params = _tparams(jp)
    idx = _all_indices(dims)
    dense = _np(dense_reconstruct(params.factors, params.core_factors))
    got = _np(TuckerServer(params, backend=backend).predict(idx))
    _close(got, np.asarray(JServer(jp).predict(idx)))
    _close(got, dense[tuple(idx.T)])


def test_predict_equals_training_eval_path(tiny):
    """Serving (cached mode products) ≡ training eval (row dots)."""
    _, params, _, idx = tiny
    srv = TuckerServer(params)
    ref = _np(ft.predict(params, torch.from_numpy(idx), "torch"))
    np.testing.assert_allclose(_np(srv.predict(idx)), ref, rtol=1e-6,
                               atol=1e-6)


def test_backends_agree(tiny):
    _, params, _, idx = tiny
    outs = [_np(TuckerServer(params, backend=b).predict(idx))
            for b in BACKENDS]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# bucketing: padding invariance, one contraction per bucket chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 7, 64])
def test_bucketing_invariance(tiny, batch):
    """Same queries, any batch size within the ladder → the same bits."""
    _, params, _, idx = tiny
    srv = TuckerServer(params)
    full = _np(srv.predict(idx[:64]))
    got = _np(srv.predict(idx[:batch]))
    assert got.shape == (batch,)
    np.testing.assert_array_equal(got, full[:batch])


def test_one_contraction_per_bucket_chunk(tiny, monkeypatch):
    """A batch sweep over a 4-bucket ladder: exactly one ``predict`` call
    (one ``kruskal_contract`` on the card) per bucketed chunk, each of a
    ladder shape, and every answer right."""
    _, params, dense, idx = tiny
    calls = []
    real = engine.ft_predict

    def counting(p, i, backend):
        calls.append(int(i.shape[0]))
        return real(p, i, backend)

    monkeypatch.setattr(engine, "ft_predict", counting)
    srv = TuckerServer(params, backend="cuda", max_bucket=64, min_bucket=8)
    assert srv.ladder == (8, 16, 32, 64)
    for b in list(range(1, 40)) + [64, 130, 200]:   # 130/200 chunk via 64
        calls.clear()
        q = np.resize(idx, (b, len(DIMS)))
        pred = _np(srv.predict(q))
        assert pred.shape == (b,)
        assert calls == [s for _, s in split_batch(b, srv.ladder)]
        _close(pred, dense[tuple(q.T)])
    assert set(calls) <= set(srv.ladder)


def test_chunked_oversize_batch_matches_dense(tiny):
    _, params, dense, idx = tiny
    pred = _np(TuckerServer(params, max_bucket=32).predict(idx))
    np.testing.assert_allclose(pred, dense[tuple(idx.T)], rtol=1e-5,
                               atol=1e-5)


def test_bucket_ladder_helpers_match_reference():
    for spec in [(64, 8), (2048, 8), (100, 3)]:
        assert bucket_ladder(*spec) == j_bucket_ladder(*spec)
    ladder = bucket_ladder(64, 8)
    assert ladder == (8, 16, 32, 64)
    for n in (1, 8, 9, 64):
        assert bucket_for(n, ladder) == j_bucket_for(n, ladder)
    for n in (1, 64, 65, 200, 1000):
        assert split_batch(n, ladder) == j_split_batch(n, ladder)
    assert split_batch(200, ladder) == [(0, 64), (64, 64), (128, 64),
                                        (192, 8)]
    with pytest.raises(ValueError):
        bucket_for(65, ladder)
    with pytest.raises(ValueError):
        split_batch(0, ladder)
    with pytest.raises(ValueError, match="ladder"):
        bucket_ladder(4, 8)


# ---------------------------------------------------------------------------
# invalid and empty queries
# ---------------------------------------------------------------------------

def test_predict_rejects_bad_shapes(tiny):
    srv = TuckerServer(tiny[1])
    with pytest.raises(ValueError, match=r"\(B, 3\)"):
        srv.predict(np.zeros((4, 2), np.int32))


def test_queries_reject_out_of_range_indices(tiny):
    srv = TuckerServer(tiny[1])
    with pytest.raises(ValueError, match="out of range"):
        srv.predict(np.array([[0, 0, 5]], np.int32))     # dims[2] == 5
    with pytest.raises(ValueError, match="out of range"):
        srv.predict(np.array([[-1, 0, 0]], np.int32))
    with pytest.raises(ValueError, match="out of range"):
        srv.top_k(0, [7], k=2)                           # dims[0] == 7
    with pytest.raises(ValueError, match="out of range"):
        srv.reconstruct_rows(1, [6])                     # dims[1] == 6


def test_empty_queries_return_empty(tiny):
    srv = TuckerServer(tiny[1])
    out = srv.predict(np.zeros((0, 3), np.int32))
    assert out.shape == (0,) and out.dtype == torch.float32
    scores, items = srv.top_k(0, [], k=3)
    assert scores.shape == (0, 3) and items.shape == (0, 3)
    assert items.dtype == torch.int32
    assert srv.reconstruct_rows(1, []).shape == (0, 7, 5)


def test_id_queries_chunk_over_the_ladder(tiny):
    """top_k/reconstruct id lists longer than the largest bucket chunk
    through the same ladder as predict: the same answers."""
    _, params, _, _ = tiny
    small = TuckerServer(params, max_bucket=8, min_bucket=4)
    big = TuckerServer(params)
    ids = [0, 1, 2, 3, 4, 5, 6, 0, 2, 4, 6]              # 11 > max bucket 8
    s0, i0 = big.top_k(0, ids, k=3)
    s1, i1 = small.top_k(0, ids, k=3)
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    np.testing.assert_allclose(s0.numpy(), s1.numpy(), rtol=1e-6, atol=1e-6)
    r0 = big.reconstruct_rows(2, [0, 1, 2, 3, 4] * 2).numpy()
    r1 = small.reconstruct_rows(2, [0, 1, 2, 3, 4] * 2).numpy()
    np.testing.assert_allclose(r1, r0, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# top-k and slices against brute force and the reference
# ---------------------------------------------------------------------------

def test_top_k_matches_brute_force_and_reference(tiny):
    jp, params, dense, _ = tiny
    srv = TuckerServer(params)
    ids = [0, 2, 6]
    scores, items = srv.top_k(0, ids, k=4)          # target mode 1
    js, ji = JServer(jp).top_k(0, ids, k=4)
    np.testing.assert_array_equal(items.numpy(), np.asarray(ji))
    _close(scores.numpy(), np.asarray(js))
    brute = dense.sum(axis=2)                       # marginalize mode 2
    for b, uid in enumerate(ids):
        order = np.argsort(-brute[uid])[:4]
        np.testing.assert_array_equal(items[b].numpy(), order)
        np.testing.assert_allclose(scores[b].numpy(), brute[uid][order],
                                   rtol=1e-4, atol=1e-5)


def test_top_k_explicit_target_mode(tiny):
    jp, params, dense, _ = tiny
    srv = TuckerServer(params)
    scores, items = srv.top_k(2, [1, 3], k=3, target_mode=0)
    js, ji = JServer(jp).top_k(2, [1, 3], k=3, target_mode=0)
    np.testing.assert_array_equal(items.numpy(), np.asarray(ji))
    _close(scores.numpy(), np.asarray(js))
    brute = dense.sum(axis=1).T                     # (I_3, I_1)
    for b, cid in enumerate([1, 3]):
        order = np.argsort(-brute[cid])[:3]
        np.testing.assert_array_equal(items[b].numpy(), order)
        np.testing.assert_allclose(scores[b].numpy(), brute[cid][order],
                                   rtol=1e-4, atol=1e-5)


def test_top_k_marginalizes_multiple_modes():
    dims = (5, 4, 3, 3)
    jp = _jparams(dims, ranks=(2, 3, 2, 2), core_rank=2, seed=5)
    params = _tparams(jp)
    dense = _np(dense_reconstruct(params.factors, params.core_factors))
    scores, items = TuckerServer(params).top_k(0, [4], k=2)  # sums 2 AND 3
    js, ji = JServer(jp).top_k(0, [4], k=2)
    np.testing.assert_array_equal(items.numpy(), np.asarray(ji))
    _close(scores.numpy(), np.asarray(js))
    brute = dense.sum(axis=(2, 3))
    order = np.argsort(-brute[4])[:2]
    np.testing.assert_array_equal(items[0].numpy(), order)


def test_top_k_ties_come_in_ascending_id():
    """Planted exact ties (integer factors: every score is an exact integer
    in f32, whatever the summation order) come back in ascending id, as
    the reference's ``lax.top_k`` gives them."""
    A0 = np.array([[1, 2], [2, 1], [0, 3]], np.float32)
    # mode-1 rows: 7, 2, 5 and 9 tie at the top; 0 and 4 tie below
    A1 = np.zeros((10, 2), np.float32)
    A1[[7, 2, 5, 9]] = [3, 3]
    A1[[0, 4]] = [1, 2]
    A1[[1, 3, 6, 8]] = [1, 1]
    A2 = np.array([[1, 1], [2, 0], [0, 1], [1, 2]], np.float32)
    eye = np.eye(2, dtype=np.float32)

    class P:
        factors = (A0, A1, A2)
        core_factors = (eye, eye, eye)

    jp = jft.FastTuckerParams(tuple(jnp.asarray(a) for a in P.factors),
                              tuple(jnp.asarray(b) for b in P.core_factors))
    for backend in BACKENDS:
        srv = TuckerServer(ft.params_from_numpy(P, device="cpu"),
                           backend=backend)
        scores, items = srv.top_k(0, [0, 1, 2], k=7)
        for row in items.numpy():
            assert row[:4].tolist() == [2, 5, 7, 9]
            assert row[4:].tolist() == [0, 4, 1]
        js, ji = JServer(jp).top_k(0, [0, 1, 2], k=7)
        np.testing.assert_array_equal(items.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(scores.numpy(), np.asarray(js))


def test_top_k_validates_args(tiny):
    srv = TuckerServer(tiny[1])
    with pytest.raises(ValueError, match="differ"):
        srv.top_k(1, [0], k=2, target_mode=1)
    with pytest.raises(ValueError, match="k="):
        srv.top_k(0, [0], k=99)
    with pytest.raises(ValueError, match="mode"):
        srv.top_k(7, [0], k=1)


@pytest.mark.parametrize("jbackend", ["xla", "pallas_interpret"])
def test_reconstruct_rows_matches_reference_and_dense(tiny, jbackend):
    jp, params, dense, _ = tiny
    srv = TuckerServer(params)
    jsrv = JServer(jp, backend=jbackend)
    for mode, ids in ((0, [0, 4]), (1, [5]), (2, [0, 1, 2])):
        got = srv.reconstruct_rows(mode, ids).numpy()
        want = np.moveaxis(dense, mode, 0)[np.asarray(ids)]
        assert got.shape == want.shape
        _close(got, want)
        _close(got, np.asarray(jsrv.reconstruct_rows(mode, ids)))


# ---------------------------------------------------------------------------
# the tables: one row function for build and patch
# ---------------------------------------------------------------------------

def test_mode_products_are_the_cached_tables(tiny):
    _, params, _, _ = tiny
    srv = TuckerServer(params)
    for c, t in zip(mode_products(params.factors, params.core_factors),
                    srv._tables):
        np.testing.assert_array_equal(c.numpy(), t.numpy())


def test_table_rows_do_not_depend_on_the_row_count():
    """Any subset of rows, in any order and count, gives each row the bits
    the whole table gives it (a matmul does not promise that), within
    1e-6 of a float64 product."""
    rng = np.random.default_rng(0)
    for J, R in ((4, 4), (7, 5), (64, 64)):
        a = torch.from_numpy(rng.standard_normal((3001, J))
                             .astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((J, R)).astype(np.float32))
        full = mode_product_rows(a, b)
        for m in (1, 2, 7, 16, 1000):
            ids = torch.from_numpy(rng.permutation(3001)[:m])
            np.testing.assert_array_equal(
                mode_product_rows(a[ids], b).numpy(), full[ids].numpy())
        want = a.double().numpy() @ b.double().numpy()
        _close(full.numpy(), want, rel=1e-6)


# ---------------------------------------------------------------------------
# online refresh: the row patch, the rebuild, the versioned swap
# ---------------------------------------------------------------------------

RDIMS = (40, 30, 20)


def _rparams(seed=0):
    return _jparams(RDIMS, ranks=(4, 3, 2), core_rank=3, seed=seed)


@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
def test_update_rows_matches_full_rebuild(table_dtype):
    """A chain of row patches across all modes lands on the tables a fresh
    server built from the final params stores — bitwise for f32 — and
    within 1e-5 of the reference's patched server."""
    jp = _rparams()
    params = _tparams(jp)
    srv = TuckerServer(params, table_dtype=table_dtype)
    jsrv = JServer(jp)
    rng = np.random.default_rng(1)
    facs = [np.array(f) for f in jp.factors]
    v0 = srv.table_version
    for it in range(6):
        mode = it % 3
        f = int(rng.integers(1, srv.dims[mode] + 1))
        ids = np.sort(rng.permutation(srv.dims[mode])[:f]).astype(np.int32)
        new = rng.standard_normal((f, facs[mode].shape[1])) \
            .astype(np.float32)
        facs[mode][ids] = new
        assert srv.update_rows(mode, ids, new) == v0 + it + 1
        jsrv.update_rows(mode, ids, new)
    # the caller's params are never written
    for f, j in zip(params.factors, jp.factors):
        np.testing.assert_array_equal(f.numpy(), np.asarray(j))

    class P:
        factors = facs
        core_factors = jp.core_factors

    ref = TuckerServer(ft.params_from_numpy(P, device="cpu"),
                       table_dtype=table_dtype)
    exact = srv.table_dtype == torch.float32
    for n in range(3):
        a, b = _np(srv._tables[n]), _np(ref._tables[n])
        if exact:
            np.testing.assert_array_equal(a, b)
            _close(a, np.asarray(jsrv._tables[n]))
        else:
            np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05)
        # colsums are incrementally maintained f32 — allclose, not bitwise
        np.testing.assert_allclose(_np(srv._colsums[n]),
                                   _np(ref._colsums[n]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(_np(srv.params.factors[n]), facs[n])

    # query parity through every entry point
    rng2 = np.random.default_rng(2)
    q = np.stack([rng2.integers(0, d, 23) for d in srv.dims], 1) \
        .astype(np.int32)
    np.testing.assert_array_equal(_np(srv.predict(q)), _np(ref.predict(q)))
    s0, i0 = srv.top_k(0, np.arange(10, dtype=np.int32), 4)
    s1, i1 = ref.top_k(0, np.arange(10, dtype=np.int32), 4)
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    np.testing.assert_allclose(s0.numpy(), s1.numpy(), rtol=1e-5, atol=1e-5)


def test_refresh_tables_flushes_to_exact_rebuild():
    params = _tparams(_rparams(seed=3))
    srv = TuckerServer(params)
    rng = np.random.default_rng(4)
    ids = np.sort(rng.permutation(RDIMS[0])[:7]).astype(np.int32)
    srv.update_rows(0, ids, rng.standard_normal((7, 4)).astype(np.float32))
    v = srv.table_version
    assert srv.refresh_tables() == v + 1
    ref = TuckerServer(srv.params)
    for n in range(3):
        np.testing.assert_array_equal(srv._tables[n].numpy(),
                                      ref._tables[n].numpy())
        np.testing.assert_array_equal(srv._colsums[n].numpy(),
                                      ref._colsums[n].numpy())


def test_update_rows_validates():
    srv = TuckerServer(_tparams(_rparams()))
    J = 4
    with pytest.raises(ValueError, match="unique"):
        srv.update_rows(0, [1, 1], np.zeros((2, J), np.float32))
    with pytest.raises(ValueError, match="factor_rows"):
        srv.update_rows(0, [1], np.zeros((2, J), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        srv.update_rows(0, [RDIMS[0]], np.zeros((1, J), np.float32))
    with pytest.raises(ValueError, match="mode"):
        srv.update_rows(5, [0], np.zeros((1, J), np.float32))
    v = srv.table_version
    assert srv.update_rows(0, np.zeros(0, np.int32),
                           np.zeros((0, J), np.float32)) == v
    # rows may come as a tensor, as the refresh supervisor passes them
    assert srv.update_rows(0, [3], torch.ones((1, J))) == v + 1


def test_swap_preserves_inflight_generation():
    """A query that snapshotted generation G answers entirely from G's
    tensors even when patches land mid-flight — the old tables are never
    written, only superseded."""
    srv = TuckerServer(_tparams(_rparams(seed=5)))
    rng = np.random.default_rng(6)
    q = np.stack([rng.integers(0, d, 17) for d in srv.dims], 1) \
        .astype(np.int32)
    before = srv.predict(q).numpy().copy()
    snapshot = srv._live                     # what an in-flight query holds
    frozen = [t.numpy().copy() for t in snapshot.tables]
    ids = np.sort(rng.permutation(RDIMS[0])[:9]).astype(np.int32)
    srv.update_rows(0, ids, rng.standard_normal((9, 4)).astype(np.float32))
    for t, f in zip(snapshot.tables, frozen):
        np.testing.assert_array_equal(t.numpy(), f)
    assert srv._live.version == snapshot.version + 1
    assert not np.array_equal(srv._tables[0].numpy(), frozen[0])
    np.testing.assert_array_equal(srv._predict_from(snapshot, q).numpy(),
                                  before)


# ---------------------------------------------------------------------------
# the online refresh step
# ---------------------------------------------------------------------------

def _refresh_problem(dims=(18, 15, 12), nnz=900):
    return planted_tensor(dims, nnz, noise=0.05, seed=0, device="cpu")


def _rcfg(dims=(18, 15, 12), **kw):
    return ft.FastTuckerConfig(dims=dims, ranks=(3,) * 3, core_rank=3,
                               batch_size=64, **kw)


@pytest.mark.parametrize("sorted_batches", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_step_batch_matches_reference(backend, sorted_batches):
    """One fed-batch refresh step against the reference's
    ``factor_phase_gradients`` + ``_apply_updates(update_core=False)`` on
    the same batch (within 1e-5 relative); the dirty rows are exactly the
    batch's ids."""
    t = _refresh_problem()
    idx, val = t.indices.numpy(), t.values.numpy()
    rng = np.random.default_rng(3)
    pick = rng.integers(0, len(val), 64)
    bi, bv = idx[pick], val[pick]
    jcfg = jft.FastTuckerConfig(dims=t.dims, ranks=(3,) * 3, core_rank=3,
                                batch_size=64,
                                sorted_batches=sorted_batches)
    jp = jft.init_params(jax.random.PRNGKey(2), jcfg)
    step = 7
    lr_a = jft.dynamic_lr(jcfg.alpha_a, jcfg.beta_a, jnp.asarray(step))
    layout = jft.batch_layout(jnp.asarray(bi), jcfg)
    fg, _ = jft.factor_phase_gradients(
        jp, jnp.asarray(bi), jnp.asarray(bv), jcfg.lambda_a, jcfg.lambda_b,
        layout=layout)
    want = jft._apply_updates(jp, jnp.asarray(bi), fg, lr_a,
                              jnp.asarray(0.0), update_factors=True,
                              update_core=False, layout=layout)

    cfg = _rcfg(backend=backend, sorted_batches=sorted_batches)
    dirty = tuple(torch.zeros(d, dtype=torch.bool) for d in t.dims)
    st = ft.refresh_step_batch(ft.TrainState(_tparams(jp), step),
                               torch.from_numpy(bi), torch.from_numpy(bv),
                               cfg, dirty)
    assert st.step == step + 1
    for got, w in zip(st.params.factors, want.factors):
        _close(got.numpy(), np.asarray(w))
    for got, w in zip(st.params.core_factors, jp.core_factors):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    for n, m in enumerate(dirty):
        np.testing.assert_array_equal(np.nonzero(m.numpy())[0],
                                      np.unique(bi[:, n]))


def test_refresh_steps_dirty_rows_cover_changes():
    t = _refresh_problem()
    cfg = _rcfg(backend="torch")
    gen = torch.Generator().manual_seed(0)
    state = ft.init_state(gen, cfg, "cpu")
    before = [f.clone() for f in state.params.factors]
    state2, dirty = ft.refresh_steps(state, gen, t.indices, t.values, cfg,
                                     num_steps=5)
    assert state2.step == state.step + 5
    assert len(dirty) == 3
    for n in range(3):
        ids = dirty[n]
        assert ids.dtype == np.int32
        assert (np.diff(ids) > 0).all()          # sorted, unique
        assert ids.size and ids.min() >= 0 and ids.max() < cfg.dims[n]
        changed = np.nonzero(
            (state2.params.factors[n] != before[n]).any(1).numpy())[0]
        assert np.isin(changed, ids).all()
        # rows outside the dirty set are untouched, bit for bit
        keep = np.setdiff1d(np.arange(cfg.dims[n]), ids)
        np.testing.assert_array_equal(state2.params.factors[n][keep].numpy(),
                                      before[n][keep].numpy())
        np.testing.assert_array_equal(state2.params.core_factors[n].numpy(),
                                      state.params.core_factors[n].numpy())
    with pytest.raises(ValueError, match="num_steps"):
        ft.refresh_steps(state, gen, t.indices, t.values, cfg, num_steps=0)


def test_strategy_refresh_steps_local():
    """The strategy face: K steps advance, dirty rows cover the factor
    changes, the batches come from (and advance) ``dstate.rng``, a refresh
    repeated from the same state repeats its bits, and the refreshed state
    slots back into the training loop."""
    t = _refresh_problem()
    st = get_strategy("local")
    cfg = _rcfg(backend="cuda")
    plan = st.prepare(t, cfg, None, seed=0)
    gen = torch.Generator().manual_seed(0)
    ds = st.init(plan, ft.init_state(gen, cfg, "cpu"), gen)
    step = st.make_step(plan)
    for _ in range(3):
        ds = step(ds)
    before = [f.clone() for f in st.eval_params(plan, ds).factors]
    win_i, win_v = t.indices.numpy()[-200:], t.values.numpy()[-200:]
    ds2, dirty = st.refresh_steps(plan, ds, win_i, win_v, num_steps=4)
    assert ds2.step == ds.step + 4
    assert not torch.equal(ds2.rng, ds.rng)
    params = st.eval_params(plan, ds2)
    for n in range(3):
        changed = np.nonzero((params.factors[n] != before[n]).any(1)
                             .numpy())[0]
        assert np.isin(changed, dirty[n]).all()
    # the same draws from the same state: the same bits
    ds3, dirty3 = st.refresh_steps(plan, ds, win_i, win_v, num_steps=4)
    for a, b in zip(ds2.params.factors, ds3.params.factors):
        assert torch.equal(a, b)
    assert torch.equal(ds2.rng, ds3.rng)
    for a, b in zip(dirty, dirty3):
        np.testing.assert_array_equal(a, b)
    # ... which are the core refresh's, from a generator at dstate.rng
    g = torch.Generator()
    g.set_state(ds.rng)
    want, _ = ft.refresh_steps(ft.TrainState(ds.params, ds.step), g,
                               torch.from_numpy(win_i),
                               torch.from_numpy(win_v), cfg, 4)
    for a, b in zip(ds2.params.factors, want.params.factors):
        assert torch.equal(a, b)
    ds4 = step(ds2)
    assert ds4.step == ds2.step + 1


# ---------------------------------------------------------------------------
# checkpoint → serve round trip (std_train --ckpt-dir)
# ---------------------------------------------------------------------------

def _std_train(tmp_path, *flags):
    return std_train.main([
        "--dims", "18,15,12", "--nnz", "2500", "--rank", "3",
        "--core-rank", "3", "--steps", "40", "--batch", "128",
        "--eval-every", "40", "--device", "cpu", "--backend", "torch",
        "--ckpt-dir", str(tmp_path / "ck"), *flags])


@pytest.mark.parametrize("flags", [(), ("--compress",),
                                   ("--dtype", "bfloat16")])
def test_checkpoint_serve_round_trip(tmp_path, flags):
    """What ``std_train --ckpt-dir`` writes (a ``DistState`` with its
    ``rng`` leaf, and ``ef`` residuals under ``--compress``) loads back as
    the trained params, bit for bit in their stored dtype, and serves what
    the in-memory params serve."""
    res = _std_train(tmp_path, *flags)
    dims = (18, 15, 12)
    loaded, step = load_params_from_checkpoint(tmp_path / "ck", dims=dims,
                                               device="cpu")
    assert step == 40
    want = res["state"].params
    for a, b in zip(want.factors + want.core_factors,
                    loaded.factors + loaded.core_factors):
        assert a.dtype == b.dtype and torch.equal(a, b)
    srv = TuckerServer.from_checkpoint(tmp_path / "ck", dims=dims,
                                       device="cpu")
    assert srv.table_dtype == want.factors[0].dtype   # bf16 serves bf16
    idx = res["test"].indices[:256]
    served = _np(srv.predict(idx.numpy()))
    np.testing.assert_array_equal(served,
                                  _np(TuckerServer(want).predict(idx)))
    if srv.table_dtype == torch.float32:
        np.testing.assert_allclose(
            served, _np(ft.predict(want, idx, "torch")), rtol=1e-6,
            atol=1e-6)


def test_checkpoint_loader_trims_and_rejects(tmp_path):
    _std_train(tmp_path)
    loaded, _ = load_params_from_checkpoint(tmp_path / "ck", dims=(10, 15, 12),
                                            device="cpu")
    assert loaded.factors[0].shape == (10, 3)
    with pytest.raises(ValueError, match="exceeds"):
        load_params_from_checkpoint(tmp_path / "ck", dims=(19, 15, 12),
                                    device="cpu")
    with pytest.raises(ValueError, match="modes"):
        load_params_from_checkpoint(tmp_path / "ck", dims=(18, 15),
                                    device="cpu")
    ckpt = CheckpointManager(tmp_path / "lm")
    ckpt.save(0, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError, match="FastTucker"):
        load_params_from_checkpoint(tmp_path / "lm", device="cpu")


# ---------------------------------------------------------------------------
# construction refusals
# ---------------------------------------------------------------------------

def test_server_validates_params(tiny):
    params = tiny[1]
    bad = ft.FastTuckerParams(params.factors, params.core_factors[:-1])
    with pytest.raises(ValueError):
        TuckerServer(bad)
    with pytest.raises(KeyError):
        TuckerServer(params, backend="not_a_backend")
    with pytest.raises(ValueError, match="table_dtype"):
        TuckerServer(params, table_dtype="float16")


def test_mesh_not_ported(tiny):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        TuckerServer(tiny[1], mesh=object())


def test_table_rank_above_the_kernel_width_refused():
    """The ``"cuda"`` backend serves R ≤ 64 (``kruskal_contract``'s
    ``MAX_WIDTH``); a wider table raises the kernel's ``ValueError`` at
    construction, wherever the params live, and is never served on the
    plain version.  The ``"torch"`` backend takes it."""
    rng = np.random.default_rng(0)

    class P:
        factors = tuple(rng.standard_normal((d, 4)).astype(np.float32)
                        for d in (5, 4, 3))
        core_factors = tuple(rng.standard_normal((4, 65)).astype(np.float32)
                             for _ in range(3))

    params = ft.params_from_numpy(P, device="cpu")
    with pytest.raises(ValueError, match=r"kruskal_contract.*R=65"):
        TuckerServer(params, backend="cuda")
    srv = TuckerServer(params, backend="torch")
    assert srv.predict(np.zeros((2, 3), np.int32)).shape == (2,)


# ---------------------------------------------------------------------------
# the serve_tucker CLI
# ---------------------------------------------------------------------------

CLI = ["--dims", "24,18,12", "--nnz", "1200", "--train-steps", "5",
       "--batch", "128", "--rank", "4", "--core-rank", "4",
       "--max-request", "8", "--microbatch", "32", "--device", "cpu"]


def test_serve_tucker_cli_requests(tmp_path):
    """``--requests``: trains into an empty ``--ckpt-dir``, serves, and a
    second run loads the checkpoint and serves the same model."""
    args = CLI + ["--requests", "20", "--ckpt-dir", str(tmp_path / "ck")]
    rep = serve_tucker.main(args)
    assert rep["served_queries"] > 0 and rep["flushes"] > 0
    assert np.isfinite(rep["rmse"])
    assert np.isfinite(np.asarray(rep["top_k"]["scores"])).all()
    assert CheckpointManager(tmp_path / "ck").latest_step() == 5
    again = serve_tucker.main(args)
    assert again["rmse"] == rep["rmse"]
    assert again["top_k"] == rep["top_k"]


def test_serve_tucker_cli_closed_loop(capsys):
    """``--qps``: the closed-loop front end, with the JSON report printed;
    every admitted request answered."""
    import json

    rep = serve_tucker.main(CLI + ["--qps", "400", "--duration", "0.5",
                                   "--concurrency", "4"])
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):]) == rep
    assert rep["served_requests"] > 0 and rep["achieved_qps"] > 0
    assert rep["served_requests"] == rep["requests"] - rep["shed_queue_full"]


def test_serving_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """Without CUDA and without ``--device cpu`` / ``device="cpu"`` the
    serving entry points raise; they never carry on on the CPU unasked."""
    _std_train(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_tucker.main([a for a in CLI if a not in ("--device", "cpu")]
                          + ["--requests", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_params_from_checkpoint(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TuckerServer.from_checkpoint(tmp_path / "ck")
