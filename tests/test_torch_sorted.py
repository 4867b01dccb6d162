"""The port's mode-sorted batches against the live JAX reference, on the CPU.

* ``sorted_batch_layout``: bitwise equal to the reference's, negative ids
  included; the step's ``sorted_batch_order`` is its first two fields.
* The dedup gather through the layout's ``uniq``/``inv``: bitwise equal to
  the plain gather that the sorted step uses, and to the reference's.
* ``segment_reduce``: on both port backends and through the kernel wrapper
  (its plain path on CPU tensors), bitwise equal to the reference's Pallas
  kernel in interpret mode and to its ``segment_reduce_ref``, ids out of
  range included; and bitwise equal to the port's own unsorted
  ``scatter_accum`` on ``"torch"``.
* The sorted step equals the unsorted one bitwise on ``"torch"`` and on
  ``"cuda"``'s CPU path, for both orders and both step forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fasttucker as jft
from repro.core.sampling import sorted_batch_layout as j_layout
from repro.kernels import ref as jref
from repro.kernels.segment_reduce import segment_reduce as j_segment_reduce
from repro_torch.core import fasttucker as ft
from repro_torch.core.sampling import (epoch_permutation_batches,
                                       sorted_batch_layout,
                                       sorted_batch_order)
from repro_torch.kernels import (dispatch, launch_counts, reset_launch_counts,
                                 segment_reduce)

DIMS = (60, 50, 40)
RANKS = (4, 5, 6)
R = 4
BATCH = 256


@pytest.mark.parametrize("B,N,lo,hi", [(64, 3, -2, 12), (256, 3, 0, 60),
                                       (1, 2, 0, 5), (300, 4, -5, 3)])
def test_layout_bitwise_vs_reference(B, N, lo, hi):
    rng = np.random.default_rng(B + N)
    idx = rng.integers(lo, hi, (B, N)).astype(np.int32)  # negatives too
    got = sorted_batch_layout(torch.tensor(idx))
    want = j_layout(jnp.asarray(idx))
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.seg_starts.shape == (N, B + 1) and got.num_uniq.shape == (N,)
    order = sorted_batch_order(torch.tensor(idx))
    for n in range(N):
        assert torch.equal(order.perm[n].to(torch.int32), got.perm[n])
        assert order.sorted_rows[n].dtype == torch.int32
        assert torch.equal(order.sorted_rows[n], got.sorted_rows[n])


def test_epoch_permutation_batches_cover_every_nonzero():
    gen = torch.Generator().manual_seed(0)
    batches = epoch_permutation_batches(gen, 1000, 128)
    assert batches.shape == (8, 128) and batches.dtype == torch.int32
    flat = batches.flatten()
    assert sorted(flat[:1000].tolist()) == list(range(1000))
    assert torch.equal(flat[1000:], flat[:24])  # padded with its own head


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dedup_gather_bitwise(dtype):
    rng = np.random.default_rng(4)
    jcfg = jft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                                dtype=dtype)
    jparams = jft.init_params(jax.random.PRNGKey(0), jcfg)
    idx = np.stack([rng.integers(0, d, BATCH) for d in DIMS], 1).astype(
        np.int32)
    params = ft.params_from_numpy(jparams, "cpu", dtype)
    lay = sorted_batch_layout(torch.tensor(idx))
    plain = ft.gather_rows(params.factors, torch.tensor(idx))
    want = jft.gather_rows(jparams.factors, jnp.asarray(idx),
                           j_layout(jnp.asarray(idx)))
    for f, uniq, inv, p, w in zip(params.factors, lay.uniq, lay.inv, plain,
                                  want):
        dedup = f.index_select(0, uniq).index_select(0, inv)
        assert p.dtype == dedup.dtype == ft.DTYPES[dtype]
        assert torch.equal(p, dedup)
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("B,J,rows", [(4096, 8, 1000), (513, 8, 100),
                                      (64, 4, 1000), (100, 32, 64),
                                      (7, 3, 5), (2000, 4, 3)])
def test_segment_reduce_bitwise_vs_reference(B, J, rows):
    rng = np.random.default_rng(B + J)
    idx = rng.integers(-2, rows + 3, B).astype(np.int32)  # OOB both sides
    order = np.argsort(idx, kind="stable")
    g = rng.normal(size=(B, J)).astype(np.float32)
    gs, ids = g[order], idx[order]
    want = np.asarray(j_segment_reduce(jnp.asarray(gs), jnp.asarray(ids),
                                       rows, block_b=128, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jref.segment_reduce_ref(jnp.asarray(gs),
                                                 jnp.asarray(ids), rows)))
    reset_launch_counts()
    for got in (dispatch.get_backend("torch").segment_reduce(
                    torch.tensor(gs), torch.tensor(ids), rows),
                dispatch.get_backend("cuda").segment_reduce(
                    torch.tensor(gs), torch.tensor(ids), rows),
                segment_reduce.segment_reduce(torch.tensor(gs),
                                              torch.tensor(ids), rows)):
        assert got.shape == (rows, J) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert launch_counts()["segment_reduce"] == 0  # CPU: the plain path


def test_segment_reduce_bitwise_vs_unsorted_scatter_on_torch():
    bk = dispatch.get_backend("torch")
    rng = np.random.default_rng(3)
    idx = torch.tensor(rng.integers(-1, 50, 2048).astype(np.int32))
    g = torch.tensor(rng.normal(size=(2048, 8)).astype(np.float32))
    sorted_idx, order = torch.sort(idx, stable=True)
    u = bk.scatter_accum(g, idx, 50)
    s = bk.segment_reduce(g[order], sorted_idx, 50)
    assert torch.equal(u, s)


def _port_run(params0, batches, backend, **kw):
    cfg = ft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                              batch_size=BATCH, backend=backend, **kw)
    state = ft.TrainState(params0, 0)
    for idx, val in batches:
        state = ft.sgd_step_batch(state, idx, val, cfg)
    return state.params


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("order", ["jacobi", "gauss_seidel"])
@pytest.mark.parametrize("phase_split", [False, True])
def test_sorted_step_bitwise_equals_unsorted(backend, order, phase_split):
    rng = np.random.default_rng(8)
    cfg = ft.FastTuckerConfig(dims=DIMS, ranks=RANKS, core_rank=R,
                              backend="torch")
    params0 = ft.init_params(torch.Generator().manual_seed(2), cfg, "cpu")
    batches = [(torch.tensor(np.stack([rng.integers(0, d, BATCH)
                                       for d in DIMS], 1).astype(np.int32)),
                torch.tensor(rng.normal(size=BATCH).astype(np.float32)))
               for _ in range(5)]
    kw = dict(update_order=order, phase_split=phase_split)
    a = _port_run(params0, batches, backend, **kw)
    b = _port_run(params0, batches, backend, sorted_batches=True, **kw)
    for x, y, p in zip(a.factors + a.core_factors, b.factors + b.core_factors,
                       params0.factors + params0.core_factors):
        assert not torch.equal(x, p)  # it moved
        assert torch.equal(x, y)
