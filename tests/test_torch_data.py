"""The port's data layer against the live reference, on the CPU.

* ``core.sptensor``: ``SparseTensor.order/density/to_dense/from_dense``,
  ``BlockPartition`` (digits, strata, ``assign``) for M ∈ {1, 2, 3, 4} and
  N ∈ {3, 4}, and ``partition_for_workers``' padded buckets, each equal to
  ``repro.core.sptensor``'s on the same numpy inputs.
* ``data.pipeline.TensorStream.picks`` bitwise the reference's.
* ``NonzeroStore``: ``build`` and ``append`` (M ∈ {1, 4}, ``chunk_nnz``
  101) array for array the reference's; the counting pass a tensor's
  build takes on its device (M ∈ {1, 2, 3, 4}, N ∈ {3, 4}) giving the
  reference's bucket sizes and store; the in-place and growth paths; the
  spill round trip and snapshot; a crash midway through growth leaving the
  pre-append store; validation; a spill directory written by either
  package opened by the other.
* ``StratumPrefetcher``: the reference's contracts
  (``tests/test_online_refresh.py`` and ``tests/test_out_of_core.py``) on
  the port's object with ``device="cpu"``; every take is bounded by a
  timeout and every worker thread is joined.
"""
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import sptensor as jsp
from repro.data import pipeline as jpipe
from repro.data.synthetic import planted_tensor as j_planted
from repro_torch.core.sptensor import (BlockPartition, SparseTensor,
                                       partition_for_workers)
from repro_torch.data import (NonzeroStore, StratumPrefetcher, TensorStream,
                              planted_tensor)
from repro_torch.data.pipeline import _tensor_bucket_counts

FIELDS = ("indices", "values", "mask")
TAKE_S = 10.0          # no take may wait longer for the worker


def _arrays(dims, nnz, seed):
    t = j_planted(dims, nnz, seed=seed)
    return np.asarray(t.indices), np.asarray(t.values)


def _jt(idx, val, dims):
    return jsp.SparseTensor(jnp.asarray(idx), jnp.asarray(val), tuple(dims))


def _tt(idx, val, dims):
    return SparseTensor.from_numpy(idx, val, dims, device="cpu")


def _same_store(a, b):
    assert a.meta == b.meta
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(autouse=True)
def _no_stray_prefetch_threads():
    yield
    alive = [t for t in threading.enumerate()
             if t.name == "stratum-prefetch" and t.is_alive()]
    for t in alive:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in alive), "a prefetch worker hangs"


# ---------------------------------------------------------------------------
# SparseTensor and the Section 5.3 partition
# ---------------------------------------------------------------------------

def test_sparse_tensor_properties_and_dense_round_trip():
    dims = (7, 5, 4)
    idx, val = _arrays(dims, 60, 3)
    ours, ref = _tt(idx, val, dims), _jt(idx, val, dims)
    assert ours.order == ref.order == 3
    assert ours.density == ref.density
    np.testing.assert_array_equal(ours.to_dense().numpy(),
                                  np.asarray(ref.to_dense()))
    dense = np.array(ref.to_dense())
    back, jback = SparseTensor.from_dense(dense, device="cpu"), \
        jsp.SparseTensor.from_dense(dense)
    np.testing.assert_array_equal(back.indices.numpy(),
                                  np.asarray(jback.indices))
    np.testing.assert_array_equal(back.values.numpy(),
                                  np.asarray(jback.values))
    assert back.dims == jback.dims
    # a tensor argument and a threshold take the same entries
    thr = SparseTensor.from_dense(torch.from_numpy(dense), threshold=0.5,
                                  device="cpu")
    jthr = jsp.SparseTensor.from_dense(dense, threshold=0.5)
    np.testing.assert_array_equal(thr.indices.numpy(),
                                  np.asarray(jthr.indices))


@pytest.mark.parametrize("N", [3, 4])
@pytest.mark.parametrize("M", [1, 2, 3, 4])
def test_block_partition_matches_reference(M, N):
    rng = np.random.default_rng(M * 10 + N)
    dims = tuple(int(d) for d in rng.integers(M, 9 * M, size=N))
    ours, ref = BlockPartition(dims, M), jsp.BlockPartition(dims, M)
    assert ours.order == ref.order
    for n in range(N):
        np.testing.assert_array_equal(ours.mode_boundaries(n),
                                      ref.mode_boundaries(n))
    idx = np.stack([rng.integers(0, d, 500) for d in dims], 1)
    np.testing.assert_array_equal(ours.block_of(idx), ref.block_of(idx))
    np.testing.assert_array_equal(ours.strata(), ref.strata())
    for a, b in zip(ours.assign(idx), ref.assign(idx)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the epoch schedule follows the reference's digit convention: a cover
    # of every stratum once, whose digits give each worker the blocks
    # strata() lists (tests/test_strategies.py:90-110); the permutation
    # comes from PyTorch's stream, the reference's from threefry
    from repro.core.sampling import stratum_digits as j_digits
    from repro_torch.core.sampling import stratum_digits

    sched = ours.epoch_schedule(0)
    assert sched.dtype == np.int64
    assert sorted(sched.tolist()) == list(range(M ** (N - 1)))
    assert np.array_equal(sched, ours.epoch_schedule(0))
    digits = stratum_digits(sched, M, N)
    np.testing.assert_array_equal(digits, np.asarray(j_digits(sched, M, N)))
    blocks = (np.arange(M)[None, :, None] + digits[:, None, :]) % M
    np.testing.assert_array_equal(blocks, ours.strata()[sched])


@pytest.mark.parametrize("dims,M,pad", [((18, 15, 12), 1, 8),
                                        ((18, 15, 12), 3, 8),
                                        ((12, 9, 8, 6), 2, 4),
                                        ((12, 9, 8, 6), 4, 8)])
def test_partition_for_workers_matches_reference(dims, M, pad):
    idx, val = _arrays(dims, 900, 4)
    ours = partition_for_workers(_tt(idx, val, dims), M, pad_multiple=pad)
    ref = jsp.partition_for_workers(_jt(idx, val, dims), M,
                                    pad_multiple=pad)
    for f in FIELDS:
        assert isinstance(ours[f], torch.Tensor)
        np.testing.assert_array_equal(ours[f].numpy(), np.asarray(ref[f]))
    assert ours["partition"] == BlockPartition(dims, M)


def test_partition_for_workers_empty_tensor():
    dims = (6, 5, 4)
    empty = (np.zeros((0, 3), np.int32), np.zeros(0, np.float32))
    ours = partition_for_workers(_tt(*empty, dims), 2)
    ref = jsp.partition_for_workers(_jt(*empty, dims), 2)
    for f in FIELDS:
        np.testing.assert_array_equal(ours[f].numpy(), np.asarray(ref[f]))


# ---------------------------------------------------------------------------
# TensorStream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (1, 2, 4),
                                                   (7, 3, 8)])
def test_tensor_stream_picks_bitwise(seed, shard, num_shards):
    ours = TensorStream(50_000, 256, seed=seed, shard=shard,
                        num_shards=num_shards)
    ref = jpipe.TensorStream(50_000, 256, seed=seed, shard=shard,
                             num_shards=num_shards)
    for step in (0, 1, 5, 1000):
        a, b = ours.picks(step), ref.picks(step)
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# NonzeroStore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 4])
def test_store_build_and_append_match_reference(M):
    dims = (18, 15, 12)
    idx, val = _arrays(dims, 2000, 0)
    base_i, base_v, new_i, new_v = idx[:-600], val[:-600], idx[-600:], \
        val[-600:]
    ours = NonzeroStore.build(_tt(base_i, base_v, dims), M, chunk_nnz=101)
    ref = jpipe.NonzeroStore.build(_jt(base_i, base_v, dims), M,
                                   chunk_nnz=101)
    _same_store(ours, ref)
    # a host triple builds the same store
    _same_store(NonzeroStore.build((base_i, base_v, dims), M), ref)
    out = ours.append(new_i, new_v, chunk_nnz=101)
    jout = ref.append(new_i, new_v, chunk_nnz=101)
    _same_store(out, jout)
    _same_store(out, jpipe.NonzeroStore.build(_jt(idx, val, dims), M))
    assert out.nnz == len(val) and out.num_workers == M
    assert out.num_strata == M ** 2 and out.order == 3


@pytest.mark.parametrize("M", [1, 2, 3, 4])
@pytest.mark.parametrize("dims", [(18, 15, 12), (11, 9, 8, 7)])
def test_store_tensor_count_pass_matches_reference(dims, M):
    """The counting pass over an index tensor (the pass a tensor on the
    card takes, on its device) gives the reference's bucket sizes, so a
    store built from a tensor is the reference's, meta and arrays."""
    idx, val = _arrays(dims, 1500, 1)
    ref = jpipe.NonzeroStore.build(_jt(idx, val, dims), M, chunk_nnz=101)
    padded = tuple(ref.meta["padded_dims"])
    stratum, worker = jsp.BlockPartition(padded, M).assign(idx)
    want = np.bincount(np.asarray(stratum) * M + np.asarray(worker),
                       minlength=M ** len(dims))
    got = _tensor_bucket_counts(BlockPartition(padded, M),
                                torch.tensor(idx), 101)
    np.testing.assert_array_equal(got, want)
    _same_store(NonzeroStore.build(_tt(idx, val, dims), M, chunk_nnz=101),
                ref)


@pytest.mark.parametrize("M", [1, 3, 4])
def test_store_layout_is_partition_for_workers(M):
    t = planted_tensor((18, 15, 12), 2500, seed=0, device="cpu")
    padded = tuple(-(-d // M) * M for d in t.dims)
    buckets = partition_for_workers(SparseTensor(t.indices, t.values,
                                                 padded), M)
    store = NonzeroStore.build(t, M, chunk_nnz=137)
    for f in FIELDS:
        np.testing.assert_array_equal(buckets[f].numpy(), getattr(store, f))
    np.testing.assert_array_equal(
        store.fill(), store.mask.reshape(M ** 3, -1).sum(1))


def test_append_in_place_vs_growth():
    dims = (14, 11, 9)
    idx, val = _arrays(dims, 1200, 2)
    store = NonzeroStore.build((idx, val, dims), 2)
    ref = jpipe.NonzeroStore.build(_jt(idx, val, dims), 2)
    L0 = store.chunk_len
    # a single entry fits in the existing padding → patched in place
    one = np.array([[1, 2, 3]], np.int32)
    same = store.append(one, np.ones(1, np.float32))
    jsame = ref.append(one, np.ones(1, np.float32))
    assert same is store and jsame is ref
    _same_store(same, jsame)
    # more entries into ONE bucket than its whole chunk → regrow
    burst_idx = np.zeros((L0 + 1, 3), np.int32)
    burst_val = np.full(L0 + 1, 2.0, np.float32)
    grown = store.append(burst_idx, burst_val)
    assert grown is not store
    assert grown.chunk_len > L0
    assert grown.chunk_len % int(grown.meta["pad_multiple"]) == 0
    _same_store(grown, ref.append(burst_idx, burst_val))
    all_idx = np.concatenate([idx, one, burst_idx])
    all_val = np.concatenate([val, np.ones(1, np.float32), burst_val])
    _same_store(grown, NonzeroStore.build((all_idx, all_val, dims), 2))
    # arrivals as tensors fold the same way
    again = grown.append(torch.from_numpy(one), torch.ones(1))
    assert again is grown and again.nnz == len(all_val) + 1


def test_store_spill_round_trip_and_snapshot(tmp_path):
    dims = (14, 11, 9)
    idx, val = _arrays(dims, 1200, 5)
    mem = NonzeroStore.build((idx, val, dims), 4)
    spilled = NonzeroStore.build((idx, val, dims), 4,
                                 spill_dir=str(tmp_path / "s"))
    assert spilled.spilled and not mem.spilled
    _same_store(mem, spilled)
    reopened = NonzeroStore.open(str(tmp_path / "s"))
    assert reopened.meta == spilled.meta
    _same_store(mem, reopened)
    # stratum() of a spilled store materializes an in-memory copy
    i, v, m = reopened.stratum(2)
    assert type(i) is np.ndarray and not isinstance(i, np.memmap)
    np.testing.assert_array_equal(i, mem.indices[2])
    saved = mem.save(str(tmp_path / "saved"))
    assert saved.spilled
    _same_store(saved, mem)
    assert spilled.nbytes == mem.nbytes == 16 * spilled.stratum_nbytes
    # strata_block is device-major
    ids = [5, 0, 11]
    bi, bv, bm = spilled.strata_block(ids)
    M, L, N = spilled.num_workers, spilled.chunk_len, spilled.order
    assert bi.shape == (M, 3, L, N) and bv.shape == bm.shape == (M, 3, L)
    for k, s in enumerate(ids):
        np.testing.assert_array_equal(bi[:, k], mem.indices[s])
        np.testing.assert_array_equal(bm[:, k], mem.mask[s])

    # append to a spilled store: growth reopens, the old handle keeps its
    # snapshot, the base entries are never reordered
    base = NonzeroStore.build((idx[:-500], val[:-500], dims), 2,
                              spill_dir=str(tmp_path / "g"))
    old_vals, old_mask = base.values.copy(), base.mask.copy()
    out = base.append(idx[-500:], val[-500:])
    assert out.spilled and out.path == base.path
    _same_store(out, NonzeroStore.build((idx, val, dims), 2))
    _same_store(NonzeroStore.open(str(tmp_path / "g")), out)
    S, M, L = old_vals.shape
    np.testing.assert_array_equal(out.values[:, :, :L][old_mask],
                                  old_vals[old_mask])
    # growth publishes new files: the old handle keeps reading its snapshot
    snap = out.values.copy()
    burst = np.zeros((out.chunk_len + 1, 3), np.int32)
    grown = out.append(burst, np.ones(len(burst), np.float32))
    assert grown.chunk_len > out.chunk_len
    np.testing.assert_array_equal(out.values, snap)


def test_append_spilled_crash_midway_recovers_pre_append(tmp_path,
                                                         monkeypatch):
    dims = (14, 11, 9)
    idx, val = _arrays(dims, 1200, 7)
    store = NonzeroStore.build((idx[:-500], val[:-500], dims), 2,
                               spill_dir=str(tmp_path / "s"))
    pre = {f: np.asarray(getattr(store, f)).copy() for f in FIELDS}
    pre_meta = dict(store.meta)
    L0 = store.chunk_len
    burst_idx = np.zeros((L0 + 1, 3), np.int32)
    burst_val = np.full(L0 + 1, 2.0, np.float32)
    real_replace = os.replace

    def dying_replace(src, dst):
        raise OSError(f"simulated crash before publishing {dst}")

    monkeypatch.setattr(os, "replace", dying_replace)
    with pytest.raises(OSError, match="simulated crash"):
        store.append(burst_idx, burst_val)
    monkeypatch.setattr(os, "replace", real_replace)

    back = NonzeroStore.open(str(tmp_path / "s"))
    assert back.meta == pre_meta and back.chunk_len == L0
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), pre[f])
    # the staged .tmp debris is invisible; the same append then succeeds
    out = back.append(burst_idx, burst_val)
    assert out.spilled and out.nnz == pre_meta["nnz"] + L0 + 1
    _same_store(out, NonzeroStore.open(str(tmp_path / "s")))


def test_append_validates_and_empty_is_noop():
    dims = (10, 8, 6)
    idx, val = _arrays(dims, 300, 1)
    store = NonzeroStore.build((idx, val, dims), 2)
    assert store.append(np.zeros((0, 3), np.int32),
                        np.zeros(0, np.float32)) is store
    with pytest.raises(ValueError, match="indices"):
        store.append(np.zeros((4, 2), np.int32), np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="values"):
        store.append(np.zeros((4, 3), np.int32), np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="range"):
        store.append(np.array([[10, 0, 0]], np.int32),
                     np.ones(1, np.float32))
    with pytest.raises(ValueError, match="nnz"):
        NonzeroStore.build((idx, val[:-1], dims), 2)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_spill_dirs_open_in_the_other_package(tmp_path, writer):
    dims = (14, 11, 9)
    idx, val = _arrays(dims, 900, 3)
    d = str(tmp_path / writer)
    if writer == "port":
        wrote = NonzeroStore.build((idx[:-200], val[:-200], dims), 2,
                                   spill_dir=d).append(idx[-200:],
                                                       val[-200:])
        read = jpipe.NonzeroStore.open(d)
        _same_store(read, wrote)
        further = read.append(idx[:5], val[:5])        # and append there
        again = NonzeroStore.open(d)
    else:
        wrote = jpipe.NonzeroStore.build(_jt(idx[:-200], val[:-200], dims),
                                         2, spill_dir=d).append(
            idx[-200:], val[-200:])
        read = NonzeroStore.open(d)
        _same_store(read, wrote)
        further = read.append(idx[:5], val[:5])
        again = jpipe.NonzeroStore.open(d)
    _same_store(again, further)
    assert again.nnz == 905


def test_data_package_exports():
    import repro_torch.data as data

    for name in ("NonzeroStore", "StratumPrefetcher", "TensorStream",
                 "TokenPipeline", "TokenPipelineConfig", "planted_tensor"):
        assert name in data.__all__ and hasattr(data, name)


# ---------------------------------------------------------------------------
# StratumPrefetcher (device="cpu")
# ---------------------------------------------------------------------------

def _store(M=4, nnz=900, seed=1):
    dims = (14, 11, 9)
    return NonzeroStore.build(_arrays(dims, nnz, seed) + (dims,), M)


def _walk(S):
    return lambda pos: (pos + 1) % S


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetcher_matches_direct_load(depth):
    store = _store()
    S = store.num_strata
    pf = StratumPrefetcher(store.stratum, _walk(S), depth=depth,
                           device="cpu")
    try:
        for p in list(range(S)) + [0, 1]:       # wraps the epoch boundary
            idx, val, msk = pf.take(p % S, timeout=TAKE_S)
            assert isinstance(idx, torch.Tensor) and idx.dtype == torch.int32
            assert msk.dtype == torch.bool
            np.testing.assert_array_equal(idx.numpy(), store.indices[p % S])
            np.testing.assert_array_equal(val.numpy(), store.values[p % S])
            np.testing.assert_array_equal(msk.numpy(), store.mask[p % S])
    finally:
        pf.close()


def test_prefetcher_copies_blocks():
    """A placed block does not alias the store: an in-place append after
    the take leaves the taken tensors as they were."""
    store = _store(M=1)
    pf = StratumPrefetcher(store.stratum, _walk(1), depth=0, device="cpu")
    idx, val, _ = pf.take(0)
    before = val.clone()
    store.append(np.array([[0, 0, 0]], np.int32), np.full(1, 9.0,
                                                          np.float32))
    assert torch.equal(val, before)


def test_prefetcher_reset_on_jump():
    store = _store()
    S = store.num_strata
    pf = StratumPrefetcher(store.stratum, _walk(S), depth=2, device="cpu")
    try:
        pf.take(0, timeout=TAKE_S)
        pf.take(1, timeout=TAKE_S)
        idx, _, _ = pf.take(7, timeout=TAKE_S)   # a resume-style jump
        np.testing.assert_array_equal(idx.numpy(), store.indices[7])
        idx, _, _ = pf.take(8, timeout=TAKE_S)
        np.testing.assert_array_equal(idx.numpy(), store.indices[8])
    finally:
        pf.close()


def test_prefetcher_close_is_idempotent_and_take_times_out():
    store = _store(M=2, nnz=300)
    gate = threading.Event()

    def slow(pos):
        gate.wait(TAKE_S)
        return store.stratum(pos)

    pf = StratumPrefetcher(slow, _walk(store.num_strata), depth=1,
                           device="cpu")
    with pytest.raises(TimeoutError, match="position 0"):
        pf.take(0, timeout=0.05)
    gate.set()
    pf.close()
    pf.close()


def test_prefetcher_raises_worker_failure():
    store = _store(M=2, nnz=600)
    S = store.num_strata

    def flaky(pos):
        if pos == 2:
            raise OSError("disk pulled")
        return store.stratum(pos)

    pf = StratumPrefetcher(flaky, _walk(S), depth=1, retries=0,
                           device="cpu")
    try:
        pf.take(0, timeout=TAKE_S)
        pf.take(1, timeout=TAKE_S)
        with pytest.raises(RuntimeError, match="position 2") as ei:
            pf.take(2, timeout=TAKE_S)
        assert isinstance(ei.value.__cause__, OSError)
        with pytest.raises(RuntimeError, match="position 2"):
            pf.take(3, timeout=TAKE_S)          # sticky until a reset
    finally:
        pf.close()


def test_prefetcher_recovers_after_reset():
    store = _store(M=2, nnz=600)
    calls = {"n": 0}

    def flaky_once(pos):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("transient")
        return store.stratum(pos)

    pf = StratumPrefetcher(flaky_once, _walk(store.num_strata), depth=2,
                           retries=0, device="cpu")
    try:
        with pytest.raises(RuntimeError):
            pf.take(0, timeout=TAKE_S)
        pf.reset(0)
        idx, _, _ = pf.take(0, timeout=TAKE_S)
        np.testing.assert_array_equal(idx.numpy(), store.indices[0])
    finally:
        pf.close()


def test_prefetcher_retries_transient_failure():
    store = _store(M=2, nnz=600)
    S = store.num_strata
    fails = {0: 2, 3: 1}

    def flaky(pos):
        if fails.get(pos, 0) > 0:
            fails[pos] -= 1
            raise OSError(f"transient at {pos}")
        return store.stratum(pos)

    pf = StratumPrefetcher(flaky, _walk(S), depth=2, retries=2,
                           retry_base_s=1e-4, retry_cap_s=1e-3, device="cpu")
    try:
        for pos in range(S):
            idx, _, _ = pf.take(pos, timeout=TAKE_S)
            np.testing.assert_array_equal(idx.numpy(), store.indices[pos])
        assert pf.retried == 3
        assert not any(fails.values())
    finally:
        pf.close()


def test_prefetcher_budget_exhaustion_still_fatal():
    store = _store(M=2, nnz=600)

    def always_bad(pos):
        if pos == 1:
            raise OSError("persistent")
        return store.stratum(pos)

    pf = StratumPrefetcher(always_bad, _walk(store.num_strata), depth=1,
                           retries=1, retry_base_s=1e-4, retry_cap_s=1e-3,
                           device="cpu")
    try:
        pf.take(0, timeout=TAKE_S)
        with pytest.raises(RuntimeError, match="position 1") as ei:
            pf.take(1, timeout=TAKE_S)
        assert isinstance(ei.value.__cause__, OSError)
    finally:
        pf.close()


def test_prefetcher_fault_plan_transfer_site():
    from repro_torch.runtime.fault import FaultInjected, FaultPlan, FaultSpec

    store = _store(M=2, nnz=600)
    S = store.num_strata
    plan = FaultPlan([FaultSpec("transfer", hits=frozenset({0, 1}))])
    pf = StratumPrefetcher(store.stratum, _walk(S), depth=0, retries=2,
                           retry_base_s=1e-4, retry_cap_s=1e-3,
                           fault_plan=plan, device="cpu")
    idx, _, _ = pf.take(0)
    np.testing.assert_array_equal(idx.numpy(), store.indices[0])
    assert plan.fired == 2 and pf.retried == 2
    # the spec the card run uses: the fourth transfer fails once, absorbed
    plan = FaultPlan.parse("transfer@3")
    pf = StratumPrefetcher(store.stratum, _walk(S), depth=2, retries=2,
                           retry_base_s=1e-4, retry_cap_s=1e-3,
                           fault_plan=plan, device="cpu")
    try:
        for pos in range(S):
            idx, _, _ = pf.take(pos, timeout=TAKE_S)
            np.testing.assert_array_equal(idx.numpy(), store.indices[pos])
        assert plan.fired == 1 and pf.retried == 1
    finally:
        pf.close()
    # a budget below the consecutive hits makes the injection fatal
    plan2 = FaultPlan([FaultSpec("transfer", hits=frozenset({0, 1}))])
    pf2 = StratumPrefetcher(store.stratum, _walk(S), depth=0, retries=1,
                            retry_base_s=1e-4, retry_cap_s=1e-3,
                            fault_plan=plan2, device="cpu")
    with pytest.raises(FaultInjected):
        pf2.take(0)


def test_prefetcher_custom_place_fn_and_default_device():
    store = _store(M=2, nnz=300)
    placed = []

    def place(block):
        placed.append(len(block))
        return block

    pf = StratumPrefetcher(store.stratum, _walk(store.num_strata), depth=0,
                           place_fn=place)
    idx, _, _ = pf.take(1)
    assert placed == [3]
    np.testing.assert_array_equal(idx, store.indices[1])
    if not torch.cuda.is_available():
        # the default placement goes to the card unless the CPU is named
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StratumPrefetcher(store.stratum, _walk(4), depth=0)


def test_prefetcher_stress_jumps_and_switches():
    """Many takes with random jumps (each a reset that stops and joins the
    worker and starts another) under a short switch interval: every block
    is still the store's chunk at its position."""
    import sys

    store = _store(M=2, nnz=600)
    S = store.num_strata
    rng = np.random.default_rng(0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    pf = StratumPrefetcher(store.stratum, _walk(S), depth=3, device="cpu")
    try:
        pos = 0
        for _ in range(200):
            pos = int(rng.integers(S)) if rng.random() < 0.1 else pos
            idx, val, _ = pf.take(pos, timeout=TAKE_S)
            np.testing.assert_array_equal(idx.numpy(), store.indices[pos])
            np.testing.assert_array_equal(val.numpy(), store.values[pos])
            pos = (pos + 1) % S
    finally:
        sys.setswitchinterval(old)
        pf.close()
