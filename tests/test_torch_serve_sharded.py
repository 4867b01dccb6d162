"""The port's sharded Tucker serving on the CPU, against its unsharded
server and the live JAX reference.

The port's counterpart of ``tests/test_serve_sharded.py`` (every test of
it, on its shapes, ``DIMS = (9, 7, 5)``), run on in-process meshes of
M = 4 and M = 1 CPU workers (``launch.mesh.make_host_mesh(num_workers=M,
device="cpu")``): shard-local top-k merge, sharded reconstruction, the
batch-parallel replicated mode, the row/batch policy, and the bytes the
collectives copy between workers (where the reference reads collective
operand bytes out of compiled HLO).  Beyond it, the sharded contracts:

* ``predict`` in row and batch mode bitwise the unsharded server's;
* ``top_k`` ids equal wherever the k-th and (k+1)-th scores differ by
  more than 1e-5 of the row's largest, scores within 2e-5, ties in
  ascending global id, padding rows never winning;
* ``reconstruct_rows`` within 2e-5, trimmed to the true dims;
* after ``update_rows`` / ``sync_factor_rows`` / ``refresh_tables`` the
  joined tables bitwise a fresh unsharded server's, colsums within 1e-5
  relative, duplicates refused;
* the launches of each entry point through counting backend methods
  (the CPU's stand-in for the kernels' counters);
* the reference's live ``TuckerServer`` on the same numpy parameters
  (carried across with ``params_from_numpy``): the port's sharded
  servers at M = 4 against its unsharded server (which its own
  ``test_sharded_matches_unsharded_exactly`` makes the sharded answer),
  the port at M = 1 against its row and batch servers at its one CPU
  device, within ``tests/test_torch_serve.py``'s tolerances (1e-5 of the
  largest; top-k ids equal);
* ``choose_shard_mode`` / ``ShardPolicy.decide`` equal the reference's
  on every branch, and the ``serve_tucker --sharded`` CLI.
"""
import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st
from repro.core import fasttucker as jft
from repro.serve import TuckerServer as JServer
from repro.serve import policy as jpolicy
from repro_torch.benchmarks import bench_serve
from repro_torch.core import fasttucker as ft
from repro_torch.core.kruskal import dense_reconstruct
from repro_torch.kernels import dispatch
from repro_torch.launch import serve_tucker
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.serve import (ShardDecision, ShardPolicy, TuckerServer,
                               choose_shard_mode, policy, split_batch)

DIMS = (9, 7, 5)
MODES = ("row", "batch")


def _jparams(dims=DIMS, ranks=(3, 4, 2), core_rank=3, seed=0):
    cfg = jft.FastTuckerConfig(dims=dims, ranks=ranks, core_rank=core_rank,
                               batch_size=32)
    return jft.init_params(jax.random.PRNGKey(seed), cfg)


def _params(dims=DIMS, ranks=(3, 4, 2), core_rank=3, seed=0):
    return ft.params_from_numpy(_jparams(dims, ranks, core_rank, seed),
                                device="cpu")


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


def _grid(dims):
    grids = np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")
    return np.stack(grids, -1).reshape(-1, len(dims)).astype(np.int32)


def _cpu_mesh(workers):
    return make_host_mesh(num_workers=workers, device="cpu")


def _top_k_agree(s1, i1, s0, i0, k):
    """The sharded top-k contract against an unsharded answer: scores
    within 2e-5 of the row's largest, ids equal on rows whose k-th and
    (k+1)-th unsharded scores are further apart than 1e-5 of it."""
    s1, s0 = _np(s1), _np(s0)
    for b in range(len(s0)):
        scale = max(float(np.abs(s0[b]).max()), 1e-30)
        assert float(np.abs(s1[b] - s0[b]).max()) <= 2e-5 * scale
    np.testing.assert_array_equal(i1.numpy(), i0.numpy())


@pytest.fixture(scope="module")
def model():
    params = _params()
    dense = _np(dense_reconstruct(params.factors, params.core_factors))
    return params, dense


@pytest.fixture(scope="module", params=(4, 1), ids=("M4", "M1"))
def mesh(request):
    return _cpu_mesh(request.param)


def _data_extent(mesh):
    return mesh.shape[mesh.axis_names.index("data")]


# ---------------------------------------------------------------------------
# parity vs brute-force dense scoring (both sharded modes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard_mode", MODES)
def test_sharded_top_k_matches_brute_force(model, mesh, shard_mode):
    params, dense = model
    srv = TuckerServer(params, mesh=mesh, shard_mode=shard_mode)
    for mode, target, marg in ((0, 1, 2), (1, 0, 2), (0, 2, 1)):
        brute = dense.sum(axis=marg)                 # (I_mode, I_target)
        if mode > target:
            brute = brute.T
        ids = np.arange(DIMS[mode], dtype=np.int32)
        k = 4
        scores, items = srv.top_k(mode, ids, k, target_mode=target)
        for b, uid in enumerate(ids):
            order = np.argsort(-brute[uid])[:k]
            np.testing.assert_allclose(_np(scores[b]), brute[uid][order],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(brute[uid][items[b].numpy()],
                                       brute[uid][order], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("shard_mode", MODES)
def test_sharded_reconstruct_matches_dense(model, mesh, shard_mode):
    params, dense = model
    srv = TuckerServer(params, mesh=mesh, shard_mode=shard_mode)
    for mode in range(len(DIMS)):
        ids = np.arange(DIMS[mode], dtype=np.int32)
        out = _np(srv.reconstruct_rows(mode, ids))
        want = np.moveaxis(dense, mode, 0)
        assert out.shape == want.shape
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shard_mode", MODES)
def test_sharded_matches_unsharded_exactly(model, mesh, shard_mode):
    """Scores AND tie-break order: the shard-merge candidate list is
    worker-major (= ascending global id), so its final stable sort picks
    the same item ids as the unsharded one — including ties."""
    params, _ = model
    base = TuckerServer(params)
    srv = TuckerServer(params, mesh=mesh, shard_mode=shard_mode)
    ids = np.arange(DIMS[0], dtype=np.int32)
    for k in (1, 3, DIMS[1]):
        s0, i0 = base.top_k(0, ids, k)
        s1, i1 = srv.top_k(0, ids, k)
        np.testing.assert_allclose(_np(s1), _np(s0), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(i1.numpy(), i0.numpy())


def test_sharded_top_k_ties_follow_unsharded_order(mesh):
    """Constant tables ⟹ every candidate ties; the winner set must be the
    lowest global ids, exactly what the unsharded stable sort returns."""
    dims, J, R = (8, 8, 4), 2, 2
    factors = tuple(torch.ones((d, J)) for d in dims)
    cores = tuple(torch.ones((J, R)) for _ in dims)
    params = ft.FastTuckerParams(factors, cores)
    base = TuckerServer(params)
    ids = np.arange(dims[0], dtype=np.int32)
    for shard_mode in MODES:
        srv = TuckerServer(params, mesh=mesh, shard_mode=shard_mode)
        for k in (1, 3, 8):
            s0, i0 = base.top_k(0, ids, k)
            s1, i1 = srv.top_k(0, ids, k)
            np.testing.assert_array_equal(i1.numpy(), i0.numpy())
            np.testing.assert_array_equal(i1.numpy()[0], np.arange(k))
            np.testing.assert_allclose(_np(s1), _np(s0), rtol=1e-6,
                                       atol=1e-6)


def test_sharded_bf16_tables(model, mesh):
    params, _ = model
    base = TuckerServer(params, table_dtype="bfloat16")
    q = _grid(DIMS)
    for shard_mode in MODES:
        srv = TuckerServer(params, mesh=mesh, shard_mode=shard_mode,
                           table_dtype="bfloat16")
        ids = np.arange(DIMS[0], dtype=np.int32)
        s0, i0 = base.top_k(0, ids, 3)
        s1, i1 = srv.top_k(0, ids, 3)
        assert s1.dtype == torch.float32
        np.testing.assert_allclose(_np(s1), _np(s0), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(i1.numpy(), i0.numpy())
        # the colsums stay f32 from the unrounded tables
        for c0, c1 in zip(base._colsums, srv._colsums):
            assert c1.dtype == torch.float32
            _close(_np(c1), _np(c0))
        assert torch.equal(srv.predict(q), base.predict(q))


def test_sharded_chunked_over_ladder(model, mesh):
    """Requests above the largest bucket chunk + concatenate identically
    in every mode (and the batch ladder stays multiple-of-M)."""
    params, _ = model
    base = TuckerServer(params, max_bucket=8, min_bucket=8)
    ids = np.tile(np.arange(DIMS[0], dtype=np.int32), 3)     # 27 > 8
    s0, i0 = base.top_k(0, ids, 3)
    r0 = _np(base.reconstruct_rows(0, ids))
    M = _data_extent(mesh)
    for shard_mode in MODES:
        srv = TuckerServer(params, mesh=mesh, shard_mode=shard_mode,
                           max_bucket=8, min_bucket=8)
        assert all(b % M == 0 for b in srv.ladder) or shard_mode == "row"
        s1, i1 = srv.top_k(0, ids, 3)
        np.testing.assert_allclose(_np(s1), _np(s0), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(i1.numpy(), i0.numpy())
        np.testing.assert_allclose(_np(srv.reconstruct_rows(0, ids)), r0,
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the bytes the collectives copy (the reference's HLO contract)
# ---------------------------------------------------------------------------

def test_row_top_k_collective_bytes_beat_gspmd():
    """The shard-local merge copies strictly fewer bytes between workers
    than the baseline (every worker's score block all-gathered, what
    GSPMD compiles the unsharded program to) on the same row-sharded
    tables, and exactly the counted payload: the query rows from their
    owners, the scaled rows to every worker, and M·k_local (score f32, id
    int32) candidates a request — nothing O(rows).  The scored mode is 600
    rows, as in the reference."""
    dims = (600, 9, 5)
    params = _params(dims=dims)
    mesh = _cpu_mesh(4)
    srv = TuckerServer(params, mesh=mesh, shard_mode="row")
    base = bench_serve.score_gather_server(params, mesh=mesh)
    B, k, M, R = 32, 5, 4, srv.core_rank
    ids = np.arange(B, dtype=np.int32) % dims[1]
    fast = bench_serve.top_k_bytes(srv, ids, k)
    gspmd = bench_serve.top_k_bytes(base, ids, k)
    s0, i0 = TuckerServer(params).top_k(1, ids, k, target_mode=0)
    s1, i1 = base.top_k(1, ids, k, target_mode=0)
    _top_k_agree(s1, i1, s0, i0, k)
    b1 = srv._block_rows[1]
    owned_elsewhere = int(np.count_nonzero(ids // b1 != 0))
    k_local = min(k, srv._block_rows[0])
    gather = owned_elsewhere * R * 4 + (M - 1) * B * R * 4
    assert fast == gather + (M - 1) * B * k_local * 8
    assert gspmd == gather + (M - 1) * B * srv._block_rows[0] * 4
    assert 0 < fast < gspmd
    assert gspmd >= B * dims[0] * 4 * (M - 1) / M


def test_batch_predict_has_zero_collectives(model):
    """Replicated tables + split batches: no table row or query row is
    copied between workers; only each worker's answers come back (4 bytes
    a query from the M − 1 other workers)."""
    params, _ = model
    srv = TuckerServer(params, mesh=_cpu_mesh(4), shard_mode="batch")
    b = srv.ladder[0]
    srv.predict(np.zeros((b, len(DIMS)), np.int32))
    assert srv.traffic["predict"] == 0
    assert srv.traffic["answers"] == b // 4 * 3 * 4


@pytest.mark.parametrize("shard_mode", MODES)
def test_predict_bytes_are_what_the_gather_copies(model, shard_mode):
    """Row predict copies each mode's query rows that live off the
    answering worker, R table entries each, and nothing else."""
    params, _ = model
    srv = TuckerServer(params, mesh=_cpu_mesh(4), shard_mode=shard_mode)
    q = _grid(DIMS)[::3]
    srv.predict(q)
    if shard_mode == "batch":
        assert srv.traffic["predict"] == 0
        return
    want = 0
    for start, bucket in split_batch(len(q), srv.ladder):
        chunk = np.zeros((bucket, len(DIMS)), np.int32)
        part = q[start:start + bucket]
        chunk[:len(part)] = part
        for n, b in enumerate(srv._block_rows):
            want += int(np.count_nonzero(chunk[:, n] // b != 0)) * 3 * 4
    assert srv.traffic["predict"] == want > 0


def test_traffic_counts_concurrent_queries_exactly(model):
    """Query threads and a patching thread add to one server's byte count
    at once (more threads than cores, a short switch interval): every
    call's bytes are counted, none lost, and every answer is one
    generation's."""
    import os
    import sys
    import threading

    params, _ = model
    srv = TuckerServer(params, mesh=_cpu_mesh(4), shard_mode="row")
    q = _grid(DIMS)[::7]
    want = srv.predict(q)
    per_call = srv.traffic["predict"]
    threads_n, calls = 2 * (os.cpu_count() or 1) + 2, 5
    errors = []

    def queries():
        try:
            for _ in range(calls):
                assert torch.equal(srv.predict(q), want)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def patches():
        for _ in range(calls):
            srv.update_rows(2, [0, 4], srv.params.factors[2][[0, 4]])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=queries) for _ in range(threads_n)]
        ts.append(threading.Thread(target=patches))
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts) and not errors
    assert srv.traffic["predict"] == per_call * (1 + threads_n * calls)
    assert srv.table_version == calls


# ---------------------------------------------------------------------------
# predict bitwise, padding, launches, the refresh on both layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("shard_mode", MODES)
def test_predict_bitwise_unsharded(model, mesh, shard_mode, table_dtype):
    """The row-owner gather copies rows exactly and the contraction gives
    a sample the same bits alone and inside a bucket, so every layout's
    predictions are the unsharded server's bits — across the batch
    ladder's rounding and chunking too."""
    params, _ = model
    base = TuckerServer(params, table_dtype=table_dtype, max_bucket=16,
                        min_bucket=2)
    srv = TuckerServer(params, mesh=mesh, shard_mode=shard_mode,
                       table_dtype=table_dtype, max_bucket=16, min_bucket=2)
    q = _grid(DIMS)
    rng = np.random.default_rng(5)
    for b in (1, 3, 7, 16, 33, len(q)):
        sel = q[rng.permutation(len(q))[:b]]
        assert torch.equal(srv.predict(sel), base.predict(sel))


def test_padding_rows_never_win():
    """13 rows over 4 workers: the last worker holds row 12 and three zero
    padding rows.  Every true score is negative, so a padding row (score
    0) would win any unmasked merge; the sharded top-k must return the
    unsharded ranking of all 13 rows."""
    dims = (13, 6, 5)
    rng = np.random.default_rng(3)
    factors = (torch.from_numpy(-rng.uniform(0.5, 1, (13, 2))),
               torch.from_numpy(rng.uniform(0.5, 1, (6, 2))),
               torch.from_numpy(rng.uniform(0.5, 1, (5, 2))))
    cores = tuple(torch.from_numpy(rng.uniform(0.5, 1, (2, 3)))
                  for _ in dims)
    params = ft.FastTuckerParams(tuple(f.float() for f in factors),
                                 tuple(c.float() for c in cores))
    base = TuckerServer(params)
    ids = np.arange(dims[1], dtype=np.int32)
    s0, i0 = base.top_k(1, ids, 13, target_mode=0)
    assert float(s0.max()) < 0
    srv = TuckerServer(params, mesh=_cpu_mesh(4), shard_mode="row")
    assert srv._block_rows[0] == 4
    for k in (1, 4, 13):
        s1, i1 = srv.top_k(1, ids, k, target_mode=0)
        _top_k_agree(s1, i1, s0[:, :k], i0[:, :k], k)
        assert int(i1.max()) < 13
    out = srv.reconstruct_rows(1, ids)
    assert tuple(out.shape) == (6, 13, 5)
    _close(_np(out), _np(base.reconstruct_rows(1, ids)), 2e-5)


class _Counting:
    """Counts the backend methods the server calls (the CPU stand-in for
    the kernels' launch counters, which count only on the card)."""

    NAMES = ("kruskal_contract", "mode_product_rows", "patch_table_rows")

    def __init__(self, monkeypatch, backend="cuda"):
        be = dispatch.get_backend(backend)
        self.calls = {n: 0 for n in self.NAMES}
        for name in self.NAMES:
            real = getattr(be, name)

            def counted(*a, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)

            monkeypatch.setattr(be, name, counted)

    def take(self) -> dict:
        out, self.calls = self.calls, {n: 0 for n in self.NAMES}
        return out


@pytest.mark.parametrize("shard_mode", MODES)
def test_launches_of_each_entry_point(model, monkeypatch, shard_mode):
    """predict: one contraction a bucket chunk (row), M a chunk (batch);
    top_k and reconstruct_rows none; update_rows one patch a worker
    holding dirty rows (row) or a replica (batch), a worker with none
    launching nothing; refresh_tables one build a mode a worker that holds
    rows."""
    params, _ = model
    M = 4
    count = _Counting(monkeypatch)
    srv = TuckerServer(params, mesh=_cpu_mesh(M), shard_mode=shard_mode,
                       max_bucket=16, min_bucket=4)
    spans = sum(hi > lo for s in srv._spans for lo, hi in s)
    assert count.take() == dict(kruskal_contract=0, mode_product_rows=spans,
                                patch_table_rows=0)
    q = _grid(DIMS)[:37]
    srv.predict(q)
    chunks = len(split_batch(len(q), srv.ladder))
    per_chunk = 1 if shard_mode == "row" else M
    assert count.take()["kruskal_contract"] == chunks * per_chunk
    srv.top_k(0, np.arange(9), 3)
    srv.reconstruct_rows(2, [0, 4])
    assert sum(count.take().values()) == 0
    # mode 0's rows 0..8 in blocks of 3: dirty rows on workers 0 and 2
    ids = np.array([1, 7, 8], np.int32)
    srv.update_rows(0, ids, np.ones((3, 3), np.float32))
    want = 2 if shard_mode == "row" else M
    assert count.take() == dict(kruskal_contract=0, mode_product_rows=0,
                                patch_table_rows=want)
    srv.refresh_tables()
    assert count.take() == dict(kruskal_contract=0, mode_product_rows=spans,
                                patch_table_rows=0)
    assert spans == (10 if shard_mode == "row" else 3 * M)


@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("shard_mode", MODES)
def test_update_rows_matches_fresh_unsharded(mesh, shard_mode, table_dtype):
    """A chain of row patches over every mode, a sync without publish and
    a rebuild: the joined tables are bitwise a fresh unsharded server's
    from the final params, the colsums within 1e-5 relative, the params
    the patched factors, the caller's params untouched; duplicates and
    out-of-range ids raise."""
    dims = (40, 30, 21)
    params = _params(dims=dims, ranks=(4, 3, 2))
    keep = [f.clone() for f in params.factors]
    srv = TuckerServer(params, mesh=mesh, shard_mode=shard_mode,
                       table_dtype=table_dtype)
    rng = np.random.default_rng(1)
    facs = [f.numpy().copy() for f in params.factors]
    v0 = srv.table_version
    for it in range(6):
        mode = it % 3
        f = int(rng.integers(1, dims[mode] + 1))
        ids = rng.permutation(dims[mode])[:f].astype(np.int32)
        if it % 2:
            ids = np.sort(ids)
        new = rng.standard_normal((f, facs[mode].shape[1])) \
            .astype(np.float32)
        facs[mode][ids] = new
        assert srv.update_rows(mode, ids, new) == v0 + it + 1

    def fresh():
        class P:
            factors = facs
            core_factors = [c.numpy() for c in params.core_factors]
        return TuckerServer(ft.params_from_numpy(P, device="cpu"),
                            table_dtype=table_dtype)

    def check(ref):
        for n in range(3):
            assert torch.equal(srv._tables[n], ref._tables[n])
            c, rc = _np(srv._colsums[n]), _np(ref._colsums[n])
            assert np.abs(c - rc).max() <= 1e-5 * np.abs(rc).max()
            np.testing.assert_array_equal(_np(srv.params.factors[n]),
                                          facs[n])
        q = np.stack([rng.integers(0, d, 23) for d in dims], 1) \
            .astype(np.int32)
        assert torch.equal(srv.predict(q), ref.predict(q))

    check(fresh())
    for f, k in zip(params.factors, keep):
        assert torch.equal(f, k)
    ids = np.array([0, 17, 39], np.int32)
    new = rng.standard_normal((3, 4)).astype(np.float32)
    facs[0][ids] = new
    v = srv.table_version
    srv.sync_factor_rows(0, ids, new)
    assert srv.table_version == v
    assert srv.refresh_tables() == v + 1
    check(fresh())
    with pytest.raises(ValueError, match="unique"):
        srv.update_rows(0, [1, 1], np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        srv.update_rows(0, [dims[0]], np.zeros((1, 4), np.float32))
    assert srv.update_rows(0, np.zeros(0, np.int32),
                           np.zeros((0, 4), np.float32)) == v + 1


def test_batch_replicas_stay_bitwise_equal(model):
    """Batch mode patches every replica from its own mirror: after a
    patch every worker's table and colsum are the same bits."""
    params, _ = model
    srv = TuckerServer(params, mesh=_cpu_mesh(4), shard_mode="batch")
    srv.update_rows(1, [0, 5], np.full((2, 4), 0.5, np.float32))
    live = srv._live
    for n in range(3):
        for m in range(1, 4):
            assert torch.equal(live.tables[n][m], live.tables[n][0])
            assert torch.equal(live.worker_colsums[m][n],
                               live.worker_colsums[0][n])
        assert torch.equal(live.colsums[n], live.worker_colsums[0][n])


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

def test_policy_decides_row_vs_batch():
    pol = ShardPolicy(replicate_bytes_ceiling=1 << 20,
                      qps_batch_threshold=100.0)
    # single device: always row
    assert pol.decide(1 << 30, 1, 1e6).mode == "row"
    # tables too big to replicate: row, regardless of traffic
    assert pol.decide(2 << 20, 4, 1e6).mode == "row"
    # small tables + traffic above threshold: batch
    d = pol.decide(1 << 10, 4, 200.0)
    assert d.mode == "batch" and "traffic" in d.reason
    # small tables, unknown/low traffic: the memory-safe row default
    assert pol.decide(1 << 10, 4, None).mode == "row"
    assert pol.decide(1 << 10, 4, 50.0).mode == "row"
    assert "row" in str(pol.decide(1 << 10, 4, 50.0))


def test_auto_policy_binds_to_server(model, mesh):
    params, _ = model
    lo = TuckerServer(params, mesh=mesh)                    # qps unknown
    hi = TuckerServer(params, mesh=mesh, expected_qps=1e6)  # heavy traffic
    if _data_extent(mesh) > 1:
        assert lo.shard_mode == "row" and hi.shard_mode == "batch"
    else:
        assert lo.shard_mode == "row" and hi.shard_mode == "row"
    assert lo.shard_decision is not None
    assert lo.shard_decision.table_bytes == sum(DIMS) * 3 * 4
    # explicit modes bypass the policy and record no decision
    assert TuckerServer(params, mesh=mesh,
                        shard_mode="batch").shard_decision is None


def test_policy_threshold_override(model, mesh):
    params, _ = model
    tiny_ceiling = ShardPolicy(replicate_bytes_ceiling=1)
    srv = TuckerServer(params, mesh=mesh, expected_qps=1e6,
                       policy=tiny_ceiling)
    # tables exceed a 1-byte ceiling → row even under heavy traffic
    assert srv.shard_mode == "row"
    if _data_extent(mesh) > 1:
        assert "ceiling" in srv.shard_decision.reason
    else:
        assert "single device" in srv.shard_decision.reason


def test_shard_mode_validation(model, mesh):
    params, _ = model
    with pytest.raises(ValueError, match="requires mesh"):
        TuckerServer(params, shard_mode="row")
    with pytest.raises(ValueError, match="requires mesh"):
        TuckerServer(params, shard_mode="batch")
    with pytest.raises(ValueError, match="unknown shard_mode"):
        TuckerServer(params, mesh=mesh, shard_mode="gspmd")
    no_data = Mesh(mesh.devices, (mesh.size,), ("model",))
    with pytest.raises(ValueError, match="'data' axis"):
        TuckerServer(params, mesh=no_data, shard_mode="row")
    # without a mesh the server is the unsharded one, whatever "auto" says
    srv = TuckerServer(params, shard_mode="auto", expected_qps=1e6)
    assert srv.shard_mode == "none" and srv.shard_decision is None


def test_model_axis_serves_over_the_data_workers(model):
    """A (2, 2) mesh: the tables shard over the two data rows' first
    workers; the answers are the unsharded ones."""
    params, _ = model
    mesh = make_host_mesh(2, num_workers=4, device="cpu")
    base = TuckerServer(params)
    q = _grid(DIMS)
    for shard_mode in MODES:
        srv = TuckerServer(params, mesh=mesh, shard_mode=shard_mode)
        assert srv._workers.size == 2
        assert torch.equal(srv.predict(q), base.predict(q))


def test_choose_shard_mode_convenience():
    assert choose_shard_mode(1 << 10, 4, 1e6).mode == "batch"
    assert choose_shard_mode(1 << 10, 4).mode == "row"


def test_policy_agrees_with_reference():
    """``ShardPolicy.decide`` and ``choose_shard_mode`` give the
    reference's decision, reason and text on every branch."""
    assert policy.DEFAULT_POLICY == ShardPolicy()
    assert ShardPolicy() == ShardPolicy(
        jpolicy.DEFAULT_POLICY.replicate_bytes_ceiling,
        jpolicy.DEFAULT_POLICY.qps_batch_threshold)
    pols = [(None, None), (ShardPolicy(1 << 20, 100.0),
                           jpolicy.ShardPolicy(1 << 20, 100.0))]
    seen = set()
    for table_bytes in (1 << 10, 2 << 20, 300 << 20, 1 << 30):
        for m in (1, 2, 4):
            for qps in (None, 50.0, 100.0, 512.0, 1e6):
                for pol, jpol in pols:
                    got = choose_shard_mode(table_bytes, m, qps, pol)
                    want = jpolicy.choose_shard_mode(table_bytes, m, qps,
                                                     jpol)
                    assert isinstance(got, ShardDecision)
                    assert (got.mode, got.table_bytes, got.num_devices,
                            got.expected_qps, got.reason) == (
                        want.mode, want.table_bytes, want.num_devices,
                        want.expected_qps, want.reason)
                    assert str(got) == str(want)
                    seen.add((got.mode, got.reason[:13]))
    # every branch taken: single device, over the ceiling, traffic, default
    assert seen == {("row", "single device"), ("row", "tables exceed"),
                    ("batch", "tables fit re"), ("row", "tables fit re")}


# ---------------------------------------------------------------------------
# top-k invariance to bucket ladder and batch split
# ---------------------------------------------------------------------------

def _topk_with_ladder(params, mesh, shard_mode, ids, k, max_bucket,
                      min_bucket):
    kw = {} if shard_mode == "none" else dict(mesh=mesh,
                                              shard_mode=shard_mode)
    srv = TuckerServer(params, max_bucket=max_bucket,
                       min_bucket=min_bucket, **kw)
    s, i = srv.top_k(0, ids, k)
    return _np(s), i.numpy()


if HAVE_HYPOTHESIS:
    @settings(max_examples=15, deadline=None)
    @given(
        st.integers(min_value=1, max_value=DIMS[1]),      # k
        st.integers(min_value=0, max_value=3),            # ladder shape a
        st.integers(min_value=0, max_value=2),            # ladder shape b
        st.lists(st.integers(min_value=0, max_value=DIMS[0] - 1),
                 min_size=1, max_size=25),                # the batch
    )
    def test_top_k_invariant_to_ladder_and_split(k, a, b, raw_ids):
        """Property: top-k answers depend only on the model and the ids —
        never on how the bucket ladder pads or the batch splits."""
        params = _params()
        mesh = _cpu_mesh(4)
        ids = np.asarray(raw_ids, np.int32)
        ref_s, ref_i = _topk_with_ladder(params, mesh, "none", ids, k,
                                         2048, 8)
        max_bucket, min_bucket = 8 << (a + b), 4 << b
        for shard_mode in ("none", "row", "batch"):
            s, i = _topk_with_ladder(params, mesh, shard_mode, ids, k,
                                     max_bucket, min_bucket)
            np.testing.assert_allclose(s, ref_s, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(i, ref_i)


def test_top_k_invariant_to_ladder_and_split_examples(model, mesh):
    """Example-based fallback for the property above (always runs)."""
    params, _ = model
    rng = np.random.default_rng(7)
    ids = rng.integers(0, DIMS[0], 23).astype(np.int32)
    k = 3
    ref_s, ref_i = _topk_with_ladder(params, mesh, "none", ids, k, 2048, 8)
    for max_bucket, min_bucket in ((8, 4), (16, 8), (64, 4), (2048, 8)):
        for shard_mode in ("none", "row", "batch"):
            s, i = _topk_with_ladder(params, mesh, shard_mode, ids, k,
                                     max_bucket, min_bucket)
            np.testing.assert_allclose(s, ref_s, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{shard_mode} "
                                               f"{max_bucket}/{min_bucket}")
            np.testing.assert_array_equal(i, ref_i)


# ---------------------------------------------------------------------------
# against the live reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    jp = _jparams()
    return jp, ft.params_from_numpy(jp, device="cpu"), JServer(jp)


def _against(srv, jsrv):
    q = _grid(DIMS)
    _close(_np(srv.predict(q)), np.asarray(jsrv.predict(q)))
    ids = np.arange(DIMS[0], dtype=np.int32)
    for k in (1, 4):
        s1, i1 = srv.top_k(0, ids, k, target_mode=2)
        s0, i0 = jsrv.top_k(0, ids, k, target_mode=2)
        np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
        _close(_np(s1), np.asarray(s0))
    for mode in range(3):
        ids = np.arange(DIMS[mode], dtype=np.int32)
        _close(_np(srv.reconstruct_rows(mode, ids)),
               np.asarray(jsrv.reconstruct_rows(mode, ids)))


@pytest.mark.parametrize("shard_mode", MODES)
def test_four_workers_match_reference_unsharded(reference, shard_mode):
    jp, params, jsrv = reference
    _against(TuckerServer(params, mesh=_cpu_mesh(4), shard_mode=shard_mode),
             jsrv)


@pytest.mark.parametrize("shard_mode", MODES)
def test_one_worker_matches_reference_sharded(reference, shard_mode):
    """The port at M = 1 against the reference's server in the same mode
    on a mesh of one CPU device (the reference tier's)."""
    jp, params, _ = reference
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    jsrv = JServer(jp, mesh=jmesh, shard_mode=shard_mode)
    srv = TuckerServer(params, mesh=_cpu_mesh(1), shard_mode=shard_mode)
    assert srv.ladder == jsrv.ladder
    _against(srv, jsrv)


# ---------------------------------------------------------------------------
# the serve_tucker CLI
# ---------------------------------------------------------------------------

CLI = ["--dims", "24,18,12", "--nnz", "1200", "--train-steps", "5",
       "--batch", "128", "--rank", "4", "--core-rank", "4",
       "--max-request", "8", "--microbatch", "32", "--device", "cpu",
       "--requests", "12", "--sharded"]


@pytest.mark.parametrize("mode,qps,want", [("row", None, "row"),
                                           ("batch", None, "batch"),
                                           ("auto", None, "row"),
                                           ("auto", 1000.0, "batch")])
def test_serve_tucker_sharded_cli(monkeypatch, caplog, mode, qps, want):
    """``--sharded --shard-mode``: four host workers, the layout asked
    for (``auto``: the policy's, logged), the same top-k and predictions
    as the unsharded CLI's run."""
    monkeypatch.setenv("REPRO_FORCE_HOST_DEVICES", "4")
    flags = CLI + ["--shard-mode", mode] + (
        ["--expected-qps", str(qps)] if qps else [])
    with caplog.at_level("INFO"):
        rep = serve_tucker.main(flags)
    assert rep["shard_mode"] == want
    assert "4 workers" in caplog.text
    assert ("shard policy" in caplog.text) == (mode == "auto")
    plain = serve_tucker.main([a for a in CLI if a != "--sharded"])
    assert plain["shard_mode"] == "none"
    assert rep["served_queries"] == plain["served_queries"]
    assert rep["top_k"]["items"] == plain["top_k"]["items"]
    np.testing.assert_allclose(rep["top_k"]["scores"],
                               plain["top_k"]["scores"], rtol=2e-5)
