"""The port's multi-device strategies on an in-process mesh of CPU workers,
against the live JAX reference.

Small size: dims (60, 48, 36), 20,000 planted nonzeros (10 % held out),
J = R = 4, B = 256 a worker, M ∈ {2, 3, 4} workers on ``cpu``.

* Parity: ``sync``, ``strata`` and ``strata_overlap`` against the
  reference's per-device bodies (``_sync_local_update``; ``rotate_shard``
  + ``stratum_row_update`` + ``core_update``) under
  ``jax.vmap(axis_name="data")`` on ``backend="xla"``, with the reference's
  picks (``randint(fold_in(fold_in(key, step), me), (B,), 0, L)``,
  recomputed here) and its LHC schedule fed to the port.  Tolerance: each
  leaf within 1e-5 of its largest entry (measured ~1e-7 after 12 steps:
  the reference sums on XLA's CPU in another order); the int8 EF residuals
  within 1e-5 of the scale of what they are the residual of (``_close_ef``
  says why).  ``--compress`` at
  M = 2 against the reference's ``compressed_reduce`` under the same vmap;
  M = 3 with chunk 4 (S = 9 is not a multiple of the chunk).
* Bitwise, the port's own: ``stratum_digits``, ``shard_nonzeros`` (nnz < M
  included), ``StrataLayout.build`` and ``pad_factors_for_strata`` against
  the reference's; ``strata_overlap`` = ``strata`` (parameters, core,
  generator states); store-fed = resident strata (in memory and spilled,
  prefetch depth 0 and 2); sorted = unsorted strata in f32; ``sync`` on one
  worker = ``local``; resume for every strategy; the legacy steps = the
  strategies.
* The gather of negative local ids reads the reference's rows
  (``x[idx]``: wrap once, clamp), on a stratum whose padding localizes
  below −rows_per_block.
* The launchers ``std_train.main`` and ``online_train.main --verify`` with
  each strategy in-process at M ∈ {2, 4} (``REPRO_FORCE_HOST_DEVICES``).

The reference's steps are jitted once a mesh size, with the stratum's
digits as an array (its rotations are eager ``ppermute``s under the vmap),
so the file stays well under a minute.  Every prefetcher is closed and its
thread joined.
"""
import dataclasses
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fasttucker as jft
from repro.core.sampling import latin_hypercube_schedule as j_lhc
from repro.core.sampling import stratum_digits as j_digits
from repro.core.sptensor import SparseTensor as JSparse
from repro.data import synthetic as jsyn
from repro.distributed import strata as jstrata
from repro.distributed import sync as jsync
from repro_torch.core import fasttucker as ft
from repro_torch.core.sampling import (latin_hypercube_schedule,
                                       stratum_digits)
from repro_torch.core.sptensor import SparseTensor
from repro_torch.data.pipeline import NonzeroStore
from repro_torch.distributed import get_strategy, resolve_strategy_name
from repro_torch.distributed import base, collectives
from repro_torch.distributed import strata as pstrata
from repro_torch.distributed import sync as psync
from repro_torch.distributed import strategy as shim
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import online_train, std_train

DIMS = (60, 48, 36)
NNZ = 20_000
J = 4
B = 256
N = 3
BASE_KEY = 7
REL = 1e-5


@pytest.fixture(scope="module")
def data():
    jt = jsyn.planted_tensor(DIMS, NNZ, noise=0.05, seed=1)
    jtrain, jtest = jt.split(0.1)
    jcfg = jft.FastTuckerConfig(dims=DIMS, ranks=(J,) * N, core_rank=J,
                                batch_size=B, backend="xla")
    p0 = jft.init_params(jax.random.PRNGKey(0), jcfg)
    idx, val = np.asarray(jtrain.indices), np.asarray(jtrain.values)
    return {"jtrain": jtrain, "jcfg": jcfg, "p0": p0,
            "train": SparseTensor.from_numpy(idx, val, DIMS, "cpu"),
            "test": SparseTensor.from_numpy(np.asarray(jtest.indices),
                                            np.asarray(jtest.values), DIMS,
                                            "cpu")}


def _cfg(**kw):
    kw.setdefault("backend", "torch")
    return ft.FastTuckerConfig(dims=DIMS, ranks=(J,) * N, core_rank=J,
                               batch_size=B, **kw)


def _mesh(M):
    return pmesh.make_host_mesh(num_workers=M, device="cpu")


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), (what, err)


def _close_ef(got, want, what=""):
    """An int8 EF residual is (g + e) − its int8 reconstruction: at most
    half a quantization step, max|g + e| / 254.  The reference's g differs
    from the port's by ~1e-7 relative (another summation order), and that
    difference lands in the residual undivided, so the residual is held to
    1e-5 of the quantized quantity's scale, which is at least 254 times
    the residual's largest entry (measured: 4.2e-8 against an allowed
    3.1e-7 at M = 2; a flipped int8 code would be off by a whole step)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= REL * 254 * float(np.abs(want).max()), (what, err)


def _same(a, b) -> bool:
    """Bitwise equal DistStates: every tensor leaf and the step."""
    la = [t for t in _leaves(a)]
    lb = [t for t in _leaves(b)]
    return (a.step == b.step and len(la) == len(lb)
            and all(torch.equal(x, y) for x, y in zip(la, lb)))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)


def _run(name, M, steps, cfg=None, seed=0, tensor=None, **prep):
    """``steps`` sampled steps of ``name`` on M CPU workers from the port's
    cold init of generator ``seed``."""
    cfg = cfg or _cfg()
    st = get_strategy(name)
    plan = st.prepare(tensor, cfg, _mesh(M) if st.needs_mesh else None,
                      seed=0, **prep)
    gen = torch.Generator().manual_seed(seed)
    ds = st.init(plan, ft.init_state(gen, cfg, "cpu"), gen)
    step = st.make_step(plan)
    try:
        while ds.step < steps:
            ds = step(ds)
    finally:
        if getattr(step, "prefetcher", None) is not None:
            step.prefetcher.close()
    return st, plan, ds


# ---------------------------------------------------------------------------
# the reference's bodies under vmap
# ---------------------------------------------------------------------------

class RefStrata:
    """The reference's strata pieces on M vmapped devices, fed its
    layout, LHC schedule and keys; ``picks`` are the draws its
    ``stratum_row_update`` makes."""

    def __init__(self, data, M, compress=False):
        jcfg = data["jcfg"]
        self.M, self.compress = M, compress
        self.lay = jstrata.StrataLayout.build(data["jtrain"], M)
        self.sched = np.asarray(j_lhc(jax.random.PRNGKey(0), M, N))
        self.digits = np.asarray(j_digits(self.sched, M, N))
        self.L = self.lay.buckets["indices"].shape[2]
        lay = self.lay

        def row(f0, f1, f2, core, idx_b, val_b, msk_b, step, skey, digits):
            return jstrata.stratum_row_update(
                jcfg, lay, "data", digits, (f0, f1, f2), core, idx_b, val_b,
                msk_b, step, skey)

        def core_fn(core, cg, ef, step):
            return jstrata.core_update(jcfg, "data", M, core, cg, ef, step,
                                       compress)

        self._row = jax.jit(jax.vmap(
            row, in_axes=(0, 0, 0, None, 0, 0, 0, None, None, None),
            axis_name="data"))
        self._core = jax.jit(jax.vmap(core_fn, in_axes=(None, 0, 0, None),
                                      axis_name="data"))
        padded = jstrata.pad_factors_for_strata(data["p0"], lay)
        self.shards = [f.reshape(M, -1, f.shape[1]) for f in padded.factors]
        self.core = padded.core_factors
        self.ef = tuple(jnp.zeros((M,) + b.shape, jnp.float32)
                        for b in self.core) if compress else ()

    def rotate(self, shards, shifts):
        M = self.M
        return [jax.vmap(lambda f, s=s: jstrata.rotate_shard(f, s, M,
                                                             "data"),
                         axis_name="data")(f)
                for f, s in zip(shards, shifts)]

    def picks(self, step):
        skey = jax.random.fold_in(jax.random.PRNGKey(BASE_KEY), step)
        return skey, np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(skey, m), (B,), 0, self.L))
            for m in range(self.M)])

    def row_update(self, shards, step):
        """The row update of schedule position step mod S on shards
        already rotated into place → (new shards, core grads, picks)."""
        pos = step % len(self.sched)
        s = int(self.sched[pos])
        skey, picks = self.picks(step)
        b = self.lay.buckets
        new, cg = self._row(*shards, self.core, b["indices"][s],
                            b["values"][s], b["mask"][s],
                            jnp.asarray(step, jnp.int32), skey,
                            jnp.asarray(self.digits[pos]))
        return list(new), cg, picks

    def core_update(self, cg, step):
        ef = self.ef if self.compress else tuple(
            jnp.zeros((self.M,)) for _ in range(N))
        core, ef = self._core(self.core, cg, ef,
                              jnp.asarray(step, jnp.int32))
        self.core = tuple(c[0] for c in core)
        if self.compress:
            self.ef = ef

    def step(self, step):
        """One strata step → the picks fed to the port."""
        d = [int(x) for x in self.digits[step % len(self.sched)]]
        rot = self.rotate(self.shards, d)
        new, cg, picks = self.row_update(rot, step)
        self.shards = self.rotate(new, [-x for x in d])
        self.core_update(cg, step)
        return picks

    def chunk(self, step, K):
        """One strata_overlap chunk from the reference's pieces: the shards
        stay rotated between strata (one rotation by d' − d a mode) →
        (K, M, B) picks."""
        S, M = len(self.sched), self.M
        prev, out, shards = [0] * N, [], self.shards
        for k in range(K):
            d = [int(x) for x in self.digits[(step + k) % S]]
            shards = self.rotate(shards, [(a - b) % M
                                          for a, b in zip(d, prev)])
            shards, cg, picks = self.row_update(shards, step + k)
            self.core_update(cg, step + k)
            out.append(picks)
            prev = d
        self.shards = self.rotate(shards, [(-x) % M for x in prev])
        return out

    def global_params(self):
        return ([np.asarray(f).reshape(-1, J) for f in self.shards],
                [np.asarray(c) for c in self.core])


def _port_strata(data, name, M, ref, compress=False, chunk=None):
    st = get_strategy(name)
    if chunk is not None:
        st = type(st)(chunk=chunk)
    plan = st.prepare(data["train"], _cfg(), _mesh(M), compress=compress,
                      seed=0)
    plan.schedule = ref.sched.astype(np.int64)
    plan.digits = ref.digits.astype(np.int64)
    ds = st.init(plan, ft.TrainState(ft.params_from_numpy(data["p0"], "cpu"),
                                     0), torch.Generator().manual_seed(0))
    return st, plan, ds


def _check_strata(st, plan, ds, ref):
    g = st._globalize(plan, ds)
    want_f, want_c = ref.global_params()
    for n in range(N):
        _close(g.params.factors[n], want_f[n], f"factor {n}")
        _close(g.params.core_factors[n], want_c[n], f"core {n}")
    if ref.compress:
        for n in range(N):
            _close_ef(g.ef[n], np.asarray(ref.ef[n]), f"ef {n}")


@pytest.mark.parametrize("M", [2, 4])
def test_strata_matches_reference_body(data, M):
    ref = RefStrata(data, M)
    st, plan, ds = _port_strata(data, "strata", M, ref)
    # the layouts agree before anything runs
    assert plan.layout.chunk_len == ref.L
    for step in range(12):
        ds = st.step_batch(plan, ds, ref.step(step))
    assert ds.step == 12
    _check_strata(st, plan, ds, ref)


def test_overlap_matches_reference_chunks_m3(data):
    """M = 3, chunk 4: S = 9 splits into chunks of 4, 4 and 1, then the
    next epoch's 4 — 13 strata."""
    M = 3
    ref = RefStrata(data, M)
    st, plan, ds = _port_strata(data, "strata_overlap", M, ref, chunk=4)
    assert plan.chunk == 4 and len(plan.schedule) == 9
    for K in (4, 4, 1, 4):
        assert st.steps_per_call(plan) == 4
        ds = st.step_batch(plan, ds, ref.chunk(ds.step, K))
    assert ds.step == 13
    _check_strata(st, plan, ds, ref)
    with pytest.raises(ValueError, match="takes 4 strata"):
        st.step_batch(plan, ds._replace(step=0), ref.chunk(0, 3))


def test_strata_compress_matches_reference_m2(data):
    ref = RefStrata(data, 2, compress=True)
    st, plan, ds = _port_strata(data, "strata", 2, ref, compress=True)
    for step in range(10):
        ds = st.step_batch(plan, ds, ref.step(step))
    _check_strata(st, plan, ds, ref)


class RefSync:
    """The reference's ``_sync_local_update`` on M vmapped devices."""

    def __init__(self, data, M, compress=False):
        jcfg = data["jcfg"]
        self.M, self.compress = M, compress
        self.idx_sh, self.val_sh = jsync.shard_nonzeros(data["jtrain"], M)
        self.L = self.idx_sh.shape[1]

        def body(params, step, key, idx_s, val_s, ef):
            return jsync._sync_local_update(jcfg, "data", compress, params,
                                            step, key, idx_s, val_s, ef)

        self._step = jax.jit(jax.vmap(
            body, in_axes=(None, None, None, 0, 0, 0), axis_name="data"))
        self.params = data["p0"]
        self.ef = (tuple(jnp.zeros((M,) + f.shape, jnp.float32)
                         for f in self.params.factors) if compress
                   else tuple(jnp.zeros((M,)) for _ in range(N)))

    def step(self, step):
        key = jax.random.fold_in(jax.random.PRNGKey(BASE_KEY), step)
        picks = np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(key, m), (B,), 0, self.L))
            for m in range(self.M)])
        params, ef = self._step(self.params, jnp.asarray(step, jnp.int32),
                                key, self.idx_sh, self.val_sh, self.ef)
        self.params = jax.tree.map(lambda x: x[0], params)
        if self.compress:
            self.ef = ef
        return picks


@pytest.mark.parametrize("M,compress", [(2, False), (4, False), (2, True)])
def test_sync_matches_reference_body(data, M, compress):
    ref = RefSync(data, M, compress)
    st = get_strategy("sync")
    plan = st.prepare(data["train"], _cfg(), _mesh(M), compress=compress)
    ds = st.init(plan, ft.TrainState(ft.params_from_numpy(data["p0"], "cpu"),
                                     0), torch.Generator().manual_seed(0))
    for step in range(12):
        ds = st.step_batch(plan, ds, ref.step(step))
    for m in range(M):   # the replicas stay bitwise equal
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(ds.params[m]), _leaves(ds.params[0])))
    got = st.eval_params(plan, ds)
    for a, b in zip(got.factors + got.core_factors,
                    ref.params.factors + ref.params.core_factors):
        _close(a, b)
    if compress:
        g = st._globalize(plan, ds)
        for n in range(N):
            _close_ef(g.ef[n], np.asarray(ref.ef[n]), f"ef {n}")


# ---------------------------------------------------------------------------
# bitwise equalities with the reference's host-side pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,order", [(1, 3), (2, 3), (3, 4), (4, 3),
                                     (5, 2)])
def test_stratum_digits_bitwise_reference(M, order):
    ids = np.arange(M ** (order - 1))
    want = np.asarray(j_digits(jnp.asarray(ids), M, order))
    np.testing.assert_array_equal(stratum_digits(ids, M, order), want)
    got_t = stratum_digits(torch.from_numpy(ids), M, order)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), want)
    sched = latin_hypercube_schedule(torch.Generator().manual_seed(M), M,
                                     order)
    assert sched.dtype == torch.int64
    assert sorted(sched.tolist()) == ids.tolist()


@pytest.mark.parametrize("nnz,M", [(3, 4), (10, 4), (2500, 3), (7, 7)])
def test_shard_nonzeros_bitwise_reference(nnz, M):
    jt = jsyn.planted_tensor((20, 16, 12), nnz, seed=nnz)
    t = SparseTensor.from_numpy(np.asarray(jt.indices),
                                np.asarray(jt.values), jt.dims, "cpu")
    wi, wv = jsync.shard_nonzeros(jt, M)
    gi, gv = psync.shard_nonzeros(t, M)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert shim.shard_nonzeros is psync.shard_nonzeros


@pytest.mark.parametrize("M", [1, 2, 3, 4])
def test_strata_layout_and_padding_bitwise_reference(data, M):
    ref = jstrata.StrataLayout.build(data["jtrain"], M)
    ours = pstrata.StrataLayout.build(data["train"], M)
    assert ours.rows_per_block == ref.rows_per_block
    assert (ours.num_strata, ours.order) == (ref.num_strata, ref.order)
    for k in ("indices", "values", "mask"):
        np.testing.assert_array_equal(ours.buckets[k].numpy(),
                                      np.asarray(ref.buckets[k]))
    for s in range(ref.num_strata):
        np.testing.assert_array_equal(ours.stratum_digits(s),
                                      ref.stratum_digits(s))
    want = jstrata.pad_factors_for_strata(data["p0"], ref)
    got = pstrata.pad_factors_for_strata(
        ft.params_from_numpy(data["p0"], "cpu"), ours)
    for a, b in zip(got.factors + got.core_factors,
                    want.factors + want.core_factors):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert shim.StrataPlan is pstrata.StrataLayout


def test_negative_local_ids_gather_reference_rows(data):
    """At M = 4 the padding of a worker whose mode-n digit is 3 localizes
    to −3·rows_per_block: the gather reads what ``x[idx]`` reads there,
    the scatter drops it, and a step over such a stratum runs."""
    rows = 15
    x = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    lidx = np.array([[-45, -31, -16], [-15, -1, 0], [14, 15, 40]],
                    np.int32)
    want = np.stack([np.asarray(jnp.asarray(x)[jnp.asarray(lidx[:, n])])
                     for n in range(N)])
    gidx = pstrata.local_gather_ids(torch.from_numpy(lidx),
                                    torch.full((N,), rows, dtype=torch.int32))
    got = np.stack([x[gidx[:, n].numpy()] for n in range(N)])
    np.testing.assert_array_equal(got, want)
    # a stratum whose digits send some worker's padding below −rpb
    ref = RefStrata(data, 4)
    pos = next(p for p, d in enumerate(ref.digits) if d.max() == 3)
    st, plan, ds = _port_strata(data, "strata", 4, ref)
    rpb = plan.layout.rows_per_block
    wb = plan.worker_buckets
    lows = [int((wb[m][0][plan.schedule[pos]][~wb[m][2][plan.schedule[pos]]]
                 - torch.tensor([((m + int(d)) % 4) * r for d, r in
                                 zip(plan.digits[pos], rpb)],
                                dtype=torch.int32)).min())
            for m in range(4) if (~wb[m][2][plan.schedule[pos]]).any()]
    assert min(lows) < -max(rpb), lows
    for step in range(pos + 1):
        ds = st.step_batch(plan, ds, ref.step(step))
    _check_strata(st, plan, ds, ref)


# ---------------------------------------------------------------------------
# the port's own bitwise equalities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [2, 3, 4])
def test_overlap_equals_strata_bitwise(data, M):
    S = M ** (N - 1)
    steps = 2 * S   # two epochs: every chunk boundary lines up with strata
    _, _, a = _run("strata", M, steps, tensor=data["train"])
    _, _, b = _run("strata_overlap", M, steps, tensor=data["train"])
    assert a.step == b.step == steps and _same(a, b)


@pytest.mark.parametrize("name", ["strata", "strata_overlap"])
@pytest.mark.parametrize("depth,spill", [(0, False), (2, True)])
def test_store_fed_equals_resident_bitwise(data, tmp_path, name, depth,
                                           spill):
    M = 4
    store = NonzeroStore.build(data["train"], M,
                               spill_dir=str(tmp_path) if spill else None)
    before = threading.active_count()
    _, _, a = _run(name, M, 20, tensor=data["train"])
    _, plan, b = _run(name, M, 20, tensor=data["train"], store=store,
                      prefetch_depth=depth)
    assert plan.store is store and plan.worker_buckets == ()
    assert _same(a, b)
    assert threading.active_count() <= before   # the walk's thread joined


def test_sorted_equals_unsorted_strata_bitwise(data):
    _, _, a = _run("strata", 4, 12, tensor=data["train"])
    _, _, b = _run("strata", 4, 12, cfg=_cfg(sorted_batches=True),
                   tensor=data["train"])
    _, _, c = _run("strata", 4, 12, cfg=_cfg(sorted_batches=True,
                                             phase_split=True),
                   tensor=data["train"])
    assert _same(a, b) and _same(a, c)


@pytest.mark.parametrize("compress", [False, True])
def test_sync_one_worker_equals_local_bitwise(data, compress):
    la, lp, ld = _run("local", 1, 10, tensor=data["train"],
                      compress=compress)
    sa, sp, sd = _run("sync", 1, 10, tensor=data["train"],
                      compress=compress)
    got = sa.eval_params(sp, sd)
    want = la.eval_params(lp, ld)
    assert all(torch.equal(x, y) for x, y in zip(
        got.factors + got.core_factors, want.factors + want.core_factors))
    assert torch.equal(sd.rng[0], ld.rng)
    if compress:
        assert all(torch.equal(x, y) for x, y in zip(sd.ef[0], ld.ef))


@pytest.mark.parametrize("name,compress", [("sync", False), ("sync", True),
                                           ("strata", False),
                                           ("strata", True),
                                           ("strata_overlap", False)])
def test_resume_exact(data, tmp_path, name, compress):
    """Save at step 8, restore into a fresh init, run to 16: bitwise the
    uninterrupted run (parameters, core, EF, generator states)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    M = 4
    st, plan, ds = _run(name, M, 8, tensor=data["train"], compress=compress)
    ckpt = CheckpointManager(tmp_path)
    st.save(plan, ckpt, ds)
    # the checkpoint holds the reference's global layout
    manifest, _ = ckpt.load_leaves()
    shapes = {x["name"]: x["shape"] for x in manifest["leaves"]}
    pad = 1 if name == "sync" else 0
    assert shapes["params.factors.0"][0] == (DIMS[0] if pad else
                                             -(-DIMS[0] // M) * M)
    assert shapes["rng"][0] == M
    if compress:
        assert shapes["ef.0"][0] == M
    step = st.make_step(plan)
    cont = ds
    while cont.step < 16:
        cont = step(cont)
    gen = torch.Generator().manual_seed(9)
    fresh = st.init(plan, ft.init_state(gen, _cfg(), "cpu"), gen)
    res = st.restore(plan, ckpt, fresh)
    assert res.step == 8
    while res.step < 16:
        res = step(res)
    assert _same(cont, res)


def test_eval_params_trims_padding(data):
    # 7 workers: no mode of (60, 48, 36) is a multiple of 7
    st, plan, ds = _run("strata", 7, 3, tensor=data["train"])
    padded = st._globalize(plan, ds).params.factors
    trimmed = st.eval_params(plan, ds).factors
    for n in range(N):
        assert padded[n].shape[0] == -(-DIMS[n] // 7) * 7 > DIMS[n]
        assert trimmed[n].shape[0] == DIMS[n]
        assert torch.equal(trimmed[n], padded[n][:DIMS[n]])
        assert not padded[n][DIMS[n]:].any()


def test_refresh_repads_and_reshards(data):
    """``refresh_steps`` on strata: evaluate, refresh, lift back; the
    lifted state's global view is the refreshed params, padded."""
    st, plan, ds = _run("strata", 4, 4, tensor=data["train"])
    idx, val = data["train"].indices[:512], data["train"].values[:512]
    new, dirty, _ = st.refresh_steps(plan, ds, idx, val, 2)
    assert new.step == 6 and len(new.params) == 4
    assert not torch.equal(new.rng[0], ds.rng[0])
    assert torch.equal(new.rng[1:], ds.rng[1:])
    again, _, _ = st.refresh_steps(plan, ds, idx, val, 2)
    assert _same(new, again)
    g = st._globalize(plan, new).params.factors
    for n in range(N):
        assert g[n].shape[0] % 4 == 0 and not g[n][DIMS[n]:].any()
        assert len(dirty[n]) > 0


def test_legacy_steps_match_strategies(data):
    """``make_sync_step`` and ``make_strata_step`` (the shim's) take one
    step of the strategies' bodies on global parameters."""
    M = 2
    mesh = _mesh(M)
    cfg = _cfg()
    p0 = ft.params_from_numpy(data["p0"], "cpu")
    picks = [torch.arange(B) * (m + 1) for m in range(M)]
    st = get_strategy("sync")
    plan = st.prepare(data["train"], cfg, mesh)
    ds = st.step_batch(plan, st.init(plan, ft.TrainState(p0, 3),
                                     torch.Generator()), picks)
    got, _ = shim.make_sync_step(cfg, mesh)(p0, 3, picks, plan.idx_shards,
                                             plan.val_shards)
    want = st.eval_params(plan, ds)
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(got), _leaves(want)))
    st = get_strategy("strata")
    plan = st.prepare(data["train"], cfg, mesh)
    ds = st.init(plan, ft.TrainState(p0, 0), torch.Generator())
    out = st.step_batch(plan, ds, picks)
    got = shim.make_strata_step(cfg, mesh, plan.layout)(
        st._globalize(plan, ds).params, 0, picks, int(plan.schedule[0]))
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(got), _leaves(st._globalize(plan, out).params)))
    assert len(shim.init_error_feedback(p0)) == N


# ---------------------------------------------------------------------------
# mesh, collectives, registry
# ---------------------------------------------------------------------------

def test_host_mesh_defaults(monkeypatch):
    monkeypatch.delenv(pmesh.FORCE_ENV_VAR, raising=False)
    m = pmesh.make_host_mesh(device="cpu")
    assert m.size == 1 and m.axis_names == ("data", "model")
    monkeypatch.setenv(pmesh.FORCE_ENV_VAR, "4")
    m = pmesh.make_host_mesh(device="cpu")
    assert m.size == 4 and m.shape == (4, 1)
    assert m.devices == (torch.device("cpu"),) * 4
    assert m.distinct_devices() == (torch.device("cpu"),)
    m = pmesh.make_host_mesh(2, num_workers=5, device="cpu")
    assert m.shape == (2, 2) and m.size == 4
    assert pmesh.batch_axes(m) == ("data",)
    with pytest.raises(ValueError, match="256"):
        pmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        pmesh.make_production_mesh(multi_pod=True)


def test_rotate_and_psum_are_copies_in_worker_order():
    mesh = _mesh(3)
    shards = [torch.full((2, 2), float(m)) for m in range(3)]
    out = collectives.rotate(shards, 1, mesh)
    assert [float(t[0, 0]) for t in out] == [1.0, 2.0, 0.0]
    assert all(o.data_ptr() != s.data_ptr() for o in out for s in shards)
    assert collectives.rotate(shards, 3, mesh) == shards
    assert collectives.shard_bytes(shards, 1) == 48
    assert collectives.shard_bytes(shards, -3) == 0
    pending = collectives.SideStreams().rotate(shards, -1, mesh)
    assert [float(t[0, 0]) for t in pending.wait()] == [2.0, 0.0, 1.0]
    parts = [(torch.tensor([1e8]), torch.tensor([1.0])),
             (torch.tensor([1.0]), torch.tensor([2.0])),
             (torch.tensor([-1e8]), torch.tensor([3.0]))]
    summed = collectives.psum(parts, mesh)
    # (1e8 + 1) − 1e8 in f32 is 0: the order is 0, 1, 2
    assert all(float(s[0]) == 0.0 and float(s[1]) == 6.0 for s in summed)
    assert summed[1][0].data_ptr() != summed[0][0].data_ptr()
    one = collectives.psum(parts[:1], _mesh(1))
    assert one[0][0] is parts[0][0]


def test_strategy_resolution(monkeypatch):
    monkeypatch.delenv(base.ENV_VAR, raising=False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert resolve_strategy_name(None, mode="strata") == "strata"
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert resolve_strategy_name("sync", mode="strata") == "sync"
    assert resolve_strategy_name() == "local"
    monkeypatch.setenv(base.ENV_VAR, "strata_overlap")
    assert get_strategy().name == "strata_overlap"
    with pytest.raises(KeyError, match="strata_overlap"):
        get_strategy("nope")


@pytest.mark.parametrize("name", ["local", "sync", "strata",
                                  "strata_overlap"])
def test_lower_step_has_no_pytorch_meaning(data, name):
    st = get_strategy(name)
    with pytest.raises(NotImplementedError, match="no PyTorch counterpart"):
        st.lower_step(None, None)


def test_worker_generators(data):
    """Worker 0 continues the given generator; the others are seeded from
    it and m, so they differ from each other and from worker 0."""
    mesh = _mesh(3)
    gen = torch.Generator().manual_seed(11)
    rng = base.worker_rng(gen, mesh)
    assert rng.shape[0] == 3 and torch.equal(rng[0], gen.get_state())
    assert not torch.equal(rng[1], rng[2])
    assert torch.equal(rng, base.worker_rng(
        torch.Generator().manual_seed(11), mesh))
    picks, new = base.WorkerDraws(mesh).draw(rng, [50, 50, 50], 8)
    assert torch.equal(picks[0], torch.randint(0, 50, (8,), generator=gen))
    assert not torch.equal(new, rng)


# ---------------------------------------------------------------------------
# the launchers in-process
# ---------------------------------------------------------------------------

STD = ["--dims", "60,48,36", "--nnz", "20000", "--rank", "4",
       "--core-rank", "4", "--batch", "256", "--eval-every", "8",
       "--steps", "16", "--seed", "1", "--device", "cpu"]


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", ["sync", "strata", "strata_overlap"])
def test_std_train_main_strategies(monkeypatch, name, M):
    monkeypatch.setenv("REPRO_FORCE_HOST_DEVICES", str(M))
    res = std_train.main(STD + ["--strategy", name])
    rmse = [h["rmse"] for h in res["history"]]
    assert res["strategy"] == name and res["workers"] == M
    assert all(np.isfinite(rmse)) and rmse[-1] < rmse[0], rmse
    assert res["state"].params.factors[0].shape[0] == DIMS[0]
    if name == "sync":
        assert res["rotated_bytes_per_step"] == 0
    else:
        assert res["rotated_bytes_per_step"] > 0


def test_std_train_out_of_core_equals_resident(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_FORCE_HOST_DEVICES", "4")
    flags = STD + ["--backend", "torch", "--strategy", "strata_overlap"]
    a = std_train.main(flags)
    b = std_train.main(flags + ["--out-of-core", "--spill-dir",
                                str(tmp_path / "spill"),
                                "--prefetch-depth", "2"])
    assert b["store_bytes"] > 0 and a["store_bytes"] is None
    assert _same(a["dstate"], b["dstate"])
    assert [h["rmse"] for h in a["history"]] == \
        [h["rmse"] for h in b["history"]]
    assert NonzeroStore.open(str(tmp_path / "spill")).num_workers == 4


@pytest.mark.parametrize("flags,match", [
    (["--strategy", "sync", "--out-of-core"], "requires a strata strategy"),
    (["--strategy", "strata", "--out-of-core", "--adaptive-rank"],
     "drop --out-of-core")])
def test_std_train_out_of_core_refusals(monkeypatch, flags, match):
    def no_data(*a, **k):
        raise AssertionError("data was made before the refusal")

    monkeypatch.setattr(std_train, "planted_tensor", no_data)
    with pytest.raises(SystemExit, match=match):
        std_train.main(STD + flags)


def test_std_train_resume_strata(monkeypatch, tmp_path):
    """An interrupted strata run resumed with ``--resume`` ends on the
    uninterrupted run's bits (``--compress`` on: the residuals too)."""
    monkeypatch.setenv("REPRO_FORCE_HOST_DEVICES", "4")
    flags = STD + ["--backend", "torch", "--strategy", "strata",
                   "--compress"]
    full = std_train.main(flags + ["--ckpt-dir", str(tmp_path / "a")])
    std_train.main(_with_steps(flags, 8) + ["--ckpt-dir",
                                            str(tmp_path / "b")])
    res = std_train.main(flags + ["--ckpt-dir", str(tmp_path / "b"),
                                  "--resume"])
    assert res["resumed_from"] == 8
    assert _same(full["dstate"], res["dstate"])


def _with_steps(flags, steps):
    out = list(flags)
    out[out.index("--steps") + 1] = str(steps)
    return out


def test_std_train_adaptive_rank_under_strata(monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_HOST_DEVICES", "2")
    res = std_train.main(STD + ["--backend", "torch", "--strategy", "strata",
                                "--adaptive-rank", "--max-core-rank", "8",
                                "--plateau-tol", "10", "--plateau-patience",
                                "1", "--eval-every", "4"])
    assert res["rank_history"] and res["rank_history"][0]["rank"] == 8
    assert res["cfg"].core_rank in (4, 8)
    assert all(np.isfinite(h["rmse"]) for h in res["history"])


ONLINE = ["--dims", "16,12,10", "--nnz", "400", "--warmup-steps", "8",
          "--rounds", "2", "--refresh-steps", "2", "--batch", "64",
          "--rank", "2", "--core-rank", "2", "--window", "128",
          "--device", "cpu", "--verify"]


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", ["sync", "strata", "strata_overlap"])
def test_online_train_main_strategies(monkeypatch, name, M):
    monkeypatch.setenv("REPRO_FORCE_HOST_DEVICES", str(M))
    rec = online_train.main(ONLINE + ["--strategy", name])
    assert rec["strategy"] == name and rec["workers"] == M
    assert rec["store"].num_workers == M
    assert rec["verify"]["exact"] and len(rec["rounds"]) == 2
    assert rec["params"].factors[0].shape[0] == 16


def test_dataclass_plans_replace(data):
    """Plans stay dataclasses: the parity tests swap in the reference's
    schedule with ``dataclasses.replace``."""
    st = get_strategy("strata_overlap")
    plan = st.prepare(data["train"], _cfg(), _mesh(2))
    other = dataclasses.replace(plan, schedule=plan.schedule[::-1].copy())
    assert other.chunk == plan.chunk and other.layout is plan.layout
