"""The port's online-training slice on the CPU: the supervisor's ``store=``
ingest fold, the refresh's device ids, and ``launch/online_train``.

* ``RefreshSupervisor(store=...)``: each round's arrivals fold into the
  store exactly once, also when an injected ingest fault makes the stage
  retry; the result equals ``NonzeroStore.build`` of the concatenation
  (in memory and spilled) and the tables a never-faulted run's.
* ``refresh_steps``: the device ids the publish gathers with are the
  host ids, and a second call from the same state repeats its bits.
* ``online_train.main`` in-process with ``--device cpu``: ``--spill-dir
  --verify`` (its spilled store equals the reference's ``online_train``
  store from the same flags with ``--serve-shard-mode none``, array for
  array, with the same ``meta.json``), under ``--inject-faults ...
  --expect-breaker`` (ending on the unfaulted run's bits), and with
  ``--table-dtype bfloat16 --verify`` (banded as in the reference); the
  refusals of ``row``/``batch`` and of the unported strategies raise
  before any data is made.
"""
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core import fasttucker as ft
from repro_torch.core.sptensor import SparseTensor
from repro_torch.data import NonzeroStore, planted_tensor
from repro_torch.distributed import get_strategy
from repro_torch.launch import online_train
from repro_torch.runtime.fault import FaultPlan
from repro_torch.serve import RefreshSupervisor, SupervisorConfig, TuckerServer

DIMS = (12, 10, 8)
FIELDS = ("indices", "values", "mask")
# the reference's green single-device run (its CLI test uses row mode)
FLAGS = ["--strategy", "local", "--dims", "16,12,10", "--nnz", "400",
         "--warmup-steps", "4", "--rounds", "2", "--refresh-steps", "2",
         "--batch", "64", "--rank", "2", "--core-rank", "2",
         "--window", "128"]
FAULTS = "refresh@0:1:2,publish@0,ingest@1"


def _same_arrays(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def _env(seed=0, nnz=500, stream=120):
    t = planted_tensor(DIMS, nnz, rank=3, core_rank=3, seed=seed,
                       device="cpu")
    idx, val = t.indices.numpy(), t.values.numpy()
    n_warm = nnz - stream
    warm_t = SparseTensor.from_numpy(idx[:n_warm], val[:n_warm], DIMS, "cpu")
    strategy = get_strategy("local")
    cfg = ft.FastTuckerConfig(dims=DIMS, ranks=(3,) * 3, core_rank=3,
                              batch_size=64)
    plan = strategy.prepare(warm_t, cfg, None, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    dstate = strategy.init(plan, ft.init_state(gen, cfg, "cpu"), gen)
    step = strategy.make_step(plan)
    for _ in range(4):
        dstate = step(dstate)
    return dict(strategy=strategy, plan=plan, dstate=dstate, warm_t=warm_t,
                warm=(idx[:n_warm], val[:n_warm]),
                stream=(idx[n_warm:], val[n_warm:]), all=(idx, val))


def _supervised(env, store, faults=None, rounds=3):
    srv = TuckerServer(env["strategy"].eval_params(env["plan"],
                                                   env["dstate"]))
    sup = RefreshSupervisor(
        srv, env["strategy"], env["plan"], env["dstate"], store=store,
        config=SupervisorConfig(refresh_steps=2, window=40,
                                backoff_base_s=1e-4, backoff_cap_s=1e-3,
                                degraded_retry_s=1e-3),
        fault_plan=FaultPlan.parse(faults) if faults else None,
        history=env["warm"])
    s_idx, s_val = env["stream"]
    per = len(s_val) // rounds
    for r in range(rounds):
        sup.run_round(s_idx[r * per:(r + 1) * per],
                      s_val[r * per:(r + 1) * per], max_cycles=5)
    return srv, sup


@pytest.mark.parametrize("spill", [False, True])
def test_supervisor_store_folds_each_round_once(tmp_path, spill):
    env = _env()
    spill_dir = str(tmp_path / "s") if spill else None
    srv0, sup0 = _supervised(env, NonzeroStore.build(env["warm_t"], 1))
    store = NonzeroStore.build(env["warm_t"], 1, spill_dir=spill_dir)
    # the second round's ingest fails twice and retries: one append only
    srv, sup = _supervised(env, store, faults="ingest@1:2")
    h = sup.health()
    assert h["faults_injected"] == 2 and h["retries"] == 2
    assert h["rounds_ok"] == 3
    assert set(h["stage_seconds"]) == {"ingest", "transfer", "refresh",
                                       "publish"}
    idx, val = env["all"]
    assert sup.store.nnz == len(val) == sup0.store.nnz
    assert sup.store.spilled == spill
    _same_arrays(sup.store, NonzeroStore.build((idx, val, DIMS), 1))
    _same_arrays(sup.store, sup0.store)
    for a, b in zip(srv._tables, srv0._tables):
        assert torch.equal(a, b)
    assert torch.equal(sup.dstate.rng, sup0.dstate.rng)


def test_supervisor_without_store_keeps_none():
    env = _env()
    srv, sup = _supervised(env, None, rounds=1)
    assert sup.store is None and sup.health()["rounds_ok"] == 1


def test_refresh_steps_device_ids_match_host_ids():
    env = _env()
    st, plan, ds = env["strategy"], env["plan"], env["dstate"]
    w_idx, w_val = env["stream"]
    a, host, _ = st.refresh_steps(plan, ds, w_idx, w_val, 3)
    b, host2, dev = st.refresh_steps(plan, ds, w_idx, w_val, 3)
    assert torch.equal(a.rng, b.rng)
    for f, g in zip(a.params.factors, b.params.factors):
        assert torch.equal(f, g)
    for h, h2, d in zip(host, host2, dev):
        assert h.dtype == np.int32 and d.dtype == torch.int64
        np.testing.assert_array_equal(h, h2)
        np.testing.assert_array_equal(d.numpy(), h)


# ---------------------------------------------------------------------------
# online_train
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_spill(tmp_path_factory):
    """The reference's online_train, in-process, spilling its store."""
    from repro.launch import online_train as ref_online

    d = tmp_path_factory.mktemp("ref") / "spill"
    argv = ["online_train", *FLAGS, "--serve-shard-mode", "none",
            "--spill-dir", str(d), "--verify"]
    with mock.patch.object(sys, "argv", argv):
        ref_online.main()
    return d


@pytest.fixture(scope="module")
def port_spill(tmp_path_factory):
    d = tmp_path_factory.mktemp("port") / "spill"
    rec = online_train.main([*FLAGS, "--device", "cpu", "--spill-dir",
                             str(d), "--verify"])
    return d, rec


def test_online_train_cpu_spill_verify(port_spill):
    d, rec = port_spill
    assert rec["verify"] == {"exact": True, "generations": 4}
    assert [r["publish"] for r in rec["rounds"]] == ["patch", "rebuild"]
    assert sum(r["arrivals"] for r in rec["rounds"]) == rec["n_stream"]
    assert rec["rounds"][-1]["store_nnz"] == rec["train"].nnz
    assert all(r["state"] == "ok" and np.isfinite(r["rmse"])
               for r in rec["rounds"])
    # the CPU launches no CUDA kernel
    assert not any(v for r in rec["rounds"] for v in r["launches"].values())
    assert rec["store"].spilled and str(rec["store"].path) == str(d)
    # the served factors are the refreshed ones
    for a, b in zip(rec["server"].params.factors, rec["params"].factors):
        assert torch.equal(a, b)


def test_online_train_store_equals_reference(port_spill, reference_spill):
    from repro.data.pipeline import NonzeroStore as RefStore

    d, _ = port_spill
    ours, ref = NonzeroStore.open(str(d)), RefStore.open(str(reference_spill))
    assert ours.meta == ref.meta
    assert (d / "meta.json").read_bytes() == \
        (reference_spill / "meta.json").read_bytes()
    _same_arrays(ours, ref)


def test_online_train_faulted_run_ends_on_unfaulted_bits(port_spill,
                                                         tmp_path):
    _, clean = port_spill
    rec = online_train.main([*FLAGS, "--device", "cpu", "--spill-dir",
                             str(tmp_path / "f"), "--verify",
                             "--inject-faults", FAULTS, "--expect-breaker"])
    h = rec["health"]
    assert h["breaker_trips"] >= 1 and h["recoveries"] >= 1
    assert h["faults_injected"] == 5 and h["rounds_ok"] == 2
    assert rec["verify"]["exact"]
    for a, b in zip(rec["server"]._tables, clean["server"]._tables):
        assert torch.equal(a, b)
    for a, b in zip(rec["dstate"].params.factors,
                    clean["dstate"].params.factors):
        assert torch.equal(a, b)
    assert torch.equal(rec["dstate"].rng, clean["dstate"].rng)
    _same_arrays(rec["store"], clean["store"])


def test_online_train_bf16_tables_banded(port_spill):
    rec = online_train.main([*FLAGS, "--device", "cpu", "--table-dtype",
                             "bfloat16", "--verify"])
    assert rec["verify"] == {"exact": False, "generations": 4}
    assert not rec["store"].spilled
    _same_arrays(rec["store"], port_spill[1]["store"])


def test_online_train_data_reuse(port_spill):
    _, clean = port_spill
    args = online_train.parse_args([*FLAGS, "--device", "cpu"])
    rec = online_train.run(args, data=(clean["train"], clean["test"]))
    for a, b in zip(rec["server"]._tables, clean["server"]._tables):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="do not match"):
        online_train.run(online_train.parse_args(
            [*FLAGS, "--device", "cpu", "--dims", "16,12,11"]),
            data=(clean["train"], clean["test"]))


@pytest.mark.parametrize("flags,exc,match", [
    (["--backend", "bogus"], KeyError, "unknown kernel backend"),
    (["--inject-faults", "refresh@"], ValueError, "no check indices"),
    (["--strategy", "bogus"], KeyError, "unknown distributed strategy"),
])
def test_online_train_refusals_before_data(monkeypatch, flags, exc, match):
    def no_data(*a, **k):
        raise AssertionError("data was made before the refusal")

    monkeypatch.setattr(online_train, "planted_tensor", no_data)
    with pytest.raises(exc, match=match):
        online_train.main([*FLAGS, "--device", "cpu", *flags])


@pytest.mark.parametrize("shard_mode", ["row", "batch"])
@pytest.mark.parametrize("strategy", ["local", "strata"])
def test_online_train_serve_shard_modes_run(monkeypatch, strategy,
                                            shard_mode):
    """``--serve-shard-mode row|batch``, once refused, serves the tables
    over the training mesh (``strata``) or a host mesh (``local``) of two
    workers; the supervisor's patch and rebuild rounds leave every
    worker's block or replica bitwise a fresh sharded server's
    (``--verify``), and the sharded tables equal the unsharded run's."""
    monkeypatch.setenv("REPRO_FORCE_HOST_DEVICES", "2")
    flags = [*FLAGS, "--device", "cpu", "--backend", "torch", "--strategy",
             strategy, "--verify"]
    rec = online_train.main(flags + ["--serve-shard-mode", shard_mode])
    srv = rec["server"]
    assert srv.shard_mode == shard_mode and rec["serve_workers"] == 2
    assert rec["verify"]["exact"] and len(rec["rounds"]) == 2
    plain = online_train.main(flags)
    assert plain["server"].shard_mode == "none"
    for a, b in zip(srv._tables, plain["server"]._tables):
        assert torch.equal(a, b)


def test_online_train_strata_runs(monkeypatch):
    """``--strategy strata``, once refused, runs on two workers: the store
    is built at the mesh's worker count, the refresh re-pads, and the
    patched tables equal a fresh server's (``--verify``)."""
    monkeypatch.setenv("REPRO_FORCE_HOST_DEVICES", "2")
    rec = online_train.main([*FLAGS, "--device", "cpu", "--backend", "torch",
                             "--strategy", "strata", "--verify"])
    assert rec["strategy"] == "strata" and rec["workers"] == 2
    assert rec["store"].num_workers == 2
    assert rec["verify"]["exact"] and len(rec["rounds"]) == 2
