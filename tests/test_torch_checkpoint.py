"""The port's checkpoint manager and supervisor
(``repro_torch.checkpoint.manager``, ``repro_torch.runtime.fault``).

The contracts of the reference's ``tests/test_checkpoint.py`` and
``tests/test_fault.py``, held against the port: round trip, latest and
specific steps, gc, atomic commits with no partial directories, async
saves, an incompatible structure, a save killed among its leaves, between
the directory and the marker renames, or while clearing a re-saved step,
byte-stable re-saves; bf16 leaves restored bit for bit; restart on
failure, the restart budget, deterministic replay and straggler
detection.  Trees are drawn from numpy seeds; every comparison is exact.
Also ``backoff`` against the reference's schedule, draw for draw.
"""
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from repro.runtime import fault as jfault
from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.runtime.fault import (FailureInjector, Supervisor,
                                       SupervisorConfig, backoff)


def make_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
        "nested": {"b": torch.arange(10, dtype=torch.int32) + seed,
                   "c": (torch.ones(3) * seed, torch.zeros(())),
                   "h": torch.from_numpy(rng.normal(size=(5,)).astype(
                       np.float32)).to(torch.bfloat16)},
    }


def zeros_like_tree(tree):
    """The same structure, every leaf zero: a fresh state to restore into."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: zeros_like_tree(v) for k, v in tree.items()}
    return tuple(zeros_like_tree(v) for v in tree)


_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The leaf's bit patterns (NaN equals itself, -0.0 differs from 0)."""
    return t.view(_INT[t.element_size()]) if t.is_floating_point() else t


def trees_equal(t1, t2):
    f1, f2 = flatten(t1), flatten(t2)
    assert list(f1) == list(f2)
    for a, b in zip(f1.values(), f2.values()):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_roundtrip_with_bf16_bitwise(tmp_path):
    m = CheckpointManager(tmp_path)
    tree = make_tree()
    # a bf16 leaf with NaN, inf, a subnormal and a negative zero
    odd = torch.tensor([float("nan"), float("inf"), 1e-40, -0.0, 3.5],
                       dtype=torch.bfloat16)
    tree["nested"]["h"] = odd
    m.save(10, tree)
    fresh = zeros_like_tree(tree)
    restored, step = m.restore(fresh)
    assert step == 10 and restored is fresh
    trees_equal(tree, restored)
    mani = json.loads((tmp_path / "step_000000010" / "manifest.json")
                      .read_text())
    dt = {leaf["name"]: leaf["dtype"] for leaf in mani["leaves"]}
    assert dt["nested.h"] == "bfloat16" and dt["nested.b"] == "int32"
    assert [leaf["name"] for leaf in mani["leaves"]] == sorted(dt)


def test_restore_latest_and_specific(tmp_path):
    m = CheckpointManager(tmp_path, keep=10)
    for s in (1, 5, 9):
        m.save(s, make_tree(s))
    assert m.latest_step() == 9
    r5, _ = m.restore(make_tree(), step=5)
    trees_equal(make_tree(5), r5)
    r9, _ = m.restore(make_tree())
    trees_equal(make_tree(9), r9)
    manifest, leaves = m.load_leaves(5)
    assert manifest["step"] == 5 and len(leaves) == manifest["num_leaves"]


def test_gc_keeps_newest(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    for s in range(5):
        m.save(s, make_tree(s))
    assert m.all_steps() == [3, 4]


def test_atomic_no_partial_dirs(tmp_path):
    m = CheckpointManager(tmp_path)
    m.save(3, make_tree())
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    d = tmp_path / "step_000000003"
    mani = json.loads((d / "manifest.json").read_text())
    assert mani["num_leaves"] == len(flatten(make_tree()))


def test_async_save_copies_before_returning(tmp_path):
    """The leaves are copied at ``save``: changing the tree afterwards
    does not reach the checkpoint."""
    m = CheckpointManager(tmp_path)
    tree = make_tree(7)
    m.save(7, tree, blocking=False)
    tree["a"].add_(1.0)
    m.wait()
    r, s = m.restore(zeros_like_tree(tree))
    assert s == 7
    trees_equal(make_tree(7), r)


def test_async_save_failure_is_raised_by_wait(tmp_path, monkeypatch):
    """A background write that fails is not lost: ``wait()`` raises it,
    and the step stays uncommitted."""
    m = CheckpointManager(tmp_path)
    m.save(1, make_tree(1))

    def full_disk(path, arr):
        raise OSError("no space left on device")

    monkeypatch.setattr(np, "save", full_disk)
    m.save(2, make_tree(2), blocking=False)
    with pytest.raises(OSError, match="no space"):
        m.wait()
    monkeypatch.undo()
    m.wait()                                # reported once
    assert m.all_steps() == [1]


@pytest.mark.parametrize("other", [
    {"only": torch.zeros(3)},                                  # names
    "shape",
    "dtype",
])
def test_incompatible_structure_errors(tmp_path, other):
    m = CheckpointManager(tmp_path)
    m.save(1, make_tree())
    like = make_tree(2)
    if other == "shape":
        like["a"] = torch.zeros(4, 8)
    elif other == "dtype":
        like["a"] = torch.zeros(8, 4, dtype=torch.float64)
    else:
        like = other
    before = {k: v.clone() for k, v in flatten(like).items()}
    with pytest.raises(ValueError):
        m.restore(like)
    trees_equal(before, flatten(like))   # nothing was copied


def test_interrupted_save_leaves_previous_commit(tmp_path, monkeypatch):
    m = CheckpointManager(tmp_path)
    m.save(1, make_tree(1))
    real_save = np.save
    calls = {"n": 0}

    def dying_save(path, arr):
        calls["n"] += 1
        if calls["n"] == 3:            # die mid-way through the leaves
            raise KeyboardInterrupt("simulated kill during leaf write")
        real_save(path, arr)

    monkeypatch.setattr(np, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        m.save(2, make_tree(2))
    monkeypatch.setattr(np, "save", real_save)
    assert m.all_steps() == [1] and m.latest_step() == 1
    r, s = m.restore(make_tree())
    assert s == 1
    trees_equal(make_tree(1), r)
    m.save(2, make_tree(2))
    assert m.all_steps() == [1, 2]
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_interrupted_commit_marker_rename(tmp_path, monkeypatch):
    m = CheckpointManager(tmp_path)
    m.save(1, make_tree(1))
    real_replace = os.replace
    calls = {"n": 0}

    def dying_replace(src, dst):
        calls["n"] += 1
        if calls["n"] == 2:            # the marker rename is the 2nd call
            raise KeyboardInterrupt("simulated kill before commit marker")
        real_replace(src, dst)

    monkeypatch.setattr(os, "replace", dying_replace)
    with pytest.raises(KeyboardInterrupt):
        m.save(2, make_tree(2))
    monkeypatch.setattr(os, "replace", real_replace)
    d2 = tmp_path / "step_000000002"
    assert d2.exists() and not (d2 / "manifest.json").exists()
    assert (d2 / "manifest.json.staged").exists()
    assert m.all_steps() == [1] and m.latest_step() == 1
    r, s = m.restore(make_tree())
    assert s == 1
    trees_equal(make_tree(1), r)
    m.save(2, make_tree(2))
    assert m.all_steps() == [1, 2]
    r2, _ = m.restore(make_tree(), step=2)
    trees_equal(make_tree(2), r2)


def test_interrupted_resave_falls_back_to_older_commit(tmp_path,
                                                      monkeypatch):
    m = CheckpointManager(tmp_path, keep=10)
    m.save(1, make_tree(1))
    m.save(2, make_tree(2))

    def dying_rmtree(path, **kw):
        raise KeyboardInterrupt("simulated kill while clearing old step")

    monkeypatch.setattr(shutil, "rmtree", dying_rmtree)
    with pytest.raises(KeyboardInterrupt):
        m.save(2, make_tree(3))
    monkeypatch.undo()
    assert m.all_steps() == [1] and m.latest_step() == 1
    r, s = m.restore(make_tree())
    assert s == 1
    trees_equal(make_tree(1), r)


def test_save_restore_save_byte_stable(tmp_path):
    m = CheckpointManager(tmp_path, keep=10)
    tree = make_tree()
    m.save(1, tree)
    r, _ = m.restore(zeros_like_tree(tree))
    m.save(2, r)
    d1 = tmp_path / "step_000000001"
    d2 = tmp_path / "step_000000002"
    files = sorted(d1.glob("*.npy"))
    assert len(files) == len(flatten(tree))
    for f in files:
        assert f.read_bytes() == (d2 / f.name).read_bytes()


def test_flatten_names_modules_and_named_tuples():
    from repro_torch.optim.adamw import AdamWState

    lin = torch.nn.Linear(2, 3)
    st = AdamWState(torch.zeros((), dtype=torch.int32),
                    {"w": torch.zeros(1)}, {"w": torch.ones(1)})
    names = list(flatten({"params": lin, "opt": st}))
    assert names == ["opt.m.w", "opt.step", "opt.v.w", "params.bias",
                     "params.weight"]
    with pytest.raises(TypeError, match="not a tensor"):
        flatten({"x": 3})


# --- the supervisor: the reference's tests/test_fault.py -------------------

def counter_step(injector=None):
    def step(state, i):
        if injector is not None:
            injector.maybe_fail(i)
        return {"x": state["x"] + 1.0,
                "i": torch.tensor(i + 1, dtype=torch.int64)}
    return step


def test_failure_restores_and_completes(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    sup = Supervisor(ckpt, SupervisorConfig(checkpoint_every=5,
                                            async_checkpoint=False))
    inj = FailureInjector({12, 17})
    state = {"x": torch.zeros(()), "i": torch.tensor(0)}
    out = sup.run(state, counter_step(inj), num_steps=25)
    assert float(out["x"]) == 25.0
    assert sup.stats.restarts == 2
    assert sup.stats.checkpoints >= 4


def test_out_of_restarts_raises(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    sup = Supervisor(ckpt, SupervisorConfig(checkpoint_every=100,
                                            max_restarts=1,
                                            async_checkpoint=False))

    def always_fail(state, i):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="out of restarts"):
        sup.run({"x": torch.zeros(())}, always_fail, num_steps=3)


@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_replay_is_deterministic(tmp_path, async_checkpoint):
    """After restore, the replayed steps give the no-failure state, bit
    for bit (f32 arithmetic in the same order)."""
    ckpt = CheckpointManager(tmp_path)
    sup = Supervisor(ckpt, SupervisorConfig(
        checkpoint_every=4, async_checkpoint=async_checkpoint))
    inj = FailureInjector({9})

    def step(state, i):
        inj.maybe_fail(i)
        return {"x": state["x"] * 1.5 + i}

    out_fail = sup.run({"x": torch.ones(())}, step, num_steps=12)
    ref = {"x": torch.ones(())}
    for i in range(12):
        ref = {"x": ref["x"] * 1.5 + i}
    assert torch.equal(out_fail["x"], ref["x"])
    assert sup.stats.restarts == 1


def test_straggler_detection(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    sup = Supervisor(ckpt, SupervisorConfig(
        checkpoint_every=1000, straggler_factor=5.0, ewma_alpha=0.5))

    def step(state, i):
        time.sleep(0.3 if i == 6 else 0.01)
        return state

    sup.run({"x": torch.zeros(())}, step, num_steps=10)
    assert sup.stats.straggler_steps >= 1


def test_backoff_matches_reference():
    for seed in (0, 3):
        for attempt in range(6):
            assert backoff(attempt, seed=seed) == jfault.backoff(
                attempt, seed=seed)
    with pytest.raises(ValueError):
        backoff(-1)
