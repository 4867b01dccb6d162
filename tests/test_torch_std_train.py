"""The port's ``std_train`` driver, in process, at tiny dims on the CPU."""
import math

import pytest

from repro_torch.launch import std_train


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_std_train_rmse_finite_and_decreasing(backend):
    res = std_train.main([
        "--dims", "60,50,40", "--nnz", "8000", "--rank", "4",
        "--core-rank", "4", "--steps", "60", "--batch", "256",
        "--eval-every", "20", "--seed", "0", "--device", "cpu",
        "--backend", backend])
    rmse = [h["rmse"] for h in res["history"]]
    assert [h["step"] for h in res["history"]] == [0, 20, 40, 60]
    assert all(math.isfinite(r) for r in rmse)
    assert all(b < a for a, b in zip(rmse, rmse[1:])), rmse
    assert res["steps_per_s"] > 0 and res["peak_device_bytes"] is None
    assert res["train"].nnz == 7200 and res["test"].nnz == 800
