"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where there is no CUDA card (decided in a
fixture, never at import).  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 sums in another order than the plain version (cuBLAS), and
atomics for the scatter — max |kernel − plain| ≤ 2e-5 · max |plain|
(1e-4 for the core gradient, summed over the whole batch).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fasttucker as ft
from repro_torch.kernels import (dispatch, kruskal_contract, kruskal_grad,
                                 launch_counts, ref, reset_launch_counts,
                                 scatter_accum)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, rel):
    err = (got - want).abs().max().item()
    assert err <= rel * max(want.abs().max().item(), 1e-30), err


@pytest.mark.parametrize("N,J,R,B", [(3, 4, 4, 1000), (4, 7, 5, 333),
                                     (3, 32, 32, 4099)])
def test_kernels_match_plain_on_card(dev, N, J, R, B):
    rng = np.random.default_rng(N * 100 + J)
    a = torch.tensor(rng.normal(0, 0.5, (N, B, J)), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(rng.normal(0, 0.5, (N, J, R)), dtype=torch.float32,
                     device=dev)
    val = torch.tensor(rng.normal(size=B), dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.random(B) > 0.2, dtype=torch.float32,
                        device=dev)
    scal = torch.tensor([1.0, 1 / mask.sum().item(), 0.01, 0.02, 1.0],
                        dtype=torch.float32, device=dev)
    reset_launch_counts()
    pred, pexc = kruskal_contract.kruskal_contract(a, b)
    pr, per = ref.kruskal_contract_ref(a, b)
    _close(pred, pr, 2e-5)
    _close(pexc, per, 2e-5)
    got = kruskal_grad.kruskal_grad(a, b, val, mask, scal)
    want = ref.kruskal_grad_ref(a, b, val, mask, scal)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 2e-5)
    _close(got.core_grads, want[3], 1e-4)
    idx = torch.tensor(rng.integers(-3, 53, B), dtype=torch.int32,
                       device=dev)
    _close(scatter_accum.scatter_accum(got.row_grads[0], idx, 50),
           ref.scatter_accum_ref(got.row_grads[0], idx, 50), 2e-5)
    torch.cuda.synchronize()
    assert launch_counts() == {"kruskal_contract": 1, "kruskal_grad": 1,
                               "scatter_accum": 1}


def test_kernel_raises_on_phase_flags_on_card(dev):
    a = torch.zeros((3, 8, 4), device=dev)
    b = torch.zeros((3, 4, 4), device=dev)
    v = torch.zeros(8, device=dev)
    scal = torch.zeros(5, device=dev)
    with pytest.raises(NotImplementedError):
        kruskal_grad.kruskal_grad(a, b, v, v, scal, want_core=False)


def test_step_cuda_matches_torch_on_card(dev):
    rng = np.random.default_rng(0)
    dims = (300, 200, 100)
    cfgs = {bk: ft.FastTuckerConfig(dims=dims, ranks=(4, 5, 6), core_rank=4,
                                    batch_size=512, backend=bk)
            for bk in ("cuda", "torch")}
    gen = torch.Generator(device=dev).manual_seed(0)
    p0 = ft.init_params(gen, cfgs["cuda"], dev)
    idx = torch.tensor(np.stack([rng.integers(0, d, 512) for d in dims], 1),
                       dtype=torch.int32, device=dev)
    val = torch.tensor(rng.normal(size=512), dtype=torch.float32, device=dev)
    outs = {bk: ft.sgd_step_batch(ft.TrainState(p0, 0), idx, val, cfg).params
            for bk, cfg in cfgs.items()}
    for g, w in zip(outs["cuda"].factors + outs["cuda"].core_factors,
                    outs["torch"].factors + outs["torch"].core_factors):
        _close(g, w, 1e-5)
    # the autograd Function's backward is the gradient kernel too
    rows = tuple(r.clone().requires_grad_() for r in
                 ft.gather_rows(p0.factors, idx))
    dispatch.kruskal_predict("cuda", rows, p0.core_factors).sum().backward()
    rows_t = tuple(r.detach().clone().requires_grad_() for r in rows)
    dispatch.get_backend("torch").kruskal_contract(
        rows_t, p0.core_factors)[0].sum().backward()
    for r, rt in zip(rows, rows_t):
        _close(r.grad, rt.grad, 2e-5)
