"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where there is no CUDA card (decided in a
fixture, never at import).  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 sums in another order than the plain version (cuBLAS) —
max |kernel − plain| ≤ 2e-5 · max |plain| (``tucker_matmul`` and
``flash_attention`` included: their 3xTF32 tensor-core products are
f32-accurate, and one pass of TF32, ~3e-4, would fail) (1e-4 for the core
gradient, summed over the whole batch).  The two scatters
(``scatter_accum`` unsorted, ``segment_reduce`` sorted) have no atomics
and fold each row in the plain version's order: they must match it
exactly, and the unsorted step must equal the sorted one bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fasttucker as ft
from repro_torch.kernels import (dispatch, flash_attention,
                                 flash_attention_bwd, kruskal_contract,
                                 kruskal_grad, launch_counts, ref,
                                 reset_launch_counts, scatter_accum,
                                 segment_reduce, tucker_matmul)

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
                                     (3, 32, 32, 4099), (4, 32, 32, 4096),
                                     (3, 48, 48, 4099), (4, 64, 64, 4096)])
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
    assert torch.equal(scatter_accum.scatter_accum(got.row_grads[0], idx, 50),
                       ref.scatter_accum_ref(got.row_grads[0], idx, 50))
    sidx = idx.sort(stable=True).values
    sr = segment_reduce.segment_reduce(got.row_grads[0], sidx, 50)
    assert torch.equal(sr, ref.segment_reduce_ref(got.row_grads[0], sidx, 50))
    torch.cuda.synchronize()
    assert launch_counts() == {"kruskal_contract": 1, "kruskal_grad": 1,
                               "scatter_accum": 1, "segment_reduce": 1,
                               "tucker_matmul": 0, "flash_attention": 0,
                               "flash_attention_bwd": 0}


FLAGS = [
    # (consume c, row_modes, want_core, emit_c)
    (False, None, True, False),     # the joint pass
    (False, None, False, True),     # factor phase: emit the mode products
    (True, (), True, False),        # core phase: consume them
    (True, (1,), False, False),     # Gauss-Seidel: one mode's rows
    (False, (2, 0), True, True),
    (True, (0, 1, 2), False, True),
]


@pytest.mark.parametrize("consume,row_modes,want_core,emit_c", FLAGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("J,R", [(6, 4), (48, 48), (64, 64)])
def test_kernel_every_phase_flag_matches_plain_on_card(
        dev, consume, row_modes, want_core, emit_c, dtype, J, R):
    rng = np.random.default_rng(3)
    N, B = 3, 4099
    a = torch.tensor(rng.normal(0, 0.5, (N, B, J)), dtype=dtype, device=dev)
    b = torch.tensor(rng.normal(0, 0.5, (N, J, R)), dtype=dtype, device=dev)
    val = torch.tensor(rng.normal(size=B), dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.random(B) > 0.2, dtype=torch.float32,
                        device=dev)
    scal = torch.tensor([1.0, 1 / mask.sum().item(), 0.01, 0.02, 1.0],
                        dtype=torch.float32, device=dev)
    c = torch.bmm(a.float(), b.float()) if consume else None
    got = kruskal_grad.kruskal_grad(a, b, val, mask, scal, c,
                                    row_modes=row_modes, want_core=want_core,
                                    emit_c=emit_c)
    want = ref.kruskal_grad_ref(a, b, val, mask, scal, c,
                                row_modes=row_modes, want_core=want_core,
                                emit_c=emit_c)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.float32
            _close(g, w, 1e-4 if i == 3 else 2e-5)
    # a core pass fed the emitted c gives the joint core gradient exactly
    joint = kruskal_grad.kruskal_grad(a, b, val, mask, scal)
    fac = kruskal_grad.kruskal_grad(a, b, val, mask, scal, want_core=False,
                                    emit_c=True)
    core = kruskal_grad.kruskal_grad(a, b, val, mask, scal, fac.c,
                                     row_modes=())
    assert torch.equal(core.core_grads, joint.core_grads)
    assert torch.equal(fac.row_grads, joint.row_grads)


def _device_kernels(fn, calls=3):
    """Names of the device kernels that ``calls`` calls of ``fn`` issue,
    from ``torch.profiler``, after a first call that builds the library and
    makes the stream's ticket.  A marker kernel (``torch.cuda._sleep``)
    opens each window: a trace without it recorded no device activity at
    all, and is taken again (at most three times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if "CUDA" in str(e.device_type)]
        if any("spin" in n for n in names):
            return [n for n in names if "spin" not in n]
    raise AssertionError("the profiler recorded no device activity")


def _grad_inputs(dev, N, B, J, R, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.normal(0, 0.5, (N, B, J)), dtype=dtype, device=dev)
    b = torch.tensor(rng.normal(0, 0.5, (N, J, R)), dtype=dtype, device=dev)
    val = torch.tensor(rng.normal(size=B), dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.random(B) > 0.2, dtype=torch.float32,
                        device=dev)
    scal = torch.tensor([1.0, 1 / max(mask.sum().item(), 1.0), 0.01, 0.02,
                         1.0], dtype=torch.float32, device=dev)
    return a, b, val, mask, scal


def _check_grad(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w, 1e-4 if i == 3 else 2e-5)


@pytest.mark.parametrize("consume,row_modes,want_core,emit_c", FLAGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kruskal_grad_is_one_device_kernel_per_call(
        dev, consume, row_modes, want_core, emit_c, dtype):
    """Every flag combination and storage dtype: one kernel, the core sum
    across blocks included (no second reduction launch)."""
    a, b, val, mask, scal = _grad_inputs(dev, 3, 4096, 4, 4, dtype)
    c = torch.bmm(a.float(), b.float()) if consume else None
    names = _device_kernels(lambda: kruskal_grad.kruskal_grad(
        a, b, val, mask, scal, c, row_modes=row_modes, want_core=want_core,
        emit_c=emit_c))
    assert len(names) == 3, names
    assert all("kruskal_grad_kernel" in n for n in names), names


@pytest.mark.parametrize("B", [1, 7, 4099, 1_000_000])
def test_kruskal_grad_edge_batches_on_card(dev, B):
    """One sample, fewer than a tile, a ragged last tile, and several tiles
    a block at MAX_BLOCKS: plain within tolerance, the same bits twice."""
    N, J, R = 3, 4, 4
    pl = kruskal_grad.plan(N, J, R, B)
    if B == 1_000_000:
        assert pl.blocks == kruskal_grad.MAX_BLOCKS
        assert -(-B // pl.bt) > 2 * pl.blocks
    a, b, val, mask, scal = _grad_inputs(dev, N, B, J, R, seed=B)
    got = kruskal_grad.kruskal_grad(a, b, val, mask, scal)
    again = kruskal_grad.kruskal_grad(a, b, val, mask, scal)
    _check_grad(got, ref.kruskal_grad_ref(a, b, val, mask, scal))
    for g, h in zip(got[:4], again[:4]):
        assert torch.equal(g, h)


def test_kruskal_grad_ticket_reused_across_calls_and_streams(dev):
    """Back-to-back calls with 128, 1, 256 and 3 blocks share the stream's
    ticket; calls on two other streams at once use their own.  Every core
    gradient is the bits of the same call alone on the default stream."""
    shapes = [4096, 5, 1_000_000, 70]
    ins = {B: _grad_inputs(dev, 3, B, 4, 4, seed=B) for B in shapes}
    alone = {}
    for B in shapes:
        alone[B] = kruskal_grad.kruskal_grad(*ins[B]).core_grads
        torch.cuda.synchronize()
    assert [kruskal_grad.plan(3, 4, 4, B).blocks for B in shapes] == [
        128, 1, 256, 3]
    for B in shapes + shapes[::-1]:           # queued back to back
        assert torch.equal(kruskal_grad.kruskal_grad(*ins[B]).core_grads,
                           alone[B])
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for s, B in zip(streams, (1_000_000, 4096)):
            with torch.cuda.stream(s):
                outs.append((B, kruskal_grad.kruskal_grad(*ins[B])))
    torch.cuda.synchronize()
    for B, o in outs:
        assert torch.equal(o.core_grads, alone[B])
    _close(alone[4096], ref.kruskal_grad_ref(*ins[4096])[3], 1e-4)


def test_segment_reduce_is_one_device_kernel_per_call(dev):
    """No zero fill beside the kernel: it writes every row itself."""
    rng = np.random.default_rng(2)
    g = torch.tensor(rng.normal(size=(4096, 4)), dtype=torch.float32,
                     device=dev)
    idx = torch.tensor(np.sort(rng.integers(0, 480_189, 4096)),
                       dtype=torch.int32, device=dev)
    names = _device_kernels(
        lambda: segment_reduce.segment_reduce(g, idx, 480_189))
    assert len(names) == 3, names
    assert all("segment_reduce_kernel" in n for n in names), names


SEGMENT_CASES = {
    "all_equal": (4096, 50, lambda rng, B, rows: np.full(B, 17)),
    "outside": (4096, 300,
                lambda rng, B, rows: rng.integers(-40, rows + 40, B)),
    "one_row": (1000, 1, lambda rng, B, rows: rng.integers(-1, 2, B)),
    "netflix_mode0": (4096, 480_189,
                      lambda rng, B, rows: rng.integers(0, rows, B)),
}


@pytest.mark.parametrize("J", [1, 3, 4, 32, 48, 64])
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_reduce_bitwise_into_nan_memory_on_card(dev, case, J):
    """One run of length B, ids below 0 and >= rows, rows = 1, and the
    Netflix mode 0 shape, each written into memory that held NaN: bitwise
    the plain version."""
    B, rows, draw = SEGMENT_CASES[case]
    rng = np.random.default_rng(J)
    g = torch.tensor(rng.normal(size=(B, J)), dtype=torch.float32,
                     device=dev)
    idx = torch.tensor(np.sort(draw(rng, B, rows)), dtype=torch.int32,
                       device=dev)
    want = ref.segment_reduce_ref(g, idx, rows)
    nan = torch.full((rows, J), float("nan"), device=dev)
    ptr = nan.data_ptr()
    del nan
    got = segment_reduce.segment_reduce(g, idx, rows)
    assert got.data_ptr() == ptr     # the NaN block, reused
    assert torch.equal(got, want)
    assert torch.equal(segment_reduce.segment_reduce(g, idx, rows), want)


NETFLIX_ROWS = (480_189, 17_770, 2_182)


@pytest.mark.parametrize("J", [4, 64])
@pytest.mark.parametrize("rows", NETFLIX_ROWS)
def test_scatter_accum_exact_at_the_netflix_modes_on_card(dev, rows, J):
    """B = 4096 unsorted ids at each mode's row count: bitwise the ordered
    plain version, and bitwise the sorted kernel over the stable-sorted
    batch; the "torch" oracle repeats itself on the card too."""
    rng = np.random.default_rng(rows + J)
    g = torch.tensor(rng.normal(size=(4096, J)), dtype=torch.float32,
                     device=dev)
    idx = torch.tensor(rng.integers(0, rows, 4096), dtype=torch.int32,
                       device=dev)
    got = scatter_accum.scatter_accum(g, idx, rows)
    want = ref.scatter_accum_ref(g, idx, rows)
    assert torch.equal(got, want)
    assert torch.equal(ref.scatter_accum_ref(g, idx, rows), want)
    sidx, perm = torch.sort(idx, stable=True)
    assert torch.equal(segment_reduce.segment_reduce(g[perm].contiguous(),
                                                     sidx, rows), got)


@pytest.mark.parametrize("J", [1, 4, 64])
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_scatter_accum_bitwise_into_nan_memory_on_card(dev, case, J):
    """Every id equal, ids below 0 and >= rows, rows = 1 (one block) and
    the Netflix mode 0 shape, unsorted, each written into memory that held
    NaN: bitwise the plain version, twice."""
    B, rows, draw = SEGMENT_CASES[case]
    rng = np.random.default_rng(J + 1)
    g = torch.tensor(rng.normal(size=(B, J)), dtype=torch.float32,
                     device=dev)
    idx = torch.tensor(draw(rng, B, rows), dtype=torch.int32, device=dev)
    want = ref.scatter_accum_ref(g, idx, rows)
    nan = torch.full((rows, J), float("nan"), device=dev)
    ptr = nan.data_ptr()
    del nan
    got = scatter_accum.scatter_accum(g, idx, rows)
    assert got.data_ptr() == ptr     # the NaN block, reused
    assert torch.equal(got, want)
    assert torch.equal(scatter_accum.scatter_accum(g, idx, rows), want)


@pytest.mark.parametrize("B,rows,J", [(10_000, 480_189, 64),
                                      (9_000, 2_182, 4)])
def test_scatter_accum_many_rounds_and_sub_tiles_on_card(dev, B, rows, J):
    """More ids than one round (4096) and, at J = 64, a block range of
    many sub-tiles: each sub-tile lists every round again; bitwise the
    plain version."""
    pl = scatter_accum.plan(rows, J, B)
    assert pl.rounds == 3
    rng = np.random.default_rng(B)
    g = torch.tensor(rng.normal(size=(B, J)), dtype=torch.float32,
                     device=dev)
    idx = torch.tensor(rng.integers(-2, rows + 2, B), dtype=torch.int32,
                       device=dev)
    assert torch.equal(scatter_accum.scatter_accum(g, idx, rows),
                       ref.scatter_accum_ref(g, idx, rows))


def test_scatter_accum_is_one_device_kernel_per_call(dev):
    """No zero fill beside the kernel: it writes every row itself."""
    rng = np.random.default_rng(4)
    g = torch.tensor(rng.normal(size=(4096, 4)), dtype=torch.float32,
                     device=dev)
    idx = torch.tensor(rng.integers(0, 480_189, 4096), dtype=torch.int32,
                       device=dev)
    names = _device_kernels(
        lambda: scatter_accum.scatter_accum(g, idx, 480_189))
    assert len(names) == 3, names
    assert all("scatter_accum_kernel" in n for n in names), names


@pytest.mark.parametrize("order", ["jacobi", "gauss_seidel"])
@pytest.mark.parametrize("split", [False, True])
def test_unsorted_step_equals_sorted_on_card(dev, order, split):
    """Five fed batches on "cuda", f32: the unsorted step equals the
    mode-sorted one bitwise, and repeats itself bitwise."""
    dims = (300, 200, 100)
    cfgs = {srt: ft.FastTuckerConfig(
        dims=dims, ranks=(4, 5, 6), core_rank=4, batch_size=512,
        backend="cuda", update_order=order, phase_split=split,
        sorted_batches=srt) for srt in (False, True)}
    gen = torch.Generator(device=dev).manual_seed(0)
    p0 = ft.init_params(gen, cfgs[False], dev)
    rng = np.random.default_rng(2)
    batches = [(torch.tensor(np.stack([rng.integers(0, d, 512)
                                       for d in dims], 1),
                             dtype=torch.int32, device=dev),
                torch.tensor(rng.normal(size=512), dtype=torch.float32,
                             device=dev)) for _ in range(5)]
    runs = []
    for srt in (False, True, False):
        st = ft.TrainState(p0, 0)
        for idx, val in batches:
            st = ft.sgd_step_batch(st, idx, val, cfgs[srt])
        runs.append(st.params)
    for run in runs[1:]:
        for x, y in zip(runs[0].factors + runs[0].core_factors,
                        run.factors + run.core_factors):
            assert torch.equal(x, y)


@pytest.mark.parametrize("N,J,R", [(3, 4, 4), (4, 8, 5), (3, 5, 3),
                                   (5, 8, 8), (3, 48, 48), (4, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kruskal_contract_with_and_without_pexc_on_card(dev, N, J, R,
                                                        dtype):
    """Both routes (one thread a sample up to width 8, a lane group
    above), with a batch that is not a multiple of any block: the plain
    version within 2e-5, and pred the same bits with and without pexc."""
    rng = np.random.default_rng(N * J + R)
    B = 262_147
    a = torch.tensor(rng.normal(0, 0.5, (N, B, J)), dtype=dtype, device=dev)
    b = torch.tensor(rng.normal(0, 0.5, (N, J, R)), dtype=dtype, device=dev)
    reset_launch_counts()
    pred, pexc = kruskal_contract.kruskal_contract(a, b)
    only, none = kruskal_contract.kruskal_contract(a, b, want_pexc=False)
    pr, per = ref.kruskal_contract_ref(a, b)
    torch.cuda.synchronize()
    assert none is None and pexc.shape == (N, B, R)
    _close(pred, pr, 2e-5)
    _close(pexc, per, 2e-5)
    assert torch.equal(only, pred)
    assert torch.equal(kruskal_contract.kruskal_contract(a, b)[1], pexc)
    assert launch_counts()["kruskal_contract"] == 3


def test_sorted_phase_split_step_equals_joint_on_card(dev):
    rng = np.random.default_rng(1)
    dims = (300, 200, 100)
    cfgs = {split: ft.FastTuckerConfig(
        dims=dims, ranks=(4, 5, 6), core_rank=4, batch_size=512,
        backend="cuda", sorted_batches=True, phase_split=split)
        for split in (False, True)}
    gen = torch.Generator(device=dev).manual_seed(0)
    p0 = ft.init_params(gen, cfgs[False], dev)
    outs = {}
    for split, cfg in cfgs.items():
        st = ft.TrainState(p0, 0)
        for _ in range(3):
            idx = torch.tensor(
                np.stack([rng.integers(0, d, 512) for d in dims], 1),
                dtype=torch.int32, device=dev)
            val = torch.tensor(rng.normal(size=512), dtype=torch.float32,
                               device=dev)
            st = ft.sgd_step_batch(st, idx, val, cfg)
        outs[split] = st.params
        rng = np.random.default_rng(1)
    for x, y in zip(outs[False].factors + outs[False].core_factors,
                    outs[True].factors + outs[True].core_factors):
        assert torch.equal(x, y)


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


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


TUCKER_F32_TOL = 2e-5   # 3xTF32 and f32 sums: ~1e-6; one TF32 pass: ~3e-4


def _tucker_inputs(dev, M, K, R1, R2, N, xdt, wdt, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(M, K)), device=dev).to(xdt)
    u1 = torch.tensor(rng.normal(size=(K, R1)) / np.sqrt(K),
                      device=dev).to(wdt)
    g = torch.tensor(rng.normal(size=(R1, R2)), device=dev).to(wdt)
    u2 = torch.tensor(rng.normal(size=(N, R2)), device=dev).to(wdt)
    return x, u1, g, u2


def _check_tucker(x, u1, g, u2):
    """Kernel against plain, twice: the same bits on both calls."""
    reset_launch_counts()
    y = tucker_matmul.tucker_matmul(x, u1, g, u2)
    y2 = tucker_matmul.tucker_matmul(x, u1, g, u2)
    want = ref.tucker_matmul_ref(x, u1, g, u2)
    torch.cuda.synchronize()
    assert y.dtype == want.dtype == torch.promote_types(x.dtype, u1.dtype)
    # bf16 output: the same f32 value rounds once, at most one ulp apart
    assert _rel(y, want) <= (TUCKER_F32_TOL if y.dtype == torch.float32
                             else 2 ** -8)
    assert torch.equal(y, y2)
    assert launch_counts()["tucker_matmul"] == 2


@pytest.mark.parametrize("M,K,R1,R2,N", [(300, 512, 32, 32, 600),
                                         (65, 130, 8, 16, 127),
                                         (17, 64, 3, 4, 40),
                                         (4, 1000, 64, 48, 3000),
                                         (1, 7, 3, 5, 9)])
@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_tucker_matmul_matches_plain_on_card(dev, M, K, R1, R2, N, xdt,
                                             wdt):
    """Ragged M, K, N (no padding: masked in the kernel), both routes
    (tensor-core tiles; factor streams at M <= 16), an odd M R1 (t past
    t1 in the workspace), the path's bf16-x/f32-factor mix; f32 accuracy,
    the same bits run to run."""
    _check_tucker(*_tucker_inputs(dev, M, K, R1, R2, N, xdt, wdt, M + K))


@pytest.mark.parametrize("M", [1, 2, 4, 8, 16, 17])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
def test_tucker_matmul_decode_shapes_on_card(dev, M, xdt):
    """The LM's up/gate product at decode batches (K = 5120, R = 512,
    N = 17408): the streaming route up to M = 16, tensor cores at 17."""
    route = tucker_matmul.plan(M, 5120, 512, 512, 17408, xdt).routes[0]
    assert route == ("rows" if M <= 16 else "mma")
    _check_tucker(*_tucker_inputs(dev, M, 5120, 512, 512, 17408, xdt,
                                  torch.float32, M))


@pytest.mark.parametrize("M", [4, 65])
def test_tucker_matmul_unaligned_x_takes_narrow_loads(dev, M):
    """x one element past a 16-byte boundary (a view at storage offset 1):
    the plan's 4-byte loads for x U1, the same result as plain."""
    x, u1, g, u2 = _tucker_inputs(dev, M, 512, 64, 64, 300, torch.float32,
                                  torch.float32, 5)
    buf = torch.empty(M * 512 + 1, device=dev)
    xo = buf[1:].view(M, 512)
    xo.copy_(x)
    assert xo.is_contiguous() and xo.data_ptr() % 16 == 4
    p = tucker_matmul.plan(M, 512, 64, 64, 300, torch.float32, x_align=4)
    assert p.load_bytes[0] == (16 if p.stream else 4)
    _check_tucker(xo, u1, g, u2)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain_on_card(dev, D, causal):
    """GQA (G = 3) read in place, ragged lengths, q_offset and kv_len."""
    rng = np.random.default_rng(D)
    B, Sq, Sk, H, Hk = 2, 133, 200, 6, 2
    q = torch.tensor(rng.normal(size=(B, Sq, H, D)), dtype=torch.float32,
                     device=dev)
    k, v = (torch.tensor(rng.normal(size=(B, Sk, Hk, D)),
                         dtype=torch.float32, device=dev) for _ in range(2))
    reset_launch_counts()
    for kv_len, q_offset in ((Sk, 0), (150, 17), (133, 0)):
        got = flash_attention.flash_attention(q, k, v, causal=causal,
                                              kv_len=kv_len,
                                              q_offset=q_offset)
        want = ref.flash_attention_ref(q, k, v, causal, kv_len=kv_len,
                                       q_offset=q_offset)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 2e-5
    # the Pallas layout (BH, S, D), a strided view of the same heads
    q3 = q.permute(0, 2, 1, 3).reshape(B * H, Sq, D)
    k3 = k.permute(0, 2, 1, 3).reshape(B * Hk, Sk, D)
    v3 = v.permute(0, 2, 1, 3).reshape(B * Hk, Sk, D)
    got = flash_attention.flash_attention(q3, k3, v3, causal=causal)
    want = ref.flash_attention_ref(q3, k3, v3, causal)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 2e-5
    assert launch_counts()["flash_attention"] == 4


@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_tiles_bitwise_on_card(dev, D, causal):
    """Sq and Sk not multiples of the 128-query or 32-key tiles, with
    kv_len and q_offset inside the last tile; two calls give the same
    bits."""
    rng = np.random.default_rng(D + causal)
    B, Sq, Sk, H, Hk = 1, 197, 171, 4, 1
    q = torch.tensor(rng.normal(size=(B, Sq, H, D)), dtype=torch.float32,
                     device=dev)
    k, v = (torch.tensor(rng.normal(size=(B, Sk, Hk, D)),
                         dtype=torch.float32, device=dev) for _ in range(2))
    for kv_len, q_offset in ((Sk, 0), (163, 41), (97, 0)):
        got = flash_attention.flash_attention(q, k, v, causal=causal,
                                              kv_len=kv_len,
                                              q_offset=q_offset)
        again = flash_attention.flash_attention(q, k, v, causal=causal,
                                                kv_len=kv_len,
                                                q_offset=q_offset)
        want = ref.flash_attention_ref(q, k, v, causal, kv_len=kv_len,
                                       q_offset=q_offset)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 2e-5
        assert torch.equal(got, again)


def test_flash_attention_unaligned_q_raises(dev):
    """q one element past a 16-byte boundary: the wrapper raises (the
    kernel's cp.async copies need 16-byte rows); it never falls back."""
    B, S, H, D = 1, 64, 2, 32
    buf = torch.zeros(B * S * H * D + 1, device=dev)
    q = buf[1:].view(B, S, H, D)
    k = torch.zeros((B, S, H, D), device=dev)
    reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention.flash_attention(q, k, k)
    # a head stride that is not a 16-byte multiple raises too
    k6 = torch.zeros((B, S, H, D + 1), device=dev)[..., :D]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention.flash_attention(k, k6, k6)
    assert launch_counts()["flash_attention"] == 0


def test_lm_serve_cuda_matches_torch_on_card(dev):
    """Reduced qwen3_14b with Tucker FFNs at a prompt that reaches the
    flash region: the "cuda" backend against "torch" from the same
    weights, prefill and decode logits (f32: 1e-4 of the largest)."""
    import dataclasses

    from repro_torch.configs.qwen3_14b import REDUCED
    from repro_torch.launch import serve

    cfg = dataclasses.replace(REDUCED, tucker_rank=8)
    reset_launch_counts()
    res = serve.run(cfg, batch=2, prompt_len=1100, gen=3, device=dev,
                    backend="cuda")
    counts = launch_counts()
    assert counts["tucker_matmul"] == 3 * cfg.num_layers * 3
    assert counts["flash_attention"] == cfg.num_layers
    plain = serve.run(cfg, batch=2, prompt_len=1100, gen=3, device=dev,
                      backend="torch", params=res["params"])
    assert res["finite"] and plain["finite"]
    assert _rel(res["last_logits"], plain["last_logits"]) <= 1e-4
    assert torch.equal(res["generated"], plain["generated"])


# ---------------------------------------------------------------------------
# LM training: the flash backward, the forward's lse, TuckerMatmul, a step
# ---------------------------------------------------------------------------

# of each output's largest magnitude: 3xTF32 tensor cores, ~1e-6 measured;
# one TF32 pass would give ~4e-4 (test_torch_lm_kernels.py's emulation)
FLASH_BWD_TOL = 2e-5


def _flash_bwd_inputs(dev, B, Sq, Sk, H, Hk, D, seed):
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.normal(size=(B, Sq, H, D)), dtype=torch.float32,
                     device=dev)
    k, v = (torch.tensor(rng.normal(size=(B, Sk, Hk, D)),
                         dtype=torch.float32, device=dev) for _ in range(2))
    dout = torch.tensor(rng.normal(size=(B, Sq, H, D)), dtype=torch.float32,
                        device=dev)
    return q, k, v, dout


@pytest.mark.parametrize("B,Sq,Sk,H,Hk,D,causal,kv_len,q_offset", [
    (2, 256, 256, 6, 2, 128, True, None, 0),     # GQA, tile multiples
    (1, 197, 197, 4, 4, 64, True, None, 0),      # G = 1, ragged S
    (2, 133, 200, 6, 2, 32, False, 150, 0),      # non-causal, kv_len < Sk
    (1, 100, 171, 4, 1, 16, True, 163, 41),      # causal with q_offset
    (1, 70, 70, 2, 1, 128, False, None, 0),
    (1, 301, 333, 10, 2, 128, True, None, 0),    # off the 128/32 tiles, G 5
    (2, 200, 290, 4, 2, 64, True, 280, 77),      # causal, q_offset > 0
])
def test_flash_attention_bwd_matches_plain_on_card(dev, B, Sq, Sk, H, Hk, D,
                                                   causal, kv_len, q_offset):
    """dQ, dK, dV each within 2e-5 of that output's largest magnitude, the
    forward's lse within 2e-5 of the plain one, two calls the same bits."""
    q, k, v, dout = _flash_bwd_inputs(dev, B, Sq, Sk, H, Hk, D,
                                      seed=Sq + D)
    kw = dict(causal=causal, kv_len=kv_len, q_offset=q_offset)
    reset_launch_counts()
    o, lse = flash_attention.flash_attention(q, k, v, return_lse=True, **kw)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal, kv_len=kv_len,
                                             q_offset=q_offset,
                                             return_lse=True)
    got = flash_attention_bwd.flash_attention_bwd(q, k, v, o, lse, dout,
                                                  **kw)
    again = flash_attention_bwd.flash_attention_bwd(q, k, v, o, lse, dout,
                                                    **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, causal,
                                       kv_len=kv_len, q_offset=q_offset)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, Sq)
    assert _rel(o, o_ref) <= 2e-5
    assert _rel(lse, lse_ref) <= 2e-5
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert _rel(g, w) <= FLASH_BWD_TOL
        assert torch.equal(g, a)
    assert launch_counts()["flash_attention_bwd"] == 2
    assert launch_counts()["flash_attention"] == 1


def test_flash_attention_bwd_pallas_layout_on_card(dev):
    """The (BH, S, D) layout: strided views in, views of the same values
    out, against the 4-D call."""
    q, k, v, dout = _flash_bwd_inputs(dev, 1, 130, 130, 4, 4, 32, seed=3)
    o, lse = flash_attention.flash_attention(q, k, v, return_lse=True)
    want = flash_attention_bwd.flash_attention_bwd(q, k, v, o, lse, dout)
    to3 = lambda t: t[0].transpose(0, 1)   # noqa: E731
    got = flash_attention_bwd.flash_attention_bwd(
        to3(q), to3(k), to3(v), to3(o), lse[0], to3(dout))
    for g, w in zip(got, want):
        assert torch.equal(g, to3(w))


def test_flash_attention_serving_bits_without_lse_on_card(dev):
    """The forward with and without an lse pointer: the same output bits
    (serving passes none)."""
    q, k, v, _ = _flash_bwd_inputs(dev, 2, 300, 320, 8, 2, 128, seed=5)
    for kv_len, q_offset in ((320, 0), (310, 10)):
        plain = flash_attention.flash_attention(q, k, v, kv_len=kv_len,
                                                q_offset=q_offset)
        with_lse, _ = flash_attention.flash_attention(
            q, k, v, kv_len=kv_len, q_offset=q_offset, return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(plain, with_lse)


def test_flash_attention_bwd_refuses_what_it_cannot_take_on_card(dev):
    """bf16, an odd head size, a CPU lse and an unaligned q or dO (its
    16-byte copies) raise; nothing launches."""
    q, k, v, dout = _flash_bwd_inputs(dev, 1, 64, 64, 2, 2, 32, seed=1)
    o, lse = flash_attention.flash_attention(q, k, v, return_lse=True)
    reset_launch_counts()
    # a seq stride of 2·33 floats: not a 16-byte multiple
    wide = torch.zeros((1, 64, 2, 33), device=dev)
    wide[..., :32] = q
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd.flash_attention_bwd(wide[..., :32], k, v, o,
                                                lse, dout)
    # a base one float past a 16-byte boundary
    flat = torch.zeros(dout.numel() + 1, device=dev)
    shifted = flat[1:].view(dout.shape)
    shifted.copy_(dout)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd.flash_attention_bwd(q, k, v, o, lse, shifted)
    with pytest.raises(TypeError):
        flash_attention_bwd.flash_attention_bwd(
            q.bfloat16(), k, v, o, lse, dout)
    with pytest.raises(ValueError, match="D in"):
        flash_attention_bwd.flash_attention_bwd(
            q[..., :24], k[..., :24], v[..., :24], o[..., :24], lse,
            dout[..., :24])
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd.flash_attention_bwd(q, k, v, o, lse.cpu(), dout)
    assert launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_tucker_matmul_function_cuda_matches_torch_on_card(dev, xdt):
    """``TuckerMatmul`` forward and its four gradients, ``"cuda"`` (the
    kernel forward and dx) against ``"torch"``: 2e-5 of each output's
    largest (dx in bf16: one bf16 ulp, 2⁻⁸); two launches a call."""
    from repro_torch.models.layers import TuckerLinear, tucker_linear

    rng = np.random.default_rng(17)
    M, K, R, N = 300, 512, 64, 600
    mod = TuckerLinear(K, N, R, torch.Generator(device=dev).manual_seed(0),
                       dev)
    for p in mod.parameters():
        p.requires_grad_(True)
    x = torch.tensor(rng.normal(size=(3, M // 3, K)), dtype=xdt,
                     device=dev)
    gy = torch.tensor(rng.normal(size=(3, M // 3, N)), dtype=torch.float32,
                      device=dev)
    out = {}
    for bk in ("cuda", "torch"):
        xx = x.clone().requires_grad_(True)
        reset_launch_counts()
        y = tucker_linear(mod, xx, bk)
        grads = torch.autograd.grad(y, [xx, mod.u1, mod.g, mod.u2], gy)
        torch.cuda.synchronize()
        assert launch_counts()["tucker_matmul"] == (2 if bk == "cuda" else 0)
        out[bk] = (y, *grads)
    for i, (a, b) in enumerate(zip(out["cuda"], out["torch"])):
        assert a.dtype == b.dtype
        tol = 2.0 ** -8 if a.dtype == torch.bfloat16 else 2e-5
        assert _rel(a, b) <= tol, i


def test_train_step_cuda_matches_torch_on_card(dev):
    """One ``make_train_step`` on each backend from the same state, reduced
    qwen3_14b (f32, Tucker rank 8) at seq 1088 (the flash region), lr 1e-3
    with warmup 1 so the step is the full lr: the loss within 1e-5
    relative; m and v within 1e-4 of each leaf's largest (the gradients'
    magnitudes and the clip factor); the parameters within 2⁻⁸ of the lr
    where |m| is past a quarter of its leaf's largest (Adam's first step is
    lr·sign(g) plus weight decay: a flipped sign is off by 2, a zero
    gradient by 1).  The cuda step launches 6·L tucker_matmul, L
    flash_attention and L flash_attention_bwd, the torch step none."""
    import dataclasses

    from repro_torch.configs.qwen3_14b import REDUCED
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(REDUCED, tucker_rank=8)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    L = cfg.num_layers
    batch = train.device_batch(TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=1088, global_batch=2)
    ).global_batch(0), dev)
    res = {}
    for bk in ("cuda", "torch"):
        state = steps.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        step = steps.make_train_step(cfg, opt_cfg, bk)
        reset_launch_counts()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = ({"tucker_matmul": 6 * L, "flash_attention": L,
                 "flash_attention_bwd": L} if bk == "cuda" else
                {"tucker_matmul": 0, "flash_attention": 0,
                 "flash_attention_bwd": 0})
        assert {k: counts[k] for k in want} == want
        res[bk] = (float(m["loss"]), float(m["lr"]), state)
    (lc, lr, sc), (lt, _, st) = res["cuda"], res["torch"]
    assert np.isfinite(lc) and abs(lc - lt) <= 1e-5 * abs(lt)
    assert lr == pytest.approx(1e-3)
    pc = dict(sc.params.named_parameters())
    pt = dict(st.params.named_parameters())
    for name in pc:
        mt = st.opt.m[name]
        assert _rel(sc.opt.m[name], mt) <= 1e-4, name
        assert _rel(sc.opt.v[name], st.opt.v[name]) <= 1e-4, name
        settled = mt.abs() > 0.25 * mt.abs().max()
        assert settled.any(), name
        d = (pc[name].detach() - pt[name].detach())[settled]
        assert d.abs().max().item() <= 2.0 ** -8 * lr, name


# ---------------------------------------------------------------------------
# the single-device driver and the baselines on the card
# ---------------------------------------------------------------------------

STD_CARD = ["--dims", "300,200,100", "--nnz", "40000", "--rank", "4",
            "--core-rank", "4", "--batch", "1024", "--eval-every", "10",
            "--seed", "3", "--device", "cuda", "--backend", "cuda"]


@pytest.mark.parametrize("compress", [False, True])
def test_std_train_resume_bitwise_on_card(dev, tmp_path, compress):
    """A run killed after its step-20 checkpoint and resumed with
    ``--resume`` ends on the uninterrupted run's bits: the unsorted f32
    step repeats itself on the card, and the generator state is part of
    the checkpoint."""
    from repro_torch.launch import std_train

    extra = ["--compress"] if compress else []
    whole = std_train.main(STD_CARD + extra + [
        "--steps", "30", "--ckpt-dir", str(tmp_path / "a")])
    std_train.main(STD_CARD + extra + ["--steps", "20", "--ckpt-dir",
                                       str(tmp_path / "b")])
    reset_launch_counts()
    res = std_train.main(STD_CARD + extra + [
        "--steps", "30", "--ckpt-dir", str(tmp_path / "b"), "--resume"])
    torch.cuda.synchronize()
    assert res["resumed_from"] == 20
    assert launch_counts()["scatter_accum"] == 3 * 10
    a, b = whole["state"].params, res["state"].params
    for x, y in zip(a.factors + a.core_factors + whole["dstate"].ef,
                    b.factors + b.core_factors + res["dstate"].ef):
        assert torch.equal(x, y)
    assert torch.equal(whole["dstate"].rng, res["dstate"].rng)


def test_cutucker_cuda_matches_torch_on_card(dev):
    """20 fed-batch cuTucker steps: the ``scatter_accum`` kernel (3 a
    step) against the plain scatter, within 1e-4 of each leaf's largest
    (the trajectory bound of the FastTucker parity tests)."""
    from repro_torch.core import cutucker as cu
    from repro_torch.core.sampling import sample_batch_arrays
    from repro_torch.data.synthetic import planted_tensor

    dims = (3000, 2000, 100)
    t = planted_tensor(dims, 200_000, rank=4, core_rank=4, seed=1,
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [sample_batch_arrays(gen, t.indices, t.values, 4096)
               for _ in range(20)]
    out = {}
    for bk in ("cuda", "torch"):
        cfg = cu.CuTuckerConfig(dims=dims, ranks=(4, 4, 4), batch_size=4096,
                                backend=bk)
        st = cu.init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
        reset_launch_counts()
        for idx, val in batches:
            st = cu.sgd_step_batch(st, idx, val, cfg)
        torch.cuda.synchronize()
        assert launch_counts()["scatter_accum"] == (60 if bk == "cuda"
                                                    else 0)
        out[bk] = st.params.factors + (st.params.core,)
    for x, y in zip(out["cuda"], out["torch"]):
        _close(x, y, 1e-4)


@pytest.mark.parametrize("mag", [1.0, 1e-5, 300.0])
def test_compress_ef_card_equals_cpu(dev, mag):
    """The int8 error-feedback round trip gives the CPU's bits on the card
    for the same input (the scale is a true division there too)."""
    from repro_torch.optim.compression import compress_ef, decompress

    rng = np.random.default_rng(int(mag * 7) + 1)
    g = torch.tensor(rng.normal(size=(4099, 4)) * mag, dtype=torch.float32)
    e = torch.tensor(rng.normal(size=(4099, 4)) * mag * 1e-2,
                     dtype=torch.float32)
    g[5] = 0.0
    e[5] = 0.0
    want = compress_ef(g, e)
    got = compress_ef(g.to(dev), e.to(dev))
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    assert torch.equal(decompress(*got[:2]).cpu(), decompress(*want[:2]))


def test_compressed_local_step_card_matches_cpu(dev):
    """Five compressed ``local`` steps on the card (the kernels) against
    the CPU (the plain versions) from the same parameters and fed batches,
    at the default λ.  The kernel's and the plain version's gradients
    differ in their last bits, so an entry near a rounding boundary can
    take the neighbouring int8 code on one side only: its factor then
    moves by one quantum (lr·scale) and its residual by the opposite
    amount.  F − lr·e has no jump there (the dequantised gradient plus
    the new residual is g + e): it is held within 1e-5 of each leaf's
    largest, and so are the core factors.  The raw factors are held
    within one quantum of the last step, per entry, plus that 1e-5."""
    from repro_torch.core.sptensor import SparseTensor
    from repro_torch.data.synthetic import planted_arrays
    from repro_torch.distributed import get_strategy, local
    from repro_torch.optim.compression import compress_ef

    dims, steps = (300, 200, 100), 5
    idx, val = planted_arrays(dims, 40_000, seed=4)
    rng = np.random.default_rng(6)
    picks = [torch.from_numpy(rng.integers(0, len(val), 1024))
             for _ in range(steps)]
    st = get_strategy("local")
    out = {}
    for device, bk in ((dev, "cuda"), (torch.device("cpu"), "torch")):
        t = SparseTensor.from_numpy(idx, val, dims, device)
        cfg = ft.FastTuckerConfig(dims=dims, ranks=(4, 4, 4), core_rank=4,
                                  batch_size=1024, backend=bk)
        plan = st.prepare(t, cfg, compress=True)
        p0 = ft.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        params = ft.FastTuckerParams(
            tuple(f.to(device) for f in p0.factors),
            tuple(b.to(device) for b in p0.core_factors))
        ds = st.init(plan, ft.TrainState(params, 0),
                     torch.Generator(device=device))
        for pick in picks:
            last = ds
            p = pick.to(device)
            ds = local.step_batch(plan, ds, t.indices[p], t.values[p])
        assert all(e.abs().max() > 0 for e in ds.ef)
        out[bk] = ds
    # the last step's per-row int8 scale, from the CPU's pieces
    p = picks[-1]
    grads = ft.step_gradients(last.params, t.indices[p], t.values[p], cfg)
    dense = ft.scatter_row_grads(last.params.factors, t.indices[p],
                                 grads.row_grads, backend="torch")
    scales = [compress_ef(g, e)[1] for g, e in zip(dense, last.ef)]
    lr = ft.dynamic_lr(cfg.alpha_a, cfg.beta_a, steps - 1)
    got, want = out["cuda"], out["torch"]
    for f_c, e_c, f_p, e_p, scale in zip(
            got.params.factors, got.ef, want.params.factors, want.ef,
            scales):
        f_c, e_c = f_c.cpu(), e_c.cpu()
        _close(f_c - lr * e_c, f_p - lr * e_p, 1e-5)
        slack = 1e-5 * f_p.abs().max()
        assert ((f_c - f_p).abs() <= lr * scale + slack).all()
    for x, y in zip(got.params.core_factors, want.params.core_factors):
        _close(x.cpu(), y, 1e-5)


# ---------------------------------------------------------------------------
# Tucker serving on the card
# ---------------------------------------------------------------------------

NETFLIX_DIMS = (480_189, 17_770, 2_182)


def _serve_params(dev, dims, J, R, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    factors = tuple(0.3 * torch.randn((d, J), generator=g, device=dev)
                    for d in dims)
    core = tuple(torch.randn((J, R), generator=g, device=dev) / J
                 for _ in dims)
    return ft.FastTuckerParams(factors, core)


@pytest.mark.parametrize("R", [4, 64])
def test_update_rows_bitwise_rebuild_at_netflix_shape_on_card(dev, R):
    """Patches of every mode (a Netflix-sized mode-0 table) land on the
    f32 tables a fresh server builds from the final factors, bitwise, and
    launch no kernel of the package."""
    from repro_torch.serve import TuckerServer

    params = _serve_params(dev, NETFLIX_DIMS, R, R)
    srv = TuckerServer(params, backend="cuda")
    rng = np.random.default_rng(R)
    facs = [f.clone() for f in params.factors]
    reset_launch_counts()
    for mode, f in ((0, 50_000), (1, 3_000), (2, 2_182), (0, 7)):
        ids = np.sort(rng.permutation(NETFLIX_DIMS[mode])[:f]).astype(
            np.int32)
        new = torch.randn((f, R), device=dev)
        facs[mode][torch.from_numpy(ids).long().to(dev)] = new
        srv.update_rows(mode, ids, new)
    torch.cuda.synchronize()
    assert set(launch_counts().values()) == {0}
    fresh = TuckerServer(ft.FastTuckerParams(tuple(facs),
                                             params.core_factors),
                         backend="cuda")
    for a, b in zip(srv._tables, fresh._tables):
        assert torch.equal(a, b)
    for a, b in zip(srv.params.factors, facs):
        assert torch.equal(a, b)
    for a, b in zip(srv._colsums, fresh._colsums):
        _close(a, b, 1e-4)


def test_swap_preserves_inflight_generation_on_card(dev):
    from repro_torch.serve import TuckerServer

    srv = TuckerServer(_serve_params(dev, (4000, 300, 50), 8, 8),
                       backend="cuda")
    rng = np.random.default_rng(6)
    q = np.stack([rng.integers(0, d, 999) for d in srv.dims], 1) \
        .astype(np.int32)
    before = srv.predict(q).clone()
    snapshot = srv._live
    frozen = [t.clone() for t in snapshot.tables]
    ids = np.sort(rng.permutation(4000)[:900]).astype(np.int32)
    srv.update_rows(0, ids, torch.randn((900, 8), device=dev))
    for t, f in zip(snapshot.tables, frozen):
        assert torch.equal(t, f)
    assert srv._live.version == snapshot.version + 1
    assert not torch.equal(srv._tables[0], frozen[0])
    assert torch.equal(srv._predict_from(snapshot, q), before)


@pytest.mark.parametrize("R", [4, 48, 64])
def test_serve_predict_cuda_matches_torch_on_card(dev, R):
    """``predict`` on ``"cuda"``: one ``kruskal_contract`` per bucket chunk
    and nothing else, within 2e-5 of a ``"torch"`` server, and a request's
    bits do not depend on its bucket."""
    from repro_torch.serve import TuckerServer, split_batch

    dims = (20_000, 3_000, 500)
    params = _serve_params(dev, dims, R, R, seed=R)
    srv = TuckerServer(params, backend="cuda")
    plain = TuckerServer(params, backend="torch")
    rng = np.random.default_rng(1)
    q = np.stack([rng.integers(0, d, 5000) for d in dims], 1).astype(
        np.int32)
    reset_launch_counts()
    got = srv.predict(q)
    torch.cuda.synchronize()
    chunks = len(split_batch(len(q), srv.ladder))
    assert launch_counts() == dict(
        {k: 0 for k in launch_counts()}, kruskal_contract=chunks)
    _close(got, plain.predict(q), 2e-5)
    assert torch.equal(srv.predict(q[:37]), srv.predict(q[:2048])[:37])
    s, i = srv.top_k(0, q[:64, 0], 10)
    s0, i0 = plain.top_k(0, q[:64, 0], 10)
    _close(s, s0, 2e-5)


def test_top_k_ties_ascending_on_card(dev):
    """Exact ties (integer factors) over a long row come back in ascending
    id on the card too (the sort is stable)."""
    from repro_torch.serve import TuckerServer

    rows = 50_000
    A1 = torch.ones((rows, 2), device=dev)
    A1[::7] = 2.0                       # every 7th id scores higher
    A0 = torch.tensor([[1.0, 2.0], [2.0, 1.0]], device=dev)
    A2 = torch.tensor([[1.0, 1.0], [2.0, 0.0]], device=dev)
    eye = torch.eye(2, device=dev)
    srv = TuckerServer(ft.FastTuckerParams((A0, A1, A2), (eye,) * 3),
                       backend="cuda")
    scores, items = srv.top_k(0, [0, 1], k=rows // 7 + 100)
    top = np.arange(0, rows, 7)
    for row in items.cpu().numpy():
        np.testing.assert_array_equal(row[:len(top)], top)
        rest = row[len(top):]
        np.testing.assert_array_equal(rest, np.setdiff1d(
            np.arange(rows), top)[:len(rest)])
