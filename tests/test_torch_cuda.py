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
                                 kruskal_grad, launch_counts,
                                 mode_product_rows, ref,
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
                               "flash_attention_bwd": 0,
                               "mode_product_rows": 0,
                               "patch_table_rows": 0}


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


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
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


@pytest.mark.parametrize("D", [16, 80, 128])
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


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_mla_widths_match_plain_on_card(dev, causal):
    """(D, Dv) = (192, 128), MLA's prefill: ragged lengths off the 128/32
    tiles, q_offset and kv_len, the lse, and two calls with one set of
    bits."""
    rng = np.random.default_rng(192 + causal)
    B, Sq, Sk, H = 2, 197, 230, 4
    q = torch.tensor(rng.normal(size=(B, Sq, H, 192)), dtype=torch.float32,
                     device=dev)
    k = torch.tensor(rng.normal(size=(B, Sk, H, 192)), dtype=torch.float32,
                     device=dev)
    v = torch.tensor(rng.normal(size=(B, Sk, H, 128)), dtype=torch.float32,
                     device=dev)
    reset_launch_counts()
    for kv_len, q_offset in ((Sk, 0), (150, 17), (197, 0)):
        got, lse = flash_attention.flash_attention(
            q, k, v, causal=causal, kv_len=kv_len, q_offset=q_offset,
            return_lse=True)
        again = flash_attention.flash_attention(
            q, k, v, causal=causal, kv_len=kv_len, q_offset=q_offset)
        want, want_lse = ref.flash_attention_ref(
            q, k, v, causal, kv_len=kv_len, q_offset=q_offset,
            return_lse=True)
        torch.cuda.synchronize()
        assert got.shape == (B, Sq, H, 128)
        assert _rel(got, want) <= 2e-5
        assert _rel(lse, want_lse) <= 2e-5
        assert torch.equal(got, again)
    assert launch_counts()["flash_attention"] == 6


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_mla_widths_match_plain_on_card(dev, causal):
    """The backward at (D, Dv) = (192, 128), MLA's training widths (16-row
    ring tiles): ragged lengths, q_offset and kv_len; dq, dk, dv each
    within 2e-5 of its largest, dv at v's width, two calls the same bits;
    (192, 192) is no width of the forward."""
    rng = np.random.default_rng(1920 + causal)
    B, Sq, Sk, H = 2, 197, 230, 4

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev)

    q, k, v, dout = t(B, Sq, H, 192), t(B, Sk, H, 192), t(B, Sk, H, 128), \
        t(B, Sq, H, 128)
    reset_launch_counts()
    for kv_len, q_offset in ((Sk, 0), (150, 17), (197, 0)):
        kw = dict(causal=causal, kv_len=kv_len, q_offset=q_offset)
        o, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                                 **kw)
        got = flash_attention_bwd.flash_attention_bwd(q, k, v, o, lse, dout,
                                                      **kw)
        again = flash_attention_bwd.flash_attention_bwd(q, k, v, o, lse,
                                                        dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, causal,
                                           kv_len=kv_len, q_offset=q_offset)
        torch.cuda.synchronize()
        assert [tuple(g.shape) for g in got] == [
            tuple(x.shape) for x in (q, k, v)]
        for g, a, w in zip(got, again, want):
            assert _rel(g, w) <= FLASH_BWD_TOL
            assert torch.equal(g, a)
    assert launch_counts()["flash_attention_bwd"] == 6
    with pytest.raises(ValueError, match="Dv"):
        flash_attention.flash_attention(q, q, q)
    assert launch_counts()["flash_attention"] == 3


WG_EDGES = [  # (Sq, Sk, causal, kv_len, q_offset)
    (64, 64, True, 64, 0),       # one warpgroup's rows, the other's none
    (65, 96, True, 65, 0),       # the second warpgroup holds one row
    (1, 33, True, 33, 32),       # one query, its last key past a 32-key tile
    (129, 161, True, 160, 31),   # tile edges of queries, keys and q_offset
    (63, 32, False, 1, 0),       # a single visible key
]


@pytest.mark.parametrize("D,Dv", [(128, 128), (192, 128)])
@pytest.mark.parametrize("Sq,Sk,causal,kv_len,q_offset", WG_EDGES)
def test_flash_attention_wgmma_route_edges_on_card(dev, D, Dv, Sq, Sk,
                                                   causal, kv_len, q_offset):
    """The wgmma route (D = 128 and (192, 128)): 128-query blocks of two
    64-row warpgroups over 32-key tiles, at their edges — a warpgroup with
    no rows or one, a causal warpgroup that skips a tile, kv_len and
    q_offset inside a tile.  Within 2e-5 of the plain version with the lse,
    o's bits the same without it, bf16 the f32 bits on the widened
    inputs."""
    rng = np.random.default_rng(Sq * 1000 + Sk + D)
    B, H, Hk = 2, 4, 2
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32,
                            device=dev)
               for s in ((B, Sq, H, D), (B, Sk, Hk, D), (B, Sk, Hk, Dv)))
    kw = dict(causal=causal, kv_len=kv_len, q_offset=q_offset)
    o, lse = flash_attention.flash_attention(q, k, v, return_lse=True, **kw)
    plain = flash_attention.flash_attention(q, k, v, **kw)
    want, want_lse = ref.flash_attention_ref(q, k, v, causal,
                                             return_lse=True, kv_len=kv_len,
                                             q_offset=q_offset)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    ob, lb = flash_attention.flash_attention(qb, kb, vb, return_lse=True,
                                             **kw)
    o32, l32 = flash_attention.flash_attention(
        qb.float(), kb.float(), vb.float(), return_lse=True, **kw)
    torch.cuda.synchronize()
    assert _rel(o, want) <= 2e-5 and _rel(lse, want_lse) <= 2e-5
    assert torch.equal(o, plain)
    assert torch.equal(ob, o32.bfloat16()) and torch.equal(lb, l32)


@pytest.mark.parametrize("D,Dv", [(64, 64), (192, 128)])
def test_flash_attention_nan_in_q_stays_nan_on_card(dev, D, Dv):
    """A NaN in one query row gives that row a NaN output and leaves the
    others finite, on the tile route and the wgmma route: the 3xTF32
    split carries a NaN in the small part, as the plain version does."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32,
                            device=dev)
               for s in ((1, 70, 2, D), (1, 70, 2, D), (1, 70, 2, Dv)))
    q[0, 5, 1, 3] = float("nan")
    o = flash_attention.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.isnan(o[0, 5, 1]).all() and torch.isnan(want[0, 5, 1]).all()
    o[0, 5, 1] = want[0, 5, 1] = 0.0
    assert torch.isfinite(o).all() and _rel(o, want) <= 2e-5


def _bf16_inputs(dev, B, Sq, Sk, H, Hk, D, Dv, seed):
    """q, k, v and dO drawn in f32 and rounded to bf16."""
    rng = np.random.default_rng(seed)
    shapes = ((B, Sq, H, D), (B, Sk, Hk, D), (B, Sk, Hk, Dv), (B, Sq, H, Dv))
    return [torch.tensor(rng.normal(size=s), dtype=torch.float32,
                         device=dev).bfloat16() for s in shapes]


BF16_SHAPES = [  # (B, Sq, Sk, H, Hk, D, Dv, causal, kv_len, q_offset)
    (2, 133, 200, 6, 2, 16, 16, True, 150, 17),
    (1, 197, 197, 4, 4, 32, 32, False, None, 0),
    (2, 200, 290, 4, 2, 64, 64, True, 280, 77),
    (1, 301, 333, 10, 2, 128, 128, True, None, 0),    # G = 5, ragged
    (1, 256, 256, 16, 2, 128, 128, True, None, 0),    # G = 8
    (2, 197, 230, 4, 4, 192, 128, True, 150, 17),     # MLA
    (1, 160, 160, 2, 2, 192, 128, False, None, 0),
    (2, 197, 230, 4, 4, 80, 80, False, 150, 0),      # HuBERT's width
]


@pytest.mark.parametrize("B,Sq,Sk,H,Hk,D,Dv,causal,kv_len,q_offset",
                         BF16_SHAPES)
def test_flash_kernels_bf16_give_the_f32_bits_on_card(
        dev, B, Sq, Sk, H, Hk, D, Dv, causal, kv_len, q_offset):
    """bf16 q, k, v (and o, dO in the backward) read in place: the forward
    gives the f32 kernel's output on the inputs widened to f32, rounded to
    bf16, and its lse; the backward the f32 kernel's dq, dk, dv, bit for
    bit, at every width.  Against the plain versions on the same inputs:
    lse, dq, dk, dv within 2e-5 of each one's largest, o within that plus
    half a bf16 ulp of the plain f32 value (its rounding)."""
    q, k, v, dout = _bf16_inputs(dev, B, Sq, Sk, H, Hk, D, Dv, Sq + D)
    kw = dict(causal=causal, kv_len=kv_len, q_offset=q_offset)
    reset_launch_counts()
    o, lse = flash_attention.flash_attention(q, k, v, return_lse=True, **kw)
    plain = flash_attention.flash_attention(q, k, v, **kw)
    wide = [x.float() for x in (q, k, v, dout)]
    o32, lse32 = flash_attention.flash_attention(*wide[:3], return_lse=True,
                                                 **kw)
    assert o.dtype == plain.dtype == torch.bfloat16
    assert lse.dtype == torch.float32
    assert torch.equal(o, o32.bfloat16()) and torch.equal(plain, o)
    assert torch.equal(lse, lse32)
    got = flash_attention_bwd.flash_attention_bwd(q, k, v, o, lse, dout,
                                                  **kw)
    want = flash_attention_bwd.flash_attention_bwd(
        *wide[:3], o.float(), lse, wide[3], **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert launch_counts()["flash_attention"] == 3
    assert launch_counts()["flash_attention_bwd"] == 2
    p_o, p_lse = ref.flash_attention_ref(*wide[:3], causal, return_lse=True,
                                         kv_len=kv_len, q_offset=q_offset)
    half_ulp = torch.ldexp(torch.ones_like(p_o), torch.frexp(p_o)[1] - 9)
    over = ((o.float() - p_o).abs() - half_ulp).clamp_min(0).max()
    assert (over / p_o.abs().max()).item() <= 2e-5
    assert _rel(lse, p_lse) <= 2e-5
    for g, w in zip(got, ref.flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                                     **kw)):
        assert _rel(g, w) <= 2e-5


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "qwen3_moe_30b_a3b"])
def test_moe_layer_cuda_matches_torch_on_card(dev, arch):
    """An MoE layer (MLA or GQA attention, then the MoE FFN) of the reduced
    config (MLA at its full head widths) at a 1100-token prompt (the flash region): "cuda" against
    "torch" from the same weights, f32, within 1e-4 of the largest.  The
    capacity factor is E / K, so nothing drops and a route that the
    attention's last bits flip moves only its own token: such tokens must
    have a router margin under 1e-5, and are left out of the compare."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models.blocks import apply_layer, init_layer
    from repro_torch.models.layers import rmsnorm

    cfg0 = get_config(arch, reduced=True)
    # MLA at the kernel's (192, 128) route: the reduced config's (24, 16)
    # is no width of the kernel
    widths = (dict(qk_nope_head_dim=128, qk_rope_head_dim=64,
                   v_head_dim=128) if cfg0.use_mla else {})
    cfg = dataclasses.replace(cfg0, capacity_factor=float(
        cfg0.num_experts / cfg0.top_k), **widths)
    spec = ("mla" if cfg.use_mla else "gqa") + "+moe"
    layer = init_layer(cfg, spec, torch.Generator(dev).manual_seed(0), dev)
    x = torch.randn((2, 1100, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    pos = torch.arange(1100, device=dev)
    attend = attn.mla_attention if cfg.use_mla else attn.gqa_attention
    reset_launch_counts()
    outs, routes = {}, {}
    for bk in ("cuda", "torch"):
        outs[bk], _ = apply_layer(layer, cfg, spec, x, positions=pos,
                                  backend=bk)
        # the MoE's input, recomputed as the layer body forms it
        y, _ = attend(layer.mixer, cfg, rmsnorm(layer.ln1, x, cfg.norm_eps),
                      pos, backend=bk)
        h = rmsnorm(layer.ln2, x + y, cfg.norm_eps).reshape(-1, cfg.d_model)
        logits, _, ids = moe.route(layer.ffn, cfg, h)
        routes[bk] = (logits, ids.sort(-1).values)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 2   # layer + recompute
    same = (routes["cuda"][1] == routes["torch"][1]).all(-1)
    if not same.all():
        logits = routes["torch"][0][~same]
        top = logits.sort(-1, descending=True).values
        margin = (top[:, cfg.top_k - 1] - top[:, cfg.top_k]).abs()
        assert (margin <= 1e-5).all(), margin.max().item()
    got = outs["cuda"].reshape(-1, cfg.d_model)[same]
    want = outs["torch"].reshape(-1, cfg.d_model)[same]
    assert _rel(got, want) <= 1e-4


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
    (2, 197, 230, 4, 4, 80, False, 200, 0),      # HuBERT's width, non-causal
    (1, 301, 333, 4, 2, 80, True, None, 0),      # D = 80 causal, G = 2
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
    launch one ``patch_table_rows`` a call and no other kernel."""
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
    assert launch_counts() == dict({k: 0 for k in launch_counts()},
                                   patch_table_rows=4)
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


@pytest.mark.parametrize("shard_mode", ["row", "batch"])
@pytest.mark.parametrize("R", [4, 64])
def test_sharded_predict_bitwise_unsharded_on_card(dev, R, shard_mode):
    """Four workers sharing the card: ``predict`` in row and batch mode
    gives the unsharded ``"cuda"`` server's bits, with one
    ``kruskal_contract`` a bucket chunk (row) or a worker's slice of it
    (batch) and nothing else; ``top_k`` within 2e-5 and the same ids."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import TuckerServer, split_batch

    dims = (20_003, 3_000, 501)
    params = _serve_params(dev, dims, R, R, seed=R)
    base = TuckerServer(params, backend="cuda")
    srv = TuckerServer(params, backend="cuda", shard_mode=shard_mode,
                       mesh=make_host_mesh(num_workers=4, device=dev))
    rng = np.random.default_rng(2)
    q = np.stack([rng.integers(0, d, 5000) for d in dims], 1).astype(
        np.int32)
    q[:4, 0] = [0, 5000, 15_003, 20_002]          # each block's edge
    want = base.predict(q)
    reset_launch_counts()
    got = srv.predict(q)
    torch.cuda.synchronize()
    chunks = len(split_batch(len(q), srv.ladder))
    assert launch_counts() == dict(
        {k: 0 for k in launch_counts()},
        kruskal_contract=chunks * (1 if shard_mode == "row" else 4))
    assert torch.equal(got, want)
    s0, i0 = base.top_k(0, q[:64, 0], 10)
    s, i = srv.top_k(0, q[:64, 0], 10)
    _close(s, s0, 2e-5)
    assert torch.equal(i, i0)


@pytest.mark.parametrize("R", [4, 64])
def test_sharded_row_patch_bitwise_rebuild_on_card(dev, R):
    """Row mode over four workers at the Netflix shape: patches of every
    mode run one ``patch_table_rows`` a worker holding dirty rows, and
    the joined tables are bitwise a fresh unsharded server's; a rebuild
    runs one ``mode_product_rows`` a mode a worker and lands on the same
    bits; colsums within 1e-5."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import TuckerServer

    params = _serve_params(dev, NETFLIX_DIMS, R, R)
    srv = TuckerServer(params, backend="cuda", shard_mode="row",
                       mesh=make_host_mesh(num_workers=4, device=dev))
    rng = np.random.default_rng(R)
    facs = [f.clone() for f in params.factors]
    reset_launch_counts()
    owners = 0
    for mode, f in ((0, 50_000), (1, 3_000), (2, 2_182), (0, 7)):
        ids = np.sort(rng.permutation(NETFLIX_DIMS[mode])[:f]).astype(
            np.int32)
        owners += len(np.unique(ids // srv._block_rows[mode]))
        new = torch.randn((f, R), device=dev)
        facs[mode][torch.from_numpy(ids).long().to(dev)] = new
        srv.update_rows(mode, ids, new)
    torch.cuda.synchronize()
    assert launch_counts() == dict({k: 0 for k in launch_counts()},
                                   patch_table_rows=owners)
    fresh = TuckerServer(ft.FastTuckerParams(tuple(facs),
                                             params.core_factors),
                         backend="cuda")
    for a, b in zip(srv._tables, fresh._tables):
        assert torch.equal(a, b)
    for a, b in zip(srv._colsums, fresh._colsums):
        _close(a, b, 1e-5)
    reset_launch_counts()
    srv.refresh_tables()
    torch.cuda.synchronize()
    assert launch_counts() == dict({k: 0 for k in launch_counts()},
                                   mode_product_rows=12)
    for a, b in zip(srv._tables, fresh._tables):
        assert torch.equal(a, b)


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


def test_warm_start_deterministic_and_shard_invariant_on_card(dev):
    """The sketched warm start repeats its bits and does not depend on how
    its per-sample work is sharded; it launches one kruskal_grad a shard,
    N scatter_accum and the ALS refine's segment_reduce."""
    from repro_torch.core import sketch
    from repro_torch.data.synthetic import planted_tensor

    dims = (300, 200, 100)
    t = planted_tensor(dims, 60_000, rank=4, core_rank=4, seed=0,
                       device=dev)
    cfg = ft.FastTuckerConfig(dims=dims, ranks=(4,) * 3, core_rank=4,
                              batch_size=4096, backend="cuda",
                              init="sketched")

    def warm(shards):
        return sketch.sketched_init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, t.indices,
            t.values, num_shards=shards)

    reset_launch_counts()
    base = warm(1)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["kruskal_grad"] == 1 and counts["scatter_accum"] == 3
    assert counts["segment_reduce"] == cfg.sketch_refine_passes * 3 * 2
    for shards in (1, 3, 7):
        other = warm(shards)
        for a, b in zip(base.factors + base.core_factors,
                        other.factors + other.core_factors):
            assert torch.equal(a, b), shards


def test_als_ccd_epochs_repeat_their_bits_on_card(dev):
    """The ordered segment sums (segment_reduce, no atomics): an ALS and a
    CCD epoch from the same parameters give the same bits twice, and
    launch (Gram slices + 1) a mode and chunk, and 2·J a mode."""
    from repro_torch.core import als, ccd
    from repro_torch.core import cutucker as cu
    from repro_torch.data.synthetic import planted_tensor

    dims = (500, 300, 60)
    t = planted_tensor(dims, 200_000, rank=4, core_rank=4, seed=1,
                       device=dev)
    for J in (4, 12):
        ccfg = cu.CuTuckerConfig(dims=dims, ranks=(J,) * 3)
        p = cu.init_params(torch.Generator(device=dev).manual_seed(0), ccfg,
                           dev)
        for mod, cfg_cls, want in (
                (als, als.ALSConfig,
                 3 * 3 * (-(-J * J // als.FOLD_WIDTH) + 1)),
                (ccd, ccd.CCDConfig, 3 * 2 * J)):
            epoch = getattr(mod, f"{mod.__name__.rsplit('.', 1)[1]}_epoch")
            cfg = cfg_cls(dims=dims, ranks=(J,) * 3)
            reset_launch_counts()
            a = epoch(p, t, cfg, chunk=70_000, backend="cuda")
            torch.cuda.synchronize()
            assert launch_counts()["segment_reduce"] == want
            b = epoch(p, t, cfg, chunk=70_000, backend="cuda")
            for x, y in zip(a.factors, b.factors):
                assert torch.equal(x, y)


@pytest.mark.parametrize("JR", [4, 8, 48, 64])
@pytest.mark.parametrize("M", [1, 7, 600, 4099, 60_000, 480_189])
def test_mode_product_rows_bitwise_plain_on_card(dev, JR, M):
    """The table kernel gives the plain version's bits at every row count,
    one launch a call, in f32 and bf16 storage."""
    g = torch.Generator(device=dev).manual_seed(M + JR)
    for dt in (torch.float32, torch.bfloat16):
        rows = torch.randn((M, JR), generator=g, device=dev).to(dt)
        core = torch.randn((JR, JR), generator=g, device=dev).to(dt)
        reset_launch_counts()
        got = mode_product_rows.mode_product_rows(rows, core)
        torch.cuda.synchronize()
        assert launch_counts() == dict({k: 0 for k in launch_counts()},
                                       mode_product_rows=1)
        assert got.dtype == torch.float32
        assert torch.equal(got, ref.mode_product_rows_ref(rows, core))
        # a row's bits do not depend on the rows around it
        assert torch.equal(got[-1:], mode_product_rows.mode_product_rows(
            rows[-1:], core))


@pytest.mark.parametrize("JR", [4, 48, 64])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_patch_table_rows_matches_plain_on_card(dev, JR, table_dtype):
    """The patch kernel: the new table and mirror bitwise the plain
    patch's, the live table untouched, the colsum within 1e-5 of the
    plain one and the same bits when repeated."""
    I, K = 20_000, 3_001
    g = torch.Generator(device=dev).manual_seed(JR)
    mirror = torch.randn((I, JR), generator=g, device=dev)
    core = torch.randn((JR, JR), generator=g, device=dev)
    table = mode_product_rows.mode_product_rows(mirror, core).to(table_dtype)
    colsum = mode_product_rows.mode_product_rows(mirror, core).sum(0)
    ids = np.random.default_rng(JR).permutation(I)[:K].astype(np.int32)
    rows = torch.randn((K, JR), generator=g, device=dev)
    frozen = table.clone()
    outs = []
    for _ in range(2):
        m = mirror.clone()
        reset_launch_counts()
        outs.append(mode_product_rows.patch_table_rows(
            table, colsum, m, core, ids, rows) + (m,))
        torch.cuda.synchronize()
        assert launch_counts() == dict({k: 0 for k in launch_counts()},
                                       patch_table_rows=1)
    m = mirror.clone()
    want_t, want_c = ref.patch_table_rows_ref(table, colsum, m, core, ids,
                                              rows)
    assert torch.equal(table, frozen)
    for got_t, got_c, got_m in outs:
        assert torch.equal(got_t, want_t)
        assert torch.equal(got_m, m)
        _close(got_c, want_c, 1e-5)
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("I, JR, K", [(480_189, 4, 14_294), (17_770, 4, 9_000),
                                      (2_000, 8, 700), (60_000, 64, 15_000)])
def test_patch_table_rows_bitwise_rebuild_at_path_shapes_on_card(dev, I, JR,
                                                                   K):
    """At the serving paths' shapes (a refresh round's Netflix modes at
    J = R = 4, bench_serve's at 8, bench_refresh's 25 % at 64) the
    patched table is bitwise the plain patch's and a rebuild's."""
    g = torch.Generator(device=dev).manual_seed(I + K)
    mirror = torch.randn((I, JR), generator=g, device=dev)
    core = torch.randn((JR, JR), generator=g, device=dev)
    table = mode_product_rows.mode_product_rows(mirror, core)
    colsum = table.sum(0)
    ids = np.sort(np.random.default_rng(K).permutation(I)[:K]).astype(
        np.int32)
    rows = torch.randn((K, JR), generator=g, device=dev)
    m_k, m_p = mirror.clone(), mirror.clone()
    got_t, got_c = mode_product_rows.patch_table_rows(table, colsum, m_k,
                                                      core, ids, rows)
    want_t, want_c = ref.patch_table_rows_ref(table, colsum, m_p, core, ids,
                                              rows)
    assert torch.equal(got_t, want_t) and torch.equal(m_k, m_p)
    assert torch.equal(got_t, mode_product_rows.mode_product_rows(m_k, core))
    _close(got_c, want_c, 1e-5)


TABLE_WIDTHS = [(w, w) for w in (1, 3, 5, 8, 9, 33, 63, 64)] + [
    (64, 1), (1, 64), (9, 4), (4, 33)]


@pytest.mark.parametrize("J,R", TABLE_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_kernels_bitwise_at_route_edges_on_card(dev, J, R, dtype):
    """On both sides of each route's tile edge, rows, core and table in
    ``dtype``: the build bitwise its plain version (also from a row slice,
    whose base may lose its 16-byte alignment); the patch's table and
    mirror bitwise the plain patch's and its table bitwise a rebuild from
    the patched mirror; its colsum within 1e-5 of the plain one and the
    same bits on a second call."""
    g = torch.Generator(device=dev).manual_seed(J * 100 + R)
    rng = np.random.default_rng(J * 100 + R)
    mpr = mode_product_rows
    core = torch.randn((J, R), generator=g, device=dev).to(dtype)
    tile = mpr.plan(1, J, R).rows_per_tile
    for M in (tile - 1, tile, tile + 1, 3 * tile + 5):
        if M < 1:
            continue
        rows = torch.randn((M, J), generator=g, device=dev).to(dtype)
        got = mpr.mode_product_rows(rows, core)
        assert torch.equal(got, ref.mode_product_rows_ref(rows, core))
        if M > 1:
            assert torch.equal(got[1:], mpr.mode_product_rows(rows[1:], core))
    I = 8_000
    mirror = torch.randn((I, J), generator=g, device=dev).to(dtype)
    table32 = mpr.mode_product_rows(mirror, core)
    table, colsum = table32.to(dtype), table32.sum(0)
    tile = mpr.plan(1, J, R, patch=True).rows_per_tile
    for K in (tile - 1, tile, tile + 1, 40 * tile + 3):
        ids = rng.permutation(I)[:K].astype(np.int32)
        new = torch.randn((K, J), generator=g, device=dev).to(dtype)
        outs = []
        for _ in range(2):
            m = mirror.clone()
            outs.append(mpr.patch_table_rows(table, colsum, m, core, ids,
                                             new) + (m,))
        m_p = mirror.clone()
        want_t, want_c = ref.patch_table_rows_ref(table, colsum, m_p, core,
                                                  ids, new)
        for got_t, got_c, got_m in outs:
            assert torch.equal(got_t, want_t) and torch.equal(got_m, m_p)
            _close(got_c, want_c, 1e-5)
        assert torch.equal(outs[0][1], outs[1][1])
        assert torch.equal(outs[0][0], mpr.mode_product_rows(
            outs[0][2], core).to(dtype))


@pytest.mark.parametrize("M", [1, 2, 3, 4])
@pytest.mark.parametrize("dims", [(40, 30, 20), (13, 11, 9, 7)])
def test_store_from_card_tensor_equals_host_build_on_card(dev, dims, M):
    """A store built from a tensor on the card (its counting pass runs
    there) equals the store built from the same host triple, meta and
    arrays; the host build is the reference's (tests/test_torch_data.py)."""
    from repro_torch.core.sptensor import SparseTensor
    from repro_torch.data import NonzeroStore

    rng = np.random.default_rng(10 * M + len(dims))
    idx = np.stack([rng.integers(0, d, 3000) for d in dims],
                   1).astype(np.int32)
    val = rng.normal(size=3000).astype(np.float32)
    card = NonzeroStore.build(
        SparseTensor.from_numpy(idx, val, dims, device=dev), M,
        chunk_nnz=101)
    host = NonzeroStore.build((idx, val, dims), M, chunk_nnz=101)
    assert card.meta == host.meta
    for f in ("indices", "values", "mask"):
        np.testing.assert_array_equal(getattr(card, f), getattr(host, f))
    np.testing.assert_array_equal(card.fill(), host.fill())


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetcher_pinned_staging_on_card(dev, depth):
    """The default placement: every block bitwise the store's chunk on the
    card, through at most depth + 1 reused pinned buffers, also after a
    jump and across the epoch boundary."""
    from repro_torch.data import NonzeroStore, StratumPrefetcher

    rng = np.random.default_rng(depth)
    dims = (40, 30, 20)
    idx = np.stack([rng.integers(0, d, 5000) for d in dims], 1)
    store = NonzeroStore.build(
        (idx.astype(np.int32), rng.normal(size=5000).astype(np.float32),
         dims), 4)
    S = store.num_strata
    pf = StratumPrefetcher(store.stratum, lambda p: (p + 1) % S,
                           depth=depth, device=dev)
    try:
        for p in list(range(S)) + [0, 7, 8]:
            blocks = pf.take(p, timeout=60)
            for t, f in zip(blocks, ("indices", "values", "mask")):
                assert t.device.type == "cuda"
                assert torch.equal(t.cpu(), torch.from_numpy(
                    np.ascontiguousarray(getattr(store, f)[p])))
            # equal-shaped strata: no slot's buffers are ever pinned again
            assert pf._placer.pinned_sets <= depth + 1
            assert all(s[0][0].is_pinned() for s in pf._placer._slots
                       if s is not None)
    finally:
        pf.close()


def test_online_train_launches_on_card(dev, tmp_path):
    """online_train on the card: each round exactly K kruskal_grad, 3K
    scatter_accum and one patch_table_rows a patched mode (one
    mode_product_rows a mode in a rebuild), the tables bitwise a rebuild."""
    from repro_torch.launch import online_train

    K = 2
    rec = online_train.main([
        "--dims", "60,50,40", "--nnz", "8000", "--warmup-steps", "10",
        "--rounds", "3", "--refresh-steps", str(K), "--batch", "256",
        "--rank", "4", "--core-rank", "4", "--device", "cuda", "--backend",
        "cuda", "--spill-dir", str(tmp_path / "s"), "--verify"])
    assert rec["verify"]["exact"]
    for r in rec["rounds"]:
        want = {k: 0 for k in r["launches"]}
        want.update(kruskal_grad=K, scatter_accum=3 * K)
        if r["publish"] == "patch":
            want["patch_table_rows"] = sum(1 for d in r["dirty"] if d)
        else:
            want["mode_product_rows"] = len(r["dirty"])
        assert r["launches"] == want, r


# ---------------------------------------------------------------------------
# the multi-device strategies, four workers on one card
# ---------------------------------------------------------------------------

def _strata_setup(dev, name, sorted_batches=False, backend="cuda", M=4,
                  dims=(600, 480, 360), nnz=200_000, batch=1024):
    from repro_torch.data.synthetic import planted_tensor
    from repro_torch.distributed import get_strategy
    from repro_torch.launch.mesh import make_host_mesh

    t = planted_tensor(dims, nnz, rank=4, core_rank=4, seed=3, device=dev)
    cfg = ft.FastTuckerConfig(dims=dims, ranks=(4,) * 3, core_rank=4,
                              batch_size=batch, backend=backend,
                              sorted_batches=sorted_batches)
    mesh = make_host_mesh(num_workers=M, device=dev)
    st = get_strategy(name)
    plan = st.prepare(t, cfg, mesh, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    return st, plan, st.init(plan, ft.init_state(gen, cfg, dev), gen), cfg


@pytest.mark.parametrize("name", ["sync", "strata"])
def test_mesh_strategy_cuda_matches_torch_on_card(dev, name):
    """Four workers on the card, 20 fed-pick steps on "cuda" against
    "torch" from the same state: within 1e-4 of each leaf's largest (the
    bound of the single-device parity); exactly M kruskal_grad and M·N
    scatter_accum launches a step, nothing else."""
    import dataclasses

    st, plan, ds, cfg = _strata_setup(dev, name)
    tplan = dataclasses.replace(plan, cfg=dataclasses.replace(
        cfg, backend="torch"))
    ts = ds
    M = plan.mesh.size
    high = (plan.layout.chunk_len if name == "strata"
            else plan.val_shards[0].shape[0])
    g = torch.Generator(device=dev).manual_seed(5)
    for _ in range(20):
        picks = [torch.randint(0, high, (cfg.batch_size,), generator=g,
                               device=dev) for _ in range(M)]
        reset_launch_counts()
        ds = st.step_batch(plan, ds, picks)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["kruskal_grad"] == M and counts["scatter_accum"] == 3 * M
        assert sum(counts.values()) == 4 * M
        ts = st.step_batch(tplan, ts, picks)
    got, want = st.eval_params(plan, ds), st.eval_params(tplan, ts)
    for a, b in zip(got.factors + got.core_factors,
                    want.factors + want.core_factors):
        _close(a, b, 1e-4)


def test_overlap_and_sorted_equal_strata_on_card(dev):
    """strata_overlap (side-stream rotations) and sorted strata end on
    plain strata's bits on the card: factors, core and generator states."""
    runs = {}
    for name, srt in (("strata", False), ("strata_overlap", False),
                      ("strata", True)):
        st, plan, ds, _ = _strata_setup(dev, name, sorted_batches=srt)
        step = st.make_step(plan)
        while ds.step < 32:
            ds = step(ds)
        torch.cuda.synchronize()
        runs[(name, srt)] = st._globalize(plan, ds)
    base = runs[("strata", False)]
    for key, other in runs.items():
        leaves = zip(base.params.factors + base.params.core_factors
                     + (base.rng,),
                     other.params.factors + other.params.core_factors
                     + (other.rng,))
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in leaves), key


def test_strata_negative_local_ids_on_card(dev):
    """Dims that leave padding in every bucket at M = 4: the localized
    padding (down to −3 rows_per_block) gathers with the clamped ids and
    the scatter drops it — no device assert, finite parameters."""
    st, plan, ds, _ = _strata_setup(dev, "strata", dims=(601, 479, 333),
                                    nnz=50_000, batch=512)
    wb = plan.worker_buckets
    assert all((~w[2]).any() for w in wb)   # every worker has padding
    step = st.make_step(plan)
    while ds.step < 2 * len(plan.schedule):
        ds = step(ds)
    torch.cuda.synchronize()
    p = st.eval_params(plan, ds)
    assert all(torch.isfinite(f).all() for f in p.factors + p.core_factors)


def test_sharded_tp_step_launches_sliced_kernels_on_card(dev):
    """The (1, 4) ``tp`` step of reduced qwen3_14b (tucker_rank 8, seq
    1088: the flash region) on four workers sharing the card: every worker
    launches its ``tucker_matmul``s at d_ff/4 rows and its flash kernels
    on its one query head; the loss, m and v after one step within phase
    13's bounds of the ``"torch"`` backend's, the parameters under its
    sign rule (where |m| is past a quarter of its leaf's largest, within
    2⁻⁵ of the lr)."""
    import dataclasses

    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs.qwen3_14b import REDUCED
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(REDUCED, tucker_rank=8)
    mesh = make_host_mesh(4, num_workers=4, device=dev)
    assert mesh.shape == (1, 4)
    batch = train.device_batch(TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=1088, global_batch=2)
    ).global_batch(0), dev)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    out = {}
    for bk in ("cuda", "torch"):
        state, layouts = train.build_state(
            torch.Generator(device=dev).manual_seed(0), cfg, mesh, "tp")
        assert tuple(layouts["layers.0.ffn.up.u2"].part_shape()) == (32, 8)
        step = steps.make_sharded_train_step(cfg, opt, mesh, layouts, bk,
                                             policy="tp")
        reset_launch_counts()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        L, W = cfg.num_layers, mesh.size
        want = (6 * L * W, L * W, L * W) if bk == "cuda" else (0, 0, 0)
        assert (counts["tucker_matmul"], counts["flash_attention"],
                counts["flash_attention_bwd"]) == want
        out[bk] = (float(m["loss"]), float(m["lr"]),
                   {k: (v.full() if hasattr(v, "full") else v).detach()
                    for k, v in flatten(state).items()})
    (lc, lr, c), (lt, _, t) = out["cuda"], out["torch"]
    assert abs(lc - lt) <= 2.0 ** -7 * abs(lt)
    for name in t:
        if name.startswith("opt."):
            _close(c[name].float(), t[name].float(), 2.0 ** -5)
    for name in (n for n in t if n.startswith("params.")):
        mom = t["opt.m." + name[len("params."):]].abs()
        settled = mom > 0.25 * mom.max()
        d = (c[name] - t[name])[settled]
        assert d.abs().max().item() <= 2.0 ** -5 * lr, name


def test_sharded_moe_step_launches_sliced_kernels_on_card(dev):
    """The (1, 2) ``tp`` step of reduced DeepSeek-V2-Lite at MLA's
    published head widths (q·k 128 + 64, v 128; seq 1088: the flash
    region) on two workers sharing the card: every worker launches both
    flash kernels at (192, 128) on its H/2 heads, once a layer; the picks
    are the ``"torch"`` backend's, and the loss, m and v after one step
    within phase 13's bounds of its, the parameters under its sign rule."""
    import dataclasses

    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b",
                                         reduced=True),
                              qk_nope_head_dim=128, qk_rope_head_dim=64,
                              v_head_dim=128)
    mesh = make_host_mesh(2, num_workers=2, device=dev)
    assert mesh.shape == (1, 2)
    batch = train.device_batch(TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=1088, global_batch=2)
    ).global_batch(0), dev)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    be = dispatch.get_backend("cuda")
    out = {}
    for bk in ("cuda", "torch"):
        state, layouts = train.build_state(
            torch.Generator(device=dev).manual_seed(0), cfg, mesh, "tp")
        step = steps.make_sharded_train_step(cfg, opt, mesh, layouts, bk,
                                             policy="tp")
        seen, picks = [], []
        real_route, fwd = moe.route, be.flash_attention
        be.flash_attention = lambda q, k, v, **kw: (
            seen.append((q.shape[2], q.shape[-1], v.shape[-1]))
            or fwd(q, k, v, **kw))
        moe.route = lambda p, c, xt: (lambda r: picks.append(r[2]) or r)(
            real_route(p, c, xt))
        reset_launch_counts()
        try:
            state, m = step(state, batch)
            torch.cuda.synchronize()
        finally:
            moe.route = real_route
            del be.flash_attention
        counts = launch_counts()
        L, W = cfg.num_layers, mesh.size
        want = (L * W, L * W) if bk == "cuda" else (0, 0)
        assert (counts["flash_attention"],
                counts["flash_attention_bwd"]) == want
        assert counts["tucker_matmul"] == 0
        if bk == "cuda":
            assert seen == [(cfg.num_heads // W, 192, 128)] * (L * W)
        out[bk] = (float(m["loss"]), float(m["lr"]), picks,
                   {k: (v.full() if hasattr(v, "full") else v).detach()
                    for k, v in flatten(state).items()})
    (lc, lr, pc, c), (lt, _, pt, t) = out["cuda"], out["torch"]
    assert all(torch.equal(a, b) for a, b in zip(pc, pt))
    assert abs(lc - lt) <= 2.0 ** -7 * abs(lt)
    for name in t:
        if name.startswith("opt."):
            _close(c[name].float(), t[name].float(), 2.0 ** -5)
    for name in (n for n in t if n.startswith("params.")):
        mom = t["opt.m." + name[len("params."):]].abs()
        settled = mom > 0.25 * mom.max()
        d = (c[name] - t[name])[settled]
        assert d.abs().max().item() <= 2.0 ** -5 * lr, name
