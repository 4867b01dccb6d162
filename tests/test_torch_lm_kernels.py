"""The LM's two kernels (plain path on CPU tensors) against the JAX reference.

The same numpy inputs go to the port's ``tucker_matmul`` and
``flash_attention`` wrappers on CPU tensors (which take the plain PyTorch
versions) and to the reference's Pallas kernels in interpret mode, its jnp
oracles (``repro.kernels.ref``), its custom-VJP ``models.flash`` and its
``chunked_attention`` scan.

Tolerances, with their reasons:

* f32, port against any reference: max |Δ| ≤ 1e-5 · max |reference|
  (``tucker_matmul``) — the same three f32 products summed in another
  order; ``flash_attention``: the reference's own kernel-vs-oracle
  tolerance (rtol 2e-4, atol 2e-5, ``tests/test_kernels.py``): dense
  softmax against an online one.
* bf16 inputs, port against the Pallas kernel: both keep the products in
  f32 and round once at the end, so they differ by at most one bf16 ulp:
  2⁻⁸ of the output's scale.  Against the jnp oracle, which rounds after
  every product, the reference test's own bf16 tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as j_flash
from repro.kernels.tucker_matmul import tucker_matmul as j_tucker
from repro.models import attention as j_attention
from repro.models import flash as j_models_flash
from repro_torch.kernels import (flash_attention, launch_counts, ref,
                                 reset_launch_counts, tucker_matmul)
from repro_torch.models import attention, flash

TUCKER_SHAPES = [(300, 512, 32, 32, 600), (128, 300, 16, 8, 200),
                 (65, 128, 8, 16, 127)]     # tests/test_kernels.py:62-64
FLASH_SHAPES = [(4, 256, 32, 64, 64), (2, 300, 16, 128, 64),
                (1, 128, 64, 128, 128)]     # tests/test_kernels.py:115-117
FLASH_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    # CPU tensors take the plain path: no kernel was launched
    assert launch_counts()["tucker_matmul"] == 0
    assert launch_counts()["flash_attention"] == 0


def _scaled_close(port, want, rel):
    port = np.asarray(port, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(port - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _tucker_inputs(M, K, R1, R2, N):
    rng = np.random.default_rng(M)
    return (rng.normal(size=(M, K)).astype(np.float32),
            (rng.normal(size=(K, R1)) / np.sqrt(K)).astype(np.float32),
            rng.normal(size=(R1, R2)).astype(np.float32),
            rng.normal(size=(N, R2)).astype(np.float32))


@pytest.mark.parametrize("M,K,R1,R2,N", TUCKER_SHAPES)
def test_tucker_matmul_f32_matches_reference(M, K, R1, R2, N):
    arrs = _tucker_inputs(M, K, R1, R2, N)
    y = tucker_matmul.tucker_matmul(*map(torch.tensor, arrs))
    assert y.dtype == torch.float32 and y.shape == (M, N)
    j = [jnp.asarray(a) for a in arrs]
    _scaled_close(y, j_tucker(*j, block_m=64, block_n=128, block_k=128,
                              interpret=True), 1e-5)
    _scaled_close(y, jref.tucker_matmul_ref(*j), 1e-5)


@pytest.mark.parametrize("M,K,R1,R2,N", TUCKER_SHAPES)
def test_tucker_matmul_bf16_matches_reference(M, K, R1, R2, N):
    arrs = _tucker_inputs(M, K, R1, R2, N)
    y = tucker_matmul.tucker_matmul(
        *(torch.tensor(a).bfloat16() for a in arrs))
    assert y.dtype == torch.bfloat16
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    _scaled_close(y.float(), j_tucker(*j, block_m=64, block_n=128,
                                      block_k=128, interpret=True), 2 ** -8)
    want = np.asarray(jref.tucker_matmul_ref(*j), np.float32)
    np.testing.assert_allclose(y.float().numpy(), want, rtol=8e-2,
                               atol=0.05 * (np.abs(want).max() + 1))


@pytest.mark.parametrize("M,K,R1,R2,N", TUCKER_SHAPES)
def test_tucker_matmul_path_mix_bf16_x_f32_factors(M, K, R1, R2, N):
    """The LM path's mix: x in bf16 (an rmsnorm output under
    dtype="bfloat16"), f32 factors.  JAX promotes to f32, and so does the
    port: the output is f32, the reference's "xla" route's result."""
    x, u1, g, u2 = _tucker_inputs(M, K, R1, R2, N)
    y = tucker_matmul.tucker_matmul(torch.tensor(x).bfloat16(),
                                    *map(torch.tensor, (u1, g, u2)))
    assert y.dtype == torch.float32
    want = jref.tucker_matmul_ref(jnp.asarray(x, jnp.bfloat16),
                                  *map(jnp.asarray, (u1, g, u2)))
    assert want.dtype == jnp.float32
    _scaled_close(y, want, 1e-5)


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_q).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,S,D,bq,bk", FLASH_SHAPES)
def test_flash_plain_matches_pallas_kernel(BH, S, D, bq, bk, causal):
    q, k, v = _qkv((BH, S, D), (BH, S, D), S + D)
    out = flash_attention.flash_attention(
        *map(torch.tensor, (q, k, v)), causal=causal)
    assert out.shape == (BH, S, D) and out.dtype == torch.float32
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(j_flash(jq, jk, jv, causal=causal,
                                        block_q=bq, block_k=bk,
                                        interpret=True)), **FLASH_TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jref.flash_attention_ref(
            jq, jk, jv, causal=causal)), **FLASH_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa_matches_reference_custom_vjp_flash(causal):
    """Grouped heads without copies: query head (kv, g) reads kv.

    Sq = Sk = 320, a multiple of the reference's kv_chunk: its flash pads
    the keys to a chunk multiple and, when not causal, does not mask the
    padded keys (``repro/models/flash.py::_fwd_impl``; ROADMAP.md
    Queue 3).  The port masks them; the offset test below covers ragged
    lengths against the reference's scan, which does mask them."""
    B, Sq, Kv, G, D = 2, 320, 2, 3, 32
    q, k, v = _qkv((B, Sq, Kv, G, D), (B, Sq, Kv, D), 7)
    want = j_models_flash.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal, 128, 64)
    got = flash.flash_attention(*map(torch.tensor, (q, k, v)), causal)
    assert got.shape == (B, Sq, Kv, G, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    # the Pallas layout of the same heads: (BH, S, D), KV rows BH / G
    q3 = torch.tensor(q).permute(0, 2, 3, 1, 4).reshape(B * Kv * G, Sq, D)
    k3, v3 = (torch.tensor(t).permute(0, 2, 1, 3).reshape(B * Kv, Sq, D)
              for t in (k, v))
    got3 = flash_attention.flash_attention(q3, k3, v3, causal=causal)
    np.testing.assert_allclose(
        got3.reshape(B, Kv, G, Sq, D).permute(0, 3, 1, 2, 4).numpy(),
        np.asarray(want), **FLASH_TOL)


@pytest.mark.parametrize("q_offset,kv_valid,causal", [
    (0, 300, True),        # prefill from index 0 into a longer cache
    (37, 337, True),       # a chunk of queries behind 37 cached positions
    (37, 337, False),
    (0, 330, False)])
def test_flash_offset_and_kv_len_match_reference_scan(q_offset, kv_valid,
                                                      causal):
    """q_offset and kv_len against the reference's ``chunked_attention``
    scan (a traced offset and a valid length, as under a cache), and the
    port's own ``chunked_attention`` taking the kernel for that region."""
    B, Sq, Sk, H, Kv, D = 2, 300, 360, 4, 2, 16
    q, k, v = _qkv((B, Sq, H, D), (B, Sk, Kv, D), q_offset + kv_valid)
    want = j_attention.chunked_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal,
        q_offset=jnp.asarray(q_offset, jnp.int32),
        kv_valid_len=jnp.asarray(kv_valid, jnp.int32), q_chunk=64,
        kv_chunk=64)
    got = flash_attention.flash_attention(
        *map(torch.tensor, (q, k, v)), causal=causal, kv_len=kv_valid,
        q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    chunked = attention.chunked_attention(
        *map(torch.tensor, (q, k, v)), causal=causal, q_offset=q_offset,
        kv_valid_len=kv_valid, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want),
                               **FLASH_TOL)


def test_chunked_attention_dense_branch_matches_reference():
    """Sq·Sk within one block: the dense masked softmax (every decode
    step), with an offset and a valid length."""
    B, Sq, Sk, H, Kv, D = 2, 1, 40, 4, 2, 16
    q, k, v = _qkv((B, Sq, H, D), (B, Sk, Kv, D), 3)
    want = j_attention.chunked_attention(
        *map(jnp.asarray, (q, k, v)), causal=True,
        q_offset=jnp.asarray(33, jnp.int32),
        kv_valid_len=jnp.asarray(34, jnp.int32))
    got = attention.chunked_attention(*map(torch.tensor, (q, k, v)),
                                      causal=True, q_offset=33,
                                      kv_valid_len=34)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_plain_versions_are_the_wrappers_cpu_path():
    arrs = _tucker_inputs(65, 128, 8, 16, 127)
    t = list(map(torch.tensor, arrs))
    assert torch.equal(tucker_matmul.tucker_matmul(*t),
                       ref.tucker_matmul_ref(*t))
    q, k, v = map(torch.tensor, _qkv((2, 50, 4, 16), (2, 50, 2, 16), 1))
    assert torch.equal(
        flash_attention.flash_attention(q, k, v, kv_len=45, q_offset=3),
        ref.flash_attention_ref(q, k, v, True, kv_len=45, q_offset=3))


D_MODEL, D_FF, LM_RANK = 5120, 17408, 512   # qwen3_14b, rank-512 FFNs
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("M,K,N,xdt,x_align,load,passes", [
    # prefill, both FFN directions: one tensor-core pass over K each,
    # 16-byte loads; x in bf16 skips its small pass (2 passes, not 3)
    (8192, D_MODEL, D_FF, BF16, 16, (16, 16, 16), (2, 3, 3)),
    (8192, D_FF, D_MODEL, F32, 16, (16, 16, 16), (3, 3, 3)),
    # ragged K: x's rows are not 16-byte multiples, so x U1 takes 4 bytes
    (8191, D_MODEL - 1, D_FF - 3, BF16, 16, (4, 16, 16), (2, 3, 3)),
    (8191, D_FF - 1, D_MODEL - 3, F32, 16, (4, 16, 16), (3, 3, 3)),
    # x one element off a 16-byte boundary: the same
    (8192, D_MODEL, D_FF, F32, 4, (4, 16, 16), (3, 3, 3)),
    # M = 17: past the streaming route, the tensor-core tiles
    (17, D_MODEL, D_FF, BF16, 16, (16, 16, 16), (2, 3, 3)),
    # decode: the streaming route, f32 fmaf, whatever x's alignment
    (1, D_MODEL, D_FF, BF16, 2, (16, 16, 16), (0, 0, 0)),
    (4, D_MODEL, D_FF, BF16, 16, (16, 16, 16), (0, 0, 0)),
    (4, D_FF, D_MODEL, F32, 16, (16, 16, 16), (0, 0, 0)),
    (16, D_MODEL, D_FF, BF16, 16, (16, 16, 16), (0, 0, 0)),
    (16, D_FF, D_MODEL, F32, 4, (16, 16, 16), (0, 0, 0)),
])
def test_plan_routes_splits_loads_and_workspace(M, K, N, xdt, x_align, load,
                                                passes):
    """The launch plan at the LM's shapes: prefill (M > 16) takes three
    tensor-core GEMMs in one pass over K; decode (M <= 16) streams the
    factors in three launches, splitting K for the first two products only;
    both routes' workspace is t1 and t."""
    R = LM_RANK
    p = tucker_matmul.plan(M, K, R, R, N, xdt, x_align=x_align)
    assert p.launches == 3
    assert p.load_bytes == load and p.passes == passes
    # t1 and t, once each, t right after t1 (M R is a multiple of 4 here)
    assert p.t_offset == M * R and p.workspace == M * 2 * R
    if M > tucker_matmul.STREAM_MAX_M:
        assert p.routes == ("mma",) * 3 and p.splits == (1, 1, 1)
        assert p.col_blocks == 0
        return
    s1, s2, s3 = p.splits
    assert p.routes == ("rows", "rows", "cols") and s3 == 1
    # each streamed factor's rows split over one cluster of at most 8
    # blocks per 32-column strip, each split at least MIN_ROWS rows, none
    # empty (the split-K sums stay inside the clusters: no partial slabs);
    # the last product on two blocks per SM
    for k, s in ((K, s1), (R, s2)):
        assert 1 <= s <= tucker_matmul.MAX_CLUSTER
        rows = -(-k // s)
        assert rows >= tucker_matmul.MIN_ROWS and -(-k // rows) == s
    assert p.col_blocks == tucker_matmul.STREAM_BLOCKS


@pytest.mark.parametrize("M,R1,R2", [(17, 3, 4), (1, 3, 5), (5, 7, 2),
                                     (65, 8, 16)])
def test_plan_puts_t_on_a_16_byte_boundary(M, R1, R2):
    """t starts at M R1 rounded up to 4 floats, so its 16-byte loads and
    8-byte stores stay aligned whatever M R1 is; the workspace holds it."""
    p = tucker_matmul.plan(M, 64, R1, R2, 40, F32)
    assert p.t_offset % 4 == 0 and 0 <= p.t_offset - M * R1 < 4
    assert p.workspace == p.t_offset + M * R2


def test_plan_small_and_unaligned_factors_take_narrow_loads():
    p = tucker_matmul.plan(1, 7, 3, 5, 9, F32)
    assert p.routes == ("rows", "rows", "cols") and p.splits == (1, 1, 1)
    assert p.load_bytes == (4, 4, 4)
    p = tucker_matmul.plan(300, 512, 32, 32, 600, F32, w_align=8)
    assert p.routes == ("mma",) * 3 and p.load_bytes == (4, 4, 4)
    # t (M x R2) past the streaming route's shared memory: tensor cores
    assert tucker_matmul.plan(16, 512, 64, 1024, 64, F32).routes[0] == "mma"


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: what ``cvt.rna.tf32.f32`` does."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_emulation_separates_three_passes_from_one():
    """The card's tolerance (2e-5 of the output's scale) admits 3xTF32 and
    refuses one pass of TF32, at the LM's longest K (17408).  Products of
    two TF32 values are exact in f32, so an f32 matmul of rounded operands
    is what one tensor-core pass with f32 accumulators computes."""
    rng = np.random.default_rng(17408)
    K = D_FF
    a = torch.tensor(rng.normal(size=(64, K)), dtype=F32)
    b = torch.tensor(rng.normal(size=(K, 64)) / np.sqrt(K), dtype=F32)
    want = a.double() @ b.double()

    def rel(y):
        return ((y.double() - want).abs().max() / want.abs().max()).item()

    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    one = ab @ bb
    three = ab @ b_s + a_s @ bb + ab @ bb
    plain = a @ b
    tol = 2e-5
    assert rel(one) > 10 * tol           # ~3e-4: one pass fails the check
    assert rel(three) <= tol / 10        # ~1e-7: f32-level
    assert rel(three) <= 4 * rel(plain) + 1e-7
    # bf16 x is exact in TF32: its small part is 0, two passes suffice
    x = a.bfloat16().float()
    assert torch.equal(_tf32(x), x)
    want = x.double() @ b.double()
    assert rel(_tf32(x) @ b_s + _tf32(x) @ bb) <= tol / 10


@pytest.mark.parametrize("K", [32, 128, 192])
def test_tf32_emulation_bf16_passes_drop_exactly(K):
    """The flash kernels' bf16 instances skip the passes of exact sides:
    a bf16 value's TF32 small part is exactly 0, so one pass of two bf16
    operands, and two passes (the f32 side's small part by the bf16 big
    part, then big by big) of an f32 and a bf16 operand, give the three-
    pass sum's bits, the zero passes summed first as the kernels order
    them.  K: a key tile (P·V), D = 128 and MLA's q·k width."""
    rng = np.random.default_rng(K)
    a = torch.tensor(rng.normal(size=(16, K)), dtype=F32)
    b = torch.tensor(rng.normal(size=(K, 8)), dtype=F32)
    ah, bh = a.bfloat16().float(), b.bfloat16().float()

    def parts(x):
        big = _tf32(x)
        return big, _tf32(x - big)

    def three(x, y):
        (xb, xs), (yb, ys) = parts(x), parts(y)
        return (xb @ ys + xs @ yb) + xb @ yb

    for x in (ah, bh):
        big, small = parts(x)
        assert torch.equal(big, x) and not small.any()
    assert torch.equal(_tf32(ah) @ _tf32(bh), three(ah, bh))
    ab, a_s = parts(a)
    assert torch.equal(a_s @ bh + ab @ bh, three(a, bh))


def test_tf32_emulation_sets_the_flash_backward_tolerance():
    """The flash backward's five products (S = q kᵀ, dP = dO vᵀ, dV = Pᵀ dO,
    dK = dSᵀ q, dQ = dS k) emulated as 3xTF32 and as one TF32 pass, at one
    head of the training shape's contraction lengths (S = 2048, D = 128,
    causal), against the f32 plain version: 3xTF32 within 2e-5 of each
    output's largest (~1e-6), one pass not (~4e-4), so the card holds the
    kernel to 2e-5 (``TOL["flash_attention_bwd"]`` in ``chip_smoke.py``,
    ``FLASH_BWD_TOL`` in ``test_torch_cuda.py``)."""
    rng = np.random.default_rng(2048)
    S, D = 2048, 128
    q, k, v, dout = (torch.tensor(rng.normal(size=(1, S, 1, D)), dtype=F32)
                     for _ in range(4))
    o, lse = ref.flash_attention_ref(q, k, v, True, return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, True)

    def three(a, b):
        ab, bb = _tf32(a), _tf32(b)
        return ab @ _tf32(b - bb) + _tf32(a - ab) @ bb + ab @ bb

    def one(a, b):
        return _tf32(a) @ _tf32(b)

    def backward(mm):
        qh, kh, vh, oh, dh = (t[0, :, 0] for t in (q, k, v, o, dout))
        mask = torch.ones(S, S, dtype=torch.bool).tril()
        p = torch.where(mask, torch.exp(mm(qh, kh.T) / np.sqrt(D)
                                        - lse[0, 0][:, None]), 0.0)
        ds = p * (mm(dh, vh.T) - (dh * oh).sum(-1)[:, None])
        return (mm(ds, kh) / np.sqrt(D), mm(ds.T, qh) / np.sqrt(D),
                mm(p.T, dh))

    def rel(got, w):
        got = got.reshape(w.shape).double()
        return ((got - w.double()).abs().max() / w.abs().max()).item()

    tol = 2e-5
    for got, w in zip(backward(three), want):
        assert rel(got, w) <= tol / 10
    for got, w in zip(backward(one), want):
        assert rel(got, w) > 10 * tol
