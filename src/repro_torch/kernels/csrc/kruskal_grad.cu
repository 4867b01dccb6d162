// Fused Theorem-1 forward + Eq. 13/17 gradients for Hopper (sm_90a), f32.
//
// Replaces src/repro/kernels/kruskal_grad.py::kruskal_grad (the Pallas TPU
// kernel `_kernel`), joint pass only: all row modes, core gradients on, no
// cached mode products in or out.  For each sampled nonzero b:
//     c[n], pexc[n], pred              as in kruskal_contract.cu
//     err      = (pred_coef·pred − val)·mask
//     rg[n][b] = (err·inv_row)·(pexc[n] B[n]ᵀ) + ((λ_a·inv_row)·mask)·a[n][b]
// and for the whole batch
//     cg[n]    = λ_b·B[n] + Σ_b a[n][b]ᵀ (err·inv_core · pexc[n][b])
// with scal = [inv_row, inv_core, λ_a, λ_b, pred_coef].
//
// Bound on the card: memory.  It reads N·B·J + 2·B floats and writes
// 2·B + N·B·J, against 6·N·B·J·R flops (three J×R products per sample and
// mode): ~1.5 flops per byte at J = R = 4, far below the ~20 the H100
// needs to be bound by f32 arithmetic.  At the training batch B = 4096 the
// whole call moves ~0.4 MB, under a microsecond at 3.35 TB/s, so in
// practice the launch sets its time.  The design keeps every intermediate
// out of device memory: B[n] in shared memory, c and pexc in registers of
// one lane group per sample, and the core gradient's per-sample terms in a
// shared tile (a and err·inv_core·pexc) that the block folds into its own
// (N, J, R) partial sum.
//
// The TPU kernel carries one core accumulator across its sequential grid.
// Blocks here run in no order, so each block writes its partial sum to a
// (blocks, N, J, R) scratch and a second small kernel adds the partials in
// block order, seeded with λ_b·B.  There are no float atomics: the core
// gradient is the same bits from run to run.  Within a block the samples
// are folded in tile order, tile by tile, in sample order.
#include "common.cuh"

__global__ void __launch_bounds__(256) kruskal_grad_kernel(
    const float* __restrict__ a, const float* __restrict__ bfac,
    const float* __restrict__ val, const float* __restrict__ mask,
    const float* __restrict__ scal, float* __restrict__ pred,
    float* __restrict__ err, float* __restrict__ rg,
    float* __restrict__ partial, int N, long long B, int J, int R, int W,
    int BT) {
  extern __shared__ float smem[];
  const int RP = R + 1;
  const int NJR = N * J * R;
  float* bs = smem;                // (N, J, R+1) Kruskal factors
  float* as = bs + N * J * RP;     // (N, BT, J)  this tile's rows
  float* wp = as + N * BT * J;     // (N, BT, R)  err·inv_core·pexc
  float* acc = wp + N * BT * R;    // (N, J, R)   this block's partial
  load_factors(bfac, bs, N, J, R);
  for (int i = threadIdx.x; i < NJR; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const float inv_row = scal[0];
  const float inv_core = scal[1];
  const float reg_a = __fmul_rn(scal[2], inv_row);
  const float pred_coef = scal[4];
  const int sub = threadIdx.x & (W - 1);
  const int group = threadIdx.x / W;
  const int groups = blockDim.x / W;
  const long long tiles = (B + BT - 1) / BT;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long t0 = tile * BT;
    // s0 is the same for the whole block: the trip count is warp-uniform
    for (int s0 = 0; s0 < BT; s0 += groups) {
      const int s = s0 + group;
      const bool in_tile = s < BT;
      const long long b = t0 + s;
      const bool valid = in_tile && b < B;
      float av[REPRO_MAX_MODES], c[REPRO_MAX_MODES], pexc[REPRO_MAX_MODES];
#pragma unroll
      for (int n = 0; n < REPRO_MAX_MODES; ++n) {
        av[n] = (n < N && valid && sub < J) ? a[(n * B + b) * J + sub] : 0.f;
        if (n < N && in_tile && sub < J) as[(n * BT + s) * J + sub] = av[n];
      }
      theorem1_forward(av, bs, N, J, R, sub, W, c, pexc);
      const float p = group_sum(__fmul_rn(pexc[0], c[0]), W);
      const float v = valid ? val[b] : 0.f;
      const float m = valid ? mask[b] : 0.f;
      const float e = __fmul_rn(__fsub_rn(__fmul_rn(pred_coef, p), v), m);
      if (valid && sub == 0) {
        pred[b] = p;
        err[b] = e;
      }
      const float w_row = __fmul_rn(e, inv_row);
      const float w_core = __fmul_rn(e, inv_core);
      const float reg = __fmul_rn(reg_a, m);
#pragma unroll
      for (int n = 0; n < REPRO_MAX_MODES; ++n) {
        if (n < N) {
          if (in_tile && sub < R)
            wp[(n * BT + s) * R + sub] = __fmul_rn(w_core, pexc[n]);
          // Eq. 13: lane j forms Σ_r pexc[n][r]·B[n][j][r]
          float d = 0.f;
          for (int r = 0; r < R; ++r) {
            const float pr = __shfl_sync(REPRO_FULL_MASK, pexc[n], r, W);
            const float bv = sub < J ? bs[(n * J + sub) * RP + r] : 0.f;
            d = fmaf(pr, bv, d);
          }
          if (valid && sub < J)
            rg[(n * B + b) * J + sub] =
                __fadd_rn(__fmul_rn(w_row, d), __fmul_rn(reg, av[n]));
        }
      }
    }
    __syncthreads();
    // Eq. 17: fold this tile into the block's partial, one entry a thread
    for (int i = threadIdx.x; i < NJR; i += blockDim.x) {
      const int n = i / (J * R);
      const int jr = i - n * J * R;
      const int j = jr / R;
      const int r = jr - j * R;
      const float* an = as + n * BT * J + j;
      const float* wn = wp + n * BT * R + r;
      float t = 0.f;
      for (int s = 0; s < BT; ++s) t = fmaf(an[s * J], wn[s * R], t);
      acc[i] = __fadd_rn(acc[i], t);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < NJR; i += blockDim.x)
    partial[static_cast<long long>(blockIdx.x) * NJR + i] = acc[i];
}

// cg = λ_b·B + Σ_p partial[p], added in block order (deterministic).
__global__ void core_reduce_kernel(
    const float* __restrict__ partial, const float* __restrict__ bfac,
    const float* __restrict__ scal, float* __restrict__ cg, int P, int NJR) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NJR) return;
  float t = __fmul_rn(scal[3], bfac[i]);
  for (int p = 0; p < P; ++p)
    t = __fadd_rn(t, partial[static_cast<long long>(p) * NJR + i]);
  cg[i] = t;
}

// Shared memory of kruskal_grad_kernel for a tile of BT samples, in bytes.
static inline size_t grad_smem_bytes(int N, int J, int R, int BT) {
  return sizeof(float) *
         (static_cast<size_t>(N) * J * (R + 1) +
          static_cast<size_t>(N) * BT * (J + R) +
          static_cast<size_t>(N) * J * R);
}

extern "C" int kruskal_grad_f32(
    const float* a, const float* bfac, const float* val, const float* mask,
    const float* scal, float* pred, float* err, float* rg, float* cg,
    float* partial, int N, long long B, int J, int R, int BT, int blocks,
    void* stream) {
  if (N < 1 || N > REPRO_MAX_MODES || J < 1 || J > REPRO_MAX_WIDTH ||
      R < 1 || R > REPRO_MAX_WIDTH || B < 1 || BT < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = group_width(J, R);
  const size_t smem = grad_smem_bytes(N, J, R, BT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kruskal_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kruskal_grad_kernel<<<blocks, 256, smem, s>>>(
      a, bfac, val, mask, scal, pred, err, rg, partial, N, B, J, R, W, BT);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int NJR = N * J * R;
  core_reduce_kernel<<<(NJR + 255) / 256, 256, 0, s>>>(
      partial, bfac, scal, cg, blocks, NJR);
  return static_cast<int>(cudaGetLastError());
}
