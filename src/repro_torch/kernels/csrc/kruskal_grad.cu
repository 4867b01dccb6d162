// Fused Theorem-1 forward + Eq. 13/17 gradients for Hopper (sm_90a), with
// the phase flags of the reference and f32 or bf16 storage.
//
// Replaces src/repro/kernels/kruskal_grad.py::kruskal_grad (the Pallas TPU
// kernel `_kernel`).  For each sampled nonzero b:
//     c[n], pexc[n], pred              as in kruskal_contract.cu
//     err      = (pred_coef·pred − val)·mask
//     rg[j][b] = (err·inv_row)·(pexc[n] B[n]ᵀ) + ((λ_a·inv_row)·mask)·a[n][b]
//                for the j-th mode n of the row-mode list
// and for the whole batch
//     cg[n]    = λ_b·B[n] + Σ_b a[n][b]ᵀ (err·inv_core · pexc[n][b])
// with scal = [inv_row, inv_core, λ_a, λ_b, pred_coef].
//
// Phase flags (the phase-split and Gauss–Seidel steps):
//   c_out      (emit_c) lane r of each sample's group stores the c[n]
//              registers the pass itself used, as an (N, B, R) output;
//   c_in       (c=) the pass loads those values instead of running the N
//              dots, then forms pexc with the same prefix/suffix code;
//   row_code   (row_modes) an ordered list of up to 10 modes, passed by
//              value: bits 0-3 hold the count, bits 4+4j the j-th mode;
//              output j of rg follows the list;
//   want_core  0 skips the shared a and err·pexc tiles, the fold, the
//              partials and the core_reduce_kernel launch.
// The tile size BT and the block count come from the caller and do not
// depend on the flags, so a core pass fed with emitted c folds the same
// terms in the same order as the joint pass: its core gradient is the
// joint one, bit for bit.
//
// Storage: a and bfac are both f32 or both bf16 (converted to f32 on load,
// in core_reduce_kernel's λ_b·B seed too); every output is f32.
//
// Bound on the card: memory.  The joint pass reads N·B·J + 2·B values and
// writes 2·B + N·B·J, against 6·N·B·J·R flops (three J×R products per
// sample and mode): ~1.5 flops per byte at J = R = 4, far below the ~20
// the H100 needs to be bound by f32 arithmetic.  At the training batch
// B = 4096 a call moves ~0.4 MB, under a microsecond at 3.35 TB/s, so in
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

template <typename T>
__global__ void __launch_bounds__(256) kruskal_grad_kernel(
    const T* __restrict__ a, const T* __restrict__ bfac,
    const float* __restrict__ val, const float* __restrict__ mask,
    const float* __restrict__ scal, const float* __restrict__ c_in,
    float* __restrict__ pred, float* __restrict__ err,
    float* __restrict__ rg, float* __restrict__ c_out,
    float* __restrict__ partial, int N, long long B, int J, int R, int W,
    int BT, long long row_code, int want_core) {
  extern __shared__ float smem[];
  const int RP = R + 1;
  const int NJR = N * J * R;
  float* bs = smem;                // (N, J, R+1) Kruskal factors
  float* as = bs + N * J * RP;     // (N, BT, J)  this tile's rows
  float* wp = as + N * BT * J;     // (N, BT, R)  err·inv_core·pexc
  float* acc = wp + N * BT * R;    // (N, J, R)   this block's partial
  load_factors(bfac, bs, N, J, R);
  if (want_core)
    for (int i = threadIdx.x; i < NJR; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const float inv_row = scal[0];
  const float inv_core = scal[1];
  const float reg_a = __fmul_rn(scal[2], inv_row);
  const float pred_coef = scal[4];
  const int nrow = static_cast<int>(row_code & 15);
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
        av[n] = (n < N && valid && sub < J)
                    ? to_float(a[(n * B + b) * J + sub]) : 0.f;
        if (want_core && n < N && in_tile && sub < J)
          as[(n * BT + s) * J + sub] = av[n];
      }
      if (c_in != nullptr) {
#pragma unroll
        for (int n = 0; n < REPRO_MAX_MODES; ++n)
          c[n] = (n < N && valid && sub < R) ? c_in[(n * B + b) * R + sub]
                                             : 0.f;
      } else {
        group_mode_dots(av, bs, N, J, R, sub, W, c);
      }
      group_exclusive_products(c, N, pexc);
      if (c_out != nullptr && valid && sub < R) {
#pragma unroll
        for (int n = 0; n < REPRO_MAX_MODES; ++n)
          if (n < N) c_out[(n * B + b) * R + sub] = c[n];
      }
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
      if (want_core && in_tile && sub < R) {
#pragma unroll
        for (int n = 0; n < REPRO_MAX_MODES; ++n)
          if (n < N) wp[(n * BT + s) * R + sub] = __fmul_rn(w_core, pexc[n]);
      }
      // Eq. 13 for each listed mode: lane j forms Σ_r pexc[n][r]·B[n][j][r]
      for (int jr = 0; jr < nrow; ++jr) {
        const int n = static_cast<int>((row_code >> (4 + 4 * jr)) & 15);
        float pn = 0.f, an = 0.f;
#pragma unroll
        for (int k = 0; k < REPRO_MAX_MODES; ++k)
          if (k == n) {
            pn = pexc[k];
            an = av[k];
          }
        float d = 0.f;
        for (int r = 0; r < R; ++r) {
          const float pr = __shfl_sync(REPRO_FULL_MASK, pn, r, W);
          const float bv = sub < J ? bs[(n * J + sub) * RP + r] : 0.f;
          d = fmaf(pr, bv, d);
        }
        if (valid && sub < J)
          rg[(jr * B + b) * J + sub] =
              __fadd_rn(__fmul_rn(w_row, d), __fmul_rn(reg, an));
      }
    }
    if (want_core) {
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
  }
  if (want_core)
    for (int i = threadIdx.x; i < NJR; i += blockDim.x)
      partial[static_cast<long long>(blockIdx.x) * NJR + i] = acc[i];
}

// cg = λ_b·B + Σ_p partial[p], added in block order (deterministic).
template <typename T>
__global__ void core_reduce_kernel(
    const float* __restrict__ partial, const T* __restrict__ bfac,
    const float* __restrict__ scal, float* __restrict__ cg, int P, int NJR) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NJR) return;
  float t = __fmul_rn(scal[3], to_float(bfac[i]));
  for (int p = 0; p < P; ++p)
    t = __fadd_rn(t, partial[static_cast<long long>(p) * NJR + i]);
  cg[i] = t;
}

// Shared memory of kruskal_grad_kernel for a tile of BT samples, in bytes.
static inline size_t grad_smem_bytes(int N, int J, int R, int BT,
                                     int want_core) {
  size_t floats = static_cast<size_t>(N) * J * (R + 1);
  if (want_core)
    floats += static_cast<size_t>(N) * BT * (J + R) +
              static_cast<size_t>(N) * J * R;
  return sizeof(float) * floats;
}

template <typename T>
static int launch_grad(
    const T* a, const T* bfac, const float* val, const float* mask,
    const float* scal, const float* c_in, float* pred, float* err, float* rg,
    float* cg, float* c_out, float* partial, int N, long long B, int J,
    int R, int BT, int blocks, long long row_code, int want_core,
    void* stream) {
  const int nrow = static_cast<int>(row_code & 15);
  if (N < 1 || N > REPRO_MAX_MODES || J < 1 || J > REPRO_MAX_WIDTH ||
      R < 1 || R > REPRO_MAX_WIDTH || B < 1 || BT < 1 || blocks < 1 ||
      nrow > REPRO_MAX_MODES || (nrow > 0 && rg == nullptr) ||
      (want_core && (cg == nullptr || partial == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < nrow; ++j)
    if (((row_code >> (4 + 4 * j)) & 15) >= N)
      return static_cast<int>(cudaErrorInvalidValue);
  const int W = group_width(J, R);
  const size_t smem = grad_smem_bytes(N, J, R, BT, want_core);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kruskal_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kruskal_grad_kernel<T><<<blocks, 256, smem, s>>>(
      a, bfac, val, mask, scal, c_in, pred, err, rg, c_out, partial, N, B, J,
      R, W, BT, row_code, want_core);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !want_core) return static_cast<int>(e);
  const int NJR = N * J * R;
  core_reduce_kernel<T><<<(NJR + 255) / 256, 256, 0, s>>>(
      partial, bfac, scal, cg, blocks, NJR);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kruskal_grad_f32(
    const float* a, const float* bfac, const float* val, const float* mask,
    const float* scal, const float* c_in, float* pred, float* err, float* rg,
    float* cg, float* c_out, float* partial, int N, long long B, int J,
    int R, int BT, int blocks, long long row_code, int want_core,
    void* stream) {
  return launch_grad(a, bfac, val, mask, scal, c_in, pred, err, rg, cg,
                     c_out, partial, N, B, J, R, BT, blocks, row_code,
                     want_core, stream);
}

extern "C" int kruskal_grad_bf16(
    const __nv_bfloat16* a, const __nv_bfloat16* bfac, const float* val,
    const float* mask, const float* scal, const float* c_in, float* pred,
    float* err, float* rg, float* cg, float* c_out, float* partial, int N,
    long long B, int J, int R, int BT, int blocks, long long row_code,
    int want_core, void* stream) {
  return launch_grad(a, bfac, val, mask, scal, c_in, pred, err, rg, cg,
                     c_out, partial, N, B, J, R, BT, blocks, row_code,
                     want_core, stream);
}
