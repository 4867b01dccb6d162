// Theorem-1 forward contraction for Hopper (sm_90a); f32 or bf16 storage.
//
// Replaces src/repro/kernels/kruskal_contract.py::kruskal_contract (the
// Pallas TPU kernel `_kernel`).  For each sampled nonzero b:
//     c[n]    = a[n][b] · B[n]          (J-long dots, one per r)
//     pexc[n] = Π_{k≠n} c[k]            (prefix/suffix chains, no division)
//     pred[b] = Σ_r pexc[0][r]·c[0][r]
// Inputs a (N, B, J) and bfac (N, J, R), contiguous, both f32 or both bf16
// (converted to f32 on load); outputs pred (B,) and pexc (N, B, R), f32;
// J, R <= 32, N <= 10.
//
// Bound on the card: memory.  It reads N·B·J floats and writes B + N·B·R,
// against 2·N·B·J·R flops: at the paper's J = R = 4 that is ~0.5 flop per
// byte, far below the H100's ~20 f32 flops per byte (bf16 storage halves
// the bytes read).  The design reads each
// input once and writes each output once: B[n] sits in shared memory for
// the whole block, the dots, chains and the r-sum stay in registers and
// shuffles, and one group of W = next_pow2(max(J, R)) lanes handles one
// sample, so at J = R = 4 a warp works on 8 samples at once.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(256) kruskal_contract_kernel(
    const T* __restrict__ a, const T* __restrict__ bfac,
    float* __restrict__ pred, float* __restrict__ pexc_out,
    int N, long long B, int J, int R, int W) {
  extern __shared__ float bs[];
  load_factors(bfac, bs, N, J, R);
  __syncthreads();

  const int sub = threadIdx.x & (W - 1);
  const int group = threadIdx.x / W;
  const int groups = blockDim.x / W;
  const long long stride = static_cast<long long>(gridDim.x) * groups;
  // b0 is the same for the whole block: the trip count is warp-uniform
  for (long long b0 = static_cast<long long>(blockIdx.x) * groups; b0 < B;
       b0 += stride) {
    const long long b = b0 + group;
    const bool valid = b < B;
    float av[REPRO_MAX_MODES], c[REPRO_MAX_MODES], pexc[REPRO_MAX_MODES];
#pragma unroll
    for (int n = 0; n < REPRO_MAX_MODES; ++n)
      av[n] = (n < N && valid && sub < J) ? to_float(a[(n * B + b) * J + sub])
                                          : 0.f;
    theorem1_forward(av, bs, N, J, R, sub, W, c, pexc);
    const float p = group_sum(__fmul_rn(pexc[0], c[0]), W);
    if (valid) {
      if (sub == 0) pred[b] = p;
      if (sub < R) {
#pragma unroll
        for (int n = 0; n < REPRO_MAX_MODES; ++n)
          if (n < N) pexc_out[(n * B + b) * R + sub] = pexc[n];
      }
    }
  }
}

template <typename T>
static int launch_contract(const T* a, const T* bfac, float* pred,
                           float* pexc, int N, long long B, int J, int R,
                           void* stream) {
  if (N < 1 || N > REPRO_MAX_MODES || J < 1 || J > REPRO_MAX_WIDTH ||
      R < 1 || R > REPRO_MAX_WIDTH || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = group_width(J, R);
  const int threads = 256;
  const int groups = threads / W;
  long long blocks = (B + groups - 1) / groups;
  if (blocks > 4096) blocks = 4096;
  const size_t smem = sizeof(float) * N * J * (R + 1);  // <= 42,240 bytes
  kruskal_contract_kernel<T><<<static_cast<unsigned>(blocks), threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      a, bfac, pred, pexc, N, B, J, R, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kruskal_contract_f32(
    const float* a, const float* bfac, float* pred, float* pexc,
    int N, long long B, int J, int R, void* stream) {
  return launch_contract(a, bfac, pred, pexc, N, B, J, R, stream);
}

extern "C" int kruskal_contract_bf16(
    const __nv_bfloat16* a, const __nv_bfloat16* bfac, float* pred,
    float* pexc, int N, long long B, int J, int R, void* stream) {
  return launch_contract(a, bfac, pred, pexc, N, B, J, R, stream);
}
