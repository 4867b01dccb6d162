// Theorem-1 forward contraction for Hopper (sm_90a); f32 or bf16 storage.
//
// Replaces src/repro/kernels/kruskal_contract.py::kruskal_contract (the
// Pallas TPU kernel `_kernel`).  For each sampled nonzero b:
//     c[n]    = a[n][b] · B[n]          (J-long dots, one per r)
//     pexc[n] = Π_{k≠n} c[k]            (prefix/suffix chains, no division)
//     pred[b] = Σ_r pexc[0][r]·c[0][r]
// Inputs a (N, B, J) and bfac (N, J, R), contiguous, both f32 or both bf16
// (converted to f32 on load); outputs pred (B,) and, unless its pointer is
// null, pexc (N, B, R), f32; J, R <= 64, N <= 10.
//
// Bound on the card: memory.  It reads N·B·J values and writes B + N·B·R
// floats (B alone without pexc), against 2·N·B·J·R flops: at the paper's
// J = R = 4 that is ~0.5 flop per byte, far below the H100's ~20 f32 flops
// per byte.  So the design is about bytes in flight and full-width
// accesses; each input is read once and each output written once.
//
// Two routes, chosen from the shapes:
//   - one thread a sample, where max(J, R) <= 8 and N·JR <= 32 (JR = 4 or
//     8, the width padded up; the paper's Table 13 shapes and every
//     Netflix-shaped path).  The thread loads each mode's row whole (16-byte
//     loads of f32 rows of 4 or 8, 8- or 16-byte loads of bf16 ones, with
//     streaming cache hints) and stores its pexc rows with 16-byte stores;
//     the factors sit in shared memory, zero-padded to (N, JR, JR), read as
//     broadcasts.  A persistent grid (the SM count × the blocks a SM holds,
//     fewer where the batch is smaller) walks the batch with a grid-stride
//     loop that loads two samples a thread before it computes either
//     (one where N·JR > 16, for registers).  pred's r-sum runs in r
//     order: ((p_0 + p_1) + p_2) + … with p_r = pexc[0][r]·c[0][r].
//   - a group of W = min(next_pow2(max(J, R)), 32) lanes a sample (E = 1 or
//     2 entries a lane, common.cuh) for the wider shapes, over the same
//     kind of persistent grid; the factors sit in shared memory with row
//     stride R+1.  pred's r-sum: each lane's entries in e order, then the
//     W lanes by a xor tree (group_pred).
// On both routes c is the j-order fmaf chain from 0 and pexc the prefix/
// suffix __fmul_rn chains of group_exclusive_products, the arithmetic of
// kruskal_grad.cu, so the two kernels give equal c and pexc bits; only the
// order of pred's r-sum differs between the routes (within 2e-5 of the
// plain version on either).
#include <cstdint>

#include "common.cuh"

#define CONTRACT_THREADS 256
#define CONTRACT_NARROW 8          // max(J, R) of the thread-a-sample route
#define CONTRACT_NARROW_REGS 32    // N·JR at most on that route

// Streaming loads of one row of JR values (J of them real, the rest 0):
// whole-row vector loads where `vec` (J == JR and the rows aligned).
__device__ __forceinline__ void load_row4(const float* p, float (&v)[4]) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load_row4(const __nv_bfloat16* p,
                                          float (&v)[4]) {
  const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 lo = __bfloat1622float2(h[0]);
  const float2 hi = __bfloat1622float2(h[1]);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

template <typename T, int JR>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&v)[JR], int J, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < JR / 4; ++q) {
      float w[4];
      load_row4(p + 4 * q, w);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * q + k] = w[k];
    }
  } else {
#pragma unroll
    for (int j = 0; j < JR; ++j) v[j] = j < J ? to_float(p[j]) : 0.f;
  }
}

template <typename T, int N, int JR>
__global__ void __launch_bounds__(CONTRACT_THREADS) contract_thread_kernel(
    const T* __restrict__ a, const T* __restrict__ bfac,
    float* __restrict__ pred, float* __restrict__ pexc_out, long long B,
    int J, int R, int vec_in, int vec_out) {
  constexpr int U = N * JR <= 16 ? 2 : 1;   // samples in flight a thread
  __shared__ __align__(16) float bs[N * JR * JR];   // (N, JR, JR), 0-padded
  for (int i = threadIdx.x; i < N * JR * JR; i += blockDim.x) {
    const int n = i / (JR * JR);
    const int j = (i / JR) % JR;
    const int r = i % JR;
    bs[i] = j < J && r < R ? to_float(bfac[(n * J + j) * R + r]) : 0.f;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       b0 < B; b0 += U * stride) {
    float av[U][N][JR];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long b = b0 + u * stride;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        if (b < B) {
          load_row<T, JR>(a + (n * B + b) * J, av[u][n], J, vec_in);
        } else {
#pragma unroll
          for (int j = 0; j < JR; ++j) av[u][n][j] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long b = b0 + u * stride;
      if (b >= B) continue;
      float c[N][JR];
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int r = 0; r < JR; ++r) c[n][r] = 0.f;
#pragma unroll
      for (int j = 0; j < JR; ++j) {
        if (j < J) {
#pragma unroll
          for (int n = 0; n < N; ++n)
#pragma unroll
            for (int r = 0; r < JR; ++r)
              c[n][r] = fmaf(av[u][n][j], bs[(n * JR + j) * JR + r], c[n][r]);
        }
      }
      float px[N][JR];   // group_exclusive_products' chains, per column
#pragma unroll
      for (int r = 0; r < JR; ++r) {
        float acc = 1.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          px[n][r] = acc;
          acc = __fmul_rn(acc, c[n][r]);
        }
        acc = 1.f;
#pragma unroll
        for (int n = N - 1; n >= 0; --n) {
          px[n][r] = __fmul_rn(px[n][r], acc);
          acc = __fmul_rn(acc, c[n][r]);
        }
      }
      float p = __fmul_rn(px[0][0], c[0][0]);
#pragma unroll
      for (int r = 1; r < JR; ++r)
        if (r < R) p = __fadd_rn(p, __fmul_rn(px[0][r], c[0][r]));
      __stcs(pred + b, p);
      if (pexc_out != nullptr) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          float* dst = pexc_out + (n * B + b) * R;
          if (vec_out) {
#pragma unroll
            for (int q = 0; q < JR / 4; ++q)
              __stcs(reinterpret_cast<float4*>(dst) + q,
                     make_float4(px[n][4 * q], px[n][4 * q + 1],
                                 px[n][4 * q + 2], px[n][4 * q + 3]));
          } else {
#pragma unroll
            for (int r = 0; r < JR; ++r)
              if (r < R) dst[r] = px[n][r];
          }
        }
      }
    }
  }
}

template <typename T, int N, int E>
__global__ void __launch_bounds__(CONTRACT_THREADS) contract_group_kernel(
    const T* __restrict__ a, const T* __restrict__ bfac,
    float* __restrict__ pred, float* __restrict__ pexc_out, long long B,
    int J, int R, int W) {
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
    float av[REPRO_MAX_MODES][E], c[REPRO_MAX_MODES][E];
    float pexc[REPRO_MAX_MODES][E];
#pragma unroll
    for (int n = 0; n < REPRO_MAX_MODES; ++n)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = sub + 32 * e;
        av[n][e] = n < N && valid && j < J
                       ? to_float(__ldcs(a + (n * B + b) * J + j)) : 0.f;
      }
    group_mode_dots(av, bs, N, J, R, sub, W, c);
    group_exclusive_products(c, N, pexc);
    const float p = group_pred(c, pexc, W);
    if (valid) {
      if (sub == 0) __stcs(pred + b, p);
      if (pexc_out != nullptr) {
#pragma unroll
        for (int n = 0; n < N; ++n)
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (sub + 32 * e < R)
              __stcs(pexc_out + (n * B + b) * R + sub + 32 * e, pexc[n][e]);
      }
    }
  }
}

// Blocks of a persistent grid: the SM count × the blocks of `kernel` a SM
// holds at `smem` bytes, and no more than the batch needs.
template <typename K>
static int persistent_blocks(K kernel, size_t smem, long long per_block,
                             long long B, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, CONTRACT_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (B + per_block - 1) / per_block;
  const long long full = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(need < full ? need : full);
  return 0;
}

template <typename T, int N, int JR>
static int launch_thread(const T* a, const T* bfac, float* pred, float* pexc,
                         long long B, int J, int R, cudaStream_t s) {
  constexpr int U = N * JR <= 16 ? 2 : 1;
  int blocks = 0;
  int err = persistent_blocks(contract_thread_kernel<T, N, JR>, 0,
                              static_cast<long long>(CONTRACT_THREADS) * U,
                              B, &blocks);
  if (err) return err;
  // whole-row vector accesses: rows of exactly JR values at aligned bases
  const int row_bytes = JR * static_cast<int>(sizeof(T));
  const int align = row_bytes < 16 ? row_bytes : 16;
  const int vec_in = J == JR && reinterpret_cast<uintptr_t>(a) % align == 0;
  const int vec_out = pexc != nullptr && R == JR &&
                      reinterpret_cast<uintptr_t>(pexc) % 16 == 0;
  contract_thread_kernel<T, N, JR><<<blocks, CONTRACT_THREADS, 0, s>>>(
      a, bfac, pred, pexc, B, J, R, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N, int E>
static int launch_group(const T* a, const T* bfac, float* pred, float* pexc,
                        long long B, int J, int R, cudaStream_t s) {
  const int W = group_width(J, R);
  const size_t smem = sizeof(float) * N * J * (R + 1);  // <= 166,400 bytes
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        contract_group_kernel<T, N, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int blocks = 0;
  int err = persistent_blocks(contract_group_kernel<T, N, E>, smem,
                              CONTRACT_THREADS / W, B, &blocks);
  if (err) return err;
  contract_group_kernel<T, N, E><<<blocks, CONTRACT_THREADS, smem, s>>>(
      a, bfac, pred, pexc, B, J, R, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_contract(const T* a, const T* bfac, float* pred,
                           float* pexc, int N, long long B, int J, int R,
                           void* stream) {
  if (N < 1 || N > REPRO_MAX_MODES || J < 1 || J > REPRO_MAX_WIDTH ||
      R < 1 || R > REPRO_MAX_WIDTH || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = J > R ? J : R;
  const int JR = m <= 4 ? 4 : 8;
  if (m <= CONTRACT_NARROW && N * JR <= CONTRACT_NARROW_REGS) {
#define THREAD_LAUNCH(n, jr)                                             \
  case n:                                                                \
    return launch_thread<T, n, jr>(a, bfac, pred, pexc, B, J, R, s);
    if (JR == 4) {
      switch (N) {
        THREAD_LAUNCH(1, 4) THREAD_LAUNCH(2, 4) THREAD_LAUNCH(3, 4)
        THREAD_LAUNCH(4, 4) THREAD_LAUNCH(5, 4) THREAD_LAUNCH(6, 4)
        THREAD_LAUNCH(7, 4) THREAD_LAUNCH(8, 4)
      }
    } else {
      switch (N) {
        THREAD_LAUNCH(1, 8) THREAD_LAUNCH(2, 8) THREAD_LAUNCH(3, 8)
        THREAD_LAUNCH(4, 8)
      }
    }
#undef THREAD_LAUNCH
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int E = lane_entries(J, R);
#define GROUP_LAUNCH(n)                                                  \
  case n:                                                                \
    return E == 1 ? launch_group<T, n, 1>(a, bfac, pred, pexc, B, J, R, s) \
                  : launch_group<T, n, 2>(a, bfac, pred, pexc, B, J, R, s);
  switch (N) {
    GROUP_LAUNCH(1) GROUP_LAUNCH(2) GROUP_LAUNCH(3) GROUP_LAUNCH(4)
    GROUP_LAUNCH(5) GROUP_LAUNCH(6) GROUP_LAUNCH(7) GROUP_LAUNCH(8)
    GROUP_LAUNCH(9) GROUP_LAUNCH(10)
  }
#undef GROUP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
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
