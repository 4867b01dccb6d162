// Helpers shared by the FastTucker kernels (plain C interface).
//
// Storage may be f32 or bf16 (the rows a and the Kruskal factors B): every
// load goes through to_float, so all arithmetic after the load is f32.
//
// Layout convention of every kernel here: one sampled nonzero is handled by
// a GROUP of W lanes of one warp, W the next power of two >= max(J, R)
// (W <= 32), so a warp holds 32/W samples at once.  Lane `sub` of a group
// owns column j = sub of the gathered rows and column r = sub of the
// Kruskal factors.  At the paper's J = R = 4 that puts 8 samples in a warp
// instead of leaving 28 of its 32 lanes idle.  Every loop that contains a
// shuffle runs a warp-uniform trip count; lanes without work carry a
// `valid` flag instead of leaving the loop, so the full-mask shuffles
// below always see all 32 lanes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

#define REPRO_MAX_MODES 10
#define REPRO_MAX_WIDTH 32
#define REPRO_FULL_MASK 0xffffffffu

// Sum of v over the W lanes of this lane's group; every lane gets the sum.
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(REPRO_FULL_MASK, v, off, width);
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Mode products of the sample held by this lane's group.
//   av[n]  this lane's entry a[n][b][sub] of the gathered rows (0 past J)
//   bs     the Kruskal factors in shared memory, bs[(n*J + j)*(R+1) + r]
//          (row stride R+1, so lanes reading one column hit distinct banks)
// On return lane r < R holds c[n] = Σ_j a[n][j]·B[n][j][r], summed in j
// order with fmaf from 0 (lanes past R hold 0).  The j loop is outside the
// mode loop, so the N chains are independent and interleave.
__device__ __forceinline__ void group_mode_dots(
    const float (&av)[REPRO_MAX_MODES], const float* __restrict__ bs,
    int N, int J, int R, int sub, int W, float (&c)[REPRO_MAX_MODES]) {
  const int RP = R + 1;
#pragma unroll
  for (int n = 0; n < REPRO_MAX_MODES; ++n) c[n] = 0.f;
#pragma unroll 4
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int n = 0; n < REPRO_MAX_MODES; ++n) {
      if (n < N) {
        const float aj = __shfl_sync(REPRO_FULL_MASK, av[n], j, W);
        const float bv = sub < R ? bs[(n * J + j) * RP + sub] : 0.f;
        c[n] = fmaf(aj, bv, c[n]);
      }
    }
  }
}

// pexc[n] = Π_{k<n} c[k] · Π_{k>n} c[k]: the prefix chain ((c0·c1)·c2)…
// times the suffix chain taken from the last mode down, the order of
// torch.cumprod in the plain version, so pexc rounds as it does.  Every
// pass that forms pexc (from its own dots or from cached c) runs this one
// function, so equal c give equal pexc bits.
__device__ __forceinline__ void group_exclusive_products(
    const float (&c)[REPRO_MAX_MODES], int N,
    float (&pexc)[REPRO_MAX_MODES]) {
  float acc = 1.f;
#pragma unroll
  for (int n = 0; n < REPRO_MAX_MODES; ++n) {
    pexc[n] = 0.f;
    if (n < N) {
      pexc[n] = acc;
      acc = __fmul_rn(acc, c[n]);
    }
  }
  acc = 1.f;
#pragma unroll
  for (int n = REPRO_MAX_MODES - 1; n >= 0; --n) {
    if (n < N) {
      pexc[n] = __fmul_rn(pexc[n], acc);
      acc = __fmul_rn(acc, c[n]);
    }
  }
}

// Theorem-1 forward of the sample held by this lane's group: the mode
// products c and the exclusive products pexc (see the two functions above).
__device__ __forceinline__ void theorem1_forward(
    const float (&av)[REPRO_MAX_MODES], const float* __restrict__ bs,
    int N, int J, int R, int sub, int W,
    float (&c)[REPRO_MAX_MODES], float (&pexc)[REPRO_MAX_MODES]) {
  group_mode_dots(av, bs, N, J, R, sub, W, c);
  group_exclusive_products(c, N, pexc);
}

// floor(i / d) for 0 <= i < 2^20 and 1 <= d <= 1024, from d's f32
// reciprocal: (i + 0.5)·(1/d) is at least 0.5/d from an integer and its
// rounding error is below 2^-23·i/d, so truncation is exact.  It replaces
// an integer division (a chain of a dozen dependent instructions).
__device__ __forceinline__ int div_small(int i, float inv_d) {
  return static_cast<int>((static_cast<float>(i) + 0.5f) * inv_d);
}

// Copies the (N, J, R) Kruskal factors into shared memory as f32, with
// row stride R+1 (see group_mode_dots).  The caller synchronises the block.
template <typename T>
__device__ __forceinline__ void load_factors(
    const T* __restrict__ bfac, float* __restrict__ bs, int N, int J, int R) {
  const int NJR = N * J * R;
  const float inv_r = 1.f / R;
  for (int i = threadIdx.x; i < NJR; i += blockDim.x) {
    const int nj = div_small(i, inv_r);
    bs[nj * (R + 1) + (i - nj * R)] = to_float(bfac[i]);
  }
}

// The group width for J and R: the next power of two >= max(J, R).
static inline int group_width(int J, int R) {
  int m = J > R ? J : R;
  int w = 1;
  while (w < m) w <<= 1;
  return w;
}

// log2 of a power of two.
static inline int log2_pow2(int w) {
  int k = 0;
  while ((1 << k) < w) ++k;
  return k;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// An empty kernel behind the same C interface as the others: its time,
// launched through ctypes, is the launch floor that chip_smoke.py prints
// beside every kernel's time.
__global__ void repro_noop_kernel() {}

extern "C" int repro_noop(void* stream) {
  repro_noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
