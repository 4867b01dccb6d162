// Helpers shared by the FastTucker kernels (plain C interface).
//
// Storage may be f32 or bf16 (the rows a and the Kruskal factors B): every
// load goes through to_float, so all arithmetic after the load is f32.
//
// Layout convention of every kernel here: one sampled nonzero is handled by
// a GROUP of W lanes of one warp, W = min(next power of two >= max(J, R),
// 32), so a warp holds 32/W samples at once.  Each lane holds E =
// ceil(max(J, R)/32) entries (1, or 2 for widths 33..64): entry e of lane
// `sub` is column j = sub + 32e of the gathered rows and column r = sub +
// 32e of the Kruskal factors.  At the paper's J = R = 4 that puts 8
// samples in a warp instead of leaving 28 of its 32 lanes idle; at E = 1
// every result keeps the bits it had before widths above 32 were taken.
// Every loop that contains a shuffle runs a warp-uniform trip count;
// lanes without work carry a `valid` flag instead of leaving the loop, so
// the full-mask shuffles below always see all 32 lanes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

#define REPRO_MAX_MODES 10
#define REPRO_MAX_WIDTH 64   // J, R: E <= 2 entries a lane
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

// Entry e of a lane's E entries, for e known only at run time (a select
// chain over the unrolled entries, so the array stays in registers).
template <int E>
__device__ __forceinline__ float pick(const float (&v)[E], int e) {
  float x = v[0];
#pragma unroll
  for (int k = 1; k < E; ++k)
    if (e == k) x = v[k];
  return x;
}

// Mode products of the sample held by this lane's group.
//   av[n][e]  this lane's entry j = sub + 32e of a[n][b] (0 past J)
//   bs        the Kruskal factors in shared memory, bs[(n*J + j)*(R+1) + r]
//             (row stride R+1, so lanes reading one column hit distinct
//             banks)
// On return c[n][e] holds c[n][r] = Σ_j a[n][j]·B[n][j][r] for r = sub +
// 32e < R, summed in j order with fmaf from 0 (entries past R hold 0).
// The j loop is outside the mode loop, so the N chains are independent and
// interleave.
template <int E>
__device__ __forceinline__ void group_mode_dots(
    const float (&av)[REPRO_MAX_MODES][E], const float* __restrict__ bs,
    int N, int J, int R, int sub, int W, float (&c)[REPRO_MAX_MODES][E]) {
  const int RP = R + 1;
#pragma unroll
  for (int n = 0; n < REPRO_MAX_MODES; ++n)
#pragma unroll
    for (int e = 0; e < E; ++e) c[n][e] = 0.f;
#pragma unroll 4
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int n = 0; n < REPRO_MAX_MODES; ++n) {
      if (n < N) {
        const float aj =
            __shfl_sync(REPRO_FULL_MASK, pick(av[n], j >> 5), j & 31, W);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int r = sub + 32 * e;
          const float bv = r < R ? bs[(n * J + j) * RP + r] : 0.f;
          c[n][e] = fmaf(aj, bv, c[n][e]);
        }
      }
    }
  }
}

// pexc[n] = Π_{k<n} c[k] · Π_{k>n} c[k]: the prefix chain ((c0·c1)·c2)…
// times the suffix chain taken from the last mode down, the order of
// torch.cumprod in the plain version, so pexc rounds as it does.  Every
// pass that forms pexc (from its own dots or from cached c) runs this one
// function, so equal c give equal pexc bits.  Each of the E entries is an
// independent column r.
template <int E>
__device__ __forceinline__ void group_exclusive_products(
    const float (&c)[REPRO_MAX_MODES][E], int N,
    float (&pexc)[REPRO_MAX_MODES][E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float acc = 1.f;
#pragma unroll
    for (int n = 0; n < REPRO_MAX_MODES; ++n) {
      pexc[n][e] = 0.f;
      if (n < N) {
        pexc[n][e] = acc;
        acc = __fmul_rn(acc, c[n][e]);
      }
    }
    acc = 1.f;
#pragma unroll
    for (int n = REPRO_MAX_MODES - 1; n >= 0; --n) {
      if (n < N) {
        pexc[n][e] = __fmul_rn(pexc[n][e], acc);
        acc = __fmul_rn(acc, c[n][e]);
      }
    }
  }
}

// pred of the sample held by this lane's group: Σ_r pexc[0][r]·c[0][r],
// each lane's entries added in e order, then the W lanes' sums by a xor
// tree (group_sum).  Every lane gets it.
template <int E>
__device__ __forceinline__ float group_pred(
    const float (&c)[REPRO_MAX_MODES][E],
    const float (&pexc)[REPRO_MAX_MODES][E], int W) {
  float t = __fmul_rn(pexc[0][0], c[0][0]);
#pragma unroll
  for (int e = 1; e < E; ++e) t = __fadd_rn(t, __fmul_rn(pexc[0][e], c[0][e]));
  return group_sum(t, W);
}

// floor(i / d) for 0 <= i < 2^22 and d >= 1, from d's f32 reciprocal:
// (i + 0.5)·(1/d) is at least 0.5/d from an integer and its rounding error
// is below 2^-23·(i + 0.5)/d, so truncation is exact.  It replaces an
// integer division (a chain of a dozen dependent instructions).
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

// The group width for J and R: the next power of two >= max(J, R), at
// most a warp.
static inline int group_width(int J, int R) {
  int m = J > R ? J : R;
  int w = 1;
  while (w < m && w < 32) w <<= 1;
  return w;
}

// Entries a lane holds for J and R: 1 up to 32, 2 up to 64.
static inline int lane_entries(int J, int R) {
  int m = J > R ? J : R;
  return (m + 31) / 32;
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
