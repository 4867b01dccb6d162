// Helpers shared by the FastTucker kernels (plain C interface, f32 storage).
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

#include <cuda_runtime.h>

#define REPRO_MAX_MODES 10
#define REPRO_MAX_WIDTH 32
#define REPRO_FULL_MASK 0xffffffffu

// Sum of v over the W lanes of this lane's group; every lane gets the sum.
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(REPRO_FULL_MASK, v, off, width);
  return v;
}

// Theorem-1 forward of the sample held by this lane's group.
//   av[n]  this lane's entry a[n][b][sub] of the gathered rows (0 past J)
//   bs     the Kruskal factors in shared memory, bs[(n*J + j)*(R+1) + r]
//          (row stride R+1, so lanes reading one column hit distinct banks)
// On return lane r < R holds c[n] = Σ_j a[n][j]·B[n][j][r] (lanes past R
// hold 0) and pexc[n] = Π_{k<n} c[k] · Π_{k>n} c[k]: the prefix chain
// ((c0·c1)·c2)… times the suffix chain taken from the last mode down, the
// order of torch.cumprod in the plain version, so pexc rounds as it does.
__device__ __forceinline__ void theorem1_forward(
    const float (&av)[REPRO_MAX_MODES], const float* __restrict__ bs,
    int N, int J, int R, int sub, int W,
    float (&c)[REPRO_MAX_MODES], float (&pexc)[REPRO_MAX_MODES]) {
  const int RP = R + 1;
#pragma unroll
  for (int n = 0; n < REPRO_MAX_MODES; ++n) {
    c[n] = 0.f;
    if (n < N) {
      float acc = 0.f;
      for (int j = 0; j < J; ++j) {
        const float aj = __shfl_sync(REPRO_FULL_MASK, av[n], j, W);
        const float bv = sub < R ? bs[(n * J + j) * RP + sub] : 0.f;
        acc = fmaf(aj, bv, acc);
      }
      c[n] = acc;
    }
  }
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

// Copies the (N, J, R) Kruskal factors into shared memory with row stride
// R+1 (see theorem1_forward).  The caller synchronises the block.
__device__ __forceinline__ void load_factors(
    const float* __restrict__ bfac, float* __restrict__ bs,
    int N, int J, int R) {
  const int NJR = N * J * R;
  for (int i = threadIdx.x; i < NJR; i += blockDim.x) {
    const int nj = i / R;
    bs[nj * (R + 1) + (i - nj * R)] = bfac[i];
  }
}

// The group width for J and R: the next power of two >= max(J, R).
static inline int group_width(int J, int R) {
  int m = J > R ? J : R;
  int w = 1;
  while (w < m) w <<= 1;
  return w;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
