// Tucker-2 factorized linear layer y = ((x U1) G) U2ᵀ, Hopper (sm_90a).
//
// Replaces src/repro/kernels/tucker_matmul.py::tucker_matmul (the Pallas TPU
// kernel `_kernel`).  Inputs: x (M, K) in f32 or bf16; the factors U1 (K, R1),
// G (R1, R2) and U2 (N, R2), all f32 (or all bf16 with a bf16 x).  Every load converts to
// f32 and every product accumulates in f32; the two intermediates
// t1 = x U1 (M, R1) and t = t1 G (M, R2) are kept in f32, as the Pallas
// kernel keeps them in its f32 VMEM scratch.  y is written in the promoted
// dtype of the inputs: f32 unless every input is bf16.  Ragged M, K and N
// are masked inside the kernel; nothing is padded or copied.
//
// Design.  The Pallas grid (M/MT, N/NT, K/KT) redoes the K-reduction x U1
// for every N tile: at the LM's prefill shapes (M = 8192, K = 5120,
// R = 512, N = 17408) that is 34 times, 7.6x the work the call needs.  Here
// the three products run as three launches of one tiled GEMM kernel, in
// order on the caller's stream: t1 = x U1 once, t = t1 G once (2 % of the
// work), then y = t U2ᵀ over all N tiles.  t1 and t are (M, R) f32 buffers
// the wrapper allocates (16 MB each at M = 8192).  Each launch is a plain
// SIMT GEMM: a BM x 128 output tile per block of 256 threads, BM/16 x 8
// outputs per thread, K walked in steps of 8 through shared memory, fmaf
// in f32.  BM is 128 (8 x 8 per thread) unless M <= 16, as in decode
// (M = batch), where a 16-row tile (1 x 8 per thread) keeps the block from
// computing 124 rows of zeros for every 4 real ones.  No tensor cores and
// no TF32: f32 means f32.
//
// Bound on the card.  Prefill (M = 8192): 2·M·(K·R1 + R1·R2 + R2·N)
// = 193 GFLOP against 785 MB of bytes — bound by operations (2.9 ms at the
// 67 TFLOP/s f32 peak).  Decode (M = 4): the 47 MB of factors — bound by
// bytes (14 us at 3.35 TB/s).  There a block does little arithmetic and
// waits on memory at every step of K, and x U1 has only four output tiles,
// so a product whose output tiles are too few to keep every SM's memory
// queue busy splits K over blockIdx.z (`splits`, chosen by the wrapper):
// each split writes its f32 partial sums to a workspace slab, and a second
// kernel adds the slabs in split order (no atomics: the same bits on every
// run) and casts.
#include "common.cuh"

namespace {

constexpr int BN = 128;
constexpr int BK = 8;
constexpr int PAD = 4;      // row padding of the shared tiles (bank spread)
constexpr int THREADS = 256;

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// c[z] (M, N) = Σ_{k in split z} A[m][k] · B(k, n), f32 accumulation, over
// BM x BN output tiles (BM = 128 or 16).
//   A  row-major (M, K)
//   B(k, n) = b[k * N + n]  when !BT  (a (K, N) row-major matrix)
//           = b[n * K + k]  when BT   (an (N, K) row-major matrix, used
//                                      transposed: U2 in y = t U2ᵀ)
// Split z covers k in [z·k_chunk, min(K, (z+1)·k_chunk)) and writes slab
// c + z·M·N (a split past K writes zeros).
template <int BM, typename TA, typename TB, typename TC, bool BT>
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const TA* __restrict__ a, const TB* __restrict__ b, TC* __restrict__ c,
    int M, int N, int K, int k_chunk) {
  constexpr int RT = BM / 16;  // rows per thread: 8, or 1 for BM = 16
  static_assert(RT == 8 || RT == 1, "BM is 128 or 16");
  __shared__ __align__(16) float As[BK][BM + PAD];  // A tile, transposed
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  c += static_cast<long long>(blockIdx.z) * M * N;

  float acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    // A tile (BM x BK): 8 consecutive threads read one row's 8 k values
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < ke)
                      ? to_float(a[static_cast<long long>(m) * K + k])
                      : 0.f;
    }
#pragma unroll
    for (int i = tid; i < BN * BK; i += THREADS) {
      int n, kk;
      if constexpr (BT) {
        n = i / BK;
        kk = i % BK;
      } else {
        kk = i / BN;
        n = i % BN;
      }
      const int nn = n0 + n, k = k0 + kk;
      float val = 0.f;
      if (nn < N && k < ke)
        val = to_float(BT ? b[static_cast<long long>(nn) * K + k]
                          : b[static_cast<long long>(k) * N + nn]);
      Bs[kk][n] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[RT], bv[8];
      if constexpr (RT == 8) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
        av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
        av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      } else {
        av[0] = As[kk][ty];
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // rows ty*4 + {0..3} and 64 + ty*4 + {0..3} (BM = 128) or ty (BM = 16);
  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int m = m0 + (RT == 1 ? ty
                                : i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n < N) store_as(&c[static_cast<long long>(m) * N + n], acc[i][j]);
    }
  }
}

// out[e] = Σ_z ws[z][e] in split order, cast to TC.
template <typename TC>
__global__ void __launch_bounds__(THREADS) split_sum_kernel(
    const float* __restrict__ ws, TC* __restrict__ out, long long count,
    int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < count; e += stride) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * count + e];
    store_as(&out[e], s);
  }
}

// One product c (M, N) = A · B(k, n) over BM-row tiles, split over K when
// splits > 1 (the partials go through ws, which holds splits·M·N floats).
template <int BM, typename TA, typename TB, typename TC, bool BT>
cudaError_t product_tiles(const TA* a, const TB* b, TC* c, float* ws, int M,
                          int N, int K, int splits, cudaStream_t stream) {
  if (splits < 1 || (splits > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  const int per = (K + splits - 1) / splits;
  const int k_chunk = (per + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (splits == 1) {
    gemm_kernel<BM, TA, TB, TC, BT><<<grid, THREADS, 0, stream>>>(
        a, b, c, M, N, K, k_chunk);
    return cudaGetLastError();
  }
  gemm_kernel<BM, TA, TB, float, BT><<<grid, THREADS, 0, stream>>>(
      a, b, ws, M, N, K, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = static_cast<long long>(M) * N;
  long long blocks = (count + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  split_sum_kernel<TC><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      ws, c, count, splits);
  return cudaGetLastError();
}

// 16-row tiles when M <= 16 (decode), else 128-row tiles.
template <typename TA, typename TB, typename TC, bool BT>
cudaError_t product(const TA* a, const TB* b, TC* c, float* ws, int M,
                    int N, int K, int splits, cudaStream_t stream) {
  if (M <= 16)
    return product_tiles<16, TA, TB, TC, BT>(a, b, c, ws, M, N, K, splits,
                                             stream);
  return product_tiles<128, TA, TB, TC, BT>(a, b, c, ws, M, N, K, splits,
                                            stream);
}

// y = ((x U1) G) U2ᵀ through t1 (M, R1) and t (M, R2), f32 scratch.
template <typename TX, typename TW, typename TO>
int tucker_matmul(const TX* x, const TW* u1, const TW* g, const TW* u2,
                  TO* y, float* t1, float* t, float* ws, int M, int K,
                  int R1, int R2, int N, int s1, int s2, int s3,
                  void* stream) {
  if (M < 1 || K < 1 || R1 < 1 || R2 < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = product<TX, TW, float, false>(x, u1, t1, ws, M, R1, K,
                                                  s1, st);
  if (err == cudaSuccess)
    err = product<float, TW, float, false>(t1, g, t, ws, M, R2, R1, s2, st);
  if (err == cudaSuccess)
    err = product<float, TW, TO, true>(t, u2, y, ws, M, N, R2, s3, st);
  return static_cast<int>(err);
}

}  // namespace

#define TUCKER_ENTRY(NAME, TX, TW, TO)                                        \
  extern "C" int NAME(const TX* x, const TW* u1, const TW* g, const TW* u2,  \
                      TO* y, float* t1, float* t, float* ws, int M, int K,   \
                      int R1, int R2, int N, int s1, int s2, int s3,         \
                      void* stream) {                                        \
    return tucker_matmul<TX, TW, TO>(x, u1, g, u2, y, t1, t, ws, M, K, R1,   \
                                     R2, N, s1, s2, s3, stream);             \
  }

// tucker_matmul_<x dtype>_<factor dtype>; y in the promoted dtype.  The
// LM path passes f32 factors with x in f32 (down) or bf16 (up, gate);
// all-bf16 is the Pallas kernel's own case.
TUCKER_ENTRY(tucker_matmul_f32_f32, float, float, float)
TUCKER_ENTRY(tucker_matmul_bf16_f32, __nv_bfloat16, float, float)
TUCKER_ENTRY(tucker_matmul_bf16_bf16, __nv_bfloat16, __nv_bfloat16,
             __nv_bfloat16)
