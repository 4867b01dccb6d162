// Tucker-2 factorized linear layer y = ((x U1) G) U2ᵀ, Hopper (sm_90a).
//
// Replaces src/repro/kernels/tucker_matmul.py::tucker_matmul (the Pallas TPU
// kernel `_kernel`).  Inputs: x (M, K) in f32 or bf16; the factors U1 (K, R1),
// G (R1, R2) and U2 (N, R2), all f32 (or all bf16 with a bf16 x).  Every
// product accumulates in f32 to f32 accuracy, and the intermediates
// t1 = x U1 (M, R1) and t = t1 G (M, R2) are kept in f32, as the Pallas
// kernel keeps them in its f32 VMEM scratch.  y is written in the promoted
// dtype of the inputs: f32 unless every input is bf16.  Ragged M, K and N
// are masked inside the kernels; nothing is padded or copied.
//
// The Pallas grid (M/MT, N/NT, K/KT) redoes x U1 for every N tile (7.6x the
// work at the LM's prefill shapes).  Here each product is computed once, in
// three launches on the caller's stream.  The wrapper's `plan()` picks one
// of two routes per call, with no atomics on either: the same bits on
// every run.
//
// Route "mma" (M > 16: prefill).  Bound by operations: 2·M·(K·R1 + R1·R2 +
// R2·N) = 193 GFLOP at M = 8192 (2.9 ms at the 67 TFLOP/s f32 SIMT peak;
// 1.2 ms at 3 x that work on the 495 TFLOP/s TF32 tensor cores).  Three
// launches of one tensor-core GEMM (gemm_kernel): 128 x 128 output tiles
// per block of two warpgroups, each a 64 x 128 wgmma m64n128k8 tile in
// 3xTF32 (mma_tf32.cuh: f32 accuracy; 2 passes when the A or B side is
// bf16).  A's fragments are split in registers; B is split once per block
// into big and small K-major planes in shared memory, the transpose that
// wgmma's TF32 form needs for U1 and G done in that same pass.  Each
// k-tile's 24 products chain into fresh accumulators that are then added
// to the running sums in f32.  K goes in steps of 64 through a 2-stage
// cp.async ring (207-209 KB of shared memory, one block per SM).  Loads
// are 16-byte cp.async when every row of both operands is a multiple of
// 16 bytes and the bases are aligned (`wide`), else 4-byte cp.async (f32)
// or plain loads (bf16), per product, as the wrapper says.
//
// Route "stream" (M <= 16: decode).  Bound by bytes: the 47 MB of factors
// at the LM's shapes (14 us at 3.35 TB/s); a GEMM tile waits on memory at
// every k-step.  Here the factors are streamed once, in order, with
// coalesced 16-byte loads and f32 fmaf (a product has M <= 16 flops per
// byte, so the SIMT core is not the limit):
//   1. t1 = x U1: one block per (32-column strip of U1, row split); the s1
//      row splits of a strip form one thread-block cluster.  A block keeps
//      x's columns of its rows in shared memory, each thread M x 4 partial
//      sums for its 4 columns over every 32nd row, with two steps of 8 rows
//      of loads in flight; the block folds its 32 row lanes in a fixed
//      order, and the cluster sums its s1 partials in rank order through
//      distributed shared memory (the split-K sum, without a workspace slab
//      or another launch) and writes t1.
//   2. t = t1 G: the same kernel over G.
//   3. y = t U2ᵀ: every block loads t (M, R2) into shared memory, then one
//      warp per output column n dots row n of U2 (16-byte loads, four rows
//      in flight) with the M rows of t and reduces over the warp: no K-split.
// Three launches per call, chained by programmatic dependent launch: each
// kernel is resident and has its first factor loads in flight before the
// previous one ends.
#include <cooperative_groups.h>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr size_t ROWS_SMEM = 192 * 1024;  // rows of x (or t1) per block

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
constexpr bool kBf16 = sizeof(T) == 2;

// Sets a kernel's dynamic shared memory limit once per instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done = true;
  return err;
}

// ===================================================== route "mma" (GEMM)

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 2;
constexpr int KS = BK / 8;   // k8 steps per k-tile

// Row strides (elements) of the cp.async tiles.  A (rows along k) is read
// in fragment pairs (mma_tf32.cuh): 72 f32 (8g + 2t banks over a half
// warp's 64-bit loads) or 72 bf16 (36 words: 4g + t).  B is read by the
// split pass, lanes on consecutive n: along n any stride is free of
// conflicts (132 f32, 136 bf16); along k (U2) a thread reads 4 values at
// once, so 68 f32 (4n banks over a quarter warp) or 72 bf16.
constexpr int A_STRIDE = BK + 8;
template <typename T, bool BT>
__host__ __device__ constexpr int b_stride() {
  return BT ? BK + (kBf16<T> ? 8 : 4) : BN + (kBf16<T> ? 8 : 4);
}

// Copy a ROWS x COLS tile of a row-major matrix (leading dimension ld,
// `rows_left` rows and `cols_left` columns in range) into shared memory with
// row stride SS; out-of-range elements become 0.  WIDE: 16-byte cp.async
// (cols_left is then a multiple of 16 bytes); else 4-byte cp.async for f32,
// and plain loads for bf16, whose elements may not be 4-byte aligned.
template <typename T, int ROWS, int COLS, int SS, bool WIDE>
__device__ __forceinline__ void load_tile(T* __restrict__ s,
                                          const T* __restrict__ g,
                                          long long ld, int rows_left,
                                          int cols_left) {
  if constexpr (WIDE) {
    constexpr int CH = 16 / sizeof(T);
    constexpr int PER_ROW = COLS / CH;
#pragma unroll
    for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * CH;
      const bool in = r < rows_left && c < cols_left;
      cp_async16(s + r * SS + c, in ? g + r * ld + c : g, in ? 16 : 0);
    }
  } else if constexpr (!kBf16<T>) {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const bool in = r < rows_left && c < cols_left;
      cp_async4(s + r * SS + c, in ? g + r * ld + c : g, in ? 4 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      s[r * SS + c] = r < rows_left && c < cols_left
                          ? g[r * ld + c]
                          : __float2bfloat16_rn(0.f);
    }
  }
}

// Four consecutive values as f32 (16-byte aligned f32, 8-byte aligned bf16).
__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const float2 lo = load_pair(p), hi = load_pair(p + 2);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename TA, typename TB, bool BT>
struct GemmSmem {
  static constexpr int SB = b_stride<TB, BT>();
  static constexpr int A_ELEMS = BM * A_STRIDE;
  static constexpr int B_ELEMS = BT ? BN * SB : BK * SB;
  static constexpr size_t A_BYTES = sizeof(TA) * A_ELEMS;   // 16-byte multiples
  static constexpr size_t B_BYTES = sizeof(TB) * B_ELEMS;
  static constexpr size_t PLANES_AT =
      (STAGES * (A_BYTES + B_BYTES) + 1023) / 1024 * 1024;
  static constexpr int PLANE = BN * BK;   // floats: one K-major B plane
  static constexpr size_t BYTES =
      PLANES_AT + sizeof(float) * PLANE * (kBf16<TB> ? 1 : 2);
};

// c (M, N) = A (M, K) · B(k, n) over 128 x 128 output tiles, on the tensor
// cores in 3xTF32 (wgmma, mma_tf32.cuh).
//   B(k, n) = b[k * N + n]  when !BT  (a (K, N) row-major matrix)
//           = b[n * K + k]  when BT   (an (N, K) row-major matrix, used
//                                      transposed: U2 in y = t U2ᵀ)
// Per k-tile of 64: the tile lands through the cp.async ring; the block
// splits B once into its big and small TF32 planes, K-major as wgmma
// wants them (so U1 and G are transposed here, in shared memory), with k
// permuted inside each group of 8 as the A fragments; each warpgroup (64
// rows) loads and splits its A fragments into registers and issues the 8
// k8 steps' wgmma m64n128k8 (small terms first) into fresh accumulators,
// which are then added to the running sums in f32.
template <typename TA, typename TB, typename TC, bool BT, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(
    const TA* __restrict__ a, const TB* __restrict__ b, TC* __restrict__ c,
    int M, int N, int K) {
  using S = GemmSmem<TA, TB, BT>;
  constexpr bool A_EXACT = kBf16<TA>;
  constexpr bool B_EXACT = kBf16<TB>;
  extern __shared__ __align__(1024) unsigned char smem[];
  TA* As = reinterpret_cast<TA*>(smem);
  TB* Bs = reinterpret_cast<TB*>(smem + STAGES * S::A_BYTES);
  float* Pbig = reinterpret_cast<float*>(smem + S::PLANES_AT);
  float* Psmall = Pbig + S::PLANE;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + g;  // and row + 8
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const TA* ag = a + static_cast<long long>(m0) * K;
  const int ktiles = (K + BK - 1) / BK;

  auto load_stage = [&](int kt) {
    const int st = kt % STAGES, k0 = kt * BK;
    load_tile<TA, BM, BK, A_STRIDE, WIDE>(As + st * S::A_ELEMS, ag + k0, K,
                                          M - m0, K - k0);
    if constexpr (BT)
      load_tile<TB, BN, BK, S::SB, WIDE>(
          Bs + st * S::B_ELEMS, b + static_cast<long long>(n0) * K + k0, K,
          N - n0, K - k0);
    else
      load_tile<TB, BK, BN, S::SB, WIDE>(
          Bs + st * S::B_ELEMS, b + static_cast<long long>(k0) * N + n0, N,
          K - k0, N - n0);
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s);
    cp_async_commit();
  }
  // plane layout: 16-byte unit (n, k/4) at ((n/8)·(BK/4) + k/4)·8 + n%8
  const uint64_t dbig = kmajor_desc(Pbig, 128, 32 * BK);
  const uint64_t dsmall = kmajor_desc(Psmall, 128, 32 * BK);
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // k-tile kt has landed (this thread's)
    __syncthreads();              // ... every thread's; kt-1 is consumed
    if (kt + STAGES - 1 < ktiles) load_stage(kt + STAGES - 1);
    cp_async_commit();

    // B into the planes: 8 k values of one n per item; k = 8s + q goes to
    // position q/2 (q even) or 4 + q/2 (q odd) of the step, as in A
    const TB* braw = Bs + (kt % STAGES) * S::B_ELEMS;
    for (int item = threadIdx.x; item < BN * KS; item += THREADS) {
      const int n = item % BN, s = item / BN;
      float v[8];
      if constexpr (BT) {
        const float4 lo = load_quad(braw + n * S::SB + s * 8);
        const float4 hi = load_quad(braw + n * S::SB + s * 8 + 4);
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          v[q] = to_float(braw[(s * 8 + q) * S::SB + n]);
      }
      const int u = ((n / 8) * (BK / 4) + 2 * s) * 32 + (n % 8) * 4;
      uint32_t bg[8], sm[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if constexpr (B_EXACT) {
          bg[q] = __float_as_uint(v[q]);
        } else {
          tf32_split(v[q], bg[q], sm[q]);
        }
      }
      *reinterpret_cast<uint4*>(Pbig + u) = make_uint4(bg[0], bg[2], bg[4], bg[6]);
      *reinterpret_cast<uint4*>(Pbig + u + 32) = make_uint4(bg[1], bg[3], bg[5], bg[7]);
      if constexpr (!B_EXACT) {
        *reinterpret_cast<uint4*>(Psmall + u) = make_uint4(sm[0], sm[2], sm[4], sm[6]);
        *reinterpret_cast<uint4*>(Psmall + u + 32) = make_uint4(sm[1], sm[3], sm[5], sm[7]);
      }
    }
    fence_proxy_async();
    __syncthreads();

    Frag<4> af[KS];
    const TA* at = As + (kt % STAGES) * S::A_ELEMS + row * A_STRIDE + 2 * t;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const float2 lo = load_pair(at + s * 8);
      const float2 hi = load_pair(at + 8 * A_STRIDE + s * 8);
      const float v[4] = {lo.x, hi.x, lo.y, hi.y};
      frag_split<A_EXACT>(v, af[s]);
    }
    pin(part);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const uint64_t off = s * 256 >> 4;   // two 128-byte k units per step
      int keep = s > 0;                    // the first product overwrites
      if constexpr (!B_EXACT) {
        wgmma_m64n128k8(part, af[s].big, dsmall + off, keep);
        keep = 1;
      }
      if constexpr (!A_EXACT) {
        wgmma_m64n128k8(part, af[s].small, dbig + off, keep);
        keep = 1;
      }
      wgmma_m64n128k8(part, af[s].big, dbig + off, keep);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // accumulator register 4j + e: row (row, row + 8 for e >= 2), column
  // 8j + 2t + (e & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + row + 8 * h;
    if (m >= M) continue;
    TC* out = c + static_cast<long long>(m) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (!kBf16<TC>) {
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<float2*>(out + n) = make_float2(v0, v1);
          continue;
        }
      }
      if (n < N) store_as(out + n, v0);
      if (n + 1 < N) store_as(out + n + 1, v1);
    }
  }
}

template <typename TA, typename TB, typename TC, bool BT, bool WIDE>
cudaError_t gemm_launch(const TA* a, const TB* b, TC* c, int M, int N, int K,
                        cudaStream_t stream) {
  using S = GemmSmem<TA, TB, BT>;
  static bool configured = false;
  auto kernel = gemm_kernel<TA, TB, TC, BT, WIDE>;
  cudaError_t err = allow_smem(kernel, S::BYTES, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, S::BYTES, stream>>>(a, b, c, M, N, K);
  return cudaGetLastError();
}

template <typename TA, typename TB, typename TC, bool BT>
cudaError_t gemm(const TA* a, const TB* b, TC* c, int M, int N, int K,
                 bool wide, cudaStream_t stream) {
  return wide ? gemm_launch<TA, TB, TC, BT, true>(a, b, c, M, N, K, stream)
              : gemm_launch<TA, TB, TC, BT, false>(a, b, c, M, N, K, stream);
}

// =================================================== route "stream" (GEMV)

constexpr int STRIP = 32;     // columns per block: 8 threads x 4 columns
constexpr int ROW_LANES = THREADS / 8;
constexpr int UNROLL = 8;     // rows per thread per step; two steps in flight
constexpr int MAX_CLUSTER = 8;    // row splits of one product: one cluster
constexpr int COLS = 4;       // output columns per warp step, last product
constexpr int CHUNKS = 4;     // 16-byte chunks per lane per U2 row and pass

// Programmatic dependent launch (sm_90): a kernel launched by launch() may
// start while the previous kernel on the stream runs.  It lets its own
// dependents start early, reads only the factors (which no kernel writes)
// before pdl_wait(), and reads the previous product's output and writes
// anything only after it: pdl_wait() returns once the previous kernel has
// finished and its writes are visible.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launch with programmatic dependent launch and, for cluster_y > 1,
// clusters of (1, cluster_y, 1) blocks.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int cluster_y,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = cluster_y;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster_y > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Four consecutive columns of a factor row as f32 (zeros past `cols`).
template <typename T, bool WIDE>
__device__ __forceinline__ float4 load4(const T* __restrict__ p, int cols) {
  if constexpr (WIDE) {  // 16-byte (f32) or 8-byte (bf16) aligned, cols % 4 == 0
    if (cols <= 0) return make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kBf16<T>) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                         __high2float(hi));
    } else {
      return __ldg(reinterpret_cast<const float4*>(p));
    }
  } else {
    return make_float4(cols > 0 ? to_float(p[0]) : 0.f,
                       cols > 1 ? to_float(p[1]) : 0.f,
                       cols > 2 ? to_float(p[2]) : 0.f,
                       cols > 3 ? to_float(p[3]) : 0.f);
  }
}

// Rows k, k + ROW_LANES, ... (UNROLL of them) of a factor strip; 0 past kn.
template <typename TB, bool WIDE>
__device__ __forceinline__ void load_rows(float4 (&v)[UNROLL],
                                          const TB* __restrict__ bp, int k,
                                          int kn, int Nc, int cols) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int r = k + u * ROW_LANES;
    v[u] = r < kn ? load4<TB, WIDE>(bp + static_cast<long long>(r) * Nc,
                                    cols)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// out (M, Nc) = A (M, K) · B (K, Nc), B row-major, for one 32-column strip
// (blockIdx.x) of B.  The strip's rows are split over the S blocks of a
// cluster (blockIdx.y = cluster rank z takes rows [z·rows, min(K,
// (z+1)·rows))).  Each block keeps its rows of A in shared memory (rows x MB
// floats, dynamic), streams its rows of B with two steps of loads in flight
// (the first issued before the wait on the previous kernel), and folds its
// 32 row lanes in a fixed order; then block z sums entries z, z + S, ... of
// the cluster's S partials, read from their shared memory in rank order.
template <int MB, typename TA, typename TB, bool WIDE>
__global__ void __launch_bounds__(THREADS) stream_rows_kernel(
    const TA* __restrict__ a, const TB* __restrict__ b,
    float* __restrict__ out, int M, int K, int Nc, int rows) {
  extern __shared__ __align__(16) float xs[];       // xs[k][m]
  __shared__ __align__(16) float red[THREADS / 32][MB][STRIP];
  __shared__ float part[MB * STRIP];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int STEP = ROW_LANES * UNROLL;
  const int S = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());
  const int k0 = z * rows;
  const int kn = min(rows, K - k0);
  const int cg8 = threadIdx.x % 8;  // 4-column group of the strip
  const int rl = threadIdx.x / 8;   // row lane
  const int c = blockIdx.x * STRIP + cg8 * 4;
  const int cols = Nc - c;          // columns of this group in range (if > 0)
  const TB* bp = b + static_cast<long long>(k0) * Nc + c;

  float4 v[UNROLL];
  load_rows<TB, WIDE>(v, bp, rl, kn, Nc, cols);
  pdl_launch_dependents();
  pdl_wait();

  // k fastest; unrolled so a thread's loads are in flight together
#pragma unroll 16
  for (int i = threadIdx.x; i < MB * kn; i += THREADS) {
    const int m = i / kn, k = i % kn;
    xs[k * MB + m] =
        m < M ? to_float(a[static_cast<long long>(m) * K + k0 + k]) : 0.f;
  }
  __syncthreads();

  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int k = rl; k < kn; k += STEP) {
    float4 nxt[UNROLL];
    load_rows<TB, WIDE>(nxt, bp, k + STEP, kn, Nc, cols);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = k + u * ROW_LANES;
      if (r >= kn) break;
      const float* xr = xs + r * MB;
#pragma unroll
      for (int m4 = 0; m4 < MB; m4 += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + m4);
        const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[m4 + q][0] = fmaf(xm[q], v[u].x, acc[m4 + q][0]);
          acc[m4 + q][1] = fmaf(xm[q], v[u].y, acc[m4 + q][1]);
          acc[m4 + q][2] = fmaf(xm[q], v[u].z, acc[m4 + q][2]);
          acc[m4 + q][3] = fmaf(xm[q], v[u].w, acc[m4 + q][3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = nxt[u];
  }

  // fold the 32 row lanes in a fixed order: 4 per warp by shuffles, then
  // the 8 warps through shared memory
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float sum = acc[m][j];
      sum += __shfl_xor_sync(REPRO_FULL_MASK, sum, 8);
      sum += __shfl_xor_sync(REPRO_FULL_MASK, sum, 16);
      acc[m][j] = sum;
    }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MB * STRIP; i += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) sum += red[w][i / STRIP][i % STRIP];
    part[i] = sum;
  }

  // the split-K sum across the cluster, in rank order
  cluster.sync();
  for (int i = z + S * threadIdx.x; i < M * STRIP; i += S * THREADS) {
    const int n = blockIdx.x * STRIP + i % STRIP;
    float sum = 0.f;
    for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(part, r)[i];
    if (n < Nc) out[static_cast<long long>(i / STRIP) * Nc + n] = sum;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// Chunks q of U2 rows n0 + c·stride (c < COLS), from column r0: lane's 4
// columns r0 + 128q + 4·lane.  Zero past N and R.
template <typename TB, bool WIDE>
__device__ __forceinline__ void fetch_cols(float4 (&u)[COLS][CHUNKS],
                                           const TB* __restrict__ u2, int n0,
                                           int stride, int r0, int R, int N,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int n = n0 + c * stride;
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      const int r = r0 + q * 128 + lane * 4;
      u[c][q] = n < N && r < R
                    ? load4<TB, WIDE>(u2 + static_cast<long long>(n) * R + r,
                                      R - r)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Four values of row m of t from column r (zeros past R).
template <bool WIDE>
__device__ __forceinline__ float4 t4(const float* __restrict__ ts, int m,
                                     int r, int R) {
  const float* p = ts + m * R + r;
  if constexpr (WIDE) return *reinterpret_cast<const float4*>(p);  // R % 4 == 0
  return make_float4(r < R ? p[0] : 0.f, r + 1 < R ? p[1] : 0.f,
                     r + 2 < R ? p[2] : 0.f, r + 3 < R ? p[3] : 0.f);
}

// y (M, N) = t U2ᵀ, t (M, R) f32, U2 (N, R) row-major: one warp per output
// column, COLS columns per warp step with all their loads in flight (the
// first step's issued before the wait on the previous kernel, the next
// step's before this one's sums over the warp).  Dynamic shared memory:
// MB x R floats of t.
template <int MB, typename TB, typename TC, bool WIDE>
__global__ void __launch_bounds__(THREADS) stream_cols_kernel(
    const float* __restrict__ t, const TB* __restrict__ u2,
    TC* __restrict__ y, int M, int R, int N) {
  extern __shared__ __align__(16) float ts[];       // ts[m][r]
  const int lane = threadIdx.x % 32;
  const int nwarps = gridDim.x * (THREADS / 32);
  const int first = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  float4 u[COLS][CHUNKS];
  fetch_cols<TB, WIDE>(u, u2, first, nwarps, 0, R, N, lane);
  pdl_launch_dependents();
  pdl_wait();
  for (int i = threadIdx.x; i < MB * R; i += THREADS)
    ts[i] = i / R < M ? t[i] : 0.f;
  __syncthreads();

  for (int n0 = first; n0 < N; n0 += COLS * nwarps) {
    float acc[COLS][MB];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int m = 0; m < MB; ++m) acc[c][m] = 0.f;
    for (int r0 = 0; r0 < R; r0 += CHUNKS * 128) {
      if (r0 > 0) fetch_cols<TB, WIDE>(u, u2, n0, nwarps, r0, R, N, lane);
#pragma unroll
      for (int q = 0; q < CHUNKS; ++q) {
        const int r = r0 + q * 128 + lane * 4;
        if (r >= R) break;
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const float4 tv = t4<WIDE>(ts, m, r, R);
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            float sum = acc[c][m];
            sum = fmaf(tv.x, u[c][q].x, sum);
            sum = fmaf(tv.y, u[c][q].y, sum);
            sum = fmaf(tv.z, u[c][q].z, sum);
            acc[c][m] = fmaf(tv.w, u[c][q].w, sum);
          }
        }
      }
    }
    if (n0 + COLS * nwarps < N)
      fetch_cols<TB, WIDE>(u, u2, n0 + COLS * nwarps, nwarps, 0, R, N, lane);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int n = n0 + c * nwarps;
      if (n >= N) break;    // warp-uniform
      float mine = 0.f;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        float sum = acc[c][m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(REPRO_FULL_MASK, sum, off);
        if (lane == m) mine = sum;
      }
      if (lane < M) store_as(&y[static_cast<long long>(lane) * N + n], mine);
    }
  }
}

template <int MB, typename TA, typename TB>
cudaError_t stream_rows(const TA* a, const TB* b, float* out, int M, int K,
                        int Nc, int splits, bool wide, cudaStream_t stream) {
  static bool configured[2] = {false, false};
  if (splits < 1 || splits > MAX_CLUSTER) return cudaErrorInvalidValue;
  const int rows = (K + splits - 1) / splits;
  const size_t bytes = sizeof(float) * MB * rows;
  auto kernel = wide ? stream_rows_kernel<MB, TA, TB, true>
                     : stream_rows_kernel<MB, TA, TB, false>;
  cudaError_t err = allow_smem(kernel, ROWS_SMEM, configured[wide]);
  if (err != cudaSuccess) return err;
  if (bytes > ROWS_SMEM) return cudaErrorInvalidValue;
  const dim3 grid((Nc + STRIP - 1) / STRIP, splits);
  return launch(kernel, grid, splits, bytes, stream, a, b, out, M, K, Nc,
                rows);
}

template <int MB, typename TB, typename TC>
cudaError_t stream_cols(const float* t, const TB* u2, TC* y, int M, int R,
                        int N, int blocks, bool wide, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * MB * R;
  if (bytes > 48 * 1024 || blocks < 1) return cudaErrorInvalidValue;
  auto kernel = wide ? stream_cols_kernel<MB, TB, TC, true>
                     : stream_cols_kernel<MB, TB, TC, false>;
  return launch(kernel, dim3(blocks), 1, bytes, stream, t, u2, y, M, R, N);
}

template <int MB, typename TX, typename TW, typename TO>
cudaError_t stream_route(const TX* x, const TW* u1, const TW* g,
                         const TW* u2, TO* y, float* t1, float* t, int M,
                         int K, int R1, int R2, int N, int s1, int s2,
                         int b3, int wide, cudaStream_t st) {
  cudaError_t err = stream_rows<MB, TX, TW>(x, u1, t1, M, K, R1, s1,
                                            wide & 1, st);
  if (err == cudaSuccess)
    err = stream_rows<MB, float, TW>(t1, g, t, M, R1, R2, s2, wide & 2, st);
  if (err == cudaSuccess)
    err = stream_cols<MB, TW, TO>(t, u2, y, M, R2, N, b3, wide & 4, st);
  return err;
}

// Tensor-core passes of each product, packed 2 bits each as the wrapper's
// plan hands them: 0 on the streaming route (f32 fmaf).
template <typename TX, typename TW>
constexpr int kGemmPasses = kPasses<kBf16<TX>, kBf16<TW>> +
                            (kPasses<false, kBf16<TW>> << 2) +
                            (kPasses<false, kBf16<TW>> << 4);

// y = ((x U1) G) U2ᵀ through f32 scratch t1 (M, R1) and t (M, R2), t on a
// 16-byte boundary past t1.  stream_path: the streaming route (M <= 16),
// its products 1 and 2 split over s1 and s2 rows (clusters of that many
// blocks, at most MAX_CLUSTER), its last product on b3 blocks; else the
// tensor-core route.  wide: bit i set when product i takes 16-byte loads.
// passes: the plan's passes, refused unless they are this build's.
template <typename TX, typename TW, typename TO>
int tucker_matmul(const TX* x, const TW* u1, const TW* g, const TW* u2,
                  TO* y, float* t1, float* t, int M, int K, int R1, int R2,
                  int N, int stream_path, int s1, int s2, int b3, int wide,
                  int passes, void* stream) {
  if (M < 1 || K < 1 || R1 < 1 || R2 < 1 || N < 1 || t1 == nullptr ||
      t - t1 < static_cast<long long>(M) * R1 ||
      reinterpret_cast<uintptr_t>(t) % 16 != 0 ||
      passes != (stream_path ? 0 : kGemmPasses<TX, TW>))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stream_path) {
    if (M > 16) return static_cast<int>(cudaErrorInvalidValue);
    err = M <= 4 ? stream_route<4>(x, u1, g, u2, y, t1, t, M, K, R1, R2, N,
                                   s1, s2, b3, wide, st)
                 : stream_route<16>(x, u1, g, u2, y, t1, t, M, K, R1, R2, N,
                                    s1, s2, b3, wide, st);
    return static_cast<int>(err);
  }
  err = gemm<TX, TW, float, false>(x, u1, t1, M, R1, K, wide & 1, st);
  if (err == cudaSuccess)
    err = gemm<float, TW, float, false>(t1, g, t, M, R2, R1, wide & 2, st);
  if (err == cudaSuccess)
    err = gemm<float, TW, TO, true>(t, u2, y, M, N, R2, wide & 4, st);
  return static_cast<int>(err);
}

}  // namespace

#define TUCKER_ENTRY(NAME, TX, TW, TO)                                       \
  extern "C" int NAME(const TX* x, const TW* u1, const TW* g, const TW* u2, \
                      TO* y, float* t1, float* t, int M, int K, int R1,   \
                      int R2, int N, int stream_path, int s1, int s2,       \
                      int b3, int wide, int passes, void* stream) {         \
    return tucker_matmul<TX, TW, TO>(x, u1, g, u2, y, t1, t, M, K, R1, R2,  \
                                     N, stream_path, s1, s2, b3, wide,      \
                                     passes, stream);                       \
  }

// tucker_matmul_<x dtype>_<factor dtype>; y in the promoted dtype.  The
// LM path passes f32 factors with x in f32 (down) or bf16 (up, gate);
// all-bf16 is the Pallas kernel's own case.
TUCKER_ENTRY(tucker_matmul_f32_f32, float, float, float)
TUCKER_ENTRY(tucker_matmul_bf16_f32, __nv_bfloat16, float, float)
TUCKER_ENTRY(tucker_matmul_bf16_bf16, __nv_bfloat16, __nv_bfloat16,
             __nv_bfloat16)
