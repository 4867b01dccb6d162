// Rows of a serving table C = A B, Hopper (sm_90a): the full build and the
// patch of dirty rows, with the same bits for a row whatever the row count.
//
// Replaces the reference's jnp mode products that build and patch the
// serving tables (src/repro/core/kruskal.py::mode_products, one jnp.matmul
// a mode, and the jitted _patch_impl of src/repro/serve/engine.py: two
// matmuls, the colsum delta and the row scatter).  No Pallas kernel.
//
// A patched row must equal the rebuilt one bit for bit.  A matmul does not
// give that: cuBLAS picks its algorithm and the split of the J sum by the
// row count.  So every output element here is the plain version's sequence
// (core/kruskal.py::mode_product_rows), whatever M is:
//     acc = a[i][0] * b[0][r]
//     acc = acc + a[i][j] * b[j][r]            j = 1 .. J-1, ascending
// each product and each sum rounded on its own (__fmul_rn, __fadd_rn: never
// an FMA).  Storage may be f32 or bf16 (rows, factors, table); every load is
// widened to f32 first and a bf16 table is rounded once, to nearest even.
//
// Layout: a block of 256 threads holds B (J, R) in shared memory for the
// whole call and walks tiles of TR rows (mode_product_rows.py::plan), grid
// stride.  A tile's rows are staged in shared memory (row stride J + 1, so
// the lanes of a warp that read different rows hit distinct banks) and its
// TR·R <= 1024 outputs are spread over the threads, four each, o = t + 256k:
// row o / R, column o % R.  The four chains are independent, so they
// interleave.  Outputs are written in order o: coalesced.
//
// mode_product_rows_kernel: out (M, R) f32, one launch a call.
// patch_rows_kernel + colsum_kernel (the patch, one C call):
//   1. the ids are copied from the caller's host buffer, and the live table
//      into the new one (the live generation is never written);
//   2. each tile gathers the old rows of the factor mirror at the ids and
//      the new rows, then writes the new rows into the mirror (no other
//      block reads those rows: the ids are unique), forms both products,
//      writes the new product into the new table at the ids and the delta
//      new - old into shared memory; threads t < R add the tile's deltas of
//      column t in row order into a running partial, one a block;
//   3. colsum_kernel (one block) adds the blocks' partials in block order
//      and writes colsum_new = colsum_old + total.  No atomics: the colsum
//      has the same bits on every run of the same shape.
//
// Bound on the card: memory at the serving shapes.  A build reads M·J + J·R
// and writes M·R values (mode 0 of bench_refresh's FULL shape at J = R = 64:
// 30.7 MB, 9.2 µs at 3.35 TB/s); its 2·M·J·R f32 operations take 7.3 µs at
// 67 TFLOP/s.  A patch of K rows moves the table copy (2·I·R values), plus
// 3·K·J and K·R, and does twice a build's operations for K rows.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;   // a tile's outputs: at most 1024

__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16_rn(v);
}

// The tile's products: for k < 4, output o = threadIdx.x + 256k of a tile
// of `rows` rows staged at `as` (stride AS), against B at `bs` (J, R).
__device__ __forceinline__ void tile_products(
    const float* __restrict__ as, int AS, const float* __restrict__ bs,
    int J, int R, int rows, float (&acc)[kPerThread]) {
  int ia[kPerThread], rr[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int o = threadIdx.x + kThreads * k;
    const bool ok = o < rows * R;
    ia[k] = ok ? (o / R) * AS : 0;
    rr[k] = ok ? o % R : 0;
    acc[k] = __fmul_rn(as[ia[k]], bs[rr[k]]);
  }
  for (int j = 1; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(as[ia[k] + j], bs[j * R + rr[k]]));
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) mode_product_rows_kernel(
    const TA* __restrict__ a, const TB* __restrict__ b,
    float* __restrict__ out, long long M, int J, int R, int TR) {
  extern __shared__ float smem[];
  float* bs = smem;               // J * R
  float* as = smem + J * R;       // TR * (J + 1)
  const int AS = J + 1;
  for (int e = threadIdx.x; e < J * R; e += kThreads) bs[e] = to_float(b[e]);
  const long long tiles = (M + TR - 1) / TR;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * TR;
    const int rows = static_cast<int>(M - row0 < TR ? M - row0 : TR);
    __syncthreads();   // B staged; the last tile's rows read
    const TA* src = a + row0 * J;
    for (int e = threadIdx.x; e < rows * J; e += kThreads)
      as[(e / J) * AS + e % J] = to_float(src[e]);
    __syncthreads();
    float acc[kPerThread];
    tile_products(as, AS, bs, J, R, rows, acc);
    float* dst = out + row0 * R;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int o = threadIdx.x + kThreads * k;
      if (o < rows * R) dst[o] = acc[k];
    }
  }
}

template <typename TA, typename TB, typename TT>
__global__ void __launch_bounds__(kThreads) patch_rows_kernel(
    const int* __restrict__ ids, const TA* __restrict__ rows_new,
    TA* __restrict__ mirror, const TB* __restrict__ b,
    TT* __restrict__ table, float* __restrict__ partials, long long K,
    int J, int R, int TR) {
  extern __shared__ float smem[];
  const int AS = J + 1;
  float* bs = smem;                     // J * R
  float* as_old = bs + J * R;           // TR * (J + 1)
  float* as_new = as_old + TR * AS;     // TR * (J + 1)
  float* ds = as_new + TR * AS;         // TR * R deltas of the tile
  for (int e = threadIdx.x; e < J * R; e += kThreads) bs[e] = to_float(b[e]);
  float part = 0.f;                     // column threadIdx.x < R
  const long long tiles = (K + TR - 1) / TR;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * TR;
    const int rows = static_cast<int>(K - row0 < TR ? K - row0 : TR);
    __syncthreads();   // B staged; the last tile's rows and deltas read
    for (int e = threadIdx.x; e < rows * J; e += kThreads) {
      const int i = e / J, j = e % J;
      const long long id = ids[row0 + i];
      as_old[i * AS + j] = to_float(mirror[id * J + j]);
      as_new[i * AS + j] = to_float(rows_new[(row0 + i) * J + j]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * J; e += kThreads) {
      const int i = e / J, j = e % J;
      mirror[static_cast<long long>(ids[row0 + i]) * J + j] =
          rows_new[(row0 + i) * J + j];
    }
    float acc_old[kPerThread], acc_new[kPerThread];
    tile_products(as_old, AS, bs, J, R, rows, acc_old);
    tile_products(as_new, AS, bs, J, R, rows, acc_new);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int o = threadIdx.x + kThreads * k;
      if (o < rows * R) {
        const int i = o / R, r = o % R;
        store(table, static_cast<long long>(ids[row0 + i]) * R + r,
              acc_new[k]);
        ds[o] = __fsub_rn(acc_new[k], acc_old[k]);
      }
    }
    __syncthreads();
    if (threadIdx.x < R)
      for (int i = 0; i < rows; ++i)
        part = __fadd_rn(part, ds[i * R + threadIdx.x]);
  }
  if (threadIdx.x < R) partials[blockIdx.x * R + threadIdx.x] = part;
}

__global__ void colsum_kernel(const float* __restrict__ partials,
                              const float* __restrict__ colsum_old,
                              float* __restrict__ colsum_new, int blocks,
                              int R) {
  const int r = threadIdx.x;
  if (r >= R) return;
  float total = 0.f;
  for (int k = 0; k < blocks; ++k)
    total = __fadd_rn(total, partials[k * R + r]);
  colsum_new[r] = __fadd_rn(colsum_old[r], total);
}

size_t build_smem(int J, int R, int TR) {
  return sizeof(float) * (static_cast<size_t>(J) * R +
                          static_cast<size_t>(TR) * (J + 1));
}

size_t patch_smem(int J, int R, int TR) {
  return sizeof(float) * (static_cast<size_t>(J) * R +
                          2 * static_cast<size_t>(TR) * (J + 1) +
                          static_cast<size_t>(TR) * R);
}

bool widths_ok(int J, int R, int TR) {
  return J >= 1 && J <= REPRO_MAX_WIDTH && R >= 1 && R <= REPRO_MAX_WIDTH &&
         TR >= 1 && TR * R <= kThreads * kPerThread;
}

template <typename TA, typename TB>
int launch_build(const void* a, const void* b, float* out, long long M,
                 int J, int R, int TR, long long blocks, cudaStream_t st) {
  const size_t smem = build_smem(J, R, TR);
  mode_product_rows_kernel<TA, TB>
      <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
          static_cast<const TA*>(a), static_cast<const TB*>(b), out, M, J, R,
          TR);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TB, typename TT>
int launch_patch(const int* ids, const void* rows, void* mirror,
                 const void* b, void* table, float* partials, long long K,
                 int J, int R, int TR, long long blocks, cudaStream_t st) {
  const size_t smem = patch_smem(J, R, TR);
  patch_rows_kernel<TA, TB, TT>
      <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
          ids, static_cast<const TA*>(rows), static_cast<TA*>(mirror),
          static_cast<const TB*>(b), static_cast<TT*>(table), partials, K, J,
          R, TR);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TB>
int launch_patch_table(bool t_bf16, const int* ids, const void* rows,
                       void* mirror, const void* b, void* table,
                       float* partials, long long K, int J, int R, int TR,
                       long long blocks, cudaStream_t st) {
  return t_bf16 ? launch_patch<TA, TB, __nv_bfloat16>(
                      ids, rows, mirror, b, table, partials, K, J, R, TR,
                      blocks, st)
                : launch_patch<TA, TB, float>(ids, rows, mirror, b, table,
                                              partials, K, J, R, TR, blocks,
                                              st);
}

}  // namespace

// out (M, R) f32 = a (M, J) times b (J, R); a_bf16 / b_bf16 name the
// storage of a and b.
extern "C" int mode_product_rows(const void* a, const void* b, float* out,
                                 long long M, int J, int R, int TR,
                                 long long blocks, int a_bf16, int b_bf16,
                                 void* stream) {
  const long long tiles = M > 0 ? (M + TR - 1) / TR : 0;
  if (M < 1 || !widths_ok(J, R, TR) || blocks < 1 || blocks > tiles ||
      blocks > 0x7fffffffLL || build_smem(J, R, TR) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_bf16)
    return b_bf16 ? launch_build<__nv_bfloat16, __nv_bfloat16>(
                        a, b, out, M, J, R, TR, blocks, st)
                  : launch_build<__nv_bfloat16, float>(a, b, out, M, J, R,
                                                       TR, blocks, st);
  return b_bf16 ? launch_build<float, __nv_bfloat16>(a, b, out, M, J, R, TR,
                                                     blocks, st)
                : launch_build<float, float>(a, b, out, M, J, R, TR, blocks,
                                             st);
}

// The patch of K unique rows (ids_host: K int32 on the host, in range):
// copies the ids to ids_dev and table_old (I, R) to table_new, then writes
// the new product rows into table_new, the new factor rows into mirror
// (I, J) and colsum_new = colsum_old + Σ (new − old) over the K rows.
// partials holds blocks·R floats.  a_bf16 names the storage of rows and
// mirror, b_bf16 of b, t_bf16 of the tables.
extern "C" int patch_table_rows(
    const int* ids_host, int* ids_dev, long long K, const void* rows,
    void* mirror, const void* b, const void* table_old, void* table_new,
    long long I, const float* colsum_old, float* colsum_new, float* partials,
    int J, int R, int TR, long long blocks, int a_bf16, int b_bf16,
    int t_bf16, void* stream) {
  const long long tiles = K > 0 ? (K + TR - 1) / TR : 0;
  if (K < 1 || K > I || !widths_ok(J, R, TR) || blocks < 1 ||
      blocks > tiles || blocks > 0x7fffffffLL ||
      patch_smem(J, R, TR) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // pageable: returns once the ids are staged, so the caller may reuse them
  cudaError_t err = cudaMemcpyAsync(ids_dev, ids_host, sizeof(int) * K,
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t elt = t_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  err = cudaMemcpyAsync(table_new, table_old, elt * I * R,
                        cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int code;
  if (a_bf16)
    code = b_bf16 ? launch_patch_table<__nv_bfloat16, __nv_bfloat16>(
                        t_bf16, ids_dev, rows, mirror, b, table_new, partials,
                        K, J, R, TR, blocks, st)
                  : launch_patch_table<__nv_bfloat16, float>(
                        t_bf16, ids_dev, rows, mirror, b, table_new, partials,
                        K, J, R, TR, blocks, st);
  else
    code = b_bf16 ? launch_patch_table<float, __nv_bfloat16>(
                        t_bf16, ids_dev, rows, mirror, b, table_new, partials,
                        K, J, R, TR, blocks, st)
                  : launch_patch_table<float, float>(
                        t_bf16, ids_dev, rows, mirror, b, table_new, partials,
                        K, J, R, TR, blocks, st);
  if (code != 0) return code;
  colsum_kernel<<<1, 64, 0, st>>>(partials, colsum_old, colsum_new,
                                  static_cast<int>(blocks), R);
  return static_cast<int>(cudaGetLastError());
}
