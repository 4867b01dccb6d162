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
// (core/kruskal.py::mode_product_rows), whatever M is or however the rows
// are tiled:
//     acc = a[i][0] * b[0][r]
//     acc = acc + a[i][j] * b[j][r]            j = 1 .. J-1, ascending
// each product and each sum rounded on its own (__fmul_rn, __fadd_rn: never
// an FMA).  Storage may be f32 or bf16 (rows, factors, table); every load is
// widened to f32 first and a bf16 table is rounded once, to nearest even.
//
// Bound on the card.  No FMA, so a build of M rows issues (2J - 1)·M·R
// separate f32 instructions, at half the FMA rate (33.5 T a second on an
// H100 SXM): 14.6 µs at M = 60,000, J = R = 64, above its 9.2 µs of bytes
// (M·J + J·R read, M·R written, at 3.35 TB/s).  At J, R <= 8 the bytes bound
// it (480,189 × 4: 4.6 µs).  Two routes, chosen by the shapes alone
// (mode_product_rows.py::plan):
//
// Wide (J or R above 8).  A block of 256 threads holds B (J, R) in shared
// memory as f32 for the whole call, its rows padded to S = R rounded up to
// 4.  Thread t owns a register micro-tile: column group t % CG (four
// columns, CG = S / 4, the only division, once a thread) of the rows
// TM·(t / CG) .. + TM of the tile, 16 row groups a tile.  Its TM·4 chains are
// independent.  For each four j, one 16-byte shared load gives a row's four
// a values and one gives B's four columns at j: TM + 4 vector loads for
// 32·TM f32 instructions.  (A stays row-major in shared memory: a row's
// four j in one load give the same ratio as a k-major tile's TM rows at one
// j, and keep the staging a straight 16-byte copy.)  A build block takes
// a contiguous range of rows, the same count for every block (a multiple
// of 8, so each tile starts 16-byte aligned; at most 264 blocks, two an
// SM), in tiles of 128 rows (TM = 8), double-buffered: cp.async fills the
// next tile while the current one computes, and B is staged while the
// first is in flight.  J not a multiple of 4 takes one j at a time (a
// scalar a, a vector of B).
//
// Narrow (J, R <= 8: the paper's J = R = 4, bench_serve's 8).  Byte-bound:
// a thread takes a row at a time, reads its J values in 16-byte (or 8-byte)
// loads, holds B in registers, and writes its R outputs with 16-byte
// stores; the grid (264 blocks, each staging B once) strides over the rows
// with the next row's load in flight while the current one computes.
//
// The patch (one C call, patch_table_rows): the ids and a bit map of the
// dirty rows are built on the host and copied in one cudaMemcpyAsync into
// the call's device workspace, then one launch with two roles.  Its copy
// blocks copy the live table's clean rows into the new table (the live
// generation is never written; a dirty row is never copied, so the roles
// need no order between them: the copy overlaps the patch, in place of a
// table cudaMemcpyAsync before it).  Its patch blocks walk tiles of dirty
// rows (wide: 32 rows, 16 row groups of 2 on the build's micro-tile, the old
// and new rows sharing each load of B; narrow: 128 rows, a row a
// thread).  Each gathers the old rows of the factor mirror at the ids and the
// new rows, writes the new rows into the mirror (no other block reads those
// rows: the ids are unique), forms both products, writes the new one into
// the new table at the ids and folds new - old in a fixed order: each thread
// its own columns in row order, in registers; then the threads of a block
// that share a column, in thread order; then, in the last patch block to
// finish, the blocks' partials in block order, cut into blockDim / R
// contiguous segments added in order (so the loads overlap).  For a route the
// order depends on K alone (fixed tiles, a constant block cap), so the
// colsum repeats its bits; the only atomic is the counter that elects the
// last block.
#include <cstdint>
#include <cstring>
#include <vector>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // a build block, a wide patch block
constexpr int kNarrow = 8;                 // J, R <= 8: the narrow route
constexpr int kTN = 4;                     // columns a thread, wide route
constexpr int kRG = 16;                    // row groups a tile, wide route
constexpr int kBuildTM = 8;                // rows a thread, wide build
constexpr int kBuildRows = kRG * kBuildTM; // 128 rows a wide build tile
constexpr int kNarrowRows = kThreads;      // a row a thread, narrow build
constexpr int kPatchTM = 2;                // rows a thread, wide patch
constexpr int kPatchRows = kRG * kPatchTM; // 32 rows a wide patch tile
constexpr int kPatchNarrow = 128;          // rows (threads) a narrow patch tile
constexpr int kNarrowBlocks = 2 * 132;     // narrow build grid at most
constexpr int kCopyBlocks = 132;           // a patch's copy blocks at most:
                                           // with 512 patch blocks, three
                                           // wide blocks an SM hold them all
constexpr int kMaxPatchBlocks = 512;       // a patch's patch blocks at most
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float widen_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float widen_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Four consecutive values at p, widened (16-byte aligned for f32, 8 for bf16).
__device__ __forceinline__ void load4(const float* p, float& v0, float& v1,
                                      float& v2, float& v3) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v0 = x.x; v1 = x.y; v2 = x.z; v3 = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float& v0,
                                      float& v1, float& v2, float& v3) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v0 = widen_lo(x.x); v1 = widen_hi(x.x);
  v2 = widen_lo(x.y); v3 = widen_hi(x.y);
}

// B (J, R) into shared memory as f32: bs[j * S + r] for j < JS, r < S, 0
// outside (J, R).  Once a block.  Where the layouts agree (f32 storage,
// JS = J, S = R, b 16-byte aligned) and `async` allows, as 16-byte
// cp.async copies that join the caller's next commit group; otherwise
// element by element, and the caller synchronises.
__device__ __forceinline__ void stage_b(const void* __restrict__ b,
                                        int b_bf16, float* __restrict__ bs,
                                        int J, int R, int JS, int S,
                                        bool async) {
  if (async && !b_bf16 && JS == J && S == R &&
      reinterpret_cast<uintptr_t>(b) % 16 == 0) {
    for (int c = threadIdx.x; c < J * R / 4; c += blockDim.x)
      cp_async16(bs + 4 * c, static_cast<const float*>(b) + 4 * c, 16);
    return;
  }
  const float inv_s = 1.f / S;
  if (b_bf16) {
    const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(b);
    for (int e = threadIdx.x; e < JS * S; e += blockDim.x) {
      const int j = div_small(e, inv_s), r = e - j * S;
      bs[e] = j < J && r < R ? __bfloat162float(bb[j * R + r]) : 0.f;
    }
  } else {
    const float* bf = static_cast<const float*>(b);
    for (int e = threadIdx.x; e < JS * S; e += blockDim.x) {
      const int j = div_small(e, inv_s), r = e - j * S;
      bs[e] = j < J && r < R ? bf[j * R + r] : 0.f;
    }
  }
}

// --- the wide route's micro-tile --------------------------------------------

// Four j (j .. j+3) of the chains of NT tiles (the patch's old and new
// rows share each load of B): TM rows at as[t] (row stride J), B's four
// columns at `bs` (row stride S).  FIRST: j = 0, the chain's first product.
template <int NT, int TM, bool FIRST, typename TA>
__device__ __forceinline__ void step4(const TA* const (&as)[NT], int J,
                                      const float* __restrict__ bs, int S,
                                      int j, float (&acc)[NT][TM][kTN]) {
  float b[4][kTN];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float4 x = *reinterpret_cast<const float4*>(bs + (j + jj) * S);
    b[jj][0] = x.x; b[jj][1] = x.y; b[jj][2] = x.z; b[jj][3] = x.w;
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float a[4];
      load4(as[t] + i * J + j, a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          const float p = __fmul_rn(a[jj], b[jj][c]);
          acc[t][i][c] = (FIRST && jj == 0) ? p : __fadd_rn(acc[t][i][c], p);
        }
    }
}

// One j of the chains, for J not a multiple of 4.
template <int NT, int TM, bool FIRST, typename TA>
__device__ __forceinline__ void step1(const TA* const (&as)[NT], int J,
                                      const float* __restrict__ bs, int S,
                                      int j, float (&acc)[NT][TM][kTN]) {
  const float4 x = *reinterpret_cast<const float4*>(bs + j * S);
  const float b[kTN] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float a = to_float(as[t][i * J + j]);
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        const float p = __fmul_rn(a, b[c]);
        acc[t][i][c] = FIRST ? p : __fadd_rn(acc[t][i][c], p);
      }
    }
}

// acc[t][i][c] = Σ_j a_t[i][j]·B[j][c] in the plain version's order, for
// TM rows of each of NT tiles staged at as[t] and four columns of B at
// `bs`.  VJ: J % 4 == 0.
template <int NT, int TM, bool VJ, typename TA>
__device__ __forceinline__ void micro_tile(const TA* const (&as)[NT], int J,
                                           const float* __restrict__ bs,
                                           int S, float (&acc)[NT][TM][kTN]) {
  if (VJ) {
    step4<NT, TM, true>(as, J, bs, S, 0, acc);
    for (int j = 4; j < J; j += 4)
      step4<NT, TM, false>(as, J, bs, S, j, acc);
  } else {
    step1<NT, TM, true>(as, J, bs, S, 0, acc);
    for (int j = 1; j < J; ++j) step1<NT, TM, false>(as, J, bs, S, j, acc);
  }
}

// n elements from src to shared dst: 16-byte cp.async where vec (both
// 16-byte aligned), the rest element by element.  The caller commits.
template <typename TA>
__device__ __forceinline__ void stage_flat(TA* dst, const TA* __restrict__ src,
                                           int n, bool vec) {
  int done = 0;
  if (vec) {
    const int n16 = static_cast<int>(n * sizeof(TA) / 16);
    for (int c = threadIdx.x; c < n16; c += blockDim.x)
      cp_async16(reinterpret_cast<char*>(dst) + 16 * c,
                 reinterpret_cast<const char*>(src) + 16 * c, 16);
    done = n16 * static_cast<int>(16 / sizeof(TA));
  }
  for (int e = done + threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// n <= 4 values of a row at p; vec: all four, 16 (f32) or 8 (bf16) bytes.
__device__ __forceinline__ void store4(float* p, int n, bool vec,
                                       const float (&v)[kTN]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kTN; ++c)
      if (c < n) p[c] = v[c];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, int n, bool vec,
                                       const float (&v)[kTN]) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int c = 0; c < kTN; ++c)
      if (c < n) p[c] = __float2bfloat16_rn(v[c]);
  }
}

template <typename TA, bool VJ>
__global__ void __launch_bounds__(kThreads, 2) mode_product_rows_kernel(
    const TA* __restrict__ a, const void* __restrict__ b, int b_bf16,
    float* __restrict__ out, long long M, int J, int R, long long per_block,
    int vec_in, int vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = (R + 3) & ~3, CG = S / kTN;
  float* bs = reinterpret_cast<float*>(smem);                     // J * S
  TA* tile0 = reinterpret_cast<TA*>(bs + J * S);                 // 128 * J
  TA* tile1 = tile0 + kBuildRows * J;                            // 128 * J
  // this block's rows: [start, end), in tiles of 128
  const long long start = blockIdx.x * per_block;
  const long long end = start + per_block < M ? start + per_block : M;
  const int tiles = static_cast<int>((end - start + kBuildRows - 1) /
                                     kBuildRows);
  auto rows_of = [&](int t) {
    const long long left = end - start - static_cast<long long>(t) *
                                             kBuildRows;
    return static_cast<int>(left < kBuildRows ? left : kBuildRows);
  };
  stage_flat(tile0, a + start * J, rows_of(0) * J, vec_in);
  stage_b(b, b_bf16, bs, J, R, J, S, true);   // with the first tile
  cp_async_commit();
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles)
      stage_flat(buf ? tile0 : tile1,
                 a + (start + static_cast<long long>(t + 1) * kBuildRows) * J,
                 rows_of(t + 1) * J, vec_in);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of tile t landed
    __syncthreads();      // everyone's (and B)
    const long long row0 = start + static_cast<long long>(t) * kBuildRows +
                           rg * kBuildTM;
    if (rg < kRG && row0 < end) {
      float acc[1][kBuildTM][kTN];
      const TA* const src[1] = {(buf ? tile1 : tile0) + rg * kBuildTM * J};
      micro_tile<1, kBuildTM, VJ>(src, J, bs + cg * kTN, S, acc);
      const int n = R - cg * kTN;
#pragma unroll
      for (int i = 0; i < kBuildTM; ++i)
        if (row0 + i < end)
          store4(out + (row0 + i) * R + cg * kTN, n, vec_out, acc[0][i]);
    }
    __syncthreads();      // tile t read before it is refilled
  }
}

// --- the narrow route -------------------------------------------------------

// A row's J <= 8 values, widened; vec: J is 4 or 8 and p aligned to the row.
template <typename TA>
__device__ __forceinline__ void load_row(const TA* __restrict__ p, int J,
                                         bool vec, float (&v)[kNarrow]) {
#pragma unroll
  for (int j = 0; j < kNarrow; ++j) v[j] = 0.f;
  if (vec) {
    load4(p, v[0], v[1], v[2], v[3]);
    if (J == 8) load4(p + 4, v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kNarrow; ++j)
      if (j < J) v[j] = to_float(p[j]);
  }
}

// The row's R <= 8 products, in the plain version's order.
__device__ __forceinline__ void narrow_products(
    const float (&a)[kNarrow], const float (&b)[kNarrow][kNarrow], int J,
    float (&acc)[kNarrow]) {
#pragma unroll
  for (int r = 0; r < kNarrow; ++r) acc[r] = __fmul_rn(a[0], b[0][r]);
#pragma unroll
  for (int j = 1; j < kNarrow; ++j)
    if (j < J) {
#pragma unroll
      for (int r = 0; r < kNarrow; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(a[j], b[j][r]));
    }
}

// R <= 8 values at p; vec: R is 4 or 8 and p aligned to four values.
template <typename TT>
__device__ __forceinline__ void store_row(TT* p, int R, bool vec,
                                          const float (&v)[kNarrow]) {
  const float lo[kTN] = {v[0], v[1], v[2], v[3]};
  const float hi[kTN] = {v[4], v[5], v[6], v[7]};
  store4(p, R, vec, lo);
  if (R > 4) store4(p + 4, R - 4, vec, hi);
}

// B (8 x 8, zero-padded) from shared memory into registers.
__device__ __forceinline__ void b_registers(const float* __restrict__ bs,
                                            float (&b)[kNarrow][kNarrow]) {
#pragma unroll
  for (int j = 0; j < kNarrow; ++j)
#pragma unroll
    for (int q = 0; q < kNarrow; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(bs + j * kNarrow + q);
      b[j][q] = x.x; b[j][q + 1] = x.y; b[j][q + 2] = x.z; b[j][q + 3] = x.w;
    }
}

template <typename TA>
__global__ void __launch_bounds__(kThreads) mode_product_rows_kernel_narrow(
    const TA* __restrict__ a, const void* __restrict__ b, int b_bf16,
    float* __restrict__ out, long long M, int J, int R, int vec_in,
    int vec_out) {
  __shared__ __align__(16) float bs[kNarrow * kNarrow];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                  threadIdx.x;
  float av[kNarrow];
  if (row < M) load_row(a + row * J, J, vec_in, av);   // in flight under B
  stage_b(b, b_bf16, bs, J, R, kNarrow, kNarrow, false);
  __syncthreads();
  float bv[kNarrow][kNarrow];
  b_registers(bs, bv);
  for (; row < M; row += stride) {
    float next[kNarrow], acc[kNarrow];
    if (row + stride < M)   // the next row in flight while this one computes
      load_row(a + (row + stride) * J, J, vec_in, next);
    narrow_products(av, bv, J, acc);
    store_row(out + row * R, R, vec_out, acc);
#pragma unroll
    for (int j = 0; j < kNarrow; ++j) av[j] = next[j];
  }
}

// --- the patch --------------------------------------------------------------

// The block's column totals (thread t < R holds column t's) into partials;
// the last of the nb patch blocks to finish adds every block's, in block
// order within S = blockDim / R contiguous segments of the blocks, then the
// segments in order (an order set by the block count, so by K, alone), and
// writes colsum_new = colsum_old + total.  seg: blockDim floats of shared
// memory.
__device__ __forceinline__ void fold_blocks(
    float* __restrict__ partials, unsigned* __restrict__ counter,
    const float* __restrict__ colsum_old, float* __restrict__ colsum_new,
    int R, unsigned nb, float block_total, unsigned* ticket, float* seg) {
  if (threadIdx.x < R) {
    partials[blockIdx.x * R + threadIdx.x] = block_total;
    __threadfence();   // the partial visible before the count says so
  }
  __syncthreads();
  if (threadIdx.x == 0) *ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (*ticket != nb - 1) return;
  __threadfence();
  const int segs = blockDim.x / R;
  const int s = threadIdx.x / R, c = threadIdx.x - s * R;
  if (s < segs) {
    const unsigned len = (nb + segs - 1) / segs;
    const unsigned lo = s * len;
    const unsigned hi = lo + len < nb ? lo + len : nb;
    const float* col = partials + c;
    float total = 0.f;
    for (unsigned k = lo; k < hi; k += 64) {   // 64 loads, then their adds
      float v[64];
#pragma unroll
      for (int q = 0; q < 64; ++q)
        v[q] = k + q < hi ? __ldcg(col + (k + q) * R) : 0.f;
#pragma unroll
      for (int q = 0; q < 64; ++q)
        if (k + q < hi) total = __fadd_rn(total, v[q]);
    }
    seg[threadIdx.x] = total;
  }
  __syncthreads();
  if (threadIdx.x < R) {
    float total = 0.f;
    for (int q = 0; q < segs; ++q)
      total = __fadd_rn(total, seg[q * R + threadIdx.x]);
    colsum_new[threadIdx.x] = __fadd_rn(colsum_old[threadIdx.x], total);
  }
}

// The copy role of a patch launch (blocks nb and up): the rows of the live
// table whose bit in `dirty` is clear, into the new table, in pieces of P
// (16, 8, 4 or 2 bytes, as the rows and pointers allow), the blocks
// striding over the pieces; the (row, piece) walk divides once a thread.
// Dirty rows are the patch blocks' alone, so no order between the two
// roles is needed.
template <typename P>
__device__ __forceinline__ void copy_clean_pieces(
    const char* __restrict__ src, char* __restrict__ dst,
    const unsigned* __restrict__ dirty, long long I, int row_bytes,
    unsigned nb) {
  const int per_row = row_bytes / static_cast<int>(sizeof(P));
  const long long threads = static_cast<long long>(gridDim.x - nb) *
                            blockDim.x;
  const long long e = static_cast<long long>(blockIdx.x - nb) * blockDim.x +
                      threadIdx.x;
  long long r = e / per_row;
  int c = static_cast<int>(e - r * per_row);
  const long long dr = threads / per_row;
  const int dc = static_cast<int>(threads - dr * per_row);
  while (r < I) {
    if (!((dirty[r >> 5] >> (r & 31)) & 1u))
      reinterpret_cast<P*>(dst + r * row_bytes)[c] =
          reinterpret_cast<const P*>(src + r * row_bytes)[c];
    r += dr;
    c += dc;
    if (c >= per_row) { c -= per_row; ++r; }
  }
}

__device__ __forceinline__ void copy_clean(
    const void* table_old, void* table_new, const unsigned* dirty,
    long long I, int row_bytes, unsigned nb, int piece) {
  const char* src = static_cast<const char*>(table_old);
  char* dst = static_cast<char*>(table_new);
  switch (piece) {
    case 16: copy_clean_pieces<uint4>(src, dst, dirty, I, row_bytes, nb); break;
    case 8: copy_clean_pieces<uint2>(src, dst, dirty, I, row_bytes, nb); break;
    case 4: copy_clean_pieces<uint32_t>(src, dst, dirty, I, row_bytes, nb);
      break;
    default: copy_clean_pieces<uint16_t>(src, dst, dirty, I, row_bytes, nb);
  }
}

// A row's raw storage from src to dst (J elements); vec: J is 4 or 8 and
// both rows 8-byte aligned, so the row moves in 8-byte pieces.
template <typename TA>
__device__ __forceinline__ void copy_row(TA* __restrict__ dst,
                                         const TA* __restrict__ src, int J,
                                         bool vec) {
  if (vec) {
    const int pieces = J * static_cast<int>(sizeof(TA)) / 8;
    for (int q = 0; q < pieces; ++q)
      reinterpret_cast<uint2*>(dst)[q] = reinterpret_cast<const uint2*>(src)[q];
  } else {
    for (int j = 0; j < J; ++j) dst[j] = src[j];
  }
}

// Narrow patch: 128 threads a block, a dirty row a thread, tiles of 128.
template <typename TA, typename TT>
__global__ void __launch_bounds__(kPatchNarrow) patch_rows_kernel_narrow(
    const int* __restrict__ ids, const TA* __restrict__ rows_new,
    TA* __restrict__ mirror, const void* __restrict__ b, int b_bf16,
    TT* __restrict__ table, float* __restrict__ partials,
    unsigned* __restrict__ counter, const float* __restrict__ colsum_old,
    float* __restrict__ colsum_new, long long K, int J, int R,
    long long tiles, int vec_rows, int vec_table,
    const unsigned* __restrict__ dirty, const TT* __restrict__ table_old,
    long long I, unsigned nb, int piece) {
  __shared__ __align__(16) float bs[kNarrow * kNarrow];
  __shared__ float red[kPatchNarrow][kNarrow + 1];
  __shared__ float seg[kPatchNarrow];
  __shared__ unsigned ticket;
  if (blockIdx.x >= nb) {
    copy_clean(table_old, table, dirty, I, R * sizeof(TT), nb, piece);
    return;
  }
  stage_b(b, b_bf16, bs, J, R, kNarrow, kNarrow, false);
  __syncthreads();
  float bv[kNarrow][kNarrow];
  b_registers(bs, bv);
  float part[kNarrow];
#pragma unroll
  for (int r = 0; r < kNarrow; ++r) part[r] = 0.f;
  for (long long tile = blockIdx.x; tile < tiles; tile += nb) {
    const long long k = tile * kPatchNarrow + threadIdx.x;
    if (k < K) {
      const long long id = ids[k];
      float ao[kNarrow], an[kNarrow], po[kNarrow], pn[kNarrow];
      load_row(mirror + id * J, J, vec_rows, ao);
      load_row(rows_new + k * J, J, vec_rows, an);
      copy_row(mirror + id * J, rows_new + k * J, J, vec_rows);
      narrow_products(ao, bv, J, po);
      narrow_products(an, bv, J, pn);
      store_row(table + id * R, R, vec_table, pn);
#pragma unroll
      for (int r = 0; r < kNarrow; ++r)
        part[r] = __fadd_rn(part[r], __fsub_rn(pn[r], po[r]));
    }
  }
#pragma unroll
  for (int r = 0; r < kNarrow; ++r) red[threadIdx.x][r] = part[r];
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x < R)
    for (int t = 0; t < kPatchNarrow; ++t)
      total = __fadd_rn(total, red[t][threadIdx.x]);
  fold_blocks(partials, counter, colsum_old, colsum_new, R, nb, total,
              &ticket, seg);
}

// Wide patch: 256 threads a block (three an SM, so the copy blocks run
// beside the patch blocks), tiles of 32 rows (16 row groups of 2).
template <typename TA, typename TT, bool VJ>
__global__ void __launch_bounds__(kThreads, 3) patch_rows_kernel(
    const int* __restrict__ ids, const TA* __restrict__ rows_new,
    TA* __restrict__ mirror, const void* __restrict__ b, int b_bf16,
    TT* __restrict__ table, float* __restrict__ partials,
    unsigned* __restrict__ counter, const float* __restrict__ colsum_old,
    float* __restrict__ colsum_new, long long K, int J, int R,
    long long tiles, int vec_rows, int vec_table,
    const unsigned* __restrict__ dirty, const TT* __restrict__ table_old,
    long long I, unsigned nb, int piece) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float seg[kThreads];
  __shared__ unsigned ticket;
  if (blockIdx.x >= nb) {
    copy_clean(table_old, table, dirty, I, R * sizeof(TT), nb, piece);
    return;
  }
  const int S = (R + 3) & ~3, CG = S / kTN;
  float* bs = reinterpret_cast<float*>(smem);                 // J * S
  float* red = bs + J * S;                                    // 16 * S
  TA* old_t = reinterpret_cast<TA*>(red + kRG * S);           // 32 * J
  TA* new_t = old_t + kPatchRows * J;                         // 32 * J
  stage_b(b, b_bf16, bs, J, R, J, S, true);   // waited with the first gather
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  // the gathers walk (row, piece) of a tile, piece = 16 bytes (vec_rows) or
  // one element: the divisions once a thread, a carry a step
  const int unit = vec_rows ? static_cast<int>(16 / sizeof(TA)) : 1;
  const int per_row = J / unit;
  const int d_row = kThreads / per_row, d_col = kThreads % per_row;
  const int r_first = threadIdx.x / per_row, c_first = threadIdx.x % per_row;
  float part[kTN] = {0.f, 0.f, 0.f, 0.f};
  for (long long tile = blockIdx.x; tile < tiles; tile += nb) {
    const long long k0 = tile * kPatchRows;
    const int rows = static_cast<int>(K - k0 < kPatchRows ? K - k0
                                                          : kPatchRows);
    __syncthreads();   // B staged; the last tile's rows read
    for (int r = r_first, c = c_first; r < rows;) {
      const long long id = ids[k0 + r];
      const int o = r * J + c * unit;
      const TA* src_old = mirror + id * J + c * unit;
      const TA* src_new = rows_new + (k0 + r) * J + c * unit;
      if (vec_rows) {
        cp_async16(old_t + o, src_old, 16);
        cp_async16(new_t + o, src_new, 16);
      } else {
        old_t[o] = *src_old;
        new_t[o] = *src_new;
      }
      r += d_row;
      c += d_col;
      if (c >= per_row) { c -= per_row; ++r; }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = r_first, c = c_first; r < rows;) {
      const long long id = ids[k0 + r];
      const int o = r * J + c * unit;
      TA* dst = mirror + id * J + c * unit;
      if (vec_rows)
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(new_t + o);
      else
        *dst = new_t[o];
      r += d_row;
      c += d_col;
      if (c >= per_row) { c -= per_row; ++r; }
    }
    if (rg < kRG && rg * kPatchTM < rows) {
      float acc[2][kPatchTM][kTN];   // the old rows' products, the new
      const TA* const src[2] = {old_t + rg * kPatchTM * J,
                                new_t + rg * kPatchTM * J};
      micro_tile<2, kPatchTM, VJ>(src, J, bs + cg * kTN, S, acc);
      const float (&po)[kPatchTM][kTN] = acc[0];
      const float (&pn)[kPatchTM][kTN] = acc[1];
      const int n = R - cg * kTN;
#pragma unroll
      for (int i = 0; i < kPatchTM; ++i) {
        const int r = rg * kPatchTM + i;
        if (r < rows) {
          store4(table + static_cast<long long>(ids[k0 + r]) * R + cg * kTN,
                 n, vec_table, pn[i]);
#pragma unroll
          for (int c = 0; c < kTN; ++c)
            part[c] = __fadd_rn(part[c], __fsub_rn(pn[i][c], po[i][c]));
        }
      }
    }
  }
  __syncthreads();
  if (rg < kRG)
#pragma unroll
    for (int c = 0; c < kTN; ++c) red[rg * S + cg * kTN + c] = part[c];
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x < R)
    for (int g = 0; g < kRG; ++g)
      total = __fadd_rn(total, red[g * S + threadIdx.x]);
  fold_blocks(partials, counter, colsum_old, colsum_new, R, nb, total,
              &ticket, seg);
}

// --- shapes and launches ----------------------------------------------------

bool narrow(int J, int R) { return J <= kNarrow && R <= kNarrow; }

bool widths_ok(int J, int R) {
  return J >= 1 && J <= REPRO_MAX_WIDTH && R >= 1 && R <= REPRO_MAX_WIDTH;
}

int pad4(int R) { return (R + 3) & ~3; }

size_t build_smem(int J, int R, size_t elt) {
  return narrow(J, R) ? 0
                      : sizeof(float) * J * pad4(R) + 2 * elt * kBuildRows * J;
}

size_t patch_smem(int J, int R, size_t elt) {
  return narrow(J, R) ? 0
                      : sizeof(float) * (J + kRG) * pad4(R) +
                            2 * elt * kPatchRows * J;
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// Row loads of the narrow route in vectors: J is 4 or 8 and the rows
// aligned to four values.
template <typename TA>
bool narrow_vec(const void* p, int J) {
  return (J == 4 || J == 8) && aligned(p, 4 * sizeof(TA));
}

// Dynamic shared memory above the default 48 kB: once a device a kernel,
// the most any width asks of it (J = R = 64).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t most, bool* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <typename TA>
int launch_build(const void* a, const void* b, int b_bf16, float* out,
                 long long M, int J, int R, long long blocks,
                 long long per_block, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(blocks);
  const TA* at = static_cast<const TA*>(a);
  if (narrow(J, R)) {
    mode_product_rows_kernel_narrow<TA><<<grid, kThreads, 0, st>>>(
        at, b, b_bf16, out, M, J, R, narrow_vec<TA>(a, J),
        (R == 4 || R == 8) && aligned(out, 16));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = build_smem(J, R, sizeof(TA));
  const size_t most = build_smem(REPRO_MAX_WIDTH, REPRO_MAX_WIDTH, sizeof(TA));
  const int vec_in = aligned(a, 16), vec_out = R % 4 == 0 && aligned(out, 16);
  static bool done_v[kMaxDevices], done_s[kMaxDevices];
  cudaError_t err;
  if (J % 4 == 0) {
    err = allow_smem(mode_product_rows_kernel<TA, true>, smem, most, done_v);
    if (err == cudaSuccess)
      mode_product_rows_kernel<TA, true><<<grid, kThreads, smem, st>>>(
          at, b, b_bf16, out, M, J, R, per_block, vec_in, vec_out);
  } else {
    err = allow_smem(mode_product_rows_kernel<TA, false>, smem, most, done_s);
    if (err == cudaSuccess)
      mode_product_rows_kernel<TA, false><<<grid, kThreads, smem, st>>>(
          at, b, b_bf16, out, M, J, R, per_block, vec_in, vec_out);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

struct PatchArgs {
  const int* ids;
  const void* rows;
  void* mirror;
  const void* b;
  int b_bf16;
  void* table;
  float* partials;
  unsigned* counter;
  const float* colsum_old;
  float* colsum_new;
  long long K;
  int J, R;
  long long blocks;       // the patch blocks (the plan's)
  const unsigned* dirty;  // I bits, set at the ids
  const void* table_old;
  long long I;
};

// The copy role's piece: the largest of 16, 8, 4, 2 bytes that divides a
// row and aligns both tables.
int copy_piece(const void* a, const void* b, int row_bytes) {
  for (int piece = 16; piece > 2; piece /= 2)
    if (row_bytes % piece == 0 && aligned(a, piece) && aligned(b, piece))
      return piece;
  return 2;
}

template <typename TA, typename TT>
int launch_patch(const PatchArgs& p, cudaStream_t st) {
  const int row_bytes = p.R * static_cast<int>(sizeof(TT));
  const int piece = copy_piece(p.table_old, p.table, row_bytes);
  const int threads = narrow(p.J, p.R) ? kPatchNarrow : kThreads;
  const long long pieces = p.I * (row_bytes / piece);
  const long long copiers = (pieces + threads - 1) / threads;
  const unsigned nb = static_cast<unsigned>(p.blocks);
  const unsigned grid =
      nb + static_cast<unsigned>(copiers < kCopyBlocks ? copiers
                                                       : kCopyBlocks);
  const TT* table_old = static_cast<const TT*>(p.table_old);
  const int rows_per_tile = narrow(p.J, p.R) ? kPatchNarrow : kPatchRows;
  const long long tiles = (p.K + rows_per_tile - 1) / rows_per_tile;
  const TA* rows = static_cast<const TA*>(p.rows);
  TA* mirror = static_cast<TA*>(p.mirror);
  TT* table = static_cast<TT*>(p.table);
  if (narrow(p.J, p.R)) {
    const int vec_rows =
        narrow_vec<TA>(rows, p.J) && narrow_vec<TA>(mirror, p.J);
    const int vec_table = (p.R == 4 || p.R == 8) &&
                          aligned(table, 4 * sizeof(TT));
    patch_rows_kernel_narrow<TA, TT><<<grid, kPatchNarrow, 0, st>>>(
        p.ids, rows, mirror, p.b, p.b_bf16, table, p.partials, p.counter,
        p.colsum_old, p.colsum_new, p.K, p.J, p.R, tiles, vec_rows,
        vec_table, p.dirty, table_old, p.I, nb, piece);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = patch_smem(p.J, p.R, sizeof(TA));
  const int vec_rows = (p.J * sizeof(TA)) % 16 == 0 && aligned(rows, 16) &&
                       aligned(mirror, 16);
  const int vec_table = p.R % 4 == 0 && aligned(table, 4 * sizeof(TT));
  if (p.J % 4 == 0)
    patch_rows_kernel<TA, TT, true><<<grid, kThreads, smem, st>>>(
        p.ids, rows, mirror, p.b, p.b_bf16, table, p.partials, p.counter,
        p.colsum_old, p.colsum_new, p.K, p.J, p.R, tiles, vec_rows,
        vec_table, p.dirty, table_old, p.I, nb, piece);
  else
    patch_rows_kernel<TA, TT, false><<<grid, kThreads, smem, st>>>(
        p.ids, rows, mirror, p.b, p.b_bf16, table, p.partials, p.counter,
        p.colsum_old, p.colsum_new, p.K, p.J, p.R, tiles, vec_rows,
        vec_table, p.dirty, table_old, p.I, nb, piece);
  return static_cast<int>(cudaGetLastError());
}

// The staged words (the layout patch_table_rows documents) to dev_words in
// one pageable cudaMemcpyAsync, which returns once CUDA has staged the
// host words (so they may be freed at once): the K ids, a 0 (the fold's
// block counter), then from word `bits_at` the I-bit map of the dirty rows.
// Refuses an id outside [0, I).
cudaError_t stage_ids(const int* ids_host, int* dev_words, long long K,
                      long long I, long long bits_at, cudaStream_t st) {
  std::vector<int> words(bits_at + (I + 31) / 32, 0);
  std::memcpy(words.data(), ids_host, sizeof(int) * K);
  unsigned* bits = reinterpret_cast<unsigned*>(words.data() + bits_at);
  for (long long k = 0; k < K; ++k) {
    const int id = ids_host[k];
    if (id < 0 || id >= I) return cudaErrorInvalidValue;
    bits[id >> 5] |= 1u << (id & 31);
  }
  return cudaMemcpyAsync(dev_words, words.data(), sizeof(int) * words.size(),
                         cudaMemcpyHostToDevice, st);
}

}  // namespace

// out (M, R) f32 = a (M, J) times b (J, R); a_bf16 / b_bf16 name the
// storage of a and b.  blocks and per_block: mode_product_rows.py::plan's
// (the narrow route strides over rows; a wide block takes per_block rows,
// a multiple of 8, so every tile starts 16-byte aligned).
extern "C" int mode_product_rows(const void* a, const void* b, float* out,
                                 long long M, int J, int R, long long blocks,
                                 long long per_block, int a_bf16, int b_bf16,
                                 void* stream) {
  if (M < 1 || !widths_ok(J, R) || blocks < 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (narrow(J, R) ? blocks > (M + kNarrowRows - 1) / kNarrowRows ||
                         blocks > kNarrowBlocks
                   : per_block < 1 || per_block % kBuildTM != 0 ||
                         (blocks - 1) * per_block >= M ||
                         blocks * per_block < M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a_bf16 ? launch_build<__nv_bfloat16>(a, b, b_bf16, out, M, J, R,
                                              blocks, per_block, st)
                : launch_build<float>(a, b, b_bf16, out, M, J, R, blocks,
                                      per_block, st);
}

// The patch of K unique rows (ids_host: K int32 on the host, in [0, I)):
// stages the ids and the bit map of the dirty rows into workspace, then one
// launch: the patch blocks write the new product rows into table_new, the
// new factor rows into mirror (I, J) and colsum_new = colsum_old +
// Σ (new − old) over the K rows; the copy blocks copy every other row of
// table_old (I, R) into table_new.  workspace (int32 words): the K ids and
// the block counter, rounded up to 4; ⌈I/32⌉ words of the bit map,
// rounded up to 4; blocks·R floats of partials.  a_bf16 names the storage
// of rows and mirror, b_bf16 of b, t_bf16 of the tables.
extern "C" int patch_table_rows(
    const int* ids_host, int* workspace, long long K, const void* rows,
    void* mirror, const void* b, const void* table_old, void* table_new,
    long long I, const float* colsum_old, float* colsum_new, int J, int R,
    long long blocks, int a_bf16, int b_bf16, int t_bf16, void* stream) {
  const int rows_per_tile = narrow(J, R) ? kPatchNarrow : kPatchRows;
  const long long tiles = K > 0 ? (K + rows_per_tile - 1) / rows_per_tile : 0;
  if (K < 1 || K > I || !widths_ok(J, R) || blocks < 1 || blocks > tiles ||
      blocks > kMaxPatchBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long bits_at = (K + 4) & ~3LL;
  const long long parts_at = bits_at + (((I + 31) / 32 + 3) & ~3LL);
  cudaError_t err = stage_ids(ids_host, workspace, K, I, bits_at, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  PatchArgs p;
  p.ids = workspace;
  p.rows = rows;
  p.mirror = mirror;
  p.b = b;
  p.b_bf16 = b_bf16;
  p.table = table_new;
  p.counter = reinterpret_cast<unsigned*>(workspace + K);
  p.partials = reinterpret_cast<float*>(workspace + parts_at);
  p.colsum_old = colsum_old;
  p.colsum_new = colsum_new;
  p.K = K;
  p.J = J;
  p.R = R;
  p.blocks = blocks;
  p.dirty = reinterpret_cast<const unsigned*>(workspace + bits_at);
  p.table_old = table_old;
  p.I = I;
  if (a_bf16)
    return t_bf16 ? launch_patch<__nv_bfloat16, __nv_bfloat16>(p, st)
                  : launch_patch<__nv_bfloat16, float>(p, st);
  return t_bf16 ? launch_patch<float, __nv_bfloat16>(p, st)
                : launch_patch<float, float>(p, st);
}
