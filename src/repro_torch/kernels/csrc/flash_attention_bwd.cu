// Flash-attention backward (recompute from the saved statistics), Hopper
// (sm_90a), f32.
//
// Counterpart of src/repro/models/flash.py::_flash_bwd, the reference's FA2
// recompute backward (a jnp custom VJP; it has no Pallas kernel).  Same
// function: from q, k, v, the forward's output o, its log-sum-exp lse and
// the output's gradient dO,
//   P  = exp(scale·q·kᵀ − lse)    (0 where masked)
//   Di = Σ_d dO·o                   per query row
//   dV = Pᵀ·dO,   dS = P ∘ (dO·vᵀ − Di),   dQ = scale·dS·k,   dK = scale·dSᵀ·q
// with the masks of the forward kernel: keys at or past kv_len excluded,
// causal or not, query i at position q_offset + i.  The layouts are the
// forward's: q, o, dO (B, Sq, H, D), k, v (B, Sk, H/G, D), addressed through
// their (batch, sequence, head) strides with D contiguous (q, k, v and dO
// on 16-byte boundaries with strides in 16-byte units: the wrapper checks);
// query head h reads key/value head h / G in place.  lse is (B, H, Sq),
// contiguous, in natural-log units of the scaled logits (the forward writes
// it).  dq, dk, dv are written contiguous in q's and k's shapes.
//
// Design (one launch of each of three kernels; 8 warps a block, 16 rows a
// warp, one block an SM):
//   * dot_kernel: Di, one warp per (b, query, head) row;
//   * dkdv_kernel: one block per (128-key tile, KV head, b).  K and V stay
//     in shared memory; 32-query tiles of Q and dO, for each of the G query
//     heads of the group and each query tile that can see the block's keys,
//     come through a double-buffered cp.async ring (16-byte copies).  Each
//     warp computes Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ, for its 16 keys (keys as
//     rows), so that Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ − Di) sit in m16n8 accumulators
//     that are, register for register, the A fragments of dV += Pᵀ·dO and
//     dK += dSᵀ·Q (mma_tf32.cuh); dO and Q are then read as B along the
//     query index with the same permutation.  lse and Di are per column
//     (query) and come from the L1-cached rows;
//   * dq_kernel: one block per (128-query tile, head, b), Q and dO in
//     shared memory, 32-key tiles of K and V through the same kind of ring:
//     S = Q·Kᵀ and dP = dO·Vᵀ per warp, then dQ += dS·K with dS's
//     accumulator as the A fragment and K read like the forward's V.
// Both grids are one-dimensional with the tile index slowest, so the
// blocks with the most causal work (key tile 0; the last query tile) are
// issued first and the shortest fill in at the end (the dK/dV pass has
// 256 blocks of 20 to 320 tiles of work at the training shape; in a 3-D
// grid's order the longest would start last).
// dQ is this second pass (S and dP computed again: seven products for the
// function's five), not a workspace of per-key-tile partials: no atomics,
// no scratch beyond Di, every output element written once, by one warp,
// after a loop of fixed order, so two calls give the same bits.
// All five products run on the tensor cores in 3xTF32 (m16n8k8 mma.sync,
// f32 accuracy): each ring tile is split into its big and small TF32 parts
// once for the block (split_smem); the resident tiles (K, V; Q, dO), read as
// A, are split per use in registers; P and dS are split once per tile.
// Fragments read along rows come in with ldmatrix (one x4 load of 16-byte
// rows for a whole A fragment, or for a B fragment's big and small parts);
// those read along columns (B of the three products over the query or key
// index) are four 32-bit loads.  The tensor cores do not round to nearest
// when they accumulate, so dV, dK and dQ chain only one tile's products (4
// k-steps, 12 mma) into fresh zero accumulators and add them to the running
// f32 sums, dV's chain before dK's.  Shared rows: the resident tiles, read
// only as rows, are D floats with the 16-byte chunks of each 128-byte
// segment permuted by the row's low three bits (rows of D + 4 floats at
// D = 16); the ring tiles, read both as rows and along columns, are D + 4
// floats.  Every fragment load is then free of bank conflicts, and at
// D = 128 each kernel takes 232,448 bytes, all an SM gives a block.
// Registers (ptxas, sm_90a): at D = 128 the dK and dV sums take 128 a
// thread; dkdv_kernel<128> uses 255 with 104 bytes of spill stores, the
// other kernels spill nothing.  Tiles that lie wholly past kv_len or
// wholly above the causal diagonal are not loaded (per block) or not
// multiplied (per warp).  IEEE exp2f; one pass of TF32 is never used: f32
// means f32.
//
// Bound on the card.  The LM's training shape (B = 2, H = 40 over Kv = 8,
// S = 2048, D = 128, causal): five (S × S × D) products (Qkᵀ, dO vᵀ, Pᵀ dO,
// dS k, dSᵀ q) of causal work, 2.5 × the forward's two, 214.8 GFLOP; as
// 3xTF32 at 495 TFLOP/s on the tensor cores, the units they run on: 1.30
// ms (the same work at the 67 TFLOP/s f32 SIMT peak: 3.21 ms).  This
// design does seven products (the dQ pass recomputes Qkᵀ and dO vᵀ), 1.82
// ms of tensor-core work.  The bytes (q, k, v, o, dO, lse in; dq, dk, dv
// out; 403 MB) take 0.12 ms.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 16 * WARPS;   // dK/dV pass: keys per block
constexpr int NQ = 32;           // ... queries per ring tile
constexpr int BQ = 16 * WARPS;   // dQ pass: queries per block
constexpr int NK = 32;           // ... keys per ring tile
constexpr int PASSES = kPasses<false, false>;   // every product, f32 x f32
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {   // (batch, sequence, head) strides, in elements
  long long b, s, h;
};

// Shared layouts of a (rows, D) f32 tile, element (r, c).
template <int D>
struct Lay {
  // resident tiles, read as rows: chunks permuted (D + 4 padding at D = 16)
  static constexpr int RES = D == 16 ? D + 4 : D;
  // ring tiles, read as rows and along columns
  static constexpr int RING = D + 4;
  static __device__ __forceinline__ int res(int r, int c) {
    if constexpr (D == 16) return r * RES + c;
    else return r * D + (c ^ ((r & 7) << 2));
  }
  static __device__ __forceinline__ int ring(int r, int c) {
    return r * RING + c;
  }
  // one ring stage: two tiles of 32 rows (Q and dO, or K and V)
  static constexpr int STAGE = 2 * 32 * RING;
  // resident tiles, two ring stages, the small parts of the landed stage
  static constexpr int FLOATS = 2 * 128 * RES + 3 * STAGE;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};
static_assert(BK == 128 && BQ == 128 && NQ == 32 && NK == 32,
              "Lay<D> is laid out for these tiles");

// rows [r0, r0 + n) of one head (row stride ss) into a tile, 16-byte
// cp.async copies; rows at or past lim are zero-filled
template <int D, bool RESIDENT>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long ss, int r0, int n,
                                          int lim) {
  constexpr int CH = D / 4;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool in = r0 + r < lim;
    const int o = RESIDENT ? Lay<D>::res(r, c) : Lay<D>::ring(r, c);
    cp_async16(dst + o, in ? src + (r0 + r) * ss + c : src, in ? 16 : 0);
  }
}

// Four 8 x 4 f32 matrices of shared memory, one 16-byte row per lane
// address (lanes 8m..8m+7: rows of matrix m): r[m] = matrix m's (g, t).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of rows r0.., k-step kd of a resident tile (raw f32),
// split: a = X[g][t], X[g+8][t], X[g][t+4], X[g+8][t+4] of the k8 block
// (k in its natural order; the B side of these products reads the same).
template <int D>
__device__ __forceinline__ void a_rows(const float* X, int r0, int kd,
                                       Frag<4>& f) {
  const int i = threadIdx.x % 32;
  uint32_t r[4];
  ldsm_x4(r, X + Lay<D>::res(r0 + i % 8 + 8 * (i / 8 % 2),
                             kd * 8 + 4 * (i / 16)));
  const float v[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]),
                      __uint_as_float(r[2]), __uint_as_float(r[3])};
  frag_split<false>(v, f);
}

// The B fragment (k = d, n = row) of rows n0.. of a split ring tile: rows
// n0 + g, columns 8kd + t and 8kd + t + 4.
template <int D>
__device__ __forceinline__ Frag<2> b_rows(const float* big,
                                          const float* small, int n0,
                                          int kd) {
  const int i = threadIdx.x % 32;
  uint32_t r[4];
  ldsm_x4(r, (i < 16 ? big : small) +
                 Lay<D>::ring(n0 + i % 8, kd * 8 + 4 * (i / 8 % 2)));
  return {{r[0], r[1]}, {r[2], r[3]}};
}

// The B fragment (k = row, n = d) of a split ring tile, k permuted as the
// accumulator-as-A fragment is (mma_tf32.cuh): rows k0 + 2t and k0 + 2t + 1,
// column 8d + g.
template <int D>
__device__ __forceinline__ Frag<2> b_cols(const float* big,
                                          const float* small, int k0,
                                          int d) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int o = Lay<D>::ring(k0 + 2 * t, d * 8 + g);
  constexpr int R = Lay<D>::RING;
  return {{__float_as_uint(big[o]), __float_as_uint(big[o + R])},
          {__float_as_uint(small[o]), __float_as_uint(small[o + R])}};
}

// x = A·Bᵀ for the 16 resident rows of this warp (A, split per use) and
// the 32 rows of a split ring tile (B): 4 n8 tiles, k = d.
template <int D>
__device__ __forceinline__ void tile_scores(const float* A, const float* big,
                                            const float* small,
                                            float (&x)[4][4]) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 8; ++kd) {
    Frag<4> a;
    a_rows<D>(A, 16 * warp, kd, a);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma_3xtf32<false, false>(x[j], a, b_rows<D>(big, small, 8 * j, kd));
  }
}

// acc += A·B over the 4 k-steps of one 32-row ring tile: A the split
// accumulator fragments a[kk] (rows of this warp, k = the tile's rows), B
// the tile's columns; each group of up to 4 n8 tiles chains into fresh
// zero accumulators that are then added to acc in f32.
template <int D>
__device__ __forceinline__ void tile_product(const Frag<4> (&a)[4],
                                             const float* big,
                                             const float* small,
                                             float (&acc)[D / 8][4]) {
  constexpr int DK = D / 8;
  constexpr int DG = DK < 4 ? DK : 4;
#pragma unroll
  for (int d0 = 0; d0 < DK; d0 += DG) {
    float f[DG][4];
#pragma unroll
    for (int i = 0; i < DG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < DG; ++i)
        mma_3xtf32<false, false>(f[i], a[kk],
                                 b_cols<D>(big, small, 8 * kk, d0 + i));
#pragma unroll
    for (int i = 0; i < DG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d0 + i][e] += f[i][e];
  }
}

// The split A fragments of a 16 x 32 accumulator (4 n8 tiles) for a
// product over its 32 columns: d[0], d[2], d[1], d[3] (mma_tf32.cuh).
__device__ __forceinline__ void acc_as_a(const float (&x)[4][4],
                                         Frag<4> (&a)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float v[4] = {x[kk][0], x[kk][2], x[kk][1], x[kk][3]};
    frag_split<false>(v, a[kk]);
  }
}

// rows r0 + g and r0 + g + 8 (below lim) of one head of out: acc · mul
template <int D>
__device__ __forceinline__ void store_rows(float* out, long long ss, int r0,
                                           int lim, float mul,
                                           const float (&acc)[D / 8][4]) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    if (r >= lim) continue;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<float2*>(out + r * ss + d * 8 + 2 * t) =
          make_float2(acc[d][2 * hf] * mul, acc[d][2 * hf + 1] * mul);
  }
}

// Di = Σ_d dO·o for one (b, query, head) row per warp
__global__ void __launch_bounds__(THREADS) dot_kernel(
    const float* __restrict__ o, const float* __restrict__ dout,
    float* __restrict__ di, int B, int Sq, int H, int D, Strides os,
    Strides ds) {
  const long long row = (static_cast<long long>(blockIdx.x) * THREADS
                         + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(B) * H * Sq) return;   // warp-uniform
  const int q = static_cast<int>(row % Sq);
  const int h = static_cast<int>((row / Sq) % H);
  const int b = static_cast<int>(row / (static_cast<long long>(Sq) * H));
  const float* op = o + b * os.b + q * os.s + h * os.h;
  const float* dp = dout + b * ds.b + q * ds.s + h * ds.h;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(op[d], dp[d], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(REPRO_FULL_MASK, s, off);
  if (lane == 0) di[row] = s;   // row = (b·H + h)·Sq + q
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dk, float* __restrict__ dv, int B, int Sq, int Sk,
    int H, int G, Strides qs, Strides ks, Strides vs, Strides dos, int kv_len,
    int q_offset, int causal, float scale) {
  constexpr int DK = D / 8;     // k8 steps of Sᵀ; n8 tiles of dK, dV
  using L = Lay<D>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * L::RES;
  float* ring = Vs + BK * L::RES;      // two stages: Q then dO
  float* Sm = ring + 2 * L::STAGE;     // small parts of the landed stage

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // one block per (key tile, KV head, b), the key tile slowest: every
  // block of key tile 0 (causal: the most work) is issued first
  const int Hk = H / G;
  const int hk = blockIdx.x % Hk;
  const int b = (blockIdx.x / Hk) % B;
  const int k0 = blockIdx.x / (Hk * B) * BK;
  const int k_lim = min(kv_len, Sk);
  const float scale2 = scale * LOG2E;
  const int kw = k0 + 16 * warp;                 // this warp's first key
  const int keys[2] = {kw + g, kw + g + 8};      // this thread's two keys

  // the query tiles that see a key of this block (causal: from the first
  // query at or past k0), for each of the group's G heads in turn
  const int nq = (Sq + NQ - 1) / NQ;
  int qt0 = causal ? max(0, k0 - q_offset) / NQ : 0;
  if (k0 >= k_lim) qt0 = nq;   // no visible key in this tile
  const int per_head = nq - qt0;
  const int ntiles = G * per_head;

  auto load = [&](int it) {
    const int h = hk * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * NQ;
    float* st = ring + (it & 1) * L::STAGE;
    copy_rows<D, false>(st, q + b * qs.b + h * qs.h, qs.s, q0, NQ, Sq);
    copy_rows<D, false>(st + NQ * L::RING, dout + b * dos.b + h * dos.h,
                        dos.s, q0, NQ, Sq);
  };

  float acc_k[DK][4], acc_v[DK][4];
#pragma unroll
  for (int d = 0; d < DK; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[d][e] = acc_v[d][e] = 0.f;

  if (ntiles > 0) {
    copy_rows<D, true>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BK, k_lim);
    copy_rows<D, true>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BK, k_lim);
    load(0);
  }
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    const int h = hk * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * NQ;
    // this thread's columns' lse (base 2) and Di: queries q0 + 8j + 2t + e
    const float* lh = lse + (static_cast<long long>(b) * H + h) * Sq;
    const float* dih = di + (static_cast<long long>(b) * H + h) * Sq;
    float lq[4][2], dc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = q0 + 8 * j + 2 * t + e;
        lq[j][e] = c < Sq ? __ldg(lh + c) * LOG2E : 0.f;
        dc[j][e] = c < Sq ? __ldg(dih + c) : 0.f;
      }
    cp_async_wait<1>();   // tile it (and K, V) landed: this thread's copies
    __syncthreads();      // ... and every thread's
    float* Qb = ring + (it & 1) * L::STAGE;
    split_smem(Qb, Sm, L::STAGE / 4);   // big parts in place, small to Sm
    __syncthreads();
    // a warp whose keys are all masked for this tile adds nothing
    const bool live = kw < k_lim &&
        (!causal || kw <= q_offset + min(q0 + NQ, Sq) - 1);
    if (live) {
      const float* dOb = Qb + NQ * L::RING;
      const float* Qsm = Sm;
      const float* dOsm = Sm + NQ * L::RING;
      // Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ: this warp's 16 keys × the 32 queries
      // (one after the other: the dK and dV sums hold 128 registers at
      // D = 128); element (key g + 8hf, query 8j + 2t + e)
      float s[4][4], dp[4][4];
      tile_scores<D>(Ks, Qb, Qsm, s);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = q0 + 8 * j + 2 * t + e, key = keys[hf];
            const bool ok = qi < Sq && key < k_lim &&
                            (!causal || q_offset + qi >= key);
            s[j][2 * hf + e] =
                ok ? exp2f(s[j][2 * hf + e] * scale2 - lq[j][e]) : 0.f;
          }
      tile_scores<D>(Vs, dOb, dOsm, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)   // dSᵀ = Pᵀ ∘ (dPᵀ − Di)
          dp[j][e] = s[j][e] * (dp[j][e] - dc[j][e % 2]);
      Frag<4> a[4];
      acc_as_a(s, a);
      tile_product<D>(a, dOb, dOsm, acc_v);   // dV += Pᵀ·dO
      acc_as_a(dp, a);
      tile_product<D>(a, Qb, Qsm, acc_k);     // dK += dSᵀ·Q
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  const long long kss = static_cast<long long>(Hk) * D;   // contiguous
  const long long base = static_cast<long long>(b) * Sk * kss + hk * D;
  store_rows<D>(dk + base, kss, kw, Sk, scale, acc_k);
  store_rows<D>(dv + base, kss, kw, Sk, 1.f, acc_v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dq, int B, int Sq, int Sk, int H, int G,
    Strides qs,
    Strides ks, Strides vs, Strides dos, int kv_len, int q_offset,
    int causal, float scale) {
  constexpr int DK = D / 8;
  using L = Lay<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * L::RES;
  float* ring = dOs + BQ * L::RES;     // two stages: K then V
  float* Sm = ring + 2 * L::STAGE;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // one block per (query tile, head, b), the query tile slowest and the
  // last first: causal, its rows see the most keys
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int q0 = ((Sq + BQ - 1) / BQ - 1 - blockIdx.x / (H * B)) * BQ;
  const int hk = h / G;
  const int k_lim = min(kv_len, Sk);
  const float scale2 = scale * LOG2E;
  const int qw = q0 + 16 * warp;                 // this warp's first query
  const int rows[2] = {qw + g, qw + g + 8};      // this thread's two rows

  const float* lh = lse + (static_cast<long long>(b) * H + h) * Sq;
  const float* dih = di + (static_cast<long long>(b) * H + h) * Sq;
  float lrow[2], drow[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lrow[hf] = rows[hf] < Sq ? lh[rows[hf]] * LOG2E : 0.f;
    drow[hf] = rows[hf] < Sq ? dih[rows[hf]] : 0.f;
  }

  int k_end = k_lim;
  if (causal) k_end = min(k_end, q_offset + min(q0 + BQ, Sq));
  const int ntiles = (max(k_end, 0) + NK - 1) / NK;
  // the last key position this warp's rows can see
  const int w_last = q_offset + min(qw + 15, Sq - 1);
  const float* kh = k + b * ks.b + hk * ks.h;
  const float* vh = v + b * vs.b + hk * vs.h;

  auto load = [&](int it) {
    float* st = ring + (it & 1) * L::STAGE;
    copy_rows<D, false>(st, kh, ks.s, it * NK, NK, k_lim);
    copy_rows<D, false>(st + NK * L::RING, vh, vs.s, it * NK, NK, k_lim);
  };

  float acc[DK][4];
#pragma unroll
  for (int d = 0; d < DK; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  if (ntiles > 0) {
    copy_rows<D, true>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, Sq);
    copy_rows<D, true>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, BQ,
                       Sq);
    load(0);
  }
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* Kb = ring + (it & 1) * L::STAGE;
    split_smem(Kb, Sm, L::STAGE / 4);
    __syncthreads();
    const int k0 = it * NK;
    if (qw < Sq && (!causal || k0 <= w_last)) {
      const float* Vb = Kb + NK * L::RING;
      const float* Ksm = Sm;
      const float* Vsm = Sm + NK * L::RING;
      // S = Q·Kᵀ and dP = dO·Vᵀ: this warp's 16 queries × the 32 keys
      float s[4][4], dp[4][4];
      tile_scores<D>(Qs, Kb, Ksm, s);
      tile_scores<D>(dOs, Vb, Vsm, dp);
      // dS in place; element (query g + 8hf, key 8j + 2t + e)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t + e, qi = rows[hf];
            const bool ok = qi < Sq && key < k_lim &&
                            (!causal || q_offset + qi >= key);
            const float p =
                ok ? exp2f(s[j][2 * hf + e] * scale2 - lrow[hf]) : 0.f;
            dp[j][2 * hf + e] = p * (dp[j][2 * hf + e] - drow[hf]);
          }
      Frag<4> a[4];
      acc_as_a(dp, a);
      tile_product<D>(a, Kb, Ksm, acc);   // dQ += dS·K
    }
    __syncthreads();
  }
  const long long qss = static_cast<long long>(H) * D;   // contiguous
  store_rows<D>(dq + static_cast<long long>(b) * Sq * qss + h * D, qss, qw,
                Sq, scale, acc);
}

// The plan this build runs (flash_attention_bwd.py's plan(), in order):
// warps a block; keys and queries of a dK/dV block's tiles; queries and
// keys of a dQ block's tiles; the tensor-core passes of the five products
// (S, dP, dV, dK, dQ), 2 bits each; the dynamic shared bytes of the dK/dV
// and of the dQ kernel; the x extents of the dot, dK/dV and dQ grids.
constexpr int PLAN = 11;

template <int D>
bool plan_matches(const int* plan, int B, int Sq, int Sk, int H, int Hk) {
  const long long rows = static_cast<long long>(B) * H * Sq;
  const long long want[PLAN] = {
      WARPS, BK, NQ, BQ, NK, PASSES * (1 + 4 + 16 + 64 + 256),
      static_cast<long long>(Lay<D>::BYTES),
      static_cast<long long>(Lay<D>::BYTES),
      (rows * 32 + THREADS - 1) / THREADS,
      static_cast<long long>((Sk + BK - 1) / BK) * Hk * B,
      static_cast<long long>((Sq + BQ - 1) / BQ) * H * B};
  for (int i = 0; i < PLAN; ++i)
    if (plan[i] != want[i]) return false;
  return true;
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* di, float* dq,
           float* dk, float* dv, int B, int Sq, int Sk, int H, int G,
           const Strides* st, int kv_len, int q_offset, int causal,
           float scale, const int* plan, cudaStream_t stream) {
  if (!plan_matches<D>(plan, B, Sq, Sk, H, H / G))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Lay<D>::BYTES));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(Lay<D>::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dot_kernel<<<static_cast<unsigned>(plan[8]), THREADS, 0, stream>>>(
      o, dout, di, B, Sq, H, D, st[3], st[4]);
  dkdv_kernel<D><<<static_cast<unsigned>(plan[9]), THREADS, Lay<D>::BYTES,
                    stream>>>(q, k, v, dout, lse, di, dk, dv, B, Sq, Sk, H, G,
                              st[0], st[1], st[2], st[4], kv_len, q_offset,
                              causal, scale);
  dq_kernel<D><<<static_cast<unsigned>(plan[10]), THREADS, Lay<D>::BYTES,
                  stream>>>(q, k, v, dout, lse, di, dq, B, Sq, Sk, H, G,
                            st[0], st[1], st[2], st[4], kv_len, q_offset,
                            causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 15 values, (batch, seq, head) of q, k, v, o and dO, in elements.
// di: a (B, H, Sq) f32 workspace.  dq (B, Sq, H, D), dk and dv (B, Sk, Hk, D)
// are written contiguous.  plan: the wrapper's plan (PLAN ints, above),
// refused unless it is this build's.
extern "C" int flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* di, float* dq, float* dk,
    float* dv, int B, int Sq, int Sk, int H, int Hk, int D,
    const long long* strides, int kv_len, int q_offset, int causal,
    float scale, const int* plan, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || Hk < 1 || H % Hk != 0 ||
      kv_len < 1 || q_offset < 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[5];
  for (int i = 0; i < 5; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int G = H / Hk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, dout, lse, di, dq, dk, dv, B, Sq,
                               Sk, H, G, st, kv_len, q_offset, causal, scale,
                               plan, s);
    case 32: return launch<32>(q, k, v, o, dout, lse, di, dq, dk, dv, B, Sq,
                               Sk, H, G, st, kv_len, q_offset, causal, scale,
                               plan, s);
    case 64: return launch<64>(q, k, v, o, dout, lse, di, dq, dk, dv, B, Sq,
                               Sk, H, G, st, kv_len, q_offset, causal, scale,
                               plan, s);
    case 128: return launch<128>(q, k, v, o, dout, lse, di, dq, dk, dv, B,
                                 Sq, Sk, H, G, st, kv_len, q_offset, causal,
                                 scale, plan, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
