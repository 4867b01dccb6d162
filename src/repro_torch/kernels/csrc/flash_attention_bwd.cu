// Flash-attention backward (recompute from the saved statistics), Hopper
// (sm_90a), f32 arithmetic on f32 or bf16 inputs.
//
// Counterpart of src/repro/models/flash.py::_flash_bwd, the reference's FA2
// recompute backward (a jnp custom VJP; it has no Pallas kernel).  Same
// function: from q, k, v, the forward's output o, its log-sum-exp lse and
// the output's gradient dO,
//   P  = exp(scale·q·kᵀ − lse)    (0 where masked)
//   Di = Σ_d dO·o                   per query row, over v's width Dv
//   dV = Pᵀ·dO,   dS = P ∘ (dO·vᵀ − Di),   dQ = scale·dS·k,   dK = scale·dSᵀ·q
// with the masks of the forward kernel: keys at or past kv_len excluded,
// causal or not, query i at position q_offset + i.  The layouts are the
// forward's: q (B, Sq, H, D), o and dO (B, Sq, H, Dv), k (B, Sk, H/G, D),
// v (B, Sk, H/G, Dv), addressed through their (batch, sequence, head)
// strides with the last dimension contiguous (every base on a 16-byte
// boundary with strides in 16-byte units: the wrapper checks); query head
// h reads key/value head h / G in place.  The widths (D, Dv) are D = Dv in
// {16, 32, 64, 80, 128} (80: HuBERT-XLarge's 1280 / 16), or (192, 128):
// MLA's (DeepSeek-V2: q·k over 128 + 64 rope dims, v at 128), the scale
// 1/sqrt(D) of the q·k width.  lse is
// (B, H, Sq) f32, contiguous, in natural-log units of the scaled logits
// (the forward writes it).  dq, dk, dv are written f32, contiguous in q's,
// k's and v's shapes.  q, k, v, o and dO are all f32 or all bf16; bf16 is
// read in place, widened to f32 on its way into shared memory, and the
// arithmetic after that is the f32 route's, operation for operation (see
// "bf16" below).
//
// Design (one launch of each of three kernels; 8 warps a block, 16 rows a
// warp, one block an SM):
//   * dot_kernel: Di, one warp per (b, query, head) row;
//   * dkdv_kernel: one block per (128-key tile, KV head, b).  K and V stay
//     in shared memory; NT-query tiles of Q and dO, for each of the G query
//     heads of the group and each query tile that can see the block's keys,
//     come through a double-buffered cp.async ring (16-byte copies).  Each
//     warp computes Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ, for its 16 keys (keys as
//     rows), so that Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ − Di) sit in m16n8 accumulators
//     that are, register for register, the A fragments of dV += Pᵀ·dO and
//     dK += dSᵀ·Q (mma_tf32.cuh); dO and Q are then read as B along the
//     query index with the same permutation.  lse and Di are per column
//     (query) and come from the L1-cached rows;
//   * dq_kernel: one block per (128-query tile, head, b), Q and dO in
//     shared memory, NT-key tiles of K and V through the same kind of ring:
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
// All five products run on the tensor cores in 3xTF32 on f32 inputs
// (m16n8k8 mma.sync, f32 accuracy; bf16 below): each ring tile is split
// into its big and small TF32 parts once for the block (split_smem); the
// resident tiles (K, V; Q, dO), read as A, are split per use in registers;
// P and dS are split once per tile.
// Fragments read along rows come in with ldmatrix (one x4 load of 16-byte
// rows for a whole A fragment, or for a B fragment's big and small parts);
// those read along columns (B of the three products over the query or key
// index) are four 32-bit loads.  The tensor cores do not round to nearest
// when they accumulate, so dV, dK and dQ chain only one tile's products
// (NT/8 k-steps) into fresh zero accumulators and add them to the running
// f32 sums, dV's chain before dK's.  Shared rows: the resident tiles, read
// only as rows, are their width in floats with the 16-byte chunks of each
// 128-byte segment permuted by the row's low three bits where the width is
// a multiple of 32 floats; at 16 and 80, where the last segment is not
// whole and a permuted chunk would land in the next row, rows of width + 4
// floats (an ldmatrix phase's eight rows then start at banks 20r mod 32,
// eight distinct 4-bank groups); the ring tiles, read both as rows and
// along columns, are their width + 4 floats.  Every fragment load is then
// free of bank conflicts.  Tiles that lie wholly past kv_len or wholly
// above the causal diagonal are not loaded (per block) or not multiplied
// (per warp).  IEEE exp2f; one pass of TF32 is never used on f32 data: f32
// means f32.
//
// The ring tiles' height NT.  At D = Dv (NT = 32) the two resident 128-row
// tiles and three ring stages take 232,448 bytes at D = 128, all an SM
// gives a block; at D = 80 (rows of 84 floats) 150,528.  At (192, 128)
// the resident tiles are 128 × 192 and 128 × 128 floats (K and V; Q and
// dO) and a stage 32 × 196 + 32 × 132: 289,792 bytes at NT = 32, which
// does not fit.  Two ways out: ring tiles
// of 16 rows (226,816 bytes) or resident tiles of 64 rows (207,872).  This
// kernel takes NT = 16: each warp then holds a 16 × 16 Sᵀ and dPᵀ and two
// A fragments instead of 16 × 32 and four, which pays for dK's 192
// columns (dK and dV hold 160 accumulator floats a thread against 128 at
// D = 128), so a thread's registers stay near D = 128's; 64-row resident
// tiles would keep 32-query tiles and the 160 sums, and halve the warps
// that share each tile brought in (twice the ring's copies from L2).  The
// cost: twice the ring's barriers and splits per query.
//
// bf16.  A bf16 value is exact in f32 and in TF32 (its small part is 0),
// so the bf16 instances keep the f32 route's tiles and orders and issue
// only the passes whose operands are not exact: S = q·kᵀ and dP = dO·vᵀ
// (bf16 × bf16) one pass each, dV = Pᵀ·dO, dK = dSᵀ·q and dQ = dS·k (the
// f32 P or dS × bf16) two each (the plan's passes, which the C entry
// checks).  A pass of exact zeros adds nothing to its accumulator, so
// they give the f32 kernel's bits on the inputs widened to f32.  The
// resident tiles are loaded once a block with 16-byte loads of 8 values,
// widened, and stored as f32 (their fragments then need no split); each
// ring tile lands by cp.async in a bf16 landing zone (two, in the space of
// the second f32 stage) and is widened into the first stage, with no small
// parts (the f32 route's third stage stays unused: 32-row ring tiles at
// (192, 128) would still need 246,784 bytes).  Di reads o and dO as bf16.
//
// Registers (ptxas, sm_90a): at D = 128 the dK and dV sums take 128 a
// thread; dkdv_kernel<128, 128, 32> uses 255 with 92 bytes of spill
// stores (68 for bf16), the other kernels of D = Dv spill nothing.  At
// (192, 128) both kernels use 255: dkdv spills 28 bytes (36 for bf16), dq
// 8 (none).  The splits round by integer adds (mma_tf32.cuh): with
// cvt.rna the f32 call at (192, 128) took 3.96 ms on the H100, with them
// 3.49.
//
// Bound on the card.  The LM's training shape (B = 2, H = 40 over Kv = 8,
// S = 2048, D = 128, causal): five (S × S × D) products (Qkᵀ, dO vᵀ, Pᵀ dO,
// dS k, dSᵀ q) of causal work, 2.5 × the forward's two, 214.8 GFLOP; as
// 3xTF32 at 495 TFLOP/s on the tensor cores, the units they run on: 1.30
// ms (the same work at the 67 TFLOP/s f32 SIMT peak: 3.21 ms).  This
// design does seven products (the dQ pass recomputes Qkᵀ and dO vᵀ), 1.82
// ms of tensor-core work.  The bytes (q, k, v, o, dO, lse in; dq, dk, dv
// out; 403 MB) take 0.12 ms.  MLA's training shape (B = 2, H = Kv = 16,
// S = 2048, (192, 128), causal): B·H·S²·(192 + 128 + 128 + 192 + 192)
// = 111.7 GFLOP of causal work, 0.677 ms as 3xTF32 (1.667 ms at the f32
// SIMT peak); with the dQ pass's recompute 154.6 GFLOP, 0.937 ms.  In
// bf16 (S and dP one pass, the rest two) 0.365 ms.  HuBERT-XLarge's
// (B = 4, H = Kv = 16, S = 1500, D = Dv = 80, non-causal): 5 · 2·B·H·S²·D
// = 115.2 GFLOP, 0.698 ms as 3xTF32, 0.372 ms in bf16.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 16 * WARPS;   // dK/dV pass: keys per block
constexpr int BQ = 16 * WARPS;   // dQ pass: queries per block
// A bf16 value is exact in TF32 (its small part is 0), so a bf16 operand
// skips its small pass: with T = bf16, S and dP (bf16 x bf16) take 1 pass,
// dV, dK and dQ (the f32 P or dS times bf16 dO, Q or K) 2; f32 takes 3.
template <typename T>
constexpr bool kExact = sizeof(T) == 2;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {   // (batch, sequence, head) strides, in elements
  long long b, s, h;
};

// Shared layouts of a (rows, W) f32 tile, element (r, c).
template <int W>
struct Lay {
  // resident tiles, read as rows: chunks permuted in whole 128-byte
  // segments, else rows padded to W + 4 (16 and 80)
  static constexpr bool PERMUTED = W % 32 == 0;
  static constexpr int RES = PERMUTED ? W : W + 4;
  // ring tiles, read as rows and along columns
  static constexpr int RING = W + 4;
  static __device__ __forceinline__ int res(int r, int c) {
    if constexpr (!PERMUTED) return r * RES + c;
    else return r * W + (c ^ ((r & 7) << 2));
  }
  static __device__ __forceinline__ int ring(int r, int c) {
    return r * RING + c;
  }
};

// A block's shared memory: two resident 128-row tiles (widths D and DV:
// K and V, or Q and dO), two ring stages of an NT-row tile at each width
// (Q and dO, or K and V), and the small parts of the landed stage.  The
// bf16 route lands its tiles in the second stage's space (two bf16 zones
// of NT·(D + DV) values each) and widens them into the first.
template <int D, int DV, int NT>
struct Smem {
  static constexpr int RES_A = 128 * Lay<D>::RES;
  static constexpr int RES_B = 128 * Lay<DV>::RES;
  static constexpr int TILE_A = NT * Lay<D>::RING;   // stage: A, then B
  static constexpr int STAGE = TILE_A + NT * Lay<DV>::RING;
  static constexpr int LAND = NT * (D + DV) / 2;     // a bf16 zone, floats
  static constexpr int FLOATS = RES_A + RES_B + 3 * STAGE;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  static_assert(2 * LAND <= STAGE, "two bf16 zones fill one f32 stage");
  static_assert(BYTES <= 232448, "a block's shared memory is at most 227 KB");
};
static_assert(BK == 128 && BQ == 128, "Smem is laid out for these tiles");

// rows [r0, r0 + n) of one head (row stride ss) into a resident tile of
// width W; rows at or past lim are zero-filled.  f32: 16-byte cp.async
// copies; bf16: 16-byte loads of 8 values, widened and stored as f32.
template <int W, typename T>
__device__ __forceinline__ void load_resident(float* dst, const T* src,
                                              long long ss, int r0, int n,
                                              int lim) {
  constexpr int V = 16 / sizeof(T);   // values per 16-byte chunk
  constexpr int CH = W / V;           // chunks per row
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * V;
    const bool in = r0 + r < lim;
    if constexpr (V == 4) {
      cp_async16(dst + Lay<W>::res(r, c), in ? src + (r0 + r) * ss + c : src,
                 in ? 16 : 0);
    } else {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (in)
        widen8(__ldg(reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c)),
               f);
      *reinterpret_cast<float4*>(dst + Lay<W>::res(r, c)) =
          make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(dst + Lay<W>::res(r, c + 4)) =
          make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// rows [r0, r0 + NT) of one head into a ring tile of width W: f32 as raw
// f32 at its ring layout, bf16 into rows of W values of a landing zone;
// rows at or past lim are zero-filled.  16-byte cp.async copies.
template <int W, int NT, typename T>
__device__ __forceinline__ void load_ring(T* dst, const T* src, long long ss,
                                          int r0, int lim) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = W / V;
  for (int i = threadIdx.x; i < NT * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * V;
    const bool in = r0 + r < lim;
    const int o = V == 4 ? Lay<W>::ring(r, c) : r * W + c;
    cp_async16(dst + o, in ? src + (r0 + r) * ss + c : src, in ? 16 : 0);
  }
}

// The ring of one block: stage `it & 1` of tile it (f32), or the landing
// zones (bf16), and the big and small parts the products read.
template <int D, int DV, int NT, typename T>
struct Ring {
  using S = Smem<D, DV, NT>;
  float* base;   // 3 · STAGE floats
  __device__ __forceinline__ T* stage(int it) const {
    if constexpr (sizeof(T) == 4)
      return reinterpret_cast<T*>(base + (it & 1) * S::STAGE);
    else
      return reinterpret_cast<T*>(base + S::STAGE + (it & 1) * S::LAND);
  }
  // big parts of tile it (the small ones at the same offsets of small())
  __device__ __forceinline__ float* big(int it) const {
    return sizeof(T) == 4 ? base + (it & 1) * S::STAGE : base;
  }
  __device__ __forceinline__ float* small() const {
    return base + 2 * S::STAGE;
  }
  // tile it (rows r0.. of a at width D, of b at width DV) into its stage
  __device__ __forceinline__ void load(int it, const T* a, long long as,
                                       const T* b, long long bs, int r0,
                                       int lim) const {
    T* st = stage(it);
    load_ring<D, NT>(st, a, as, r0, lim);
    load_ring<DV, NT>(st + (sizeof(T) == 4 ? S::TILE_A : NT * D), b, bs, r0,
                      lim);
  }
  // the landed tile it split for the products (the caller synchronises);
  // bf16 is only widened: its values are their own big parts
  __device__ __forceinline__ void split(int it) const {
    if constexpr (sizeof(T) == 4) {
      split_smem(big(it), small(), S::STAGE / 4);
    } else {
      const T* st = stage(it);
      widen_rows(st, NT, D, big(it), Lay<D>::RING);
      widen_rows(st + NT * D, NT, DV, big(it) + S::TILE_A, Lay<DV>::RING);
    }
  }
};

// Four 8 x 4 f32 matrices of shared memory, one 16-byte row per lane
// address (lanes 8m..8m+7: rows of matrix m): r[m] = matrix m's (g, t).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8 x 4 f32 matrices, lanes 0..15 giving the row addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// The A fragment of rows r0.., k-step kd of a resident tile (raw f32),
// split (EXACT, a bf16 tile: the big parts alone): a = X[g][t], X[g+8][t],
// X[g][t+4], X[g+8][t+4] of the k8 block (k in its natural order; the B
// side of these products reads the same).
template <int W, bool EXACT>
__device__ __forceinline__ void a_rows(const float* X, int r0, int kd,
                                       Frag<4>& f) {
  const int i = threadIdx.x % 32;
  uint32_t r[4];
  ldsm_x4(r, X + Lay<W>::res(r0 + i % 8 + 8 * (i / 8 % 2),
                             kd * 8 + 4 * (i / 16)));
  const float v[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]),
                      __uint_as_float(r[2]), __uint_as_float(r[3])};
  frag_split<EXACT>(v, f);
}

// The B fragment (k = d, n = row) of rows n0.. of a split ring tile: rows
// n0 + g, columns 8kd + t and 8kd + t + 4 (EXACT: the big parts alone).
template <int W, bool EXACT>
__device__ __forceinline__ Frag<2> b_rows(const float* big,
                                          const float* small, int n0,
                                          int kd) {
  const int i = threadIdx.x % 32;
  const int o = Lay<W>::ring(n0 + i % 8, kd * 8 + 4 * (i / 8 % 2));
  Frag<2> f;
  if constexpr (EXACT) {
    ldsm_x2(f.big, big + o);
  } else {
    uint32_t r[4];
    ldsm_x4(r, (i < 16 ? big : small) + o);
    f = {{r[0], r[1]}, {r[2], r[3]}};
  }
  return f;
}

// The B fragment (k = row, n = d) of a split ring tile, k permuted as the
// accumulator-as-A fragment is (mma_tf32.cuh): rows k0 + 2t and k0 + 2t + 1,
// column 8d + g.
template <int W, bool EXACT>
__device__ __forceinline__ Frag<2> b_cols(const float* big,
                                          const float* small, int k0,
                                          int d) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int o = Lay<W>::ring(k0 + 2 * t, d * 8 + g);
  constexpr int R = Lay<W>::RING;
  Frag<2> f;
  f.big[0] = __float_as_uint(big[o]);
  f.big[1] = __float_as_uint(big[o + R]);
  if constexpr (!EXACT) {
    f.small[0] = __float_as_uint(small[o]);
    f.small[1] = __float_as_uint(small[o + R]);
  }
  return f;
}

// x = A·Bᵀ for the 16 resident rows of this warp (A, width W, split per
// use) and the NT rows of a split ring tile (B): NT/8 n8 tiles, k = d;
// EXACT (bf16 on both sides): one pass.
template <int W, int NT, bool EXACT>
__device__ __forceinline__ void tile_scores(const float* A, const float* big,
                                            const float* small,
                                            float (&x)[NT / 8][4]) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < W / 8; ++kd) {
    Frag<4> a;
    a_rows<W, EXACT>(A, 16 * warp, kd, a);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
      mma_3xtf32<EXACT, EXACT>(x[j], a,
                               b_rows<W, EXACT>(big, small, 8 * j, kd));
  }
}

// acc += A·B over the NT/8 k-steps of one NT-row ring tile of width W: A
// the split accumulator fragments a[kk] (rows of this warp, k = the tile's
// rows), B the tile's columns; each group of up to 4 n8 tiles (5 at
// width 80, whose 10 do not split into fours) chains into fresh zero
// accumulators that are then added to acc in f32 (the group only bounds
// the live accumulators: each element's chain is the same whatever its
// group); B_EXACT (a bf16 tile): two passes.
template <int W, int NT, bool B_EXACT>
__device__ __forceinline__ void tile_product(const Frag<4> (&a)[NT / 8],
                                             const float* big,
                                             const float* small,
                                             float (&acc)[W / 8][4]) {
  constexpr int DK = W / 8;
  constexpr int DG = DK < 4 ? DK : DK % 4 == 0 ? 4 : 5;
  static_assert(DK % DG == 0, "the groups cover the n8 tiles");
#pragma unroll
  for (int d0 = 0; d0 < DK; d0 += DG) {
    float f[DG][4];
#pragma unroll
    for (int i = 0; i < DG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 8; ++kk)
#pragma unroll
      for (int i = 0; i < DG; ++i)
        mma_3xtf32<false, B_EXACT>(
            f[i], a[kk], b_cols<W, B_EXACT>(big, small, 8 * kk, d0 + i));
#pragma unroll
    for (int i = 0; i < DG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d0 + i][e] += f[i][e];
  }
}

// The split A fragments of a 16 x NT accumulator (NT/8 n8 tiles) for a
// product over its NT columns: d[0], d[2], d[1], d[3] (mma_tf32.cuh).
template <int NT>
__device__ __forceinline__ void acc_as_a(const float (&x)[NT / 8][4],
                                         Frag<4> (&a)[NT / 8]) {
#pragma unroll
  for (int kk = 0; kk < NT / 8; ++kk) {
    const float v[4] = {x[kk][0], x[kk][2], x[kk][1], x[kk][3]};
    frag_split<false>(v, a[kk]);
  }
}

// rows r0 + g and r0 + g + 8 (below lim) of one head of out: acc · mul
template <int W>
__device__ __forceinline__ void store_rows(float* out, long long ss, int r0,
                                           int lim, float mul,
                                           const float (&acc)[W / 8][4]) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    if (r >= lim) continue;
#pragma unroll
    for (int d = 0; d < W / 8; ++d)
      *reinterpret_cast<float2*>(out + r * ss + d * 8 + 2 * t) =
          make_float2(acc[d][2 * hf] * mul, acc[d][2 * hf + 1] * mul);
  }
}

// Di = Σ_d dO·o over the Dv columns, one (b, query, head) row per warp
template <typename T>
__global__ void __launch_bounds__(THREADS) dot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ di, int B, int Sq, int H, int Dv, Strides os,
    Strides ds) {
  const long long row = (static_cast<long long>(blockIdx.x) * THREADS
                         + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(B) * H * Sq) return;   // warp-uniform
  const int q = static_cast<int>(row % Sq);
  const int h = static_cast<int>((row / Sq) % H);
  const int b = static_cast<int>(row / (static_cast<long long>(Sq) * H));
  const T* op = o + b * os.b + q * os.s + h * os.h;
  const T* dp = dout + b * ds.b + q * ds.s + h * ds.h;
  float s = 0.f;
  for (int d = lane; d < Dv; d += 32)
    s = fmaf(to_float(op[d]), to_float(dp[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(REPRO_FULL_MASK, s, off);
  if (lane == 0) di[row] = s;   // row = (b·H + h)·Sq + q
}

template <int D, int DV, int NT, typename T>
__global__ void __launch_bounds__(THREADS, 1) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dk, float* __restrict__ dv, int B, int Sq, int Sk,
    int H, int G, Strides qs, Strides ks, Strides vs, Strides dos, int kv_len,
    int q_offset, int causal, float scale) {
  constexpr int NJ = NT / 8;    // n8 tiles of Sᵀ; k8 steps of dK, dV
  constexpr bool EXACT = kExact<T>;
  using S = Smem<D, DV, NT>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + S::RES_A;
  const Ring<D, DV, NT, T> ring{Vs + S::RES_B};   // Q then dO

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
  const int nq = (Sq + NT - 1) / NT;
  int qt0 = causal ? max(0, k0 - q_offset) / NT : 0;
  if (k0 >= k_lim) qt0 = nq;   // no visible key in this tile
  const int per_head = nq - qt0;
  const int ntiles = G * per_head;

  auto load = [&](int it) {
    const int h = hk * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * NT;
    ring.load(it, q + b * qs.b + h * qs.h, qs.s,
              dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  };

  float acc_k[D / 8][4], acc_v[DV / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[d][e] = 0.f;
#pragma unroll
  for (int d = 0; d < DV / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[d][e] = 0.f;

  if (ntiles > 0) {
    load_resident<D>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BK, k_lim);
    load_resident<DV>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BK, k_lim);
    load(0);
  }
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    const int h = hk * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * NT;
    // this thread's columns' lse (base 2) and Di: queries q0 + 8j + 2t + e
    const float* lh = lse + (static_cast<long long>(b) * H + h) * Sq;
    const float* dih = di + (static_cast<long long>(b) * H + h) * Sq;
    float lq[NJ][2], dc[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = q0 + 8 * j + 2 * t + e;
        lq[j][e] = c < Sq ? __ldg(lh + c) * LOG2E : 0.f;
        dc[j][e] = c < Sq ? __ldg(dih + c) : 0.f;
      }
    cp_async_wait<1>();   // tile it (and K, V) landed: this thread's copies
    __syncthreads();      // ... and every thread's
    ring.split(it);       // big parts to big(it), small to small()
    __syncthreads();
    // a warp whose keys are all masked for this tile adds nothing
    const bool live = kw < k_lim &&
        (!causal || kw <= q_offset + min(q0 + NT, Sq) - 1);
    if (live) {
      const float* Qb = ring.big(it);
      const float* dOb = Qb + S::TILE_A;
      const float* Qsm = ring.small();
      const float* dOsm = Qsm + S::TILE_A;
      // Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ: this warp's 16 keys × the NT queries
      // (one after the other: the dK and dV sums hold 128 registers at
      // D = 128); element (key g + 8hf, query 8j + 2t + e)
      float s[NJ][4], dp[NJ][4];
      tile_scores<D, NT, EXACT>(Ks, Qb, Qsm, s);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
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
      tile_scores<DV, NT, EXACT>(Vs, dOb, dOsm, dp);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)   // dSᵀ = Pᵀ ∘ (dPᵀ − Di)
          dp[j][e] = s[j][e] * (dp[j][e] - dc[j][e % 2]);
      Frag<4> a[NJ];
      acc_as_a<NT>(s, a);
      tile_product<DV, NT, EXACT>(a, dOb, dOsm, acc_v);   // dV += Pᵀ·dO
      acc_as_a<NT>(dp, a);
      tile_product<D, NT, EXACT>(a, Qb, Qsm, acc_k);      // dK += dSᵀ·Q
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  // contiguous (B, Sk, Hk, width)
  const long long kss = static_cast<long long>(Hk) * D;
  const long long vss = static_cast<long long>(Hk) * DV;
  store_rows<D>(dk + static_cast<long long>(b) * Sk * kss + hk * D, kss, kw,
                Sk, scale, acc_k);
  store_rows<DV>(dv + static_cast<long long>(b) * Sk * vss + hk * DV, vss,
                 kw, Sk, 1.f, acc_v);
}

template <int D, int DV, int NT, typename T>
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dq, int B, int Sq, int Sk, int H, int G,
    Strides qs,
    Strides ks, Strides vs, Strides dos, int kv_len, int q_offset,
    int causal, float scale) {
  constexpr int NJ = NT / 8;
  constexpr bool EXACT = kExact<T>;
  using S = Smem<D, DV, NT>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + S::RES_A;
  const Ring<D, DV, NT, T> ring{dOs + S::RES_B};   // K then V

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
  const int ntiles = (max(k_end, 0) + NT - 1) / NT;
  // the last key position this warp's rows can see
  const int w_last = q_offset + min(qw + 15, Sq - 1);
  const T* kh = k + b * ks.b + hk * ks.h;
  const T* vh = v + b * vs.b + hk * vs.h;

  auto load = [&](int it) {
    ring.load(it, kh, ks.s, vh, vs.s, it * NT, k_lim);
  };

  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  if (ntiles > 0) {
    load_resident<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, Sq);
    load_resident<DV>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, BQ, Sq);
    load(0);
  }
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    ring.split(it);
    __syncthreads();
    const int k0 = it * NT;
    if (qw < Sq && (!causal || k0 <= w_last)) {
      const float* Kb = ring.big(it);
      const float* Vb = Kb + S::TILE_A;
      const float* Ksm = ring.small();
      const float* Vsm = Ksm + S::TILE_A;
      // S = Q·Kᵀ and dP = dO·Vᵀ: this warp's 16 queries × the NT keys
      float s[NJ][4], dp[NJ][4];
      tile_scores<D, NT, EXACT>(Qs, Kb, Ksm, s);
      tile_scores<DV, NT, EXACT>(dOs, Vb, Vsm, dp);
      // dS in place; element (query g + 8hf, key 8j + 2t + e)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
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
      Frag<4> a[NJ];
      acc_as_a<NT>(dp, a);
      tile_product<D, NT, EXACT>(a, Kb, Ksm, acc);   // dQ += dS·K
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

template <int D, int DV, int NT, typename T>
bool plan_matches(const int* plan, int B, int Sq, int Sk, int H, int Hk) {
  using S = Smem<D, DV, NT>;
  constexpr bool E = kExact<T>;
  const long long rows = static_cast<long long>(B) * H * Sq;
  const long long want[PLAN] = {
      WARPS, BK, NT, BQ, NT,
      kPasses<E, E> * (1 + 4) + kPasses<false, E> * (16 + 64 + 256),
      static_cast<long long>(S::BYTES), static_cast<long long>(S::BYTES),
      (rows * 32 + THREADS - 1) / THREADS,
      static_cast<long long>((Sk + BK - 1) / BK) * Hk * B,
      static_cast<long long>((Sq + BQ - 1) / BQ) * H * B};
  for (int i = 0; i < PLAN; ++i)
    if (plan[i] != want[i]) return false;
  return true;
}

template <int D, int DV, int NT, typename T>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           const float* lse, float* di, float* dq, float* dk, float* dv,
           int B, int Sq, int Sk, int H, int G, const Strides* st,
           int kv_len, int q_offset, int causal, float scale,
           const int* plan, cudaStream_t stream) {
  using S = Smem<D, DV, NT>;
  if (!plan_matches<D, DV, NT, T>(plan, B, Sq, Sk, H, H / G))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<D, DV, NT, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::BYTES));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dq_kernel<D, DV, NT, T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(S::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dot_kernel<T><<<static_cast<unsigned>(plan[8]), THREADS, 0, stream>>>(
      o, dout, di, B, Sq, H, DV, st[3], st[4]);
  dkdv_kernel<D, DV, NT, T><<<static_cast<unsigned>(plan[9]), THREADS,
                              S::BYTES, stream>>>(
      q, k, v, dout, lse, di, dk, dv, B, Sq, Sk, H, G, st[0], st[1], st[2],
      st[4], kv_len, q_offset, causal, scale);
  dq_kernel<D, DV, NT, T><<<static_cast<unsigned>(plan[10]), THREADS,
                            S::BYTES, stream>>>(
      q, k, v, dout, lse, di, dq, B, Sq, Sk, H, G, st[0], st[1], st[2],
      st[4], kv_len, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(const T* q, const T* k, const T* v, const T* o, const T* dout,
          const float* lse, float* di, float* dq, float* dk, float* dv,
          int B, int Sq, int Sk, int H, int Hk, int D, int Dv,
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
#define REPRO_BWD_CASE(DQK, DVV, NTT)                                       \
  if (D == DQK && Dv == DVV)                                                \
    return launch<DQK, DVV, NTT, T>(q, k, v, o, dout, lse, di, dq, dk, dv,  \
                                    B, Sq, Sk, H, G, st, kv_len, q_offset,  \
                                    causal, scale, plan, s);
  REPRO_BWD_CASE(16, 16, 32)
  REPRO_BWD_CASE(32, 32, 32)
  REPRO_BWD_CASE(64, 64, 32)
  REPRO_BWD_CASE(80, 80, 32)
  REPRO_BWD_CASE(128, 128, 32)
  REPRO_BWD_CASE(192, 128, 16)
#undef REPRO_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides: 15 values, (batch, seq, head) of q, k, v, o and dO, in elements.
// D: the width of q and k; Dv: the width of v, o and dO.  di: a (B, H, Sq)
// f32 workspace.  dq (B, Sq, H, D), dk (B, Sk, Hk, D) and dv (B, Sk, Hk,
// Dv) are written f32, contiguous.  plan: the wrapper's plan (PLAN ints,
// above), refused unless it is this build's.  The bf16 entry reads q, k,
// v, o and dO as bf16; lse and the outputs are f32 in both.
extern "C" int flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* di, float* dq, float* dk,
    float* dv, int B, int Sq, int Sk, int H, int Hk, int D, int Dv,
    const long long* strides, int kv_len, int q_offset, int causal,
    float scale, const int* plan, void* stream) {
  return entry<float>(q, k, v, o, dout, lse, di, dq, dk, dv, B, Sq, Sk, H,
                      Hk, D, Dv, strides, kv_len, q_offset, causal, scale,
                      plan, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
    float* di, float* dq, float* dk, float* dv, int B, int Sq, int Sk, int H,
    int Hk, int D, int Dv, const long long* strides, int kv_len,
    int q_offset, int causal, float scale, const int* plan, void* stream) {
  return entry<__nv_bfloat16>(q, k, v, o, dout, lse, di, dq, dk, dv, B, Sq,
                              Sk, H, Hk, D, Dv, strides, kv_len, q_offset,
                              causal, scale, plan, stream);
}
