// Flash-attention forward (online softmax), Hopper (sm_90a), f32 arithmetic
// on f32 or bf16 inputs.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_fwd (the
// Pallas TPU kernel `_kernel`).  Same function: logits q·kᵀ scaled by
// 1/sqrt(D); keys at or past kv_len excluded; causal or not; a running max
// m and denominator l per query row; the output acc / max(l, 1e-30).  Two
// extensions the LM needs, of which the Pallas contract is the special
// case G = 1, q_offset = 0, kv_len = Sk:
//   * GQA without copies: q is (B, Sq, H, D), k and v are (B, Sk, H/G, D),
//     and query head h reads key/value head h / G;
//   * q_offset: query i sits at position q_offset + i (prefill into a KV
//     cache), so the causal test is q_offset + i >= j;
//   * v narrower than q and k: (D, Dv) = (192, 128) is MLA's prefill
//     (DeepSeek-V2: q·k over 128 + 64 rope dims, v at 128), the scale
//     1/sqrt(D) of the q·k width.  The kernel is templated on both widths;
//     the other instances take D = Dv in {16, 32, 64, 80, 128} (80 is
//     HuBERT-XLarge's 1280 / 16, non-causal).
// Every tensor is addressed through its (batch, sequence, head) strides
// with D contiguous, so a KV cache (B, S_max, Kv, D) is read in place and
// the (BH, S, D) layout of the Pallas kernel is the case B = 1, H = BH.
//
// Two routes by width (entry() below): the wgmma route for D = Dv = 128
// and MLA's (192, 128) (flash_fwd_wg_kernel), the tile route for D = Dv in
// {16, 32, 64, 80} (flash_fwd_kernel, mma.sync).  Both run one block of 8
// warps per (128-query tile, head, batch), each warp 16 query rows, over
// 32-key tiles of K and V, and both products on the tensor cores in 3xTF32
// (mma_tf32.cuh: f32 accuracy), each tile's P·V chained in fresh
// accumulators and added to the running (16, Dv) sums in f32.  The row max
// and row sum are taken in registers from the S accumulator (a row lives
// in one quad of lanes: two shuffles), in base 2 (exp2f).  With k permuted
// inside each group of 8 keys (mma_tf32.cuh), the S accumulator is already
// P's A fragment for P·V: P never leaves the registers.  Key tiles that lie
// wholly past kv_len, or wholly above the diagonal under causal masking,
// are not loaded (per block) or not multiplied (per warp; per warpgroup on
// the wgmma route): there every p is 0 and alpha is 1, so skipping changes
// nothing.  Masked entries get p = 0 exactly.  Query tiles are launched
// last-first, so that the longest causal rows start first.  IEEE division;
// one pass of TF32 is never used on f32 data: f32 means f32.  On request
// (a non-null lse) it also writes each row's log-sum-exp, m + log l in
// natural-log units, which the backward (flash_attention_bwd.cu) recomputes
// P from; without it nothing else changes, so serving keeps its bits.
//
// The wgmma route.  Each of the two warpgroups owns 64 query rows.  S = Q·Kᵀ
// is wgmma m64n32k8 (TF32) with A, the Q fragments, in registers (the raw
// Q tile stays in shared memory and each warp loads and splits its
// fragments, 8 k steps at a time) and B, the K tile, read by the tensor
// cores from shared memory; each 3xTF32 pass runs in its own chain of D/8
// products, summed after.  P·V is wgmma m64n128k8 with P's accumulator
// registers, split, as A and V as B, the passes chained per tile.  wgmma
// reads B once for a warpgroup, where mma.sync has each warp read it: the
// tile route at (192, 128) read 750 KB of shared memory for each 32-key
// tile of a block, beyond the 128 bytes a clock an SM serves, and ran at
// 25 % of the tensor-core bound.  wgmma takes TF32 B K-major, so each
// landed raw tile is split once by the whole block into big and small
// planes in the no-swizzle core-matrix layout, K as it lands (k = d) and V
// transposed (k = key), k permuted as the A fragments hold it.  Shared
// memory at (192, 128) in f32: the Q tile 102,400 bytes (rows of D + 8
// floats, conflict-free fragment loads), the planes 81,920, one raw tile
// 41,472 (K rows of D + 4): 225,792 of the 232,448 a block may have, so
// there is one raw stage and one stage of planes: tile t + 1 lands by
// cp.async while tile t is multiplied, and the split sits between two
// barriers (tools/flash_ablate.py measures what each part costs).  At
// D = 128, 168,448 bytes.  The splits round by integer adds
// (mma_tf32.cuh); with cvt.rna the route took 19 % longer on the H100.
//
// The tile route.  K and V come in 32-key tiles through a
// double-buffered cp.async ring (16-byte copies, read in place through the
// strides; keys at or past kv_len are zero-filled), so the next tile is in
// flight while this one is multiplied.  Each landed tile is split into its
// TF32 big and small parts once for the block (not once per warp that
// reads it).  S = Q·Kᵀ runs each pass in its own accumulator, with the Q
// tile loaded once into shared memory and its fragments split per use.
// Shared rows are padded so every fragment load is free of bank conflicts
// (Q and K rows D + 8, read in 64-bit pairs; V rows D + 4).  At D = 80,
// which is not a multiple of 32, the same paddings hold: a half-warp's
// 64-bit Q and K loads (rows g < 4 of a quad group) start at banks
// 24g mod 32 = {0, 24, 16, 8}, 8 words apart, and the V column loads at
// 2t·84 + g = 8t + g mod 32; every row is a whole number of 16-byte
// copies (352 and 336 bytes), so the cp.async rows stay aligned.  Shared
// memory at D = 80: 111,104 bytes.
//
// bf16 q, k and v (mixed-precision training) are read in place, and the
// output o is written in their dtype (rounded to nearest even), the lse in
// f32.  A bf16 value is exact in f32 and in TF32 (its small part is 0), so
// the bf16 instances issue only the passes whose operands are not exact:
// S (bf16 × bf16) one pass, P·V (the f32 P × bf16 V) two; their tiles are
// widened and not split, and the Q fragments not split.  A pass of exact
// zeros adds nothing to its accumulator, and S's dropped chains would add
// 0 + 0 after, so the bf16 route gives the f32 route's bits on the inputs
// widened to f32, o then rounded to bf16.  Tiles land as bf16 by cp.async
// (half the bytes) and are widened into the f32 layout; the Q tile is
// widened on its way in.
//
// Bound on the card.  Prefill of the LM (B = 4, H = 40, Kv = 8, S = 2048,
// D = 128, causal): 2·B·H·S²·D = 172 GFLOP of causal work against 403 MB
// of bytes — bound by operations: 2.6 ms at the 67 TFLOP/s f32 SIMT peak,
// 1.0 ms for 3 x that work at the 495 TFLOP/s TF32 tensor-core peak.
// MLA's prefill (B = 4, H = Kv = 16, S = 2048, (D, Dv) = (192, 128),
// causal): B·H·S²·(D + Dv) = 85.9 GFLOP, 0.52 ms as 3xTF32 at 495 TFLOP/s,
// 1.28 ms at the f32 SIMT peak; its training shape (B = 2) half that.  In
// bf16 (S one pass, P·V two) MLA's training forward is 0.12 ms.
// HuBERT-XLarge's attention (B = 4, H = Kv = 16, S = 1500, D = 80,
// non-causal): B·H·S²·(D + Dv) = 46.1 GFLOP, 0.279 ms as 3xTF32 at 495
// TFLOP/s; 0.140 ms in bf16.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;   // query rows per block
constexpr int BKV = 32;          // keys per tile
constexpr float NEG = -1e30f;

template <int D, int DV>
struct Smem {
  // row strides (floats), fragments read as in mma_tf32.cuh:
  static constexpr int QS = D + 8;   // Q, K: pairs (g, 2t..2t+1), 8g + 2t
  static constexpr int KS = D + 8;
  static constexpr int VS = DV + 4;  // V: rows 2t and 2t+1, column g: 8t + g
  static constexpr int STAGE = BKV * (KS + VS);
  // two ring stages of K and V, the small parts of the current stage
  // (f32 only), Q
  static constexpr int FLOATS = 3 * STAGE + BQ * QS;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  // bf16: a tile's K rows of D values, then its V rows of DV, back to back
  static constexpr int LAND = BKV * (D + DV) / 2;   // floats
  static_assert(2 * LAND <= STAGE, "two bf16 zones fill one f32 stage");
};

// The epilogue of both routes: a thread's rows (below Sq) of o, acc / l
// with IEEE division, in o's dtype (bf16 rounded to nearest even), from
// the m16n8 accumulator layout; on request each row's log-sum-exp to
// lse[lrow0 + row].
template <int DO, typename T>
__device__ __forceinline__ void store_rows(T* ob, long long oss,
                                           const int (&rows)[2], int Sq,
                                           const float (&acc)[DO][4],
                                           const float (&l)[2],
                                           const float (&m)[2], float* lse,
                                           long long lrow0, int t) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = rows[hf];
    if (r >= Sq) continue;
    const float den = fmaxf(l[hf], 1e-30f);
#pragma unroll
    for (int d = 0; d < DO; ++d) {
      const float2 y =
          make_float2(acc[d][2 * hf] / den, acc[d][2 * hf + 1] / den);
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(ob + r * oss + d * 8 + 2 * t) =
            __floats2bfloat162_rn(y.x, y.y);
      else
        *reinterpret_cast<float2*>(ob + r * oss + d * 8 + 2 * t) = y;
    }
    // the log-sum-exp of the row's scaled logits, for the backward: m and
    // l are base 2, so lse = (m + log2 l)·ln 2
    if (lse != nullptr && t == 0)
      lse[lrow0 + r] = (m[hf] + log2f(l[hf])) * 0.6931471805599453f;
  }
}

// The Q tile: ROWS rows from q0 of one head (row stride qss; rows past Sq
// zero-filled) into rows of QS floats.  f32 by 16-byte cp.async (the
// caller commits and waits); bf16 by 16-byte loads of 8 values, widened
// and stored, seen by every warp after the caller's next barrier.
template <int D, int QS, int ROWS, int NTHREADS, typename T>
__device__ __forceinline__ void load_q(float* Qs, const T* qb, long long qss,
                                       int q0, int Sq) {
  constexpr int V8 = 16 / sizeof(T);   // values per 16-byte copy
  for (int i = threadIdx.x; i < ROWS * (D / V8); i += NTHREADS) {
    const int r = i / (D / V8), c = (i % (D / V8)) * V8;
    const bool in = q0 + r < Sq;
    if constexpr (sizeof(T) == 2) {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (in)
        widen8(__ldg(reinterpret_cast<const uint4*>(qb + (q0 + r) * qss + c)),
               f);
      *reinterpret_cast<float4*>(Qs + r * QS + c) =
          make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(Qs + r * QS + c + 4) =
          make_float4(f[4], f[5], f[6], f[7]);
    } else {
      cp_async16(Qs + r * QS + c, in ? qb + (q0 + r) * qss + c : qb,
                 in ? 16 : 0);
    }
  }
}

// The online softmax of a thread's rows g (half 0) and g + 8 (half 1) over
// one tile of 8·NK keys from k0, in the m16n8 accumulators s of its NK n8
// tiles: a row's scores sit in the 4 lanes of one quad, register
// [j][2hf + e] holding key k0 + 8j + 2t + e.  The scores go in, p comes
// out (0 where masked); m and l move on and the O accumulators are
// rescaled.
template <int NK, int DO>
__device__ __forceinline__ void softmax_tile(float (&s)[NK][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&acc)[DO][4],
                                             const int (&rows)[2], int k0,
                                             int t, int k_lim, int q_offset,
                                             int causal, float scale2) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qpos = q_offset + rows[hf];
    bool ok[NK][2];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + e;
        ok[j][e] = kpos < k_lim && (!causal || qpos >= kpos);
        const float x = ok[j][e] ? s[j][2 * hf + e] * scale2 : NEG;
        s[j][2 * hf + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(REPRO_FULL_MASK, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(REPRO_FULL_MASK, mx, 2));
    const float m_new = fmaxf(m[hf], mx);
    const float alpha = exp2f(m[hf] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ok[j][e] ? exp2f(s[j][2 * hf + e] - m_new) : 0.f;
        s[j][2 * hf + e] = p;
        sum += p;
      }
    sum += __shfl_xor_sync(REPRO_FULL_MASK, sum, 1);
    sum += __shfl_xor_sync(REPRO_FULL_MASK, sum, 2);
    l[hf] = l[hf] * alpha + sum;
    m[hf] = m_new;
#pragma unroll
    for (int d = 0; d < DO; ++d) {
      acc[d][2 * hf] *= alpha;
      acc[d][2 * hf + 1] *= alpha;
    }
  }
}

template <int D, int DV, typename T>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
    int G, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int kv_len,
    int q_offset, int causal, float scale, float* __restrict__ lse) {
  constexpr int DK = D / 8;     // k8 steps of Q·Kᵀ
  constexpr int DO = DV / 8;    // n8 tiles of O
  constexpr int NK = BKV / 8;   // n8 tiles of S; k8 steps of P·V
  using S = Smem<D, DV>;
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* Sm = smem + 2 * S::STAGE;   // small parts of the current K/V tile
  float* Qs = smem + 3 * S::STAGE;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const int wq0 = q0 + warp * 16;             // this warp's first row
  const int rows[2] = {wq0 + g, wq0 + g + 8};  // this thread's two rows

  // the softmax runs in base 2: logits scaled by log2(e)/sqrt(D), so m is
  // the running max of those and p = exp2(x - m) = exp(logit - max)
  const float scale2 = scale * 1.4426950408889634f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DO][4];
#pragma unroll
  for (int d = 0; d < DO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  // keys this tile can see: below kv_len and, if causal, at or before the
  // position of its last query row
  const int k_lim = min(kv_len, Sk);
  int k_end = k_lim;
  if (causal) k_end = min(k_end, q_offset + min(q0 + BQ, Sq));
  const int ntiles = (k_end + BKV - 1) / BKV;
  // the last key position this warp's rows can see
  const int w_last = q_offset + min(wq0 + 15, Sq - 1);
  const bool warp_rows = wq0 < Sq;

  // f32: tile t lands raw in stage t & 1 and is split in place; bf16: it
  // lands in zone t & 1 (the second stage's space) and is widened into
  // stage 0, with no small parts (a bf16 value is exact in TF32).  Ks
  // below is the tile's stage of big parts either way.
  constexpr bool WIDE = sizeof(T) == 2;
  constexpr int V8 = 16 / sizeof(T);   // values per 16-byte copy
  auto land = [&](int tile) {
    return reinterpret_cast<T*>(
        WIDE ? smem + S::STAGE + (tile & 1) * S::LAND
             : smem + (tile & 1) * S::STAGE);
  };
  auto load = [&](int tile) {
    T* Kl = land(tile);
    T* Vl = Kl + (WIDE ? BKV * D : BKV * S::KS);
    const int k0 = tile * BKV;
    constexpr int CK = D / V8, CV = DV / V8;   // 16-byte chunks per row
#pragma unroll
    for (int i = threadIdx.x; i < BKV * CK; i += THREADS) {
      const int r = i / CK, c = (i % CK) * V8;
      const bool in = k0 + r < k_lim;
      cp_async16(Kl + r * (WIDE ? D : S::KS) + c,
                 in ? kb + (k0 + r) * kss + c : kb, in ? 16 : 0);
    }
#pragma unroll
    for (int i = threadIdx.x; i < BKV * CV; i += THREADS) {
      const int r = i / CV, c = (i % CV) * V8;
      const bool in = k0 + r < k_lim;
      cp_async16(Vl + r * (WIDE ? DV : S::VS) + c,
                 in ? vb + (k0 + r) * vss + c : vb, in ? 16 : 0);
    }
  };

  // the Q tile, with the first K/V tile
  load_q<D, S::QS, BQ, THREADS>(Qs, qb, qss, q0, Sq);
  if (ntiles > 0) load(0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile it has landed (this thread's copies)
    __syncthreads();      // ... and every thread's
    // split the tile once for the block: big parts in its stage, small
    // to Sm (bf16: widened, the values their own big parts)
    float* Kt = WIDE ? smem : smem + (it & 1) * S::STAGE;
    if constexpr (WIDE) {
      const T* Kl = land(it);
      widen_rows(Kl, BKV, D, Kt, S::KS);
      widen_rows(Kl + BKV * D, BKV, DV, Kt + BKV * S::KS, S::VS);
    } else {
      split_smem(Kt, Sm, S::STAGE / 4);
    }
    __syncthreads();
    const int k0 = it * BKV;
    if (warp_rows && (!causal || k0 <= w_last)) {
      const float* Ks = Kt;
      const float* Vs = Ks + BKV * S::KS;
      // S = Q·Kᵀ, each 3xTF32 pass in its own accumulator (three chains of
      // D/8 dependent products instead of one of 3·D/8), summed after; on
      // bf16 (both sides exact) the one big-by-big pass
      float s[NK][4], s_bs[NK][4], s_sb[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s_bs[j][e] = s_sb[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DK; ++kd) {
        const float* qp = Qs + (warp * 16 + g) * S::QS + kd * 8 + 2 * t;
        const float2 lo = load_pair(qp), hi = load_pair(qp + 8 * S::QS);
        const float qv[4] = {lo.x, hi.x, lo.y, hi.y};
        Frag<4> qa;
        frag_split<WIDE>(qv, qa);
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int ko = (j * 8 + g) * S::KS + kd * 8 + 2 * t;
          const float2 kbig = load_pair(Ks + ko);
          const uint32_t kb2[2] = {__float_as_uint(kbig.x),
                                   __float_as_uint(kbig.y)};
          if constexpr (!WIDE) {
            const float2 ksml = load_pair(Sm + ko);
            const uint32_t ks2[2] = {__float_as_uint(ksml.x),
                                     __float_as_uint(ksml.y)};
            mma_tf32(s_bs[j], qa.big, ks2);
            mma_tf32(s_sb[j], qa.small, kb2);
          }
          mma_tf32(s[j], qa.big, kb2);
        }
      }

      if constexpr (!WIDE) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += s_bs[j][e] + s_sb[j][e];
      }

      softmax_tile<NK, DO>(s, m, l, acc, rows, k0, t, k_lim, q_offset,
                           causal, scale2);

      // this tile's P·V in fresh accumulators (see mma_tf32.cuh)
      float pv_acc[DO][4];
#pragma unroll
      for (int d = 0; d < DO; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv_acc[d][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        // S's accumulator over keys 8kk.. is P·V's A fragment (mma_tf32.cuh)
        const float pv[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        Frag<4> pa;
        frag_split<false>(pv, pa);
#pragma unroll
        for (int d = 0; d < DO; ++d) {
          const int vo = (kk * 8 + 2 * t) * S::VS + d * 8 + g;
          Frag<2> vf;
          vf.big[0] = __float_as_uint(Vs[vo]);
          vf.big[1] = __float_as_uint(Vs[vo + S::VS]);
          if constexpr (!WIDE) {   // bf16: V exact, two passes
            const float* vs = Sm + BKV * S::KS + vo;
            vf.small[0] = __float_as_uint(vs[0]);
            vf.small[1] = __float_as_uint(vs[S::VS]);
          }
          mma_3xtf32<false, WIDE>(pv_acc[d], pa, vf);
        }
      }
#pragma unroll
      for (int d = 0; d < DO; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] += pv_acc[d][e];
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  store_rows<DO>(o + b * osb + h * osh, oss, rows, Sq, acc, l, m, lse,
                 (static_cast<long long>(b) * gridDim.y + h) * Sq, t);
}

template <int D, int DV, typename T>
int launch_tile(const T* q, const T* k, const T* v, T* o, int B,
           int Sq, int Sk, int H, int G, const long long* st, int kv_len,
           int q_offset, int causal, float scale, float* lse,
           cudaStream_t stream) {
  static_assert(Smem<D, DV>::BYTES <= 232448,
                "a block's shared memory is at most 227 KB");
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, DV, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<D, DV>::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D, DV, T><<<grid, THREADS, Smem<D, DV>::BYTES, stream>>>(
      q, k, v, o, Sq, Sk, G, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], kv_len, q_offset, causal, scale,
      lse);
  return static_cast<int>(cudaGetLastError());
}

// --- the wgmma route: (D, Dv) = (192, 128) --------------------------------

constexpr int WG_THREADS = 256;   // two warpgroups of 64 query rows
constexpr int WG_BQ = 128;        // query rows per block
constexpr int WG_BKV = 32;        // keys per tile

template <int D, int DV, typename T>
struct WgSmem {
  static constexpr bool EXACT = sizeof(T) == 2;
  static constexpr int QS = D + 8;              // Q row stride (floats)
  static constexpr int Q = WG_BQ * QS;
  static constexpr int KP = WG_BKV * D;         // a K plane (floats)
  static constexpr int VP = WG_BKV * DV;        // a V plane
  // K and V big planes, then (f32) their small planes
  static constexpr int PLANES = (EXACT ? 1 : 2) * (KP + VP);
  static constexpr int RK = D + 16 / sizeof(T);   // raw K row (elements)
  static constexpr int RAW = WG_BKV * (RK + DV);  // raw K rows, V rows
  static constexpr size_t BYTES = 4 * (Q + PLANES) + sizeof(T) * RAW;
};

// 8 values of one row n of a K-major plane (n rows of K8 k values) at k
// step s: positions 0..3 take values 0, 2, 4, 6 and positions 4..7 the
// odd ones, as the A fragments hold k (mma_tf32.cuh); big parts to big,
// small parts (f32 only) to small.  Plane layout (wgmma_m64nNk8's
// no-swizzle K-major core matrices): the 16-byte unit of row n and k/4 at
// ((n/8)·(K8/4) + k/4)·8 + n%8.
template <int K8, bool EXACT>
__device__ __forceinline__ void plane_store(float* big, float* small, int n,
                                            int s, const float (&v)[8]) {
  const int u = ((n / 8) * (K8 / 4) + 2 * s) * 32 + (n % 8) * 4;
  uint32_t bg[8], sm[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if constexpr (EXACT) bg[q] = __float_as_uint(v[q]);
    else tf32_split(v[q], bg[q], sm[q]);
  }
  *reinterpret_cast<uint4*>(big + u) = make_uint4(bg[0], bg[2], bg[4], bg[6]);
  *reinterpret_cast<uint4*>(big + u + 32) =
      make_uint4(bg[1], bg[3], bg[5], bg[7]);
  if constexpr (!EXACT) {
    *reinterpret_cast<uint4*>(small + u) =
        make_uint4(sm[0], sm[2], sm[4], sm[6]);
    *reinterpret_cast<uint4*>(small + u + 32) =
        make_uint4(sm[1], sm[3], sm[5], sm[7]);
  }
}

template <int D, int DV, typename T>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_fwd_wg_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
    int G, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int kv_len,
    int q_offset, int causal, float scale, float* __restrict__ lse) {
  using S = WgSmem<D, DV, T>;
  constexpr bool EXACT = S::EXACT;
  constexpr int DK = D / 8;        // k8 steps of Q·Kᵀ
  constexpr int CH = 8;            // of them per batch of Q fragments
  constexpr int NK = WG_BKV / 8;   // n8 tiles of S; k8 steps of P·V
  constexpr int DO = DV / 8;       // n8 tiles of O
  static_assert(DK % CH == 0 && DV == 128, "P·V is one m64n128 product");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Kbig = Qs + S::Q;
  float* Vbig = Kbig + S::KP;
  float* Ksml = Vbig + S::VP;      // f32 only
  float* Vsml = Ksml + S::KP;
  T* Kraw = reinterpret_cast<T*>(smem + S::Q + S::PLANES);
  T* Vraw = Kraw + WG_BKV * S::RK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const int wq0 = q0 + warp * 16;             // this warp's first row
  const int rows[2] = {wq0 + g, wq0 + g + 8};  // this thread's two rows
  const int gq0 = q0 + (warp / 4) * 64;       // this warpgroup's first row

  const float scale2 = scale * 1.4426950408889634f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DO][4];
#pragma unroll
  for (int d = 0; d < DO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  const int k_lim = min(kv_len, Sk);
  int k_end = k_lim;
  if (causal) k_end = min(k_end, q_offset + min(q0 + WG_BQ, Sq));
  const int ntiles = (k_end + WG_BKV - 1) / WG_BKV;
  // the last key position this warpgroup's rows can see
  const int g_last = q_offset + min(gq0 + 63, Sq - 1);
  const bool g_rows = gq0 < Sq;

  constexpr int V8 = 16 / sizeof(T);   // values per 16-byte copy
  auto load = [&](int tile) {
    const int k0 = tile * WG_BKV;
    constexpr int CK = D / V8, CV = DV / V8;
#pragma unroll
    for (int i = threadIdx.x; i < WG_BKV * CK; i += WG_THREADS) {
      const int r = i / CK, c = (i % CK) * V8;
      const bool in = k0 + r < k_lim;
      cp_async16(Kraw + r * S::RK + c, in ? kb + (k0 + r) * kss + c : kb,
                 in ? 16 : 0);
    }
#pragma unroll
    for (int i = threadIdx.x; i < WG_BKV * CV; i += WG_THREADS) {
      const int r = i / CV, c = (i % CV) * V8;
      const bool in = k0 + r < k_lim;
      cp_async16(Vraw + r * DV + c, in ? vb + (k0 + r) * vss + c : vb,
                 in ? 16 : 0);
    }
  };
  // the landed raw tile into the planes: K as it is (k = d), V transposed
  // (k = key), both K-major with k permuted as the A fragments hold it
  auto split = [&]() {
#pragma unroll
    for (int i = threadIdx.x; i < WG_BKV * DK; i += WG_THREADS) {
      const int n = i % WG_BKV, st = i / WG_BKV;   // key, d step
      float x[8];
      if constexpr (EXACT) {
        widen8(*reinterpret_cast<const uint4*>(Kraw + n * S::RK + 8 * st), x);
      } else {
        const float4 lo = *reinterpret_cast<const float4*>(
            Kraw + n * S::RK + 8 * st);
        const float4 hi = *reinterpret_cast<const float4*>(
            Kraw + n * S::RK + 8 * st + 4);
        x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
        x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
      }
      plane_store<D, EXACT>(Kbig, Ksml, n, st, x);
    }
#pragma unroll
    for (int i = threadIdx.x; i < DV * NK; i += WG_THREADS) {
      const int n = i % DV, st = i / DV;   // column of v, key step
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = to_float(Vraw[(8 * st + e) * DV + n]);
      plane_store<WG_BKV, EXACT>(Vbig, Vsml, n, st, x);
    }
  };

  load_q<D, S::QS, WG_BQ, WG_THREADS>(Qs, qb, qss, q0, Sq);
  const uint64_t kd_big = kmajor_desc(Kbig, 128, 32 * D);
  const uint64_t kd_sml = kmajor_desc(Ksml, 128, 32 * D);
  const uint64_t vd_big = kmajor_desc(Vbig, 128, 32 * WG_BKV);
  const uint64_t vd_sml = kmajor_desc(Vsml, 128, 32 * WG_BKV);
  if (ntiles > 0) load(0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();   // tile it (and Q) landed: this thread's copies
    __syncthreads();      // ... and every thread's; the planes are free
    split();
    fence_proxy_async();  // the planes' stores, seen by wgmma
    __syncthreads();      // ... of every thread; the raw tile is free
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    const int k0 = it * WG_BKV;
    if (!g_rows || (causal && k0 > g_last)) continue;   // warpgroup-uniform

    // S = Q·Kᵀ for the warpgroup's 64 rows: each 3xTF32 pass in its own
    // chain of D/8 products (bf16: the big-by-big pass alone), summed after
    float s[NK][4], s_bs[NK][4], s_sb[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s_bs[j][e] = s_sb[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < DK / CH; ++c) {
      Frag<4> qa[CH];
#pragma unroll
      for (int kk = 0; kk < CH; ++kk) {
        const float* qp =
            Qs + (warp * 16 + g) * S::QS + (c * CH + kk) * 8 + 2 * t;
        const float2 lo = load_pair(qp), hi = load_pair(qp + 8 * S::QS);
        const float qv[4] = {lo.x, hi.x, lo.y, hi.y};
        frag_split<EXACT>(qv, qa[kk]);
      }
      pin(s);
      if constexpr (!EXACT) {
        pin(s_bs);
        pin(s_sb);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CH; ++kk) {
        const uint64_t off = (c * CH + kk) * 256 >> 4;   // two k units
        if constexpr (!EXACT) {
          wgmma_m64n32k8(s_bs, qa[kk].big, kd_sml + off, 1);
          wgmma_m64n32k8(s_sb, qa[kk].small, kd_big + off, 1);
        }
        wgmma_m64n32k8(s, qa[kk].big, kd_big + off, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      if constexpr (!EXACT) {
        pin(s_bs);
        pin(s_sb);
      }
    }
    if constexpr (!EXACT) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s_bs[j][e] + s_sb[j][e];
    }

    softmax_tile<NK, DO>(s, m, l, acc, rows, k0, t, k_lim, q_offset, causal,
                         scale2);

    // this tile's P·V in fresh accumulators: P's accumulator registers are
    // its A fragments (mma_tf32.cuh), split; V exact on bf16 (2 passes)
    Frag<4> pa[NK];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const float pv4[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      frag_split<false>(pv4, pa[kk]);
    }
    float pv[4 * DO];
#pragma unroll
    for (int i = 0; i < 4 * DO; ++i) pv[i] = 0.f;
    pin(pv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint64_t off = kk * 256 >> 4;
      if constexpr (!EXACT) wgmma_m64n128k8(pv, pa[kk].big, vd_sml + off, 1);
      wgmma_m64n128k8(pv, pa[kk].small, vd_big + off, 1);
      wgmma_m64n128k8(pv, pa[kk].big, vd_big + off, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(pv);
#pragma unroll
    for (int d = 0; d < DO; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] += pv[4 * d + e];
  }

  store_rows<DO>(o + b * osb + h * osh, oss, rows, Sq, acc, l, m, lse,
                 (static_cast<long long>(b) * gridDim.y + h) * Sq, t);
}

template <int D, int DV, typename T>
int launch_wg(const T* q, const T* k, const T* v, T* o, int B, int Sq,
              int Sk, int H, int G, const long long* st, int kv_len,
              int q_offset, int causal, float scale, float* lse,
              cudaStream_t stream) {
  using S = WgSmem<D, DV, T>;
  static_assert(S::BYTES <= 232448,
                "a block's shared memory is at most 227 KB");
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wg_kernel<D, DV, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Sq + WG_BQ - 1) / WG_BQ, H, B);
  flash_fwd_wg_kernel<D, DV, T><<<grid, WG_THREADS, S::BYTES, stream>>>(
      q, k, v, o, Sq, Sk, G, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], kv_len, q_offset, causal, scale,
      lse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk,
          int H, int Hk, int D, int Dv, const long long* strides, int kv_len,
          int q_offset, int causal, float scale, float* lse, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || Hk < 1 || H % Hk != 0 ||
      kv_len < 1 || q_offset < 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // D = Dv < 128: the tile route (mma.sync; the wgmma route's P·V is one
  // m64n128 product); 128 and MLA's (192, 128): the wgmma route
#define REPRO_FLASH_CASE(DQK, DVV, ROUTE)                                 \
  if (D == DQK && Dv == DVV)                                              \
    return ROUTE<DQK, DVV, T>(q, k, v, o, B, Sq, Sk, H, G, strides,       \
                              kv_len, q_offset, causal, scale, lse, st);
  REPRO_FLASH_CASE(16, 16, launch_tile)
  REPRO_FLASH_CASE(32, 32, launch_tile)
  REPRO_FLASH_CASE(64, 64, launch_tile)
  REPRO_FLASH_CASE(80, 80, launch_tile)
  REPRO_FLASH_CASE(128, 128, launch_wg)
  REPRO_FLASH_CASE(192, 128, launch_wg)
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides: 12 values, (batch, seq, head) of q, k, v and o, in elements.
// D: the width of q and k; Dv: the width of v and o.
// lse: null, or (B, H, Sq) f32 for the row log-sum-exps (the backward's).
// The bf16 entry reads q, k, v and writes o as bf16; lse is f32 in both.
extern "C" int flash_attention_f32(
    const float* q, const float* k, const float* v, float* o, int B, int Sq,
    int Sk, int H, int Hk, int D, int Dv, const long long* strides,
    int kv_len, int q_offset, int causal, float scale, float* lse,
    void* stream) {
  return entry<float>(q, k, v, o, B, Sq, Sk, H, Hk, D, Dv, strides, kv_len,
                      q_offset, causal, scale, lse, stream);
}

extern "C" int flash_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* o, int B, int Sq, int Sk, int H, int Hk, int D, int Dv,
    const long long* strides, int kv_len, int q_offset, int causal,
    float scale, float* lse, void* stream) {
  return entry<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hk, D, Dv, strides,
                              kv_len, q_offset, causal, scale, lse, stream);
}
