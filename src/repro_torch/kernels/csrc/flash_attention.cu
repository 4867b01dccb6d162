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
//     the other instances take D = Dv in {16, 32, 64, 128}.
// Every tensor is addressed through its (batch, sequence, head) strides
// with D contiguous, so a KV cache (B, S_max, Kv, D) is read in place and
// the (BH, S, D) layout of the Pallas kernel is the case B = 1, H = BH.
//
// Design.  One block of 8 warps per (128-query tile, head, batch); each
// warp owns 16 query rows.  Both products run on the tensor cores in 3xTF32
// (mma_tf32.cuh: m16n8k8 fragments, f32 accuracy): S = Q·Kᵀ, each pass in
// its own accumulator, with the Q tile loaded once into shared memory and
// its fragments split per use, and O += P·V with the (16, D) f32
// accumulator in registers, each tile's P·V chained in fresh accumulators
// and added to it in f32.  K and V come in 32-key tiles through a
// double-buffered cp.async ring (16-byte copies, read in place through the
// strides; keys at or past kv_len are zero-filled), so the next tile is in
// flight while this one is multiplied.  Each landed tile is split into its
// TF32 big and small parts once for the block (not once per warp that
// reads it).  Shared rows are padded so every fragment load is free of bank
// conflicts (Q and K rows D + 8, read in 64-bit pairs; V rows D + 4); at
// D = 128 a block takes 172 KB, at (192, 128) 229,888 bytes of the
// 232,448 a block may have, one block (8 warps) per SM.  The row max
// and row sum are taken in registers from the S accumulator fragments (a
// row lives in one quad of lanes: two shuffles), in base 2 (exp2f).  With k
// permuted inside each group of 8 keys (mma_tf32.cuh), the S accumulator
// fragment is already P's A fragment for P·V: P never leaves the
// registers.  Key tiles that lie wholly past kv_len, or wholly above the
// diagonal under causal masking, are not loaded (per block) or not
// multiplied (per warp): there every p is 0 and alpha is 1, so skipping
// changes nothing.  Masked entries get p = 0 exactly.  Query tiles are
// launched last-first, so that the longest causal rows start first.  IEEE
// division; one pass of TF32 is never used: f32 means f32.  On request
// (a non-null lse) it also writes each row's log-sum-exp, m + log l in
// natural-log units, which the backward (flash_attention_bwd.cu) recomputes
// P from; without it nothing else changes, so serving keeps its bits.
//
// bf16 q, k and v (mixed-precision training) are read in place, and the
// output o is written in their dtype (rounded to nearest even), the lse in
// f32.  A bf16 value is exact in f32 and in TF32's big part (its small
// part is 0), so the bf16 route keeps the f32 route's tiles, orders and
// all three passes (the zero small parts included: dropping them is a
// later redesign) and gives the f32 kernel's bits on the inputs widened to
// f32, o then rounded to bf16.  The Q tile is loaded with 16-byte loads of
// 8 values, widened and stored as f32; each K/V tile lands by cp.async in
// a bf16 landing zone (two, in the space of the second f32 stage) and is
// widened and split into the first stage and the small parts in one pass,
// so the shared bytes are the f32 route's.
//
// Bound on the card.  Prefill of the LM (B = 4, H = 40, Kv = 8, S = 2048,
// D = 128, causal): 2·B·H·S²·D = 172 GFLOP of causal work against 403 MB
// of bytes — bound by operations: 2.6 ms at the 67 TFLOP/s f32 SIMT peak,
// 1.0 ms for 3 x that work at the 495 TFLOP/s TF32 tensor-core peak.
// MLA's prefill (B = 4, H = Kv = 16, S = 2048, (D, Dv) = (192, 128),
// causal): B·H·S²·(D + Dv) = 85.9 GFLOP, 0.52 ms as 3xTF32 at 495 TFLOP/s,
// 1.28 ms at the f32 SIMT peak.
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
  // two ring stages of K and V, the small parts of the current stage, Q
  static constexpr int FLOATS = 3 * STAGE + BQ * QS;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  // bf16: a tile's K rows of D values, then its V rows of DV, back to back
  static constexpr int LAND = BKV * (D + DV) / 2;   // floats
  static_assert(2 * LAND <= STAGE, "two bf16 zones fill one f32 stage");
};

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
  // lands in zone t & 1 (the second stage's space) and is widened and split
  // into stage 0.  Ks below is the split tile's stage either way.
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

  // the Q tile (rows past Sq zero-filled), with the first K/V tile; bf16
  // rows are widened on the way (plain 16-byte loads, seen by every warp
  // after the loop's first barrier)
  for (int i = threadIdx.x; i < BQ * (D / V8); i += THREADS) {
    const int r = i / (D / V8), c = (i % (D / V8)) * V8;
    const bool in = q0 + r < Sq;
    if constexpr (WIDE) {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (in)
        widen8(__ldg(reinterpret_cast<const uint4*>(qb + (q0 + r) * qss + c)),
               f);
      *reinterpret_cast<float4*>(Qs + r * S::QS + c) =
          make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(Qs + r * S::QS + c + 4) =
          make_float4(f[4], f[5], f[6], f[7]);
    } else {
      cp_async16(Qs + r * S::QS + c, in ? qb + (q0 + r) * qss + c : qb,
                 in ? 16 : 0);
    }
  }
  if (ntiles > 0) load(0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile it has landed (this thread's copies)
    __syncthreads();      // ... and every thread's
    // split the tile once for the block: big parts in its stage, small
    // to Sm
    float* Kt = WIDE ? smem : smem + (it & 1) * S::STAGE;
    if constexpr (WIDE) {
      const T* Kl = land(it);
      widen_split_rows(Kl, BKV, D, Kt, Sm, S::KS);
      widen_split_rows(Kl + BKV * D, BKV, DV, Kt + BKV * S::KS,
                       Sm + BKV * S::KS, S::VS);
    } else {
      split_smem(Kt, Sm, S::STAGE / 4);
    }
    __syncthreads();
    const int k0 = it * BKV;
    if (warp_rows && (!causal || k0 <= w_last)) {
      const float* Ks = Kt;
      const float* Vs = Ks + BKV * S::KS;
      // S = Q·Kᵀ, each 3xTF32 pass in its own accumulator (three chains of
      // D/8 dependent products instead of one of 3·D/8), summed after
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
        frag_split<false>(qv, qa);
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int ko = (j * 8 + g) * S::KS + kd * 8 + 2 * t;
          const float2 kbig = load_pair(Ks + ko), ksml = load_pair(Sm + ko);
          const Frag<2> kf = {
              {__float_as_uint(kbig.x), __float_as_uint(kbig.y)},
              {__float_as_uint(ksml.x), __float_as_uint(ksml.y)}};
          mma_tf32(s_bs[j], qa.big, kf.small);
          mma_tf32(s_sb[j], qa.small, kf.big);
          mma_tf32(s[j], qa.big, kf.big);
        }
      }

#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s_bs[j][e] + s_sb[j][e];

      // online softmax of rows g (half 0) and g + 8 (half 1); a row's 32
      // scores sit in the 4 lanes of one quad, 8 each
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
          const float* vs = Sm + BKV * S::KS + vo;
          const Frag<2> vf = {
              {__float_as_uint(Vs[vo]), __float_as_uint(Vs[vo + S::VS])},
              {__float_as_uint(vs[0]), __float_as_uint(vs[S::VS])}};
          mma_3xtf32<false, false>(pv_acc[d], pa, vf);
        }
      }
#pragma unroll
      for (int d = 0; d < DO; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] += pv_acc[d][e];
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = rows[hf];
    if (r >= Sq) continue;
    const float den = fmaxf(l[hf], 1e-30f);
#pragma unroll
    for (int d = 0; d < DO; ++d) {
      const float2 y =
          make_float2(acc[d][2 * hf] / den, acc[d][2 * hf + 1] / den);
      if constexpr (WIDE)
        *reinterpret_cast<__nv_bfloat162*>(ob + r * oss + d * 8 + 2 * t) =
            __floats2bfloat162_rn(y.x, y.y);
      else
        *reinterpret_cast<float2*>(ob + r * oss + d * 8 + 2 * t) = y;
    }
    // the log-sum-exp of the row's scaled logits, for the backward: m and
    // l are base 2, so lse = (m + log2 l)·ln 2
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + r] =
          (m[hf] + log2f(l[hf])) * 0.6931471805599453f;
  }
}

template <int D, int DV, typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B,
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

template <typename T>
int entry(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk,
          int H, int Hk, int D, int Dv, const long long* strides, int kv_len,
          int q_offset, int causal, float scale, float* lse, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || Hk < 1 || H % Hk != 0 ||
      kv_len < 1 || q_offset < 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(DQK, DVV)                                        \
  if (D == DQK && Dv == DVV)                                              \
    return launch<DQK, DVV, T>(q, k, v, o, B, Sq, Sk, H, G, strides,      \
                               kv_len, q_offset, causal, scale, lse, st);
  REPRO_FLASH_CASE(16, 16)
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(192, 128)
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
