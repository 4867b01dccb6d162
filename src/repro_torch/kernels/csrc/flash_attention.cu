// Flash-attention forward (online softmax), Hopper (sm_90a), f32.
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
//     cache), so the causal test is q_offset + i >= j.
// Every tensor is addressed through its (batch, sequence, head) strides
// with D contiguous, so a KV cache (B, S_max, Kv, D) is read in place and
// the (BH, S, D) layout of the Pallas kernel is the case B = 1, H = BH.
//
// Design.  One block of 256 threads per (64-query tile, head, batch).  The
// Q tile stays in shared memory; the block walks the 64-key tiles of K and
// V, which it stores transposed (K) and row-major (V) in shared memory, and
// keeps the (64, D) f32 accumulator in registers: thread (ty, tx) owns
// query rows ty·4 + {0..3}, score columns tx + 16·{0..3} and output columns
// tx + 16·{0..D/16-1}.  Row max and row sum are reduced over the 16 lanes
// that share a row with shuffles.  The probabilities go through shared
// memory (into the K buffer, whose tile is spent by then) for the P·V
// product.  Key tiles that lie wholly past kv_len, or wholly above the
// diagonal under causal masking, are skipped: there every p is 0 and
// alpha is 1, so skipping changes nothing.  Masked entries get p = 0
// exactly.  Query tiles are launched last-first, so that the longest
// causal rows start first.  expf, IEEE division, fmaf; no tensor cores and
// no TF32: f32 means f32.
//
// Bound on the card.  Prefill of the LM (B = 4, H = 40, Kv = 8, S = 2048,
// D = 128, causal): 2·B·H·S²·D = 172 GFLOP of causal work against 403 MB
// of bytes — bound by operations (2.6 ms at the 67 TFLOP/s f32 peak).  The
// shared-memory reads (about one per two fmaf) and the SIMT core keep this
// kernel well below that; tensor cores are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

template <int D>
struct Smem {
  static constexpr int QS = D + 1;                  // Qs[BQ][D+1]
  static constexpr int KS = BKV + 1;                // Kt[D][BKV+1], then P
  static constexpr int VS = D + 1;                  // Vs[BKV][D+1]
  static constexpr int KROWS = D > BQ ? D : BQ;     // P[BQ][BKV+1] reuses Kt
  static constexpr int FLOATS = BQ * QS + KROWS * KS + BKV * VS;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
    int G, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int kv_len,
    int q_offset, int causal, float scale) {
  constexpr int DJ = D / 16;
  using S = Smem<D>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = Qs + BQ * S::QS;
  float* Ps = Kt;
  float* Vs = Kt + S::KROWS * S::KS;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[r * S::QS + d] = q0 + r < Sq ? qb[(q0 + r) * qss + d] : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // keys this tile can see: below kv_len and, if causal, at or before the
  // position of its last query row
  int k_end = min(kv_len, Sk);
  if (causal) k_end = min(k_end, q_offset + min(q0 + BQ, Sq));

  for (int k0 = 0; k0 < k_end; k0 += BKV) {
    __syncthreads();  // the previous tile's P and V are spent
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < Sk;
      Kt[d * S::KS + c] = in ? kb[(k0 + c) * kss + d] : 0.f;
      Vs[c * S::VS + d] = in ? vb[(k0 + c) * vss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * S::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * S::KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }
    __syncthreads();  // every thread is done with Kt: P may overwrite it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < kv_len && kpos < Sk && (!causal || qpos >= kpos);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(REPRO_FULL_MASK, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * S::KS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(REPRO_FULL_MASK, sum, off, 16);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a row of P is written and read by one half-warp

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * S::KS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * S::VS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  float* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[r * oss + tx + 16 * j] = acc[i][j] / den;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int Sq, int Sk, int H, int G, const long long* st, int kv_len,
           int q_offset, int causal, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<D>::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
      q, k, v, o, Sq, Sk, G, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], kv_len, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 values, (batch, seq, head) of q, k, v and o, in elements.
extern "C" int flash_attention_f32(
    const float* q, const float* k, const float* v, float* o, int B, int Sq,
    int Sk, int H, int Hk, int D, const long long* strides, int kv_len,
    int q_offset, int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || Hk < 1 || H % Hk != 0 ||
      kv_len < 1 || q_offset < 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Sk, H, G, strides, kv_len,
                               q_offset, causal, scale, st);
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, G, strides, kv_len,
                               q_offset, causal, scale, st);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, G, strides, kv_len,
                               q_offset, causal, scale, st);
    case 128: return launch<128>(q, k, v, o, B, Sq, Sk, H, G, strides, kv_len,
                                 q_offset, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
