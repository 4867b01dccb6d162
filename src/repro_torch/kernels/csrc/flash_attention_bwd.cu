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
// their (batch, sequence, head) strides with D contiguous; query head h
// reads key/value head h / G in place.  lse is (B, H, Sq), contiguous, in
// natural-log units of the scaled logits (the forward writes it).  dq, dk,
// dv are written contiguous in q's and k's shapes.
//
// Design (f32 on the SIMT cores; one launch of each of three kernels):
//   * dot_kernel: Di, one warp per (b, query, head) row;
//   * dkdv_kernel: one block per (64-key tile, KV head, b).  K and V stay in
//     shared memory; the block loops over the G query heads of its group
//     and, for each, over the 64-query tiles that can see its keys,
//     recomputing Pᵀ and dSᵀ for the tile and adding Pᵀ·dO and dSᵀ·q into
//     register accumulators;
//   * dq_kernel: one block per (64-query tile, head, b), looping over the
//     key tiles its rows can see and adding dS·k into registers.
// No atomics: every output element is written once, by one block, after a
// loop of fixed order, so two calls give the same bits.  A thread holds a
// 4 × 4 micro-tile of each 64 × 64 score tile (rows ty + 16i, columns
// tx + 16j) and 4 × D/16 entries of each (64, D) accumulator; shared rows
// are padded to D + 1 floats (64 + 1 for the score tiles), so the loads of
// every product are free of bank conflicts.  Tiles that lie wholly past
// kv_len or wholly above the causal diagonal are not visited.  Blocks are
// launched longest-first (causal: key tile 0 sees every query tile).
//
// Bound on the card.  The LM's training shape (B = 2, H = 40 over Kv = 8,
// S = 2048, D = 128, causal): five (S × S × D) products (Qkᵀ, dO vᵀ, Pᵀ dO,
// dS k, dSᵀ q) of causal work, 2.5 × the forward's two, 214.8 GFLOP; this
// design recomputes Qkᵀ and dO vᵀ in both passes (seven products).  Against
// 67 TFLOP/s f32 SIMT: 3.21 ms; the bytes (q, k, v, o, dO, lse in; dq, dk,
// dv out; 403 MB) take 0.12 ms.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;            // queries and keys per tile
constexpr int TP = T + 1;        // padded row of a score tile
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {   // (batch, sequence, head) strides, in elements
  long long b, s, h;
};

template <int D>
struct Smem {
  static constexpr int P = D + 1;                 // padded (·, D) row
  static constexpr int ROWS = T * P;              // one (64, D) tile
  static constexpr size_t DKDV = sizeof(float) * (4 * ROWS + 2 * T * TP
                                                   + 2 * T);
  static constexpr size_t DQ = sizeof(float) * (4 * ROWS + T * TP);
};

// rows [r0, r0 + 64) of one head of x into a padded tile (zeros past lim)
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0, int lim) {
  for (int i = threadIdx.x; i < T * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * Smem<D>::P + c] = r0 + r < lim ? src[(r0 + r) * ss + c] : 0.f;
  }
}

// s[i][j] += Σ_d X[ty + 16i][d]·Y[tx + 16j][d], and the same for a second
// pair (X2, Y2) into s2: the two score products of one tile in one loop
template <int D>
__device__ __forceinline__ void scores(const float* X, const float* Y,
                                       const float* X2, const float* Y2,
                                       float (&s)[4][4], float (&s2)[4][4]) {
  constexpr int P = Smem<D>::P;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = s2[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4], x2[4], y2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = X[(ty + 16 * i) * P + d];
      x2[i] = X2[(ty + 16 * i) * P + d];
      y[i] = Y[(tx + 16 * i) * P + d];
      y2[i] = Y2[(tx + 16 * i) * P + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i], y[j], s[i][j]);
        s2[i][j] = fmaf(x2[i], y2[j], s2[i][j]);
      }
  }
}

// acc[i][j] += Σ_c W[ty + 16i][c]·Y[c][tx + 16j] over the 64 rows c of Y
template <int D>
__device__ __forceinline__ void accumulate(const float* W, const float* Y,
                                           float (&acc)[4][D / 16]) {
  constexpr int P = Smem<D>::P;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int c = 0; c < T; ++c) {
    float w[4], y[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(ty + 16 * i) * TP + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = Y[c * P + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(w[i], y[j], acc[i][j]);
  }
}

// out rows [r0, r0 + 64) (below lim) of one head: acc · mul
template <int D>
__device__ __forceinline__ void store_rows(float* out, long long ss, int r0,
                                           int lim, float mul,
                                           const float (&acc)[4][D / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= lim) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) out[r * ss + tx + 16 * j] = acc[i][j] * mul;
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
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int G, Strides qs, Strides ks, Strides vs, Strides dos, int kv_len,
    int q_offset, int causal, float scale) {
  using S = Smem<D>;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + S::ROWS;
  float* Qs = Vs + S::ROWS;
  float* dOs = Qs + S::ROWS;
  float* Ps = dOs + S::ROWS;
  float* dSs = Ps + T * TP;
  float* Ls = dSs + T * TP;      // the query tile's lse, base 2
  float* Ds = Ls + T;            // ... and its Di

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * T;   // key tile 0 first: it has the most work
  const int hk = blockIdx.y, b = blockIdx.z;
  const int Hk = H / G;
  const int k_lim = min(kv_len, Sk);
  const float scale2 = scale * LOG2E;

  load_tile<D>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, k_lim);
  load_tile<D>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, k_lim);

  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // the first query that sees key k0 (causal), the tiles from there on
  const int nq = (Sq + T - 1) / T;
  int qt0 = 0;
  if (causal) qt0 = max(0, k0 - q_offset) / T;
  if (k0 >= k_lim) qt0 = nq;   // no visible key in this tile

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* qh = q + b * qs.b + h * qs.h;
    const float* dh = dout + b * dos.b + h * dos.h;
    const float* lh = lse + (static_cast<long long>(b) * H + h) * Sq;
    const float* dih = di + (static_cast<long long>(b) * H + h) * Sq;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * T;
      __syncthreads();   // the previous tile's reads are done
      load_tile<D>(Qs, qh, qs.s, q0, Sq);
      load_tile<D>(dOs, dh, dos.s, q0, Sq);
      if (threadIdx.x < T) {
        const int r = q0 + threadIdx.x;
        Ls[threadIdx.x] = r < Sq ? lh[r] * LOG2E : 0.f;
        Ds[threadIdx.x] = r < Sq ? dih[r] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<D>(Ks, Qs, Vs, dOs, s, dp);   // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, qi = q0 + c;
          const bool ok = qi < Sq && key < k_lim &&
                          (!causal || q_offset + qi >= key);
          const float p = ok ? exp2f(s[i][j] * scale2 - Ls[c]) : 0.f;
          Ps[(ty + 16 * i) * TP + c] = p;
          dSs[(ty + 16 * i) * TP + c] = p * (dp[i][j] - Ds[c]);
        }
      }
      __syncthreads();
      accumulate<D>(Ps, dOs, acc_v);    // dV += Pᵀ·dO
      accumulate<D>(dSs, Qs, acc_k);    // dK += dSᵀ·Q
    }
  }
  const long long kss = static_cast<long long>(Hk) * D;   // contiguous
  store_rows<D>(dk + static_cast<long long>(b) * Sk * kss + hk * D, kss, k0, Sk, scale, acc_k);
  store_rows<D>(dv + static_cast<long long>(b) * Sk * kss + hk * D, kss, k0, Sk, 1.f, acc_v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dq, int Sq, int Sk, int H, int G, Strides qs,
    Strides ks, Strides vs, Strides dos, int kv_len, int q_offset,
    int causal, float scale) {
  using S = Smem<D>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + S::ROWS;
  float* Ks = dOs + S::ROWS;
  float* Vs = Ks + S::ROWS;
  float* dSs = Vs + S::ROWS;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int k_lim = min(kv_len, Sk);
  const float scale2 = scale * LOG2E;

  load_tile<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<D>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  const float* lh = lse + (static_cast<long long>(b) * H + h) * Sq;
  const float* dih = di + (static_cast<long long>(b) * H + h) * Sq;
  float lrow[4], drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lrow[i] = r < Sq ? lh[r] * LOG2E : 0.f;
    drow[i] = r < Sq ? dih[r] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  int k_end = k_lim;
  if (causal) k_end = min(k_end, q_offset + min(q0 + T, Sq));
  const int ntiles = (max(k_end, 0) + T - 1) / T;
  const float* kh = k + b * ks.b + hk * ks.h;
  const float* vh = v + b * vs.b + hk * vs.h;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * T;
    __syncthreads();   // the previous tile's reads are done
    load_tile<D>(Ks, kh, ks.s, k0, k_lim);
    load_tile<D>(Vs, vh, vs.s, k0, k_lim);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(Qs, Ks, dOs, Vs, s, dp);   // S = Q·Kᵀ, dP = dO·Vᵀ
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = qi < Sq && key < k_lim &&
                        (!causal || q_offset + qi >= key);
        const float p = ok ? exp2f(s[i][j] * scale2 - lrow[i]) : 0.f;
        dSs[(ty + 16 * i) * TP + tx + 16 * j] = p * (dp[i][j] - drow[i]);
      }
    }
    __syncthreads();
    accumulate<D>(dSs, Ks, acc);   // dQ += dS·K
  }
  const long long qss = static_cast<long long>(H) * D;   // contiguous
  store_rows<D>(dq + static_cast<long long>(b) * Sq * qss + h * D, qss, q0, Sq, scale, acc);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* di, float* dq,
           float* dk, float* dv, int B, int Sq, int Sk, int H, int G,
           const Strides* st, int kv_len, int q_offset, int causal,
           float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<D>::DKDV));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(Smem<D>::DQ));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long rows = static_cast<long long>(B) * H * Sq;
  const unsigned dot_blocks =
      static_cast<unsigned>((rows * 32 + THREADS - 1) / THREADS);
  dot_kernel<<<dot_blocks, THREADS, 0, stream>>>(o, dout, di, B, Sq, H, D,
                                                 st[3], st[4]);
  const dim3 kv_grid((Sk + T - 1) / T, H / G, B);
  dkdv_kernel<D><<<kv_grid, THREADS, Smem<D>::DKDV, stream>>>(
      q, k, v, dout, lse, di, dk, dv, Sq, Sk, H, G, st[0], st[1], st[2],
      st[4], kv_len, q_offset, causal, scale);
  const dim3 q_grid((Sq + T - 1) / T, H, B);
  dq_kernel<D><<<q_grid, THREADS, Smem<D>::DQ, stream>>>(
      q, k, v, dout, lse, di, dq, Sq, Sk, H, G, st[0], st[1], st[2], st[4],
      kv_len, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 15 values, (batch, seq, head) of q, k, v, o and dO, in elements.
// di: a (B, H, Sq) f32 workspace.  dq (B, Sq, H, D), dk and dv (B, Sk, Hk, D)
// are written contiguous.
extern "C" int flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* di, float* dq, float* dk,
    float* dv, int B, int Sq, int Sk, int H, int Hk, int D,
    const long long* strides, int kv_len, int q_offset, int causal,
    float scale, void* stream) {
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
                               s);
    case 32: return launch<32>(q, k, v, o, dout, lse, di, dq, dk, dv, B, Sq,
                               Sk, H, G, st, kv_len, q_offset, causal, scale,
                               s);
    case 64: return launch<64>(q, k, v, o, dout, lse, di, dq, dk, dv, B, Sq,
                               Sk, H, G, st, kv_len, q_offset, causal, scale,
                               s);
    case 128: return launch<128>(q, k, v, o, dout, lse, di, dq, dk, dv, B,
                                 Sq, Sk, H, G, st, kv_len, q_offset, causal,
                                 scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
