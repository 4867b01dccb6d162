// Segment-sum scatter of unsorted per-sample row gradients, Hopper (sm_90a),
// in one launch that writes every output row exactly once, with no atomics.
//
// Replaces src/repro/kernels/scatter_accum.py::scatter_accum (the Pallas
// TPU kernel `_kernel`, a one-hot (rows × B) sweep through the MXU).
// Inputs: g (B, J) f32 row gradients in batch order and their int32 row
// ids (B,), in any order.  The output (rows, J) may hold anything on entry;
// on return
//     out[r][j] = ((0 + g[b0][j]) + g[b1][j]) + …   over b0 < b1 < … with
//                                                   idx[b] = r
//     out[r][j] = 0                                 where no id is r
// in ascending batch position, with __fadd_rn, and ids outside [0, rows)
// are dropped.  That is the order of jax.ops.segment_sum on the CPU, and of
// segment_reduce.cu over the stable-sorted batch, so the unsorted step
// equals the sorted one bit for bit, on every run.  Each row's fold is the
// same sequence of adds whatever the plan, so the bits do not depend on the
// number of blocks either.
//
// Each block owns a contiguous range of RB output rows
// (scatter_accum.py::plan), and 512 threads walk it in sub-tiles of TR rows
// that fit shared memory.  Per round of CH = 4096 batch positions a block:
//   1. reads the round's ids, 8 a thread as two 16-byte loads issued back
//      to back, laid out so that each warp instruction reads 512
//      contiguous bytes (position 256w + 128q + 4l + u for lane l of warp
//      w, load q, entry u);
//   2. marks the ids in its row range and compacts them into a list in
//      batch order: two interleaved warp scans (shuffles, one per load q)
//      and the warps' totals give each hit its place, and the hits go into
//      shared memory as (position, row) pairs packed in one word.  The
//      thread that writes a hit also puts its gradient row into a staging
//      area at the same place (2048 staged floats; hits past that are
//      staged in later passes, all threads together).  At J <= 4 a thread
//      loads the rows of its first two hits as soon as its ids arrive, so
//      their latency overlaps the scan and the barrier;
// and for each sub-tile, zeroed while its first round's ids are read:
//   3. folds the staged rows of the sub-tile's hits into it: one group of
//      W = min(next_pow2(J), 32) lanes per residue of the row modulo the
//      group count takes the hits of its rows in list order, so each row is
//      folded by one group in batch order (a row's running sum stays in
//      registers while its hits follow each other).  A warp reads the list
//      32 entries at a time and one ballot per group in it marks the
//      group's entries, so a group touches its own hits only.  Lane l folds
//      columns l, l + 32 (J <= 64);
//   4. writes the sub-tile with 16-byte stores where its start is 16-byte
//      aligned (RB and TR are multiples of 4), 4-byte stores for the rest.
// With one round (B <= 4096, the training batch) the list is built once
// and serves every sub-tile; with more, each sub-tile lists each round
// again.
//
// Bound on the card: memory.  It reads B·J + B values and writes the dense
// rows·J output, which at the training shapes is most of the bytes (mode 0
// of the Netflix shape: 480,189 × 4 floats).  But every block reads every
// id, so the grid reads blocks × B ids (16 kB a block at the training
// batch), and that time grew with the blocks; fewer blocks of 256 threads
// lost more on their longer lists and row ranges than they saved.  So a
// block is 512 threads, one a SM (128 blocks at every Netflix mode), which
// halves the ids read at the same work a thread.  The steps of a block are chained
// (ids, then rows, then fold, then write), so at the small modes its time
// is those latencies; one launch (no separate zero fill) and no float
// atomics are what the design buys.
#include <cstdint>

#include "common.cuh"

#define SCATTER_THREADS 512
#define SCATTER_LOADS 2         // 16-byte id loads a thread makes a round
#define SCATTER_IDS (4 * SCATTER_LOADS)                 // ids a thread reads
#define SCATTER_CHUNK (SCATTER_THREADS * SCATTER_IDS)   // 4096 a round
#define SCATTER_WARP_IDS (32 * SCATTER_IDS)             // ids a warp reads
#define SCATTER_STAGE 2048      // floats of gradient rows staged a pass

// A gradient row of J <= 4 values as a float4 (0 past J); `ok` false
// loads nothing.
__device__ __forceinline__ float4 load_row4(const float* __restrict__ g,
                                            long long p, int J, bool vec,
                                            bool ok) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) {
    if (vec) {
      v = __ldg(reinterpret_cast<const float4*>(g + p * 4));
    } else {
      const float* r = g + p * J;
      v.x = __ldg(r);
      if (J > 1) v.y = __ldg(r + 1);
      if (J > 2) v.z = __ldg(r + 2);
    }
  }
  return v;
}

// The same row into the staging area.
__device__ __forceinline__ void store_row4(float* __restrict__ dst, float4 v,
                                           int J) {
  if (J == 4) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    dst[0] = v.x;
    if (J > 1) dst[1] = v.y;
    if (J > 2) dst[2] = v.z;
  }
}

// One hit's gradient row into the staging area, loaded and stored here
// (out of line: the rare third hit of a thread, and rows wider than 4).
__device__ __noinline__ void stage_row(const float* __restrict__ g,
                                       float* __restrict__ gs, long long p,
                                       int slot, int J, bool vec) {
  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(g + p * J);
    float4* dst = reinterpret_cast<float4*>(gs + slot * J);
    for (int j = 0; j < J / 4; ++j) dst[j] = __ldg(src + j);
  } else {
    for (int j = 0; j < J; ++j) gs[slot * J + j] = __ldg(g + p * J + j);
  }
}

// Steps 1-2 for the round at c0: the block's hits in batch order in
// `hits`, the first `cap` of them staged in `gs`; `zero` floats of `tile`
// are zeroed while the ids are on their way.  Returns the hits' count.
// Entry k = 4q + u of a thread is position 256·warp + 128q + 4·lane + u.
__device__ __forceinline__ int list_round(
    const float* __restrict__ g, const int* __restrict__ idx,
    unsigned* __restrict__ hits, float* __restrict__ gs,
    float* __restrict__ tile, int zero, int* warp_hits, long long B, int J,
    long long c0, long long r0, int nr, int cap, bool vec_ids, bool vec_g) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pos0 = SCATTER_WARP_IDS * warp + 4 * lane;   // entry 0's place
  const long long p0 = c0 + pos0;
  // the loads first, back to back, then their tests
  int id[SCATTER_IDS];
  if (vec_ids && p0 + 128 * (SCATTER_LOADS - 1) + 4 <= B) {
#pragma unroll
    for (int q = 0; q < SCATTER_LOADS; ++q) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(idx + p0 + 128 * q));
      id[4 * q] = v.x;
      id[4 * q + 1] = v.y;
      id[4 * q + 2] = v.z;
      id[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < SCATTER_IDS; ++k) {
      const long long p = p0 + 128 * (k >> 2) + (k & 3);
      id[k] = p < B ? __ldg(idx + p) : -1;
    }
  }
  for (int i = threadIdx.x; i < zero; i += blockDim.x) tile[i] = 0.f;
  unsigned mask = 0;     // bit k: entry k is a hit of this block
  unsigned word[SCATTER_IDS];  // its list word: (place in the round, row)
#pragma unroll
  for (int k = 0; k < SCATTER_IDS; ++k) {
    const long long r = static_cast<long long>(id[k]) - r0;
    const int pos = pos0 + 128 * (k >> 2) + (k & 3);
    const bool in = c0 + pos < B && r >= 0 && r < nr;
    mask |= static_cast<unsigned>(in) << k;
    word[k] = (static_cast<unsigned>(pos) << 16) | static_cast<unsigned>(r);
  }
  // the rows of this thread's first two hits, issued before the scan
  const bool hold = J <= 4;
  const unsigned rest = mask & (mask - 1);
  const int k0 = __ffs(mask) - 1, k1 = __ffs(rest) - 1;
  const float4 held0 = load_row4(
      g, c0 + pos0 + 128 * (k0 >> 2) + (k0 & 3), J, vec_g, hold && mask != 0);
  const float4 held1 = load_row4(
      g, c0 + pos0 + 128 * (k1 >> 2) + (k1 & 3), J, vec_g, hold && rest != 0);
  // batch order within the warp is (q, lane, u): a scan over the lanes
  // for each q, and the q's totals before it
  int cnt[SCATTER_LOADS], incl[SCATTER_LOADS];
#pragma unroll
  for (int q = 0; q < SCATTER_LOADS; ++q)
    incl[q] = cnt[q] = __popc((mask >> (4 * q)) & 15u);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < SCATTER_LOADS; ++q) {
      const int v = __shfl_up_sync(REPRO_FULL_MASK, incl[q], off);
      if (lane >= off) incl[q] += v;
    }
  }
  int off_q[SCATTER_LOADS];
  int wsum = 0;
#pragma unroll
  for (int q = 0; q < SCATTER_LOADS; ++q) {
    off_q[q] = wsum + incl[q] - cnt[q];
    wsum += __shfl_sync(REPRO_FULL_MASK, incl[q], 31);
  }
  if (lane == 0) warp_hits[warp] = wsum;
  __syncthreads();
  int base = 0, H = 0;
#pragma unroll
  for (int w = 0; w < SCATTER_THREADS / 32; ++w) {
    const int c = warp_hits[w];
    if (w < warp) base += c;
    H += c;
  }
  int t = 0;   // this thread's hits so far
#pragma unroll
  for (int k = 0; k < SCATTER_IDS; ++k) {
    if ((mask >> k) & 1u) {
      // after the hits of earlier q (off_q) and of this q's earlier u
      const int slot = base + off_q[k >> 2] +
                       __popc((mask >> (k & ~3)) & ((1u << (k & 3)) - 1u));
      hits[slot] = word[k];
      if (slot < cap) {
        if (hold && t < 2)
          store_row4(gs + slot * J, t == 0 ? held0 : held1, J);
        else
          stage_row(g, gs, c0 + (word[k] >> 16), slot, J, vec_g);
      }
      ++t;
    }
  }
  __syncthreads();   // the list and the first pass are in place
  return H;
}

template <int E>
__global__ void __launch_bounds__(SCATTER_THREADS, 1) scatter_accum_kernel(
    const float* __restrict__ g, const int* __restrict__ idx,
    float* __restrict__ out, long long B, int J, long long rows, int W,
    int RB, int TR, float inv_j) {
  extern __shared__ __align__(16) float smem[];
  unsigned* hits = reinterpret_cast<unsigned*>(smem);           // (CHUNK,)
  float* gs = reinterpret_cast<float*>(hits + SCATTER_CHUNK);   // (STAGE,)
  float* tile = gs + SCATTER_STAGE;                             // (TR, J)
  __shared__ int warp_hits[SCATTER_THREADS / 32];
  const long long r0 = static_cast<long long>(blockIdx.x) * RB;
  const int nr = static_cast<int>(min(static_cast<long long>(RB), rows - r0));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = threadIdx.x & (W - 1);
  const int groups = blockDim.x / W;
  const int group = threadIdx.x / W;
  const bool vec_ids = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const bool vec_g = J % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const bool one_round = B <= SCATTER_CHUNK;
  const int cap = SCATTER_STAGE / J;   // hits staged a pass
  int H = 0;          // hits of the listed round
  int staged = 0;     // the first hit of the pass that gs holds

  for (int t0 = 0; t0 < nr; t0 += TR) {
    const int nt = min(TR, nr - t0);
    const int total = nt * J;
    int cur = -1;      // the tile row whose running sum acc holds
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (long long c0 = 0; c0 < B; c0 += SCATTER_CHUNK) {
      // the tile is zeroed before its first round's fold
      const int zero = c0 == 0 ? total : 0;
      if (t0 == 0 || !one_round) {
        H = list_round(g, idx, hits, gs, tile, zero, warp_hits, B, J, c0, r0,
                       nr, cap, vec_ids, vec_g);
        staged = 0;
      } else {
        for (int i = threadIdx.x; i < zero; i += blockDim.x) tile[i] = 0.f;
        __syncthreads();
      }
      for (int h0 = 0; h0 < H; h0 += cap) {
        const int nh = min(cap, H - h0);
        if (staged != h0) {
          for (int i = threadIdx.x; i < nh * J; i += blockDim.x) {
            const int k = div_small(i, inv_j);
            gs[i] = __ldg(g + (c0 + (hits[h0 + k] >> 16)) * J + (i - k * J));
          }
          staged = h0;
          __syncthreads();
        }
        // 3. entry k0 + lane's owner group, then this group's entries as a
        // mask; the group folds them in order
        for (int k0 = 0; k0 < nh; k0 += 32) {
          const int k = k0 + lane;
          int owner = -1;
          if (k < nh) {
            const int r = static_cast<int>(hits[h0 + k] & 0xffffu) - t0;
            if (r >= 0 && r < nt) owner = r & (groups - 1);
          }
          unsigned mine = 0;
          for (int q = 0; q < 32 / W; ++q) {
            const unsigned b =
                __ballot_sync(REPRO_FULL_MASK, owner == warp * (32 / W) + q);
            if (group == warp * (32 / W) + q) mine = b;
          }
          while (mine != 0) {
            const int kk = k0 + __ffs(mine) - 1;
            mine &= mine - 1;
            const int r = static_cast<int>(hits[h0 + kk] & 0xffffu) - t0;
            if (r != cur) {
#pragma unroll
              for (int e = 0; e < E; ++e) {
                const int j = sub + 32 * e;
                if (j < J) {
                  if (cur >= 0) tile[cur * J + j] = acc[e];
                  acc[e] = tile[r * J + j];
                }
              }
              cur = r;
            }
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const int j = sub + 32 * e;
              if (j < J) acc[e] = __fadd_rn(acc[e], gs[kk * J + j]);
            }
          }
        }
        __syncthreads();   // gs and the list may be rewritten after this
      }
    }
    if (cur >= 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = sub + 32 * e;
        if (j < J) tile[cur * J + j] = acc[e];
      }
    }
    __syncthreads();

    // 4. every row of the sub-tile, once
    float* dst = out + (r0 + t0) * J;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      head = total / 4 * 4;
      const float4* src4 = reinterpret_cast<const float4*>(tile);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int i = threadIdx.x; i < total / 4; i += blockDim.x)
        dst4[i] = src4[i];
    }
    for (int i = head + threadIdx.x; i < total; i += blockDim.x)
      dst[i] = tile[i];
    __syncthreads();   // the tile is free for the next sub-tile
  }
}

template <int E>
static int launch_scatter(const float* g, const int* idx, float* out,
                          long long B, int J, long long rows, int W, int RB,
                          int TR, float inv_j, long long blocks, size_t smem,
                          cudaStream_t s) {
  // the kernel's static shared memory (warp_hits) counts against the same
  // 48 kB that a launch may use without opting in
  if (smem > 47 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scatter_accum_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scatter_accum_kernel<E><<<static_cast<unsigned>(blocks), SCATTER_THREADS,
                            smem, s>>>(g, idx, out, B, J, rows, W, RB, TR,
                                       inv_j);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scatter_accum_f32(
    const float* g, const int* idx, float* out, long long B, int J,
    long long rows, int RB, int TR, long long blocks, void* stream) {
  if (B < 1 || J < 1 || J > REPRO_MAX_WIDTH || rows < 1 || RB < 4 ||
      RB % 4 != 0 || RB > 0xffff || TR < 4 || TR % 4 != 0 || TR > RB ||
      blocks < 1 || blocks > 0x7fffffffLL || blocks * RB < rows ||
      (blocks - 1) * RB >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (SCATTER_CHUNK + SCATTER_STAGE +
                                       static_cast<size_t>(TR) * J);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const int W = group_width(J, J);
  const float inv_j = 1.f / static_cast<float>(J);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane_entries(J, J) == 1)
    return launch_scatter<1>(g, idx, out, B, J, rows, W, RB, TR, inv_j,
                             blocks, smem, s);
  return launch_scatter<2>(g, idx, out, B, J, rows, W, RB, TR, inv_j, blocks,
                           smem, s);
}
