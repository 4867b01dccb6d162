// Sorted segment-sum of mode-sorted row gradients, Hopper (sm_90a), in one
// launch that writes every output row exactly once.
//
// Replaces src/repro/kernels/segment_reduce.py::segment_reduce (the Pallas
// TPU kernel `_kernel`).  Inputs: g (B, J) f32 row gradients already
// permuted into mode-sorted order, and the sorted int32 row ids (B,)
// (duplicates adjacent, in batch order: a stable sort).  The output (rows,
// J) may hold anything on entry; on return
//     out[r][j] = ((0 + g[p][j]) + g[p+1][j]) + …   over the run of id r
//     out[r][j] = 0                                 where no id is r
// in ascending sorted position, and ids outside [0, rows) are dropped.
//
// The TPU kernel walks the batch tiles in order on one core and adds each
// entry into a VMEM-resident output.  Here each block owns a contiguous
// range of RB output rows (segment_reduce.py::plan) and:
//   1. zeroes its rows in a shared-memory tile;
//   2. finds the span [lo, hi) of sorted positions whose ids fall in its
//      range, by two lower-bound searches over the sorted ids that one
//      warp runs while the others zero the tile: each round tests 32
//      positions per target and counts them with a ballot, so a range
//      shrinks 32-fold a round (3 rounds at B = 4096).  Every block searches
//      the same ids, so more probes a round (a block-wide search, or all
//      4096 ids at once) measured slower: they crowd the same L2 lines;
//   3. stages the span's ids and gradient rows in shared memory, CH
//      positions at a time, and folds each run of equal ids with one group
//      of W = min(next_pow2(J), 32) lanes into the tile (lane l folds
//      columns l, l + 32, … < J: up to two at J <= 64).  A run starts from the
//      tile's value: 0 at a run's first entry, the running sum where a run
//      goes on from the last chunk, so the adds are those of one walk from
//      0.f in sorted order, with __fadd_rn (no FMA contraction);
//   4. writes its rows with 16-byte stores where the range's start is
//      16-byte aligned (RB is a multiple of 4, so it is for any J on an
//      aligned output), 4-byte stores for the rest.
// Ids below 0 come before block 0's span and ids >= rows after the last
// block's, so they are dropped with no test.  There are no atomics: the
// result is the same bits on every run, bitwise equal to the ordered plain
// version (ref.segment_reduce_ref) and to jax.ops.segment_sum of the
// unsorted batch — the reference's own contract (segment_reduce.py:13-18).
//
// Bound on the card: memory.  It reads B·J + B values and writes the dense
// rows·J output, which at the training shapes is most of the bytes (mode 0
// of the Netflix shape: 480,189 × 4 floats).  At the smaller modes a call
// moves a few tens of kB and the launch and the searches' latency set its
// time; one launch (no separate zero fill) is what the design buys there.
//
// The walk route (segment_reduce_kernel_walk) serves calls whose runs are
// long (plan(): B at least WALK_MIN_RUN × rows, as in the ALS and CCD sums
// over a whole tensor: runs of ~49,000 at the Netflix shape's mode 2).  The
// staged route folds such a run 256 positions a stage with one group of
// lanes while the block's other groups wait, run after run.  Here every
// group of W lanes owns one output row: it finds the row's run [start, end)
// with two (W + 1)-ary searches over the sorted ids (a ballot over the
// group's lanes; W = 1 is a binary search), folds the run from global
// memory in sorted order from 0.f with __fadd_rn, 8 positions' loads issued
// before their adds, and writes the row once.  The same adds in the same
// order as the staged route and the plain version: the same bits.
#include <cstdint>

#include "common.cuh"

// First positions in [0, B) whose ids are >= t0 and >= t1 (B where there
// is none), searched by one warp: each round every lane tests one position
// per target (the same one while the two ranges agree) and a ballot counts
// the ids below, so a range shrinks 32-fold a round with no block barrier
// (3 rounds at B = 4096).  Few probes a round keep the blocks, which all
// search the same ids, from crowding the same L2 lines.
__device__ __forceinline__ void warp_lower_bounds(
    const int* __restrict__ idx, long long B, long long t0, long long t1,
    long long& lo, long long& hi) {
  const int lane = threadIdx.x & 31;
  long long a[2] = {0, 0};
  long long b[2] = {B, B};
  const long long target[2] = {t0, t1};
  // invariant: ids before a[k] are < target[k], ids from b[k] on are >=
  while (a[0] < b[0] || a[1] < b[1]) {   // the same bounds in every lane
    long long stride[2];
    int v[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      stride[k] = (b[k] - a[k] + 31) / 32;
      const long long q = a[k] + lane * stride[k];
      v[k] = a[k] < b[k] && q < b[k] ? idx[q] : 0;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long q = a[k] + lane * stride[k];
      const int count = __popc(__ballot_sync(
          REPRO_FULL_MASK, a[k] < b[k] && q < b[k] && v[k] < target[k]));
      if (a[k] >= b[k]) continue;
      // the tested ids are sorted: the first count of them are below
      if (count == 0) {
        b[k] = a[k];
      } else {
        const long long next = a[k] + count * stride[k];
        a[k] += (count - 1) * stride[k] + 1;
        if (next < b[k]) b[k] = next;
      }
    }
  }
  lo = a[0];
  hi = a[1];
}

__global__ void __launch_bounds__(256) segment_reduce_kernel(
    const float* __restrict__ g, const int* __restrict__ idx,
    float* __restrict__ out, long long B, int J, long long rows, int W,
    int RB, int CH) {
  extern __shared__ float smem[];
  float* tile = smem;                               // (RB, J) block's rows
  int* ids = reinterpret_cast<int*>(tile + RB * J);  // (CH,) sorted ids
  float* gs = reinterpret_cast<float*>(ids + CH);    // (CH, J) their rows
  const long long r0 = static_cast<long long>(blockIdx.x) * RB;
  const int nr = static_cast<int>(min(static_cast<long long>(RB), rows - r0));
  __shared__ long long span[2];
  const int total = nr * J;
  if (threadIdx.x < 32) {
    long long lo, hi;
    warp_lower_bounds(idx, B, r0, r0 + nr, lo, hi);
    if (threadIdx.x == 0) {
      span[0] = lo;
      span[1] = hi;
    }
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) tile[i] = 0.f;
  __syncthreads();
  const long long lo = span[0];
  const long long hi = span[1];
  const int sub = threadIdx.x & (W - 1);
  const int group = threadIdx.x / W;
  const int groups = blockDim.x / W;
  for (long long c0 = lo; c0 < hi; c0 += CH) {
    const int n = static_cast<int>(min(static_cast<long long>(CH), hi - c0));
    for (int k = threadIdx.x; k < n; k += blockDim.x) ids[k] = idx[c0 + k];
    for (int k = threadIdx.x; k < n * J; k += blockDim.x)
      gs[k] = g[c0 * J + k];
    __syncthreads();
    // one group per run of equal ids in the chunk (a run's first entry,
    // or the chunk's first, which may go on from the last chunk)
    for (int p = group; p < n; p += groups) {
      const int id = ids[p];
      if (p > 0 && ids[p - 1] == id) continue;
      for (int j = sub; j < J; j += 32) {
        float* dst = tile + static_cast<long long>(id - r0) * J + j;
        float acc = *dst;
        for (int q = p; q < n && ids[q] == id; ++q)
          acc = __fadd_rn(acc, gs[q * J + j]);
        *dst = acc;
      }
    }
    __syncthreads();
  }
  float* dst = out + r0 * J;
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
}

// First position in [a, B) whose id is >= t, by the W lanes of a group
// (lanes sharing `mask`): each round the lanes probe the W cut points that
// split [a, b) into W + 1 parts, and a ballot counts the ids below t; the
// tested ids are sorted, so those are the first `count` cuts.  Every lane
// of the group keeps the same bounds.
__device__ __forceinline__ long long group_lower_bound(
    const int* __restrict__ idx, long long a, long long B, long long t,
    int sub, int W, unsigned mask) {
  long long b = B;
  // invariant: ids before a are < t, ids from b on are >= t
  while (a < b) {
    const long long len = b - a;
    const long long q = a + (sub + 1) * len / (W + 1);
    const int count = __popc(__ballot_sync(mask, idx[q] < t) & mask);
    if (count == 0) {
      b = a + len / (W + 1);
    } else {
      const long long next_a = a + count * len / (W + 1) + 1;
      if (count < W) b = a + (count + 1) * len / (W + 1);
      a = next_a;
    }
  }
  return a;
}

__global__ void __launch_bounds__(256) segment_reduce_kernel_walk(
    const float* __restrict__ g, const int* __restrict__ idx,
    float* __restrict__ out, long long B, int J, long long rows, int W) {
  const int lane = threadIdx.x & 31;
  const int sub = threadIdx.x & (W - 1);
  const unsigned mask =
      W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (lane & ~(W - 1));
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x / W) +
                      threadIdx.x / W;
  if (r >= rows) return;  // a whole group leaves together
  const long long start = group_lower_bound(idx, 0, B, r, sub, W, mask);
  const long long end = group_lower_bound(idx, start, B, r + 1, sub, W, mask);
  for (int j = sub; j < J; j += W) {
    float acc = 0.f;
    long long p = start;
    for (; p + 8 <= end; p += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldg(g + (p + u) * J + j);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; p < end; ++p) acc = __fadd_rn(acc, __ldg(g + p * J + j));
    out[r * J + j] = acc;
  }
}

extern "C" int segment_walk_f32(
    const float* g, const int* idx, float* out, long long B, int J,
    long long rows, long long blocks, void* stream) {
  if (B < 1 || J < 1 || J > REPRO_MAX_WIDTH || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = group_width(J, J);
  const long long groups = 256 / W;
  if (blocks != (rows + groups - 1) / groups || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  segment_reduce_kernel_walk<<<static_cast<unsigned>(blocks), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      g, idx, out, B, J, rows, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_reduce_f32(
    const float* g, const int* idx, float* out, long long B, int J,
    long long rows, int RB, int CH, long long blocks, void* stream) {
  if (B < 1 || J < 1 || J > REPRO_MAX_WIDTH || rows < 1 || RB < 4 ||
      RB % 4 != 0 || CH < 1 || blocks < 1 || blocks > 0x7fffffffLL ||
      blocks * RB < rows || (blocks - 1) * RB >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (static_cast<size_t>(RB) * J +
                                       static_cast<size_t>(CH) * (J + 1));
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  segment_reduce_kernel<<<static_cast<unsigned>(blocks), 256, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      g, idx, out, B, J, rows, group_width(J, J), RB, CH);
  return static_cast<int>(cudaGetLastError());
}
