// Sorted segment-sum of mode-sorted row gradients, Hopper (sm_90a).
//
// Replaces src/repro/kernels/segment_reduce.py::segment_reduce (the Pallas
// TPU kernel `_kernel`).  Inputs: g (B, J) f32 row gradients already
// permuted into mode-sorted order, and the sorted int32 row ids (B,)
// (duplicates adjacent, in batch order: a stable sort).  out (rows, J)
// must be zeroed by the caller; then for every run of equal ids
//     out[id][j] = ((0 + g[p][j]) + g[p+1][j]) + …     if 0 <= id < rows
// in ascending sorted position, and ids outside [0, rows) are dropped.
//
// The TPU kernel walks the batch tiles in order on one core and adds each
// entry into a VMEM-resident output.  Blocks here run in no order, so the
// walk is split at the run heads instead: one group of W = next_pow2(J)
// lanes takes each run head (a position p where p == 0 or
// ids[p] != ids[p-1]), folds g[p], g[p+1], … while the id stays the same,
// and writes its row once.  The fold starts from 0.f and adds with
// __fadd_rn, so no FMA contraction changes the order or the rounding.
// There are no atomics, so the result is the same bits on every run,
// bitwise equal to the ordered plain version (ref.segment_reduce_ref),
// and bitwise equal to jax.ops.segment_sum of the unsorted batch — the
// reference's own contract (segment_reduce.py:13-18).
//
// Bound on the card: memory.  It reads B·J + B values and must write the
// dense rows·J output (zeroed by the caller), which at the training shapes
// is most of the bytes (mode 0 of the Netflix shape: 480,189 × 4 floats).
// Run lengths depend on the data; at the training batch they are short,
// and a long run is walked by one group alone.
#include "common.cuh"

__global__ void __launch_bounds__(256) segment_reduce_kernel(
    const float* __restrict__ g, const int* __restrict__ idx,
    float* __restrict__ out, long long B, int J, long long rows, int W) {
  const int sub = threadIdx.x & (W - 1);
  const long long group =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / W;
  const long long groups =
      static_cast<long long>(gridDim.x) * blockDim.x / W;
  for (long long p = group; p < B; p += groups) {
    const int id = idx[p];
    if (p > 0 && idx[p - 1] == id) continue;    // not a run head
    if (id < 0 || id >= rows || sub >= J) continue;
    float acc = 0.f;
    for (long long q = p; q < B && idx[q] == id; ++q)
      acc = __fadd_rn(acc, g[q * J + sub]);
    out[static_cast<long long>(id) * J + sub] = acc;
  }
}

extern "C" int segment_reduce_f32(
    const float* g, const int* idx, float* out, long long B, int J,
    long long rows, void* stream) {
  if (B < 1 || J < 1 || J > REPRO_MAX_WIDTH || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int W = 1;
  while (W < J) W <<= 1;
  const int threads = 256;
  const long long groups = threads / W;
  long long blocks = (B + groups - 1) / groups;
  if (blocks > 8192) blocks = 8192;
  segment_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      g, idx, out, B, J, rows, W);
  return static_cast<int>(cudaGetLastError());
}
