// Segment-sum scatter of unsorted per-sample row gradients, Hopper (sm_90a).
//
// Replaces src/repro/kernels/scatter_accum.py::scatter_accum (the Pallas
// TPU kernel `_kernel`).  out (rows, J) must be zeroed by the caller; then
//     out[idx[b]][j] += g[b][j]     for every b with 0 <= idx[b] < rows
// and ids outside [0, rows) are dropped, as jax.ops.segment_sum drops them.
//
// The TPU kernel sweeps a one-hot (rows × B) matrix through the MXU:
// O(rows·B) work.  Here one thread adds one (b, j) entry with atomicAdd:
// O(B·J) work.  Bound on the card: memory — it reads B·J + B values, and the
// output it must produce is rows·J floats (zeroed by the caller, which at
// the training shapes is most of the bytes).  The order in which
// duplicates of a row are summed changes from run to run, so the result is
// equal to the sequential segment sum within f32 tolerance, not bitwise.
#include "common.cuh"

__global__ void __launch_bounds__(256) scatter_accum_kernel(
    const float* __restrict__ g, const int* __restrict__ idx,
    float* __restrict__ out, long long B, int J, long long rows) {
  const long long total = B * J;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long b = i / J;
    const long long row = idx[b];
    if (row >= 0 && row < rows) atomicAdd(out + row * J + (i - b * J), g[i]);
  }
}

extern "C" int scatter_accum_f32(
    const float* g, const int* idx, float* out, long long B, int J,
    long long rows, void* stream) {
  if (B < 1 || J < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  long long blocks = (B * J + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  scatter_accum_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, idx, out, B, J, rows);
  return static_cast<int>(cudaGetLastError());
}
