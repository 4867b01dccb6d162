// Fused Theorem-1 forward + Eq. 13/17 gradients for Hopper (sm_90a), with
// the phase flags of the reference and f32 or bf16 storage, in one launch.
//
// Replaces src/repro/kernels/kruskal_grad.py::kruskal_grad (the Pallas TPU
// kernel `_kernel`).  For each sampled nonzero b:
//     c[n], pexc[n], pred              as in kruskal_contract.cu
//     err      = (pred_coef·pred − val)·mask
//     rg[j][b] = (err·inv_row)·(pexc[n] B[n]ᵀ) + ((λ_a·inv_row)·mask)·a[n][b]
//                for the j-th mode n of the row-mode list
// and for the whole batch
//     cg[n]    = λ_b·B[n] + Σ_b a[n][b]ᵀ (err·inv_core · pexc[n][b])
// with scal = [inv_row, inv_core, λ_a, λ_b, pred_coef].
//
// Phase flags (the phase-split and Gauss–Seidel steps):
//   c_out      (emit_c) lane r of each sample's group stores the c[n]
//              registers the pass itself used, as an (N, B, R) output;
//   c_in       (c=) the pass loads those values instead of running the N
//              dots, then forms pexc with the same prefix/suffix code;
//   row_code   (row_modes) an ordered list of up to 10 modes, passed by
//              value: bits 0-3 hold the count, bits 4+4j the j-th mode;
//              output j of rg follows the list;
//   want_core  0 skips the shared a and err·pexc tiles, the fold, the
//              partials and the cross-block sum.
// The tiling (BT samples a tile, one group of W lanes a sample, the block
// count and the fold's S slices) comes from kruskal_grad.py::plan(N, J, R,
// B), never from the flags, so a core pass fed with emitted c folds the
// same terms in the same order as the joint pass: its core gradient is the
// joint one, bit for bit.
//
// Storage: a and bfac are both f32 or both bf16 (converted to f32 on load,
// in the λ_b·B seed too); every output is f32.  Widths: J, R <= 64 (E = 1
// or 2 entries a lane, common.cuh), a template parameter beside N; the
// plan shrinks the tile where the factors and tiles would overflow shared
// memory, and refuses the shapes where one sample a tile does not fit.
//
// Bound on the card: at the training batch (B = 4096, N = 3, J = R = 4) a
// call moves ~0.4 MB, a tenth of a microsecond at 3.35 TB/s, and does 6·N·B·
// J·R flops, less still at 67 TFLOP/s.  What sets its time is the launch
// and chains of dependent latency, so the design cuts both:
//   - one launch per call.  Each block folds its samples into an (N, J, R)
//     partial and writes it; after a barrier its thread 0 runs a
//     release fence and takes a ticket with an integer atomicAdd (the
//     pattern of a cooperative grid sync).  The block that draws the last
//     ticket adds the partials in a fixed order: lane l of warp w sums
//     entry l's rows p = w, w + warps, … in order, with coalesced loads
//     (32 rows of 2 entries in flight a lane), and the warps' sums are
//     added to λ_b·B in warp order.  A walk over all partials in block order (the old second
//     kernel's) is one chain of `blocks` dependent adds; this order's
//     longest is blocks/warps + warps.  The last block puts the ticket
//     back to 0 as soon as it draws it (every block has counted itself by
//     then), so the wrapper's per-(device, stream) ticket is zeroed once,
//     when it is created.  A cooperative grid sync or a
//     cluster reduction would do the same with a launch constraint (all
//     blocks resident, or a cluster of at most 16 blocks); the ticket
//     needs neither.
//   - blocks that fill the card: BT <= 32 gives 128 blocks at B = 4096
//     (MAX_BLOCKS = 256 caps it; a constant, so the bits do not depend on
//     the card).
//   - the mode count N is a template parameter (1..10, chosen at launch),
//     so no predicated work is issued for modes a call does not have, and
//     no integer division by a runtime value is left in the loops;
//   - the first tile's row, val, mask and c_in loads are issued before the
//     factor barrier, and each next tile's before the current tile's fold;
//     the N mode dots and the Eq. 13 products run as N independent chains
//     (Eq. 13 for every mode, branch-free; the listed ones are stored).
//   - the Eq. 17 fold spreads over the block's threads: entry (n, j, r) of
//     the tile is split into S slices of BT/S samples (S from the plan:
//     the most that fit one pass over the threads), each an fmaf chain in
//     sample order; the S slice sums sit on adjacent lanes and a fixed xor
//     tree adds them, then the tile's sum is added to the block's partial.
// There are no float atomics: the core gradient is the same bits from run
// to run.  The Eq. 13 rows use the products and roundings of the plain
// version's expression (__fmul_rn/__fadd_rn where it pins them).
#include "common.cuh"

#define GRAD_STAGE 32       // partial rows a lane loads before adding
#define GRAD_LANE_ENTRIES 2  // (n, j, r) entries a lane sums at once

// The global loads of one sample, issued before they are needed.
template <int N, int E>
struct SampleLoads {
  float av[N][E];  // lane sub's entries j = sub + 32e of each mode's row
  float c[N][E];   // cached mode products (c_in), else 0
  float v, m;      // val and mask
};

template <int N, int E, typename T>
__device__ __forceinline__ void load_sample(
    const T* __restrict__ a, const float* __restrict__ val,
    const float* __restrict__ mask, const float* __restrict__ c_in,
    long long B, int J, int R, long long b, int sub, SampleLoads<N, E>& s) {
  const bool valid = b < B;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = sub + 32 * e;
      s.av[n][e] =
          (valid && j < J) ? to_float(a[(n * B + b) * J + j]) : 0.f;
      s.c[n][e] = (c_in != nullptr && valid && j < R)
                      ? c_in[(n * B + b) * R + j] : 0.f;
    }
  }
  s.v = valid ? val[b] : 0.f;
  s.m = valid ? mask[b] : 0.f;
}

// Makes the value's load complete here (an empty asm that reads it), so
// the compiler cannot sink the load past a later barrier.
__device__ __forceinline__ void arrive(float v) { asm volatile("" ::"f"(v)); }

// A release-acquire fence at GPU scope, the pattern of CUTLASS's
// inter-block semaphore: after a barrier, thread 0's fence and relaxed
// atomic publish the whole block's writes; __threadfence() would be the
// heavier sequentially consistent fence.
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

template <typename T, int N, int E>
__global__ void __launch_bounds__(256) kruskal_grad_kernel(
    const T* __restrict__ a, const T* __restrict__ bfac,
    const float* __restrict__ val, const float* __restrict__ mask,
    const float* __restrict__ scal, const float* __restrict__ c_in,
    float* __restrict__ pred, float* __restrict__ err,
    float* __restrict__ rg, float* __restrict__ cg,
    float* __restrict__ c_out, float* __restrict__ partial,
    unsigned int* __restrict__ ticket, long long B, long long tiles, int J,
    int R, int W, int w_shift, int BT, int s_shift, long long row_code,
    int want_core) {
  extern __shared__ float smem[];
  __shared__ int is_last;
  const int RP = R + 1;
  const int NJR = N * J * R;
  float* bs = smem;                // (N, J, R+1) Kruskal factors
  float* as = bs + N * J * RP;     // (N, BT, J)  this tile's rows
  float* wp = as + N * BT * J;     // (N, BT, R)  err·inv_core·pexc
  float* acc = wp + N * BT * R;    // (N, J, R)   this block's partial

  const int sub = threadIdx.x & (W - 1);
  const int s = threadIdx.x >> w_shift;  // the group's sample in the tile
  long long tile = blockIdx.x;     // < tiles: the plan's blocks <= tiles
  SampleLoads<N, E> ld;
  load_sample(a, val, mask, c_in, B, J, R, tile * BT + s, sub, ld);
  const float inv_row = scal[0];
  const float inv_core = scal[1];
  const float reg_a = __fmul_rn(scal[2], inv_row);
  const float pred_coef = scal[4];
  const int nrow = static_cast<int>(row_code & 15);
  load_factors(bfac, bs, N, J, R);
  if (want_core)
    for (int i = threadIdx.x; i < NJR; i += blockDim.x) acc[i] = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      arrive(ld.av[n][e]);
      arrive(ld.c[n][e]);
    }
  }
  arrive(ld.v);
  arrive(ld.m);
  __syncthreads();

  for (; tile < tiles; tile += gridDim.x) {
    const long long b = tile * BT + s;
    const bool valid = b < B;
    float c[REPRO_MAX_MODES][E], pexc[REPRO_MAX_MODES][E];
    float av[REPRO_MAX_MODES][E];
#pragma unroll
    for (int n = 0; n < REPRO_MAX_MODES; ++n) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        av[n][e] = n < N ? ld.av[n][e] : 0.f;
        c[n][e] = n < N ? ld.c[n][e] : 0.f;
      }
    }
    if (c_in == nullptr) group_mode_dots(av, bs, N, J, R, sub, W, c);
    group_exclusive_products(c, N, pexc);
    if (c_out != nullptr && valid) {
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (sub + 32 * e < R)
            c_out[(n * B + b) * R + sub + 32 * e] = c[n][e];
    }
    const float p = group_pred(c, pexc, W);
    const float e =
        __fmul_rn(__fsub_rn(__fmul_rn(pred_coef, p), ld.v), ld.m);
    if (valid && sub == 0) {
      pred[b] = p;
      err[b] = e;
    }
    const float w_row = __fmul_rn(e, inv_row);
    const float w_core = __fmul_rn(e, inv_core);
    const float reg = __fmul_rn(reg_a, ld.m);
    if (want_core) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int jr = sub + 32 * e;
          if (jr < J) as[(n * BT + s) * J + jr] = av[n][e];
          if (jr < R)
            wp[(n * BT + s) * R + jr] = __fmul_rn(w_core, pexc[n][e]);
        }
      }
    }
    // Eq. 13: lane entry j forms d[n] = Σ_r pexc[n][r]·B[n][j][r] for
    // every mode side by side (branch-free), then stores the listed modes'
    // rows
    if (nrow > 0) {
      float d[N][E];
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < E; ++e) d[n][e] = 0.f;
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float pr =
              __shfl_sync(REPRO_FULL_MASK, pick(pexc[n], r >> 5), r & 31, W);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int j = sub + 32 * e;
            const float bv = j < J ? bs[(n * J + j) * RP + r] : 0.f;
            d[n][e] = fmaf(pr, bv, d[n][e]);
          }
        }
      }
      if (valid) {
        for (int jr = 0; jr < nrow; ++jr) {
          const int m = static_cast<int>((row_code >> (4 + 4 * jr)) & 15);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int j = sub + 32 * e;
            float dm = 0.f, am = 0.f;
#pragma unroll
            for (int n = 0; n < N; ++n)
              if (n == m) {
                dm = d[n][e];
                am = av[n][e];
              }
            if (j < J)
              rg[(jr * B + b) * J + j] =
                  __fadd_rn(__fmul_rn(w_row, dm), __fmul_rn(reg, am));
          }
        }
      }
    }
    // the next tile's loads go out before this tile's fold
    const long long next = tile + gridDim.x;
    if (next < tiles)
      load_sample(a, val, mask, c_in, B, J, R, next * BT + s, sub, ld);
    if (want_core) {
      __syncthreads();
      // Eq. 17: item (i, q) sums samples [q·L, (q+1)·L) of entry i in
      // sample order (L = BT/S); the S items of an entry sit on adjacent
      // lanes (S is a power of two <= 32, blockDim a multiple of 32, so
      // they share a warp) and a fixed xor tree adds them
      const int S = 1 << s_shift;
      const int L = BT >> s_shift;
      const int items = NJR * S;
      const float inv_jr = 1.f / (J * R);
      const float inv_r = 1.f / R;
      for (int base = 0; base < items; base += blockDim.x) {
        const int it = base + threadIdx.x;
        const int i = it >> s_shift;
        const int q = it & (S - 1);
        float t = 0.f;
        if (it < items) {
          const int n = div_small(i, inv_jr);
          const int jr = i - n * J * R;
          const int j = div_small(jr, inv_r);
          const int r = jr - j * R;
          const float* an = as + (n * BT + q * L) * J + j;
          const float* wn = wp + (n * BT + q * L) * R + r;
#pragma unroll 4
          for (int k = 0; k < L; ++k) t = fmaf(an[k * J], wn[k * R], t);
        }
        for (int off = 1; off < S; off <<= 1)
          t = __fadd_rn(t, __shfl_xor_sync(REPRO_FULL_MASK, t, off, S));
        if (it < items && q == 0) acc[i] = __fadd_rn(acc[i], t);
      }
      __syncthreads();
    }
  }
  if (!want_core) return;

  // the block's partial, then a ticket (the pattern of a cooperative grid
  // sync: the barrier orders the block's writes before thread 0's fence
  // and atomic); the last block sums them all
  for (int i = threadIdx.x; i < NJR; i += blockDim.x)
    partial[static_cast<long long>(blockIdx.x) * NJR + i] = acc[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel_gpu();   // release: the block's partial, then the ticket
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (is_last) {
      fence_acq_rel_gpu();   // acquire: every block's partial
      atomicExch(ticket, 0u);  // every block has counted itself
    }
  }
  __syncthreads();
  if (!is_last) return;
  // cg = λ_b·B + Σ_p partial[p] in a fixed order: lane l of warp w takes
  // entries c0 + l + 32e (e < GRAD_LANE_ENTRIES) and adds partial rows
  // p = w, w + warps, … in order, loading GRAD_STAGE rows at once
  // (coalesced across the lanes, clamped so every load is issued); then
  // the warps' sums are added to the seed in warp order.  Plain loads see
  // the other blocks' partials: thread 0's acquire fence after the last
  // ticket and the barrier order them after every block's release
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int P = gridDim.x;
  const int rows_w = warp < P ? (P - 1 - warp) / warps + 1 : 0;
  constexpr int LE = GRAD_LANE_ENTRIES;
  float* sums = smem;                // (warps, LE·32), free now
  const float lam_b = scal[3];
  for (int c0 = 0; c0 < NJR; c0 += 32 * LE) {
    float t[LE], seed[LE];
    int idx[LE];
#pragma unroll
    for (int e = 0; e < LE; ++e) {
      idx[e] = min(c0 + 32 * e + lane, NJR - 1);
      seed[e] = to_float(bfac[idx[e]]);
      t[e] = 0.f;
    }
    for (int k0 = 0; k0 < rows_w; k0 += GRAD_STAGE) {
      float v[LE][GRAD_STAGE];
#pragma unroll
      for (int u = 0; u < GRAD_STAGE; ++u) {
        const long long p = warp + warps * min(k0 + u, rows_w - 1);
#pragma unroll
        for (int e = 0; e < LE; ++e) v[e][u] = partial[p * NJR + idx[e]];
      }
#pragma unroll
      for (int u = 0; u < GRAD_STAGE; ++u)
        if (k0 + u < rows_w) {
#pragma unroll
          for (int e = 0; e < LE; ++e) t[e] = __fadd_rn(t[e], v[e][u]);
        }
    }
#pragma unroll
    for (int e = 0; e < LE; ++e) sums[warp * 32 * LE + 32 * e + lane] = t[e];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int e = 0; e < LE; ++e) {
        float x = __fmul_rn(lam_b, seed[e]);
        for (int w = 0; w < warps; ++w)
          x = __fadd_rn(x, sums[w * 32 * LE + 32 * e + lane]);
        if (c0 + 32 * e + lane < NJR) cg[c0 + 32 * e + lane] = x;
      }
    }
    __syncthreads();
  }
}

// Shared memory of kruskal_grad_kernel in bytes (kruskal_grad.py::plan
// gives the same with the core stages on).
static inline size_t grad_smem_bytes(int N, int J, int R, int BT, int threads,
                                     int want_core) {
  size_t floats = static_cast<size_t>(N) * J * (R + 1);
  if (want_core) {
    floats += static_cast<size_t>(N) * BT * (J + R) +
              static_cast<size_t>(N) * J * R;
    const size_t sums = static_cast<size_t>(threads) * GRAD_LANE_ENTRIES;
    if (sums > floats) floats = sums;
  }
  return sizeof(float) * floats;
}

template <typename T, int N, int E>
static int launch_modes(
    const T* a, const T* bfac, const float* val, const float* mask,
    const float* scal, const float* c_in, float* pred, float* err, float* rg,
    float* cg, float* c_out, float* partial, unsigned int* ticket,
    long long B, int J, int R, int W, int BT, int S, int blocks,
    size_t smem, long long row_code, int want_core, cudaStream_t s) {
  const long long tiles = (B + BT - 1) / BT;
  // the kernel's static shared memory (is_last) counts against the same
  // 48 kB that a launch may use without opting in
  if (smem > 47 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kruskal_grad_kernel<T, N, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kruskal_grad_kernel<T, N, E><<<blocks, BT * W, smem, s>>>(
      a, bfac, val, mask, scal, c_in, pred, err, rg, cg, c_out, partial,
      ticket, B, tiles, J, R, W, log2_pow2(W), BT, log2_pow2(S), row_code,
      want_core);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_grad(
    const T* a, const T* bfac, const float* val, const float* mask,
    const float* scal, const float* c_in, float* pred, float* err, float* rg,
    float* cg, float* c_out, float* partial, unsigned int* ticket, int N,
    long long B, int J, int R, int BT, int S, int blocks,
    long long row_code, int want_core, void* stream) {
  const int nrow = static_cast<int>(row_code & 15);
  const int W = group_width(J, R);
  const int threads = BT * W;
  if (N < 1 || N > REPRO_MAX_MODES || J < 1 || J > REPRO_MAX_WIDTH ||
      R < 1 || R > REPRO_MAX_WIDTH || B < 1 || BT < 1 || threads > 256 ||
      threads % 32 != 0 || blocks < 1 || blocks > (B + BT - 1) / BT ||
      S < 1 || S > 32 || (S & (S - 1)) != 0 || BT % S != 0 ||
      nrow > REPRO_MAX_MODES || (nrow > 0 && rg == nullptr) ||
      (want_core && (cg == nullptr || partial == nullptr ||
                     ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < nrow; ++j)
    if (((row_code >> (4 + 4 * j)) & 15) >= N)
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = grad_smem_bytes(N, J, R, BT, threads, want_core);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = lane_entries(J, R);
#define GRAD_LAUNCH(n)                                                     \
  case n:                                                                  \
    return E == 1                                                          \
        ? launch_modes<T, n, 1>(a, bfac, val, mask, scal, c_in, pred, err, \
                                rg, cg, c_out, partial, ticket, B, J, R,   \
                                W, BT, S, blocks, smem, row_code,          \
                                want_core, s)                              \
        : launch_modes<T, n, 2>(a, bfac, val, mask, scal, c_in, pred, err, \
                                rg, cg, c_out, partial, ticket, B, J, R,   \
                                W, BT, S, blocks, smem, row_code,          \
                                want_core, s);
  switch (N) {
    GRAD_LAUNCH(1) GRAD_LAUNCH(2) GRAD_LAUNCH(3) GRAD_LAUNCH(4)
    GRAD_LAUNCH(5) GRAD_LAUNCH(6) GRAD_LAUNCH(7) GRAD_LAUNCH(8)
    GRAD_LAUNCH(9) GRAD_LAUNCH(10)
  }
#undef GRAD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int kruskal_grad_f32(
    const float* a, const float* bfac, const float* val, const float* mask,
    const float* scal, const float* c_in, float* pred, float* err, float* rg,
    float* cg, float* c_out, float* partial, unsigned int* ticket, int N,
    long long B, int J, int R, int BT, int S, int blocks,
    long long row_code, int want_core, void* stream) {
  return launch_grad(a, bfac, val, mask, scal, c_in, pred, err, rg, cg,
                     c_out, partial, ticket, N, B, J, R, BT, S, blocks,
                     row_code, want_core, stream);
}

extern "C" int kruskal_grad_bf16(
    const __nv_bfloat16* a, const __nv_bfloat16* bfac, const float* val,
    const float* mask, const float* scal, const float* c_in, float* pred,
    float* err, float* rg, float* cg, float* c_out, float* partial,
    unsigned int* ticket, int N, long long B, int J, int R, int BT, int S,
    int blocks, long long row_code, int want_core, void* stream) {
  return launch_grad(a, bfac, val, mask, scal, c_in, pred, err, rg, cg,
                     c_out, partial, ticket, N, B, J, R, BT, S, blocks,
                     row_code, want_core, stream);
}
