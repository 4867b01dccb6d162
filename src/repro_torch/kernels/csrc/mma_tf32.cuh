// f32 products on Hopper's tensor cores (3xTF32), and cp.async copies.
//
// A TF32 operand keeps 10 of f32's 23 mantissa bits, so one pass of
// mma.sync on f32 data loses about three decimal digits.  3xTF32 keeps f32
// accuracy: each f32 value x is split into big = x rounded to nearest
// (ties away) to TF32 and small = x − big (exact in f32, passed whole: the
// tensor cores read its top 19 bits, cutting the rest), and a product a·b
// is taken as big_a·small_b + small_a·big_b + big_a·big_b with f32
// accumulators.  The neglected small_a·small_b and the cut of the small
// parts are about 2^-21 of |a·b|, below f32's own rounding of a sum over K
// terms.  The small terms are issued first, so the large term is added
// last.  A bf16 value is exact in TF32 (its small part is zero), so an
// operand stored in bf16 skips its small pass: 2 passes instead of 3.
//
// The tensor cores add a product into its accumulator without rounding to
// nearest: the low bits of the smaller addends are cut, a bias of the same
// sign at every step.  Chained over a long K into one accumulator it grows
// with the number of steps (3e-5 of the scale at K = 5120, measured on the
// H100), not with its square root as f32 rounding does.  So a kernel chains
// only a short run of products (one k-tile) into fresh zero accumulators
// and adds them to its running sums with f32 adds, which round to nearest.
//
// Inline PTX only: mma.sync and cp.async (sm_80 and later), wgmma (sm_90a,
// the kernels' target).
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

// Round to nearest (ties away) to TF32: an f32 bit pattern whose low 13
// bits are zero, as cvt.rna.tf32.f32 rounds a finite x, in two integer
// operations at full rate (the conversion runs at a fraction of it): half
// a TF32 ulp added to the bits carries into the exponent where it must.
// Inf stays inf; a NaN may not stay a NaN, but its small part below does.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small exactly: big in TF32, small the f32 rest, which the
// tensor cores cut to TF32 (about 2^-21 of |x| lost).  A NaN x gives a
// NaN small part, so every 3xTF32 or 2-pass product carries it.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a·b, one m16n8k8 TF32 product with f32 accumulators, g = lane / 4,
// t = lane % 4.  The product sums over its 8 k values, so any order of k
// that A and B share gives the same products; the kernels here take
// k = t at column 2t and k = t + 4 at column 2t + 1 of each 8-column group:
//   a: (g, 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1) of the 16 x 8 A tile;
//   b: rows 2t and 2t+1, column g, of the 8 x 8 B tile;
//   d: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of the 16 x 8 result.
// Then a thread's two A values of a row, and two B values stored along k,
// are adjacent (one 64-bit load), and the accumulator of an m16n8 product
// is, register for register, the A fragment of a product over its 8
// columns: d[0], d[2], d[1], d[3].
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two adjacent values as f32 (4- or 8-byte aligned).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The split fragments of one operand: big and small parts.
template <int N>
struct Frag {
  uint32_t big[N];
  uint32_t small[N];
};

// Split n4 float4 of shared memory in place: big parts stay, small parts go
// to `small` at the same offsets.  The caller synchronises the block.
__device__ __forceinline__ void split_smem(float* raw, float* small, int n4) {
  float4* r4 = reinterpret_cast<float4*>(raw);
  float4* s4 = reinterpret_cast<float4*>(small);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 x = r4[i];
    uint32_t b[4], s[4];
    tf32_split(x.x, b[0], s[0]);
    tf32_split(x.y, b[1], s[1]);
    tf32_split(x.z, b[2], s[2]);
    tf32_split(x.w, b[3], s[3]);
    r4[i] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                        __uint_as_float(b[2]), __uint_as_float(b[3]));
    s4[i] = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                        __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
}

// 8 bf16 values (16 bytes, the first in the low half of u.x) as f32: a
// bf16 value is the high 16 bits of its f32 value, so this is exact.
__device__ __forceinline__ void widen8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// n rows of w bf16 values (w a multiple of 8; rows back to back, 16-byte
// aligned) widened to f32, row r at r * ld floats of dst.  A bf16 value is
// exact in TF32: the widened value is its own big part and its small part
// is 0, so a bf16 tile needs no small parts and no split.  The caller
// synchronises.
__device__ __forceinline__ void widen_rows(const __nv_bfloat16* src, int n,
                                           int w, float* dst, int ld) {
  const int ch = w / 8;
  for (int i = threadIdx.x; i < n * ch; i += blockDim.x) {
    const int r = i / ch, c = (i % ch) * 8;
    float f[8];
    widen8(*reinterpret_cast<const uint4*>(src + r * w + c), f);
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(dst + r * ld + c + 4) =
        make_float4(f[4], f[5], f[6], f[7]);
  }
}

// Split f32 values into a fragment; with EXACT (a bf16 source) the small
// part is never read and is not formed.
template <bool EXACT, int N>
__device__ __forceinline__ void frag_split(const float (&v)[N], Frag<N>& f) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (EXACT) {
      f.big[i] = __float_as_uint(v[i]);
    } else {
      tf32_split(v[i], f.big[i], f.small[i]);
    }
  }
}

// d += a·b in 3xTF32 (2 passes when one side is exact, 1 when both are):
// the small terms first, the large one last.
// Tensor-core products per f32 one: 3xTF32, less the small pass of each
// exact (bf16) side.
template <bool A_EXACT, bool B_EXACT>
constexpr int kPasses = 1 + !A_EXACT + !B_EXACT;

template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Frag<4>& a,
                                           const Frag<2>& b) {
  if constexpr (!B_EXACT) mma_tf32(d, a.big, b.small);
  if constexpr (!A_EXACT) mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.big);
}

// --- cp.async: global -> shared without a register round trip -----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes; only the first `bytes` (0 or 16) are read, the rest of the
// 16 are zero-filled.  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// Copy 4 bytes (0 read: zero-filled).  Both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// --- wgmma (sm_90a): warpgroup products, B from shared memory -------------

// d (64 x 128 per warpgroup, m64n128 accumulator layout) (+)= a · B, one
// wgmma of TF32 with A in registers (the mma.sync m16n8k8 A fragment of each
// warp's 16 rows) and B (8 x 128, K-major) in shared memory through desc;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

// d (64 x 32 per warpgroup) (+)= a · B, as wgmma_m64n128k8 with B 8 x 32:
// d[j] is the m16n8 accumulator of the warp's 16 rows and columns 8j..8j+7.
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[4][4],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %21, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory stores by threads, made visible to the tensor cores' reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving register reads or writes across an
// asynchronous wgmma that owns these registers.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void pin(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) pin(r[i]);
}

// Descriptor of a K-major operand without swizzle: core matrices of 8 rows
// x 16 bytes (128 contiguous bytes); lbo = bytes between the two 16-byte k
// halves of a k8 step, sbo = bytes between 8-row groups.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, uint32_t lbo,
                                                uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}
