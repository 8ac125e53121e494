// Warp-level tensor-core and copy helpers shared by the flash-attention
// kernels (flash_attn_fwd.cu, flash_attn_bwd.cu), for sm_90a:
// - mma.sync m16n8k8 TF32 and the 3xTF32 split that keeps f32-grade error
//   (x = big + small, both TF32, rounded to nearest with ties away from
//   zero by an integer add and mask), m16n8k16 bf16 -> f32;
// - ldmatrix (plain and .trans) for bf16 operands in shared memory;
// - 16-byte and 4-byte cp.async copies, zero-filled past an array's end,
//   and a row loader for padded shared tiles that falls back to plain loads
//   for pointers that are not 16-byte aligned;
// - the once-per-device opt-in to more than 48 KB of shared memory.
// Everything is inline and sits in an unnamed namespace: each source that
// includes this file compiles its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one 4-byte word; src_bytes 0 writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero: the rounding of cvt.rna.tf32.f32, written as an integer add
// and mask because ptxas expands that cvt into a compare-and-select
// sequence on sm_90a, which made the splits most of the f32 kernel's work
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (3xTF32 operand split)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// 2^x by the SFU (ex2.approx.ftz: ~2 ulp; a result below 2^-126, which
// adds nothing next to the row's p = 1 at its max, is flushed to 0;
// 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += small*big + big*small + big*big: the small cross terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows [row0, row0 + kRows) of a (n_rows, D) matrix into a shared tile with
// rows of kLd elements, by the block's kThreads threads: 16-byte cp.async
// copies where `vec`, else plain loads. Rows past n_rows are zero-filled
// and never read.
template <typename T, int D, int kLd, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int n_rows, bool vec, int tid) {
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = D / kE;     // chunks per row
  static_assert(kRows * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks;
    const int e0 = (c % kChunks) * kE;
    const int gr = row0 + r;
    const bool ok = gr < n_rows;
    T* d = dst + r * kLd + e0;
    if (vec) {
      cp_async16(d, src + (size_t)(ok ? gr : 0) * D + e0, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e)
        d[e] = ok ? src[(size_t)gr * D + e0 + e] : from_f32<T>(0.f);
    }
  }
}

// Above 48 KB a kernel's dynamic shared memory must be allowed once per
// device; `allowed` holds one bit per device id.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes,
                       std::atomic<unsigned long long>& allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (allowed.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) allowed.fetch_or(bit);
  return err;
}

}  // namespace
