// Shared device helpers of the argus_tpu_torch kernels: shared-memory
// addressing, cp.async, ldmatrix and the m16n8k16 bf16 tensor-core MMA, plus
// the error-string export every kernel library carries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace argus {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; pred false zero-fills the destination
// (src-size 0), which doubles as the zero padding of a convolution.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one register, `lo` in the low half (the MMA fragment order)
__device__ __forceinline__ uint32_t pack_bf16x2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// An f32 value rounded to TF32 (10 mantissa bits, to nearest, ties away from
// zero), in the register form the TF32 MMA takes.
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// D (16x8 f32) += A (16x8 tf32, row) * B (8x8 tf32, col). Fragments: with
// g = lane / 4 and t = lane % 4, a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d as the bf16 MMA's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element access shared by the bf16 and f32 instantiations of the mma.sync
// engines: a value as f32, a pair as float2, a pair stored with one rounding.
__device__ __forceinline__ float as_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

__device__ __forceinline__ float2 load2(const bf16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  __nv_bfloat162 o;
  o.x = __float2bfloat16(a);
  o.y = __float2bfloat16(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = o;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

}  // namespace argus

extern "C" const char* argus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
