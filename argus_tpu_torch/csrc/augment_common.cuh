// Device helpers of the two augmentation kernels (blur.cu, augment_fused.cu):
// arithmetic in the image dtype on pairs of pixels, and the stages of the
// gated gaussian-then-motion blur that both run.
//
// Rounding points are argus_tpu's, whose vector ops compute in the image
// dtype T: each product and each sum rounds to T once. In bf16 an op on two
// pixels is one packed bf16x2 instruction: a correctly rounded bf16 product
// or sum of two bf16 operands has the bits of the f32 op followed by one
// rounding to bf16, which is what the plain versions compute
// (tests/test_torch_augment_sm90.py holds that premise). In f32 the
// intrinsics (__fmul_rn, __fadd_rn, ...) keep nvcc from contracting a
// product and a sum into one fused multiply-add.

#pragma once

#include "common.cuh"

namespace argus {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// one rounding to T, kept in f32
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// ───────────── image-dtype arithmetic on pairs of pixels ─────────────

template <typename T>
struct Pair;

// bf16: one packed instruction for both pixels, correctly rounded
template <>
struct Pair<bf16> {
  typedef __nv_bfloat162 V;
  // mul.rn / add.rn.bf16x2 (sm_90): what __hmul2_rn and __hadd2_rn emit there
  __device__ static __forceinline__ V mul(V a, V b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
    return *reinterpret_cast<const V*>(&d);
  }
  __device__ static __forceinline__ V add(V a, V b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
    return *reinterpret_cast<const V*>(&d);
  }
  __device__ static __forceinline__ uint32_t bits(V v) { return *reinterpret_cast<const uint32_t*>(&v); }
  __device__ static __forceinline__ V clip01(V v) {
    return __hmin2(__hmax2(v, __float2bfloat162_rn(0.f)), __float2bfloat162_rn(1.f));
  }
  __device__ static __forceinline__ V splat(float s) { return __float2bfloat162_rn(s); }
  __device__ static __forceinline__ V make(float lo, float hi) { return __floats2bfloat162_rn(lo, hi); }
  __device__ static __forceinline__ float lo(V v) { return __low2float(v); }
  __device__ static __forceinline__ float hi(V v) { return __high2float(v); }
  // (a.hi, b.lo): the pair one pixel to the right of a
  __device__ static __forceinline__ V shift(V a, V b) {
    const uint32_t r = __byte_perm(bits(a), bits(b), 0x5432);
    return *reinterpret_cast<const V*>(&r);
  }
  __device__ static __forceinline__ V dup_lo(V v) { return __low2bfloat162(v); }
  __device__ static __forceinline__ V dup_hi(V v) { return __high2bfloat162(v); }
};

// f32: two scalar ops
template <>
struct Pair<float> {
  typedef float2 V;
  __device__ static __forceinline__ V mul(V a, V b) { return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)); }
  __device__ static __forceinline__ V add(V a, V b) { return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y)); }
  __device__ static __forceinline__ V clip01(V v) { return make_float2(argus::clip01(v.x), argus::clip01(v.y)); }
  __device__ static __forceinline__ V splat(float s) { return make_float2(s, s); }
  __device__ static __forceinline__ V make(float lo, float hi) { return make_float2(lo, hi); }
  __device__ static __forceinline__ float lo(V v) { return v.x; }
  __device__ static __forceinline__ float hi(V v) { return v.y; }
  __device__ static __forceinline__ V shift(V a, V b) { return make_float2(a.y, b.x); }
  __device__ static __forceinline__ V dup_lo(V v) { return make_float2(v.x, v.x); }
  __device__ static __forceinline__ V dup_hi(V v) { return make_float2(v.y, v.y); }
};

// ───────────── the blur's stages on a pair of pixels ─────────────
//
// Edge clamps fall on the image's border: a stage's caller passes the pair
// left of the centre pair, lf, as P::dup_lo(cc) at the image's left edge, and
// the pair right of it, rt, as P::dup_hi(cc) at its right edge (with an odd
// width the last pair's second pixel repeats column W - 1). kZero: the sum
// starts from 0 (0 + the first product, a Python sum: a -0 first product
// becomes +0); without it from the first product.

// w[0] a + w[1] b + w[2] c + w[3] d + w[4] e, summed in that order
template <typename T, bool kZero>
__device__ __forceinline__ typename Pair<T>::V tap5(const typename Pair<T>::V (&w)[5], typename Pair<T>::V a,
                                                    typename Pair<T>::V b, typename Pair<T>::V c,
                                                    typename Pair<T>::V d, typename Pair<T>::V e) {
  typedef Pair<T> P;
  typename P::V acc = P::mul(w[0], a);
  if (kZero) acc = P::add(P::splat(0.f), acc);
  acc = P::add(acc, P::mul(w[1], b));
  acc = P::add(acc, P::mul(w[2], c));
  acc = P::add(acc, P::mul(w[3], d));
  return P::add(acc, P::mul(w[4], e));
}

// the 5-tap gaussian along a row at the pair cc (columns x - 2 .. x + 3)
template <typename T, bool kZero>
__device__ __forceinline__ typename Pair<T>::V hgauss(const typename Pair<T>::V (&w)[5], typename Pair<T>::V lf,
                                                      typename Pair<T>::V cc, typename Pair<T>::V rt) {
  typedef Pair<T> P;
  return tap5<T, kZero>(w, lf, P::shift(lf, cc), cc, P::shift(cc, rt), rt);
}

// the 3x3 motion kernel at the pair cc[1]: rows ky = 0, 1, 2 (image rows
// y - 1, y, y + 1), columns in order, summed ky-major
template <typename T, bool kZero>
__device__ __forceinline__ typename Pair<T>::V motion9(const typename Pair<T>::V (&m)[9],
                                                       const typename Pair<T>::V (&lf)[3],
                                                       const typename Pair<T>::V (&cc)[3],
                                                       const typename Pair<T>::V (&rt)[3]) {
  typedef Pair<T> P;
  typename P::V acc = P::mul(m[0], P::shift(lf[0], cc[0]));
  if (kZero) acc = P::add(P::splat(0.f), acc);
  acc = P::add(acc, P::mul(m[1], cc[0]));
  acc = P::add(acc, P::mul(m[2], P::shift(cc[0], rt[0])));
#pragma unroll
  for (int ky = 1; ky < 3; ++ky) {
    acc = P::add(acc, P::mul(m[3 * ky], P::shift(lf[ky], cc[ky])));
    acc = P::add(acc, P::mul(m[3 * ky + 1], cc[ky]));
    acc = P::add(acc, P::mul(m[3 * ky + 2], P::shift(cc[ky], rt[ky])));
  }
  return acc;
}

// a gate: g a + g1 b (g1 = 1 - g in T)
template <typename T>
__device__ __forceinline__ typename Pair<T>::V gate(typename Pair<T>::V g, typename Pair<T>::V g1,
                                                    typename Pair<T>::V a, typename Pair<T>::V b) {
  typedef Pair<T> P;
  return P::add(P::mul(g, a), P::mul(g1, b));
}

}  // namespace argus
