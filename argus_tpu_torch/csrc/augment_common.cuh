// Device helpers of the two augmentation kernels (blur.cu, augment_fused.cu):
// arithmetic in the image dtype and the gated gaussian-then-motion blur of
// one tile.
//
// Image-dtype arithmetic: every op runs in f32 registers and rounds to the
// image dtype T, the rounding points of argus_tpu's kernels, whose vector
// ops compute in T. The intrinsics (__fmul_rn, __fadd_rn, ...) keep nvcc from
// contracting a product and a sum into one fused multiply-add, so each op
// rounds as the plain PyTorch versions' separate ops do.

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

template <typename T>
__device__ __forceinline__ float mul(float a, float b) { return rnd<T>(__fmul_rn(a, b)); }

template <typename T>
__device__ __forceinline__ float add(float a, float b) { return rnd<T>(__fadd_rn(a, b)); }

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// ───────────────────────── the blur of one tile ─────────────────────────
//
// Output tile kBT x kBT at (y0, x0) of a (3, H, W) image, all three channels
// per stage. A neighbour at image coordinate q is read at clamp(q) at every
// stage (edge clamp, argus_tpu/ops/pallas/blur.py:14-17), so each buffer
// covers the clamped coordinates its consumer reads:
//   s  (kSE x kSE):  the input, rows y0-3 .. y0+kBT+2, cols x0-3 .. x0+kBT+2;
//   g  (kGE x kSE):  the 5-tap gaussian down the rows, rows y0-1 .. y0+kBT;
//   g2 (kGE x kGE):  then along the columns and gated, cols x0-1 .. x0+kBT;
// and the 3x3 motion kernel on g2, gated, goes to `store(c, y, x, value)`.
// The buffers hold T: every stored value is already rounded to T.

constexpr int kBT = 32;
constexpr int kSE = kBT + 6;
constexpr int kGE = kBT + 2;
constexpr int kBlurBuf = kSE * kSE + kGE * kSE + kGE * kGE;  // elements per channel

template <typename T>
__host__ __device__ constexpr int blur_buf_bytes() { return 3 * kBlurBuf * static_cast<int>(sizeof(T)); }

template <typename T, typename Store>
__device__ void blur_tile(const T* src, int H, int W, int y0, int x0, const float* gw, const float* mk,
                          float ggate, float mgate, T* buf, Store store) {
  T* s = buf;                   // 3 x kSE x kSE
  T* g = s + 3 * kSE * kSE;     // 3 x kGE x kSE
  T* g2 = g + 3 * kGE * kSE;    // 3 x kGE x kGE
  const int tid = threadIdx.x, nt = blockDim.x;
  const int hw = H * W;
  float w5[5], m9[9];
#pragma unroll
  for (int k = 0; k < 5; ++k) w5[k] = rnd<T>(gw[k]);
#pragma unroll
  for (int k = 0; k < 9; ++k) m9[k] = rnd<T>(mk[k]);
  const float gg = rnd<T>(ggate), gg1 = rnd<T>(1.f - ggate);
  const float mg = rnd<T>(mgate), mg1 = rnd<T>(1.f - mgate);

  for (int i = tid; i < kSE * kSE; i += nt) {
    const int a = i / kSE, b = i % kSE;
    const int off = clampi(y0 - 3 + a, H - 1) * W + clampi(x0 - 3 + b, W - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c * kSE * kSE + i] = src[c * hw + off];
  }
  __syncthreads();
  for (int i = tid; i < kGE * kSE; i += nt) {
    const int a = i / kSE, b = i % kSE;
    const int r = clampi(y0 - 1 + a, H - 1);
    int o[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) o[k] = (clampi(r + k - 2, H - 1) - (y0 - 3)) * kSE + b;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T* sc = s + c * kSE * kSE;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 5; ++k) acc = add<T>(acc, mul<T>(w5[k], to_f32(sc[o[k]])));
      g[c * kGE * kSE + i] = from_f32<T>(acc);
    }
  }
  __syncthreads();
  for (int i = tid; i < kGE * kGE; i += nt) {
    const int a = i / kGE, b = i % kGE;
    const int r = clampi(y0 - 1 + a, H - 1), q = clampi(x0 - 1 + b, W - 1);
    const int row = (r - (y0 - 1)) * kSE, center = (r - (y0 - 3)) * kSE + (q - (x0 - 3));
    int o[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) o[k] = row + clampi(q + k - 2, W - 1) - (x0 - 3);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T* gc = g + c * kGE * kSE;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 5; ++k) acc = add<T>(acc, mul<T>(w5[k], to_f32(gc[o[k]])));
      const float x = to_f32(s[c * kSE * kSE + center]);
      g2[c * kGE * kGE + i] = from_f32<T>(add<T>(mul<T>(gg, acc), mul<T>(gg1, x)));
    }
  }
  __syncthreads();
  for (int i = tid; i < kBT * kBT; i += nt) {
    const int y = y0 + i / kBT, x = x0 + i % kBT;
    if (y >= H || x >= W) continue;
    int o[9];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        o[3 * ky + kx] = (clampi(y + ky - 1, H - 1) - (y0 - 1)) * kGE + clampi(x + kx - 1, W - 1) - (x0 - 1);
    const int center = (y - (y0 - 1)) * kGE + (x - (x0 - 1));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T* g2c = g2 + c * kGE * kGE;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) acc = add<T>(acc, mul<T>(m9[k], to_f32(g2c[o[k]])));
      store(c, y, x, add<T>(mul<T>(mg, acc), mul<T>(mg1, to_f32(g2c[center]))));
    }
  }
  __syncthreads();  // the buffers are restaged for the next tile
}

}  // namespace argus
