// The identity bottleneck block's backward from h1/h2 on the Hopper engines
// (conv_dgrad_sm90.cuh, wgrad_sm90.cuh), shared by the saved-residual
// backward (block_fused_bwd.cu), the recompute backward
// (block_fused_rbwd.cu) and the stage chain's backward (stage_fused_bwd.cu),
// with the formulas and rounding points of argus_tpu's saved-residual
// backward (block_fused.py `_bwd_saved_kernel` :350):
//
//   m3 = g * (out > 0);  m2 = bf16(m3 @ w3^T) * (h2 > 0)
//   m1 = bf16(conv3x3^T(m2)) * (h1 > 0);  dx = bf16(m1 @ w1^T + m3)
//   dw1 = x^T m1, dw2 = shift(h1)^T m2, dw3 = h2^T m3   (f32)
//
// Launches, in order:
//   1. m3 = g * (out > 0), written once (`relu_mask_sm90`); every later
//      launch reads it plain. The chain takes the form from m3
//      (`identity_block_bwd_m3_sm90`): its m3 is the dx of the block after,
//      masked in that block's dx launch (`dx_mask`, below);
//   2. m2: a 1x1 data gradient, K = CIN, COUT = F, the mask h2 > 0 in its
//      epilogue;
//   3. dw3 = h2^T m3 (weight gradient, one tap);
//   4. m1: the 3x3's data gradient over m2 (the forward conv with w2d), the
//      mask h1 > 0 in its epilogue;
//   5. dw2 = shift(h1)^T m2 (nine taps);
//   6. dx: a 1x1 data gradient, K = F, COUT = CIN, m3 added in its epilogue
//      before the one rounding (skipped when dx is nullptr); with `dx_mask`
//      (the block before's output in a chain) its epilogue also applies
//      that block's relu mask, bf16(m1 @ w1^T + m3) * (dx_mask > 0), which
//      is that block's m3: a 0/1 mask after the rounding is exact, so the
//      bits are those of a separate mask pass;
//   7. dw1 = x^T m1.
// The weight gradients' partials share one workspace, sized by the wrappers
// from the plans of 3, 5 and 7 in that order (ops/kernels/block_fused.py
// `identity_wgrad_plans`).

#pragma once

#include "conv_dgrad_sm90.cuh"
#include "wgrad_sm90.cuh"

namespace argus {

#ifndef ARGUS_TRY
#define ARGUS_TRY(call)               \
  do {                                \
    const cudaError_t e_ = (call);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)
#endif

// The backward from the masked cotangent m3: x, m3 (N, H, W, CIN); h1, h2,
// m1, m2 (N, H, W, F); w1t (F, CIN), w2d (9, F, F) with w2d[ky, kx] =
// w2[2-ky, 2-kx]^T, w3t (CIN, F); dw1 (CIN, F), dw2 (3, 3, F, F), dw3 (F,
// CIN) f32; dx may be nullptr; dx_mask (like dx) or nullptr.
inline cudaError_t identity_block_bwd_m3_sm90(const void* x, const void* m3, const void* h1, const void* h2,
                                              const void* w1t, const void* w2d, const void* w3t, void* dx,
                                              const void* dx_mask, void* m1, void* m2, void* dw1, void* dw2,
                                              void* dw3, void* ws, int64_t ws_elems, int N, int H, int W, int CIN,
                                              int F, cudaStream_t st) {
  // m2 = bf16(m3 @ w3^T) * (h2 > 0)
  DgradArgs p = dgrad_args(dgrad_seg(m3, H, W, CIN, 1, 1, 0), nullptr, N, H, W, F, m2);
  p.emask = static_cast<const bf16*>(h2);
  ARGUS_TRY(launch_dgrad(p, w3t, nullptr, st));
  // dw3 = h2^T m3
  ARGUS_TRY(wgrad_sm90(h2, H, W, F, 1, 1, 0, m3, CIN, N, H, W, dw3, ws, ws_elems, st));
  // m1 = bf16(conv3x3^T(m2)) * (h1 > 0)
  p = dgrad_args(dgrad_seg(m2, H, W, F, 3, 1, 1), nullptr, N, H, W, F, m1);
  p.emask = static_cast<const bf16*>(h1);
  ARGUS_TRY(launch_dgrad(p, w2d, nullptr, st));
  // dw2[ky, kx] = shift(h1)^T m2
  ARGUS_TRY(wgrad_sm90(h1, H, W, F, 3, 1, 1, m2, F, N, H, W, dw2, ws, ws_elems, st));
  // dx = bf16(m1 @ w1^T + m3) (* (dx_mask > 0))
  if (dx != nullptr) {
    p = dgrad_args(dgrad_seg(m1, H, W, F, 1, 1, 0), nullptr, N, H, W, CIN, dx);
    p.residual = static_cast<const bf16*>(m3);
    p.emask = static_cast<const bf16*>(dx_mask);
    ARGUS_TRY(launch_dgrad(p, w1t, nullptr, st));
  }
  // dw1 = x^T m1
  return wgrad_sm90(x, H, W, CIN, 1, 1, 0, m1, F, N, H, W, dw1, ws, ws_elems, st);
}

// The block backward from the cotangent g: x, g, out, m3 (N, H, W, CIN),
// m3 scratch; the rest as above.
inline cudaError_t identity_block_bwd_sm90(const void* x, const void* g, const void* out, const void* h1,
                                           const void* h2, const void* w1t, const void* w2d, const void* w3t,
                                           void* dx, void* m1, void* m2, void* m3, void* dw1, void* dw2, void* dw3,
                                           void* ws, int64_t ws_elems, int N, int H, int W, int CIN, int F,
                                           cudaStream_t st) {
  // m3 = g * (out > 0), once
  ARGUS_TRY(relu_mask_sm90(g, out, m3, static_cast<int64_t>(N) * H * W * CIN, st));
  return identity_block_bwd_m3_sm90(x, m3, h1, h2, w1t, w2d, w3t, dx, nullptr, m1, m2, dw1, dw2, dw3, ws, ws_elems,
                                    N, H, W, CIN, F, st);
}

}  // namespace argus
