// The projection (stage-entry) bottleneck block's backward from h1/h2 on
// the Hopper engines (conv_dgrad_sm90.cuh, wgrad_sm90.cuh), shared by the
// block backward (proj_fused_bwd.cu) and the stage chain's backward
// (stage_fused_bwd.cu), with the formulas and rounding points of
// argus_tpu's `_proj_bwd_kernel` (proj_fused.py :286), stride S in {1, 2}
// on the 3x3:
//
//   m3 = g * (out > 0);  m2 = bf16(m3 @ w3^T) * (h2 > 0)
//   m1 = bf16(conv3x3_S^T(m2)) * (h1 > 0)
//   dx = bf16(m1 @ w1^T + scatter_S(m3 @ wsc^T))
//   dw1 = x^T m1, dw2 = shift_S(h1)^T m2, dw3 = h2^T m3, dwsc = x[::S, ::S]^T m3
//
// Launches, in order:
//   1. m3 = g * (out > 0), written once (`relu_mask_sm90`), then m2 from m3;
//      the chain takes the form from m3 (`projection_block_bwd_m3_sm90`),
//      its m3 masked by the dx launch of the block after;
//   2. dw3 = h2^T m3 and dwsc = x[::S, ::S]^T m3, reading m3 plain;
//   3. m1: one launch at S = 1, four parity-class launches at S = 2;
//   4. dx: one launch of two K segments (m1 @ w1^T, m3 @ wsc^T) at S = 1,
//      four class launches at S = 2 (the shortcut in class (0, 0) alone);
//      with `dx_mask`, bf16(...) * (dx_mask > 0) in their epilogues;
//   5. dw2 (three taps per staged m2 tile) and dw1.
// m1, m2, m3 go through device memory (scratch the caller allocates); the
// weight gradients' partials share one workspace (ops/kernels/proj_fused.py
// `projection_wgrad_plans`, in this order).

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

// The stride-2 3x3 data gradient's taps per output parity p (an even output
// takes tap 1 at offset 0, an odd one taps 2 and 0 at offsets 0 and +1);
// class (py, px) of w2d starts at tap kSm90ClassTap (ops/kernels `dgrad_w2`).
constexpr int kSm90ClassTaps[2] = {1, 2};
constexpr int kSm90ClassTap[4] = {0, 1, 3, 5};

// The backward from the masked cotangent m3: x (N, H, W, CIN); m3 (N, Ho,
// Wo, COUT); h1, m1 (N, H, W, F); h2, m2 (N, Ho, Wo, F); dw1 (CIN, F), dw2
// (3, 3, F, F), dw3 (F, COUT), dwsc (CIN, COUT) f32; Ho = H / S; dx may be
// nullptr; dx_mask (like dx) or nullptr.
inline cudaError_t projection_block_bwd_m3_sm90(const void* x, const void* m3, const void* h1, const void* h2,
                                                const void* w1t, const void* w2d, const void* w3t, const void* wsct,
                                                void* dx, const void* dx_mask, void* m1, void* m2, void* dw1,
                                                void* dw2, void* dw3, void* dwsc, void* ws, int64_t ws_elems, int N,
                                                int H, int W, int CIN, int F, int COUT, int S, cudaStream_t st) {
  const int Ho = H / S, Wo = W / S;
  // m2 = bf16(m3 @ w3^T) * (h2 > 0)
  DgradArgs p = dgrad_args(dgrad_seg(m3, Ho, Wo, COUT, 1, 1, 0), nullptr, N, Ho, Wo, F, m2);
  p.emask = static_cast<const bf16*>(h2);
  ARGUS_TRY(launch_dgrad(p, w3t, nullptr, st));
  // dw3 = h2^T m3, dwsc = x[::S, ::S]^T m3
  ARGUS_TRY(wgrad_sm90(h2, Ho, Wo, F, 1, 1, 0, m3, COUT, N, Ho, Wo, dw3, ws, ws_elems, st));
  ARGUS_TRY(wgrad_sm90(x, H, W, CIN, 1, S, 0, m3, COUT, N, Ho, Wo, dwsc, ws, ws_elems, st));
  if (S == 1) {
    // m1 = bf16(conv3x3^T(m2)) * (h1 > 0); dx = bf16(m1 @ w1^T + m3 @ wsc^T)
    p = dgrad_args(dgrad_seg(m2, H, W, F, 3, 1, 1), nullptr, N, H, W, F, m1);
    p.emask = static_cast<const bf16*>(h1);
    ARGUS_TRY(launch_dgrad(p, w2d, nullptr, st));
    if (dx != nullptr) {
      const DgradSeg s1 = dgrad_seg(m1, H, W, F, 1, 1, 0);
      const DgradSeg ssc = dgrad_seg(m3, H, W, COUT, 1, 1, 0);
      p = dgrad_args(s1, &ssc, N, H, W, CIN, dx);
      p.emask = static_cast<const bf16*>(dx_mask);
      ARGUS_TRY(launch_dgrad(p, w1t, wsct, st));
    }
  } else {
    for (int py = 0; py < 2; ++py) {
      for (int px = 0; px < 2; ++px) {
        // class (py, px) of m1: its taps of m2, written to pixels (2a+py, 2b+px)
        DgradSeg s2 = dgrad_seg(m2, Ho, Wo, F, 1, 1, 0);
        s2.kh = kSm90ClassTaps[py];
        s2.kw = kSm90ClassTaps[px];
        finish_seg(s2);
        p = dgrad_args(s2, nullptr, N, Ho, Wo, F, m1);
        p.OH = H;
        p.OW = W;
        p.ostride = 2;
        p.oy = py;
        p.ox = px;
        p.emask = static_cast<const bf16*>(h1);
        ARGUS_TRY(launch_dgrad(p, static_cast<const bf16*>(w2d) + static_cast<int64_t>(kSm90ClassTap[2 * py + px]) * F * F,
                               nullptr, st));
      }
    }
    if (dx != nullptr) {
      for (int py = 0; py < 2; ++py) {
        for (int px = 0; px < 2; ++px) {
          // class (py, px) of dx: m1 @ w1^T there, plus m3 @ wsc^T at the even pixels
          DgradSeg s1 = dgrad_seg(m1, H, W, F, 1, 2, 0);
          s1.pad_h = -py;
          s1.pad_w = -px;
          const DgradSeg ssc = dgrad_seg(m3, Ho, Wo, COUT, 1, 1, 0);
          const bool shortcut = py == 0 && px == 0;
          p = dgrad_args(s1, shortcut ? &ssc : nullptr, N, Ho, Wo, CIN, dx);
          p.OH = H;
          p.OW = W;
          p.ostride = 2;
          p.oy = py;
          p.ox = px;
          p.emask = static_cast<const bf16*>(dx_mask);
          ARGUS_TRY(launch_dgrad(p, w1t, shortcut ? wsct : nullptr, st));
        }
      }
    }
  }
  // dw2[ky, kx] = shift_S(h1)^T m2; dw1 = x^T m1
  ARGUS_TRY(wgrad_sm90(h1, H, W, F, 3, S, 1, m2, F, N, Ho, Wo, dw2, ws, ws_elems, st));
  return wgrad_sm90(x, H, W, CIN, 1, 1, 0, m1, F, N, H, W, dw1, ws, ws_elems, st);
}

// The block backward from the cotangent g: g, out, m3 (N, Ho, Wo, COUT), m3
// scratch; the rest as above.
inline cudaError_t projection_block_bwd_sm90(const void* x, const void* g, const void* out, const void* h1,
                                             const void* h2, const void* w1t, const void* w2d, const void* w3t,
                                             const void* wsct, void* dx, void* m1, void* m2, void* m3, void* dw1,
                                             void* dw2, void* dw3, void* dwsc, void* ws, int64_t ws_elems, int N,
                                             int H, int W, int CIN, int F, int COUT, int S, cudaStream_t st) {
  // m3 = g * (out > 0), once
  ARGUS_TRY(relu_mask_sm90(g, out, m3, static_cast<int64_t>(N) * (H / S) * (W / S) * COUT, st));
  return projection_block_bwd_m3_sm90(x, m3, h1, h2, w1t, w2d, w3t, wsct, dx, nullptr, m1, m2, dw1, dw2, dw3, dwsc,
                                      ws, ws_elems, N, H, W, CIN, F, COUT, S, st);
}

}  // namespace argus
