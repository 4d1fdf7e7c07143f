// One-pass bottleneck backwards from saved h1/h2, on folded frozen-BN weights,
// composed from the masked data-gradient mode of the mma.sync conv-GEMM
// (conv_gemm.cuh) and the weight-gradient reduction (wgrad.cuh): the
// previous form of the redesigned backwards and of the stage chain's
// backward, which bwd_prev.cu keeps for timing. The block and chain
// backwards themselves (block_fused_bwd.cu, block_fused_rbwd.cu,
// proj_fused_bwd.cu, basic_fused_bwd.cu, stage_fused_bwd.cu) run on the
// Hopper engines (conv_dgrad_sm90.cuh, wgrad_sm90.cuh) with the same
// formulas and rounding points:
//
//   m3  = g * (out > 0)                       (applied as g is loaded)
//   m2  = bf16(m3 @ w3^T) * (h2 > 0)          dw3  = h2^T m3
//   m1  = bf16(conv3x3_s^T(m2)) * (h1 > 0)    dw2  = shift_s(h1)^T m2, 9 taps
//   dx  = bf16(m1 @ w1^T + m3)                dw1  = x^T m1         identity
//   dx  = bf16(m1 @ w1^T + scatter_s(m3 @ wsc^T))                   projection
//                                             dwsc = x[::s, ::s]^T m3
//
// the formulas and rounding points of argus_tpu's saved-residual backwards
// (block_fused.py `_bwd_saved_kernel` :350, proj_fused.py `_proj_bwd_kernel`
// :286): every sum in f32, m2 and m1 rounded to bf16 before their masks, dx
// rounded once. m1 and m2 go through device memory (scratch buffers the
// caller allocates); the dw are f32. The data gradients take the weights
// transposed (w1t = w1^T, w3t = w3^T, wsct = wsc^T) and the 3x3's as `w2d`
// (9, F, F), prepared by the caller once per step (ops/kernels
// `dgrad_w2`). At stride 1 the 3x3's data gradient is the forward conv of m2
// with w2d[ky, kx] = w2[2-ky, 2-kx]^T. At stride 2 dh1[y, x] sums
// m2[(y+1-ky)/2, (x+1-kx)/2] @ w2[ky, kx]^T over the taps where both
// quotients are whole (`_dh1_scatter` :242): an even row takes tap ky = 1
// from row y/2, an odd row ky = 2 from (y-1)/2 and ky = 0 from (y+1)/2, and
// the same for columns. So it runs as four launches, one per output parity
// class (y % 2, x % 2), each a small forward conv over m2 with only its 1, 2,
// 2 or 4 taps (w2d holds them in that class order, 9 taps in all), written
// to its pixels of m1; no work lands on a tap that misses. The dx GEMM splits
// the same way: the shortcut's m3 @ wsc^T reaches only the even pixels
// (`_scatter2` :129), as a second K segment of class (0, 0) alone. dx ==
// nullptr skips the dx GEMMs (nothing upstream needs them).

#pragma once

#include "conv_gemm.cuh"
#include "wgrad.cuh"

namespace argus {

#define ARGUS_TRY(call)                       \
  do {                                        \
    const cudaError_t e_ = (call);            \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

// x, g, out (N, H, W, CIN); h1, h2, m1, m2 (N, H, W, F); dw1 (CIN, F),
// dw2 (3, 3, F, F), dw3 (F, CIN) f32.
inline cudaError_t identity_block_bwd(const void* x, const void* g, const void* out, const void* h1,
                                      const void* h2, const void* w1t, const void* w2d,
                                      const void* w3t, void* dx, void* m1, void* m2, void* dw1,
                                      void* dw2, void* dw3, void* ws, int64_t ws_elems, int N,
                                      int H, int W, int CIN, int F, cudaStream_t st) {
  // m2 = bf16(m3 @ w3^T) * (h2 > 0), m3 = g * (out > 0) as g is loaded
  const ConvSeg sg = make_seg(g, w3t, H, W, CIN, 1, 1, 0, out);
  ConvGemmArgs p = gemm_args(sg, nullptr, N, H, W, F, m2);
  p.emask = static_cast<const bf16*>(h2);
  ARGUS_TRY(launch_conv_gemm(p, st));
  // dw3 = h2^T m3
  ARGUS_TRY(wgrad(h2, H, W, F, 1, 1, 0, g, out, CIN, N, H, W, dw3, ws, ws_elems, st));
  // m1 = bf16(conv3x3^T(m2)) * (h1 > 0)
  const ConvSeg s2 = make_seg(m2, w2d, H, W, F, 3, 1, 1);
  p = gemm_args(s2, nullptr, N, H, W, F, m1);
  p.emask = static_cast<const bf16*>(h1);
  ARGUS_TRY(launch_conv_gemm(p, st));
  // dw2[ky, kx] = shift(h1)^T m2
  ARGUS_TRY(wgrad(h1, H, W, F, 3, 1, 1, m2, nullptr, F, N, H, W, dw2, ws, ws_elems, st));
  // dx = bf16(m1 @ w1^T + m3)
  if (dx != nullptr) {
    const ConvSeg s1 = make_seg(m1, w1t, H, W, F, 1, 1, 0);
    p = gemm_args(s1, nullptr, N, H, W, CIN, dx);
    p.residual = static_cast<const bf16*>(g);
    p.rmask = static_cast<const bf16*>(out);
    ARGUS_TRY(launch_conv_gemm(p, st));
  }
  // dw1 = x^T m1
  return wgrad(x, H, W, CIN, 1, 1, 0, m1, nullptr, F, N, H, W, dw1, ws, ws_elems, st);
}

// The stride-2 3x3 data gradient's taps per output parity p: (tap, source
// offset); an even output takes tap 1 at offset 0, an odd one taps 2 and 0
// at offsets 0 and +1. Class (py, px) of w2d starts at tap kClassTap.
constexpr int kClassTaps[2] = {1, 2};
constexpr int kClassTap[4] = {0, 1, 3, 5};

// x (N, H, W, CIN); g, out (N, Ho, Wo, COUT); h1, m1 (N, H, W, F); h2, m2
// (N, Ho, Wo, F); dw1 (CIN, F), dw2 (3, 3, F, F), dw3 (F, COUT), dwsc
// (CIN, COUT) f32; Ho = H / S.
inline cudaError_t projection_block_bwd(const void* x, const void* g, const void* out,
                                        const void* h1, const void* h2, const void* w1t,
                                        const void* w2d, const void* w3t, const void* wsct,
                                        void* dx, void* m1, void* m2, void* dw1, void* dw2,
                                        void* dw3, void* dwsc, void* ws, int64_t ws_elems, int N,
                                        int H, int W, int CIN, int F, int COUT, int S,
                                        cudaStream_t st) {
  const int Ho = H / S, Wo = W / S;
  // m2 = bf16(m3 @ w3^T) * (h2 > 0)
  const ConvSeg sg = make_seg(g, w3t, Ho, Wo, COUT, 1, 1, 0, out);
  ConvGemmArgs p = gemm_args(sg, nullptr, N, Ho, Wo, F, m2);
  p.emask = static_cast<const bf16*>(h2);
  ARGUS_TRY(launch_conv_gemm(p, st));
  // dw3 = h2^T m3, dwsc = x[::S, ::S]^T m3
  ARGUS_TRY(wgrad(h2, Ho, Wo, F, 1, 1, 0, g, out, COUT, N, Ho, Wo, dw3, ws, ws_elems, st));
  ARGUS_TRY(wgrad(x, H, W, CIN, 1, S, 0, g, out, COUT, N, Ho, Wo, dwsc, ws, ws_elems, st));
  if (S == 1) {
    // m1 = bf16(conv3x3^T(m2)) * (h1 > 0); dx = bf16(m1 @ w1^T + m3 @ wsc^T)
    p = gemm_args(make_seg(m2, w2d, H, W, F, 3, 1, 1), nullptr, N, H, W, F, m1);
    p.emask = static_cast<const bf16*>(h1);
    ARGUS_TRY(launch_conv_gemm(p, st));
    if (dx != nullptr) {
      const ConvSeg s1 = make_seg(m1, w1t, H, W, F, 1, 1, 0);
      const ConvSeg ssc = make_seg(g, wsct, H, W, COUT, 1, 1, 0, out);
      ARGUS_TRY(launch_conv_gemm(gemm_args(s1, &ssc, N, H, W, CIN, dx), st));
    }
  } else {
    for (int py = 0; py < 2; ++py) {
      for (int px = 0; px < 2; ++px) {
        // class (py, px) of m1: its taps of m2, written to pixels (2a+py, 2b+px)
        ConvSeg s2 = make_seg(m2, static_cast<const bf16*>(w2d) +
                                      static_cast<int64_t>(kClassTap[2 * py + px]) * F * F,
                              Ho, Wo, F, 1, 1, 0);
        s2.kh = kClassTaps[py];
        s2.kw = kClassTaps[px];
        p = gemm_args(s2, nullptr, N, Ho, Wo, F, m1);
        p.OH = H;
        p.OW = W;
        p.ostride = 2;
        p.oy = py;
        p.ox = px;
        p.emask = static_cast<const bf16*>(h1);
        ARGUS_TRY(launch_conv_gemm(p, st));
      }
    }
    if (dx != nullptr) {
      for (int py = 0; py < 2; ++py) {
        for (int px = 0; px < 2; ++px) {
          // class (py, px) of dx: m1 @ w1^T there, plus m3 @ wsc^T at the even pixels
          ConvSeg s1 = make_seg(m1, w1t, H, W, F, 1, 2, 0);
          s1.pad_h = -py;
          s1.pad_w = -px;
          const ConvSeg ssc = make_seg(g, wsct, Ho, Wo, COUT, 1, 1, 0, out);
          p = gemm_args(s1, py == 0 && px == 0 ? &ssc : nullptr, N, Ho, Wo, CIN, dx);
          p.OH = H;
          p.OW = W;
          p.ostride = 2;
          p.oy = py;
          p.ox = px;
          ARGUS_TRY(launch_conv_gemm(p, st));
        }
      }
    }
  }
  // dw2[ky, kx] = shift_S(h1)^T m2; dw1 = x^T m1
  ARGUS_TRY(wgrad(h1, H, W, F, 3, S, 1, m2, nullptr, F, N, Ho, Wo, dw2, ws, ws_elems, st));
  return wgrad(x, H, W, CIN, 1, 1, 0, m1, nullptr, F, N, H, W, dw1, ws, ws_elems, st);
}

}  // namespace argus
