// The bottleneck block forwards on folded frozen-BN weights, NHWC bf16, as
// launches of the TMA forward engine (conv_fwd_sm90.cuh): one definition of
// each, which block_fused.cu (the identity block), proj_fused.cu (the
// projection block) and stage_fused.cu (the chains) call.
//
//   identity:    h1  = bf16(relu(x @ w1 + b1))                  1x1, CIN -> F
//                h2  = bf16(relu(conv3x3(h1) + b2))             pad 1
//                out = bf16(relu(h2 @ w3 + b3 + f32(x)))        1x1, F -> CIN
//   projection:  h1  = bf16(relu(x @ w1 + b1))                  1x1, input resolution
//                h2  = bf16(relu(conv3x3_S(h1) + b2))           stride S in {1, 2}, pad 1
//                out = bf16(relu((h2 @ w3 + x[::S, ::S] @ wsc) + b3 + bsc))
//
// Each launch is a conv with its bias and relu (conv3 with the residual x,
// or with the strided shortcut as a second K segment of the same f32
// accumulator and its bias after b3) in the epilogue, so every rounding
// point matches the TPU kernels (`_fwd_kernel`, `_proj_fwd_core`); h1/h2 go
// through device memory (a no-save caller passes scratch). Any CIN, F and
// COUT that are multiples of 8.

#pragma once

#include "conv_fwd_sm90.cuh"

namespace argus {

// x, out (N, H, W, CIN); h1, h2 (N, H, W, F) bf16; w1 (CIN, F), w2 (3, 3, F,
// F) HWIO, w3 (F, CIN) bf16; b1, b2 (F,), b3 (CIN,) f32.
inline cudaError_t identity_block_fwd_sm90(const void* x, void* h1, void* h2, void* out, const void* w1,
                                           const void* b1, const void* w2, const void* b2, const void* w3,
                                           const void* b3, int N, int H, int W, int CIN, int F, cudaStream_t st) {
  const float *bias1 = static_cast<const float*>(b1), *bias2 = static_cast<const float*>(b2),
              *bias3 = static_cast<const float*>(b3);
  // h1 = bf16(relu(x @ w1 + b1))
  cudaError_t e = launch_conv_fwd_tma<1>(x, w1, bias1, nullptr, h1, N, H, W, CIN, F, 1, st);
  // h2 = bf16(relu(conv3x3(h1) + b2))
  if (e == cudaSuccess) e = launch_conv_fwd_tma<3>(h1, w2, bias2, nullptr, h2, N, H, W, F, F, 1, st);
  // out = bf16(relu(h2 @ w3 + b3 + f32(x)))
  if (e == cudaSuccess) e = launch_conv_fwd_tma<1>(h2, w3, bias3, x, out, N, H, W, F, CIN, 1, st);
  return e;
}

// x (N, H, W, CIN); h1 (N, H, W, F), h2 (N, Ho, Wo, F), out (N, Ho, Wo,
// COUT) bf16 with Ho = H / S, Wo = W / S; w1 (CIN, F), w2 (3, 3, F, F) HWIO,
// w3 (F, COUT), wsc (CIN, COUT) bf16; b1, b2 (F,), b3, bsc (COUT,) f32.
inline cudaError_t projection_block_fwd_sm90(const void* x, void* h1, void* h2, void* out, const void* w1,
                                             const void* b1, const void* w2, const void* b2, const void* w3,
                                             const void* b3, const void* wsc, const void* bsc, int N, int H, int W,
                                             int CIN, int F, int COUT, int S, cudaStream_t st) {
  const float *bias1 = static_cast<const float*>(b1), *bias2 = static_cast<const float*>(b2),
              *bias3 = static_cast<const float*>(b3), *biassc = static_cast<const float*>(bsc);
  // h1 = bf16(relu(x @ w1 + b1)), at the input's resolution
  cudaError_t e = launch_conv_fwd_tma<1>(x, w1, bias1, nullptr, h1, N, H, W, CIN, F, 1, st);
  // h2 = bf16(relu(conv3x3_S(h1) + b2))
  if (e == cudaSuccess) e = launch_conv_fwd_tma<3>(h1, w2, bias2, nullptr, h2, N, H, W, F, F, S, st);
  // out = bf16(relu((h2 @ w3 + x[::S, ::S] @ wsc) + b3 + bsc)): one launch, two K segments
  if (e == cudaSuccess) e = launch_conv_fwd_tma_sc(h2, w3, bias3, x, wsc, biassc, out, N, H, W, F, CIN, COUT, S, st);
  return e;
}

}  // namespace argus
