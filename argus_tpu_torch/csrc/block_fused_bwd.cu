// Identity bottleneck block backward from the saved h1/h2, on folded
// frozen-BN weights, NHWC bf16.
//
// Replaces: argus_tpu/ops/pallas/block_fused.py `_block_bwd_saved_pallas`
// (:394, body `_bwd_saved_kernel` :350), the one-pass backward of every
// stride-1 identity bottleneck in the training step:
//
//   m3 = g * (out > 0);  m2 = bf16(m3 @ w3^T) * (h2 > 0)
//   m1 = bf16(conv3x3^T(m2)) * (h1 > 0);  dx = bf16(m1 @ w1^T + m3)
//   dw1 = x^T m1, dw2 = shift(h1)^T m2, dw3 = h2^T m3   (f32)
//
// Bound on the H100: twice the forward's FLOPs (a data and a weight gradient
// per conv), tensor-core issue at stages 1-3; the TPU kernel's sequential
// grid carries the dw in VMEM, which Hopper cannot, so each dw is a split
// reduction over all pixels with a second pass over the partials. Design:
// the wgmma/TMA engines (conv_dgrad_sm90.cuh, wgrad_sm90.cuh) composed by
// identity_bwd_sm90.cuh: the relu mask written once as m3, three masked
// data-gradient launches and three weight-gradient launches (the 3x3's nine
// taps in one), m1/m2/m3 through device memory. One launch per block is
// later work.

#include "identity_bwd_sm90.cuh"

// w1t (F, CIN), w2d (3, 3, F, F) with w2d[ky, kx] = w2[2-ky, 2-kx]^T, w3t (CIN, F);
// dx may be nullptr; m1, m2 (N, H, W, F) and m3 (N, H, W, CIN) are scratch;
// ws holds ws_elems f32 for the weight-gradient partials
// (ops/kernels/block_fused.py `identity_wgrad_plans`, wgrad_plan.py).
extern "C" int argus_block_bwd(const void* x, const void* g, const void* out, const void* h1,
                               const void* h2, const void* w1t, const void* w2d, const void* w3t,
                               void* dx, void* m1, void* m2, void* m3, void* dw1, void* dw2, void* dw3,
                               void* ws, int64_t ws_elems, int N, int H, int W, int CIN, int F,
                               void* stream) {
  return static_cast<int>(argus::identity_block_bwd_sm90(x, g, out, h1, h2, w1t, w2d, w3t, dx, m1, m2, m3,
                                                         dw1, dw2, dw3, ws, ws_elems, N, H, W, CIN, F,
                                                         static_cast<cudaStream_t>(stream)));
}
