// Projection (stage-entry) bottleneck block backward from the saved h1/h2, on
// folded frozen-BN weights, NHWC bf16, stride S in {1, 2} on the 3x3.
//
// Replaces: argus_tpu/ops/pallas/proj_fused.py `_proj_bwd_pallas` (:363, body
// `_proj_bwd_kernel` :286), the one-pass backward of the stage 1-3 entry
// blocks in the training step:
//
//   m3 = g * (out > 0);  m2 = bf16(m3 @ w3^T) * (h2 > 0)
//   m1 = bf16(conv3x3_S^T(m2)) * (h1 > 0)
//   dx = bf16(m1 @ w1^T + scatter_S(m3 @ wsc^T))
//   dw1 = x^T m1, dw2 = shift_S(h1)^T m2, dw3 = h2^T m3, dwsc = x[::S, ::S]^T m3
//
// At S = 2 the 3x3's data gradient is the transpose of the strided taps
// (`_dh1_scatter` :242) and the shortcut's m3 @ wsc^T lands on the even
// pixels only (`_scatter2` :129): both run as one data-gradient launch per
// output parity class, each with only the taps that land on it, so
// no scatter or interleave pass exists and no work is spent on taps that
// miss.
//
// Bound on the H100: twice the forward's FLOPs, tensor-core issue. Design:
// the wgmma/TMA engines (conv_dgrad_sm90.cuh, wgrad_sm90.cuh) composed by
// proj_bwd_sm90.cuh: the relu mask written once as m3, the masked data
// gradients (parity-class launches at S = 2) and four weight gradients,
// m1, m2, m3 through device memory (scratch the wrapper allocates).

#include "proj_bwd_sm90.cuh"

// w1t (F, CIN), w2d (9, F, F) the 3x3's data-gradient taps for stride S
// (ops/kernels `dgrad_w2`), w3t (COUT, F), wsct (COUT, CIN); dx may be
// nullptr; m1, m2, m3 are scratch; ws holds ws_elems f32 for the
// weight-gradient partials (ops/kernels/wgrad_plan.py).
extern "C" int argus_proj_bwd(const void* x, const void* g, const void* out, const void* h1, const void* h2,
                              const void* w1t, const void* w2d, const void* w3t, const void* wsct, void* dx, void* m1,
                              void* m2, void* m3, void* dw1, void* dw2, void* dw3, void* dwsc, void* ws,
                              int64_t ws_elems, int N, int H, int W, int CIN, int F, int COUT, int S, void* stream) {
  return static_cast<int>(argus::projection_block_bwd_sm90(x, g, out, h1, h2, w1t, w2d, w3t, wsct, dx, m1, m2, m3,
                                                           dw1, dw2, dw3, dwsc, ws, ws_elems, N, H, W, CIN, F, COUT,
                                                           S, static_cast<cudaStream_t>(stream)));
}
