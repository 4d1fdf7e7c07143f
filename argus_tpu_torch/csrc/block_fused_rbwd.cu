// Identity bottleneck block backward that recomputes h1/h2 from x, on folded
// frozen-BN weights, NHWC bf16: the backward of a fused identity block under
// remat.
//
// Replaces: argus_tpu/ops/pallas/block_fused.py `_block_bwd_pallas` (:519,
// body `_bwd_kernel` :454), which reads only x, g and out:
//
//   h1 = bf16(relu(x @ w1 + b1));  h2 = bf16(relu(conv3x3(h1) + b2))   (recomputed)
//   m3 = g * (out > 0);  m2 = bf16(m3 @ w3^T) * (h2 > 0)
//   m1 = bf16(conv3x3^T(m2)) * (h1 > 0);  dx = bf16(m1 @ w1^T + m3)
//   dw1 = x^T m1, dw2 = shift(h1)^T m2, dw3 = h2^T m3   (f32)
//
// Bound on the H100: the saved-residual backward's FLOPs plus the first two
// convs of the forward, on the tensor cores at stages 1-3. The TPU kernel
// keeps the recomputed h1/h2 in VMEM. Design: the wgmma/TMA data-gradient
// engine in its forward mode (conv_dgrad_sm90.cuh `launch_conv_bias_relu`,
// bias + relu and one rounding in the epilogue) recomputes h1 (a 1x1 over
// x) and h2 (a 3x3 over h1) into a per-launch workspace, then the
// saved-residual backward of identity_bwd_sm90.cuh runs on them; the
// workspace costs 2 * N*H*W*F bf16 written and read back (PERF.md).
// Keeping h1/h2 on chip is later work.

#include "identity_bwd_sm90.cuh"

// x, g, out (N, H, W, CIN); w1 (CIN, F), w2 (3, 3, F, F); f32 biases b1, b2
// (F,); the data gradients' w1t (F, CIN), w2d (9, F, F) and w3t (CIN, F) as
// block_fused_bwd.cu takes them; h1, h2, m1, m2 (N, H, W, F) and m3 (N, H,
// W, CIN) workspace; dx may be nullptr; ws holds ws_elems f32 for the
// weight-gradient partials.
extern "C" int argus_block_rbwd(const void* x, const void* g, const void* out, const void* w1,
                                const void* b1, const void* w2, const void* b2, const void* w1t,
                                const void* w2d, const void* w3t, void* dx, void* h1, void* h2,
                                void* m1, void* m2, void* m3, void* dw1, void* dw2, void* dw3, void* ws,
                                int64_t ws_elems, int N, int H, int W, int CIN, int F, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // h1 = bf16(relu(x @ w1 + b1)); h2 = bf16(relu(conv3x3(h1) + b2))
  argus::DgradArgs p = argus::dgrad_args(argus::dgrad_seg(x, H, W, CIN, 1, 1, 0), nullptr, N, H, W, F, h1);
  p.bias = static_cast<const float*>(b1);
  cudaError_t e = argus::launch_conv_bias_relu(p, w1, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  p = argus::dgrad_args(argus::dgrad_seg(h1, H, W, F, 3, 1, 1), nullptr, N, H, W, F, h2);
  p.bias = static_cast<const float*>(b2);
  e = argus::launch_conv_bias_relu(p, w2, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(argus::identity_block_bwd_sm90(x, g, out, h1, h2, w1t, w2d, w3t, dx, m1, m2, m3,
                                                         dw1, dw2, dw3, ws, ws_elems, N, H, W, CIN, F, st));
}
