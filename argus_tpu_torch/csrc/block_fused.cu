// Identity bottleneck block forward on folded frozen-BN weights, NHWC bf16.
//
// Replaces: argus_tpu/ops/pallas/block_fused.py `_block_fwd_pallas` (:270,
// body `_fwd_kernel` :249), the no-save forward that eval and serving run for
// every stride-1 identity bottleneck, and `_block_fwd_save_pallas` (:314,
// body `_fwd_save_kernel` :299), the training forward that also emits h1 and
// h2 for the one-pass backward (block_fused_bwd.cu).
//
//   h1  = bf16(relu(x @ w1 + b1))            1x1, CIN -> F
//   h2  = bf16(relu(conv3x3(h1) + b2))       pad 1
//   out = bf16(relu(h2 @ w3 + b3 + x))       1x1, F -> CIN, identity residual
//
// Bound on the H100: at the serving shapes the block's FLOPs (3x3 with
// K = 9F, two 1x1s) and its x/out bytes take about the same time at peak
// (stage 1, N = 512: 292 GFLOP and 1.07 GB, ~0.3 ms each); the h1/h2 round
// trips through device memory add 4 * N*H*W*F bf16 bytes per block, and the
// conv-GEMM's tensor-core rate is what limits it today.
// Design: three launches of the implicit-GEMM kernel (conv_gemm.cuh), each
// with its bias/relu (and the residual add) fused into the epilogue, so every
// rounding point matches the TPU kernel. Keeping h1/h2 on chip in one launch
// per block is the first redesign item. The save variant is the same three
// launches: h1/h2 go through device memory either way, so saving them costs
// nothing extra here (the caller keeps the buffers instead of dropping them).

#include "conv_gemm.cuh"

extern "C" int argus_block_fwd(const void* x, void* h1, void* h2, void* out, const void* w1,
                               const void* b1, const void* w2, const void* b2, const void* w3,
                               const void* b3, int N, int H, int W, int CIN, int F,
                               void* stream) {
  return static_cast<int>(argus::identity_block(x, h1, h2, out, w1, b1, w2, b2, w3, b3, N, H, W,
                                                CIN, F, static_cast<cudaStream_t>(stream)));
}
