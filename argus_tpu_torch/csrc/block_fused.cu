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
// Bound on the H100: 292 GFLOP a block at N = 512 at every stage of
// ResNet-50 (0.30 ms of bf16 tensor-core issue), the 3x3 most of it; the
// 1x1s are near the byte bound at stage 1 (conv3 reads x and h2 and writes
// out, ~1.2 GB, ~0.36 ms) and near the FLOP bound at stages 2-3.
// Design: three launches of the TMA forward engine (conv_fwd_sm90.cuh), a
// 1x1, the 3x3 and a 1x1, each with its bias and relu (the last with the
// residual x) in the epilogue, so every rounding point matches the TPU
// kernel (bottleneck_fwd_sm90.cuh `identity_block_fwd_sm90`, which the stage
// chains run too); h1/h2 go through device memory (the no-save variant
// writes them to scratch, so one launcher serves both). The 1x1s are the engine's
// single-tap mode: conv1 has K = CIN (8-32 k-steps) and COUT = F, conv3
// K = F and COUT = CIN on 128-wide tiles with the residual prefetched (its
// epilogue is its pace). Any CIN and F that are multiples of 8: the last
// 64-channel step of both operands is zero-filled past C. Keeping h1/h2 on
// chip in one launch per block is later work. The previous form, three
// launches of the mma.sync conv-GEMM (conv_gemm.cuh `identity_block`), is
// `argus_block_fwd_prev` in bwd_prev.cu.

#include "bottleneck_fwd_sm90.cuh"

// x, out (N, H, W, CIN); h1, h2 (N, H, W, F) bf16; w1 (CIN, F), w2 (3, 3, F,
// F) HWIO, w3 (F, CIN) bf16; b1, b2 (F,), b3 (CIN,) f32.
extern "C" int argus_block_fwd(const void* x, void* h1, void* h2, void* out, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3, const void* b3, int N, int H, int W,
                               int CIN, int F, void* stream) {
  return static_cast<int>(argus::identity_block_fwd_sm90(x, h1, h2, out, w1, b1, w2, b2, w3, b3, N, H, W, CIN, F,
                                                         static_cast<cudaStream_t>(stream)));
}
