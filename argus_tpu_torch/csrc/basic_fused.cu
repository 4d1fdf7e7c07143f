// Identity BasicBlock (ResNet-18/34) forward on folded frozen-BN weights,
// NHWC bf16.
//
// Replaces: argus_tpu/ops/pallas/basic_fused.py `_fwd_pallas` (:87, bodies
// `_fwd_kernel` :62 and `_fwd_save_kernel` :67), both variants: save=False,
// the forward that eval runs for every stride-1 identity BasicBlock, and
// save=True, the training forward that also keeps h1 for the one-pass
// backward (basic_fused_bwd.cu).
//
//   h1  = bf16(relu(conv3x3(x) + b1))                 pad 1, C -> C
//   out = bf16(relu(f32(conv3x3(h1)) + b2 + f32(x)))  identity residual
//
// every sum in f32, one rounding after each bias + relu (`_fwd_math` :52-59).
//
// Bound on the H100: each conv is N*H*W*9*C^2 MACs, the same at every stage
// of ResNet-18 (C doubles as H*W quarters): 1.55e11 FLOP at N = 512 and
// 256x256 frames, so a block is 0.31 ms of bf16 tensor-core issue against
// 0.24 ms for its bytes at stage 0 (x, h1 and out of 268 MB each, h1 written
// and read back). Design: two launches, h1 through device memory (the
// no-save variant writes it to scratch, so one launcher serves both), each
// a forward conv on the TMA engine (conv_fwd_sm90.cuh) with the bias, the
// relu and (the second) the residual in its epilogue: a tile of 128 output
// pixels is a box of one image (or of whole images, where they are small),
// its A operand per tap and 64 channels one tiled TMA box (the zero fill
// is the padding), a producer issuing the boxes to two wgmma warpgroups
// through mbarriers. Needs C % 64 == 0, which every BasicBlock of
// ResNet-18/34 has. The TPU kernel's nine shifted matmuls over a padded
// VMEM copy are not carried over. One launch per block with h1 on chip is
// later work. The previous form, two launches of the mma.sync conv-GEMM
// (conv_gemm.cuh), is `argus_basic_fwd_prev` in bwd_prev.cu.

#include "conv_fwd_sm90.cuh"

// x, h1, out (N, H, W, C) bf16; w1, w2 (3, 3, C, C) HWIO bf16; b1, b2 (C,)
// f32; C % 64 == 0.
extern "C" int argus_basic_fwd(const void* x, void* h1, void* out, const void* w1, const void* b1, const void* w2,
                               const void* b2, int N, int H, int W, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // h1 = bf16(relu(conv3x3(x) + b1)); out = bf16(relu(conv3x3(h1) + b2 + f32(x)))
  cudaError_t e =
      argus::launch_conv_fwd_tma<3>(x, w1, static_cast<const float*>(b1), nullptr, h1, N, H, W, C, C, 1, st);
  if (e == cudaSuccess)
    e = argus::launch_conv_fwd_tma<3>(h1, w2, static_cast<const float*>(b2), x, out, N, H, W, C, C, 1, st);
  return static_cast<int>(e);
}
