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
// and read back). Design: two launches of the implicit-GEMM kernel
// (conv_gemm.cuh) with K = 9C, the bias, the relu and the residual add in
// the epilogue, h1 through device memory. The save variant is the same two
// launches (the caller keeps h1). The TPU kernel's nine shifted matmuls over
// a padded VMEM copy are not carried over: the conv-GEMM gathers the taps
// as it loads A, the zero padding from cp.async's zero fill. One launch per
// block with h1 on chip, then wgmma/TMA tiles, are later work.

#include "conv_gemm.cuh"

namespace argus {

inline cudaError_t basic_block(const void* x, void* h1, void* out, const void* w1, const void* b1,
                               const void* w2, const void* b2, int N, int H, int W, int C,
                               cudaStream_t stream) {
  cudaError_t e;
  const ConvSeg s1 = make_seg(x, w1, H, W, C, 3, 1, 1);
  if ((e = conv_gemm(s1, nullptr, N, H, W, C, b1, nullptr, nullptr, h1, stream)) != cudaSuccess)
    return e;
  const ConvSeg s2 = make_seg(h1, w2, H, W, C, 3, 1, 1);
  return conv_gemm(s2, nullptr, N, H, W, C, b2, nullptr, x, out, stream);
}

}  // namespace argus

// x, h1, out (N, H, W, C) bf16; w1, w2 (3, 3, C, C) HWIO bf16; b1, b2 (C,) f32.
extern "C" int argus_basic_fwd(const void* x, void* h1, void* out, const void* w1, const void* b1,
                               const void* w2, const void* b2, int N, int H, int W, int C,
                               void* stream) {
  return static_cast<int>(argus::basic_block(x, h1, out, w1, b1, w2, b2, N, H, W, C,
                                             static_cast<cudaStream_t>(stream)));
}
