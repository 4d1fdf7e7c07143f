// Pointwise (1x1) conv on a folded frozen-BN weight with relu and an optional
// residual, over (M, CIN) rows of an NHWC bf16 activation.
//
// Replaces: argus_tpu/ops/pallas/pointwise.py `_pw_fwd_pallas` (:93, bodies
// `_fwd_kernel` :77 and `_fwd_res_kernel` :85), the forward of
// `pointwise_conv_frozen_bn` that `fuse_pointwise` runs for Conv_0 (no
// residual) and Conv_2 (with the block's residual) of every bottleneck that
// no block, projection or chain kernel takes:
//
//   out = bf16(relu(x2 @ w_eff + b_eff [+ res2]))      sums in f32, one rounding
//
// (relu=False: the same without the relu).
//
// Bound on the H100: at ResNet-50's widths (K or COUT = 64 to 2048) the op
// does 2*M*CIN*COUT FLOPs on (CIN + COUT [+ COUT]) * 2 bytes a row, 64 to
// 680 FLOP per byte: device memory bounds the stage-0 and narrow cases, the
// tensor cores the 1024/2048-channel ones. Design: one launch of the TMA
// forward engine's 1x1 mode (conv_fwd_sm90.cuh) over the rows as M images of
// 1 x 1 pixel, so a tile is 128 consecutive rows (one TMA box of 64 channels
// a k-step, zero-filled past M and past CIN), wgmma on two consumer
// warpgroups, the bias, residual and relu in its epilogue (with the
// residual: both tiles through TMA and shared memory), x read once and out
// written once, each rounding where the TPU kernel rounds. relu is a
// template flag of the engine: relu=False takes its own instantiation. The
// previous form, one launch of the mma.sync conv-GEMM (conv_gemm.cuh), is
// `argus_pointwise_fwd_prev` in bwd_prev.cu.

#include "conv_fwd_sm90.cuh"

// x (M, CIN), w (CIN, COUT), b (COUT,) f32, res (M, COUT) or nullptr, out (M, COUT).
extern "C" int argus_pointwise_fwd(const void* x, const void* w, const void* b, const void* res,
                                   void* out, int M, int CIN, int COUT, int relu, void* stream) {
  const float* bias = static_cast<const float*>(b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(relu ? argus::launch_conv_fwd_tma<1>(x, w, bias, res, out, M, 1, 1, CIN, COUT, 1, st)
                               : argus::launch_conv_fwd_tma<1, false>(x, w, bias, res, out, M, 1, 1, CIN, COUT, 1, st));
}
