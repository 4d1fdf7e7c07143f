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
// Bound on the H100: at ResNet-50's widths (K or COUT = 64 to 2048) the op
// does 2*M*CIN*COUT FLOPs on (CIN + COUT [+ COUT]) * 2 bytes a row, 64 to
// 680 FLOP per byte: device memory bounds the stage-0 and narrow cases, the
// tensor cores the 1024/2048-channel ones. Design: one launch of the
// implicit-GEMM kernel (conv_gemm.cuh) over a 1x1 grid of M "images", the
// bias, residual and relu in its epilogue, so x is read once and out written
// once, each rounding where the TPU kernel rounds. relu == 0 takes the
// gradient instantiation, which adds the bias and residual without a relu.

#include "conv_gemm.cuh"

// x (M, CIN), w (CIN, COUT), b (COUT,) f32, res (M, COUT) or nullptr, out (M, COUT).
extern "C" int argus_pointwise_fwd(const void* x, const void* w, const void* b, const void* res,
                                   void* out, int M, int CIN, int COUT, int relu, void* stream) {
  const argus::ConvSeg s = argus::make_seg(x, w, 1, 1, CIN, 1, 1, 0);
  argus::ConvGemmArgs p = argus::gemm_args(s, nullptr, M, 1, 1, COUT, out);
  p.bias0 = static_cast<const float*>(b);
  p.residual = static_cast<const argus::bf16*>(res);
  p.relu = relu;
  return static_cast<int>(argus::launch_conv_gemm(p, static_cast<cudaStream_t>(stream)));
}
