// Backward of the pointwise (1x1) conv on a folded frozen-BN weight, over
// (M, CIN) rows of an NHWC bf16 activation.
//
// Replaces: argus_tpu/ops/pallas/pointwise.py `_pw_bwd_pallas` (:157, body
// `_bwd_kernel` :124), the one-pass backward of `pointwise_conv_frozen_bn`:
//
//   m  = g * (out > 0)          (g without relu)
//   dx = bf16(m @ w_eff^T)      dw = x2^T m   (f32, over all M rows)
//   m written out as the residual's cotangent when the op had a residual
//
// Bound on the H100: device memory at every geometry of configuration P
// (2 * 2*M*CIN*COUT FLOPs on g, out, x2 and dx, plus m, once each). The TPU
// kernel carries dw in a VMEM accumulator across its sequential grid;
// Hopper has no such carry, so dw is the split-M reduction of the weight-
// gradient engine (each block a contiguous range of rows, a second pass
// adding the partials in order: deterministic). Design: composed from the
// Hopper engines as the identity block's 1x1 ends are
// (identity_bwd_sm90.cuh):
//   1. with relu, m = g * (out > 0), written once (`relu_mask_sm90`): into
//      the caller's buffer when m is emitted, into scratch otherwise; both
//      products read it plain (masking g in shared memory as the tiles
//      arrive lost to the pass, PERF.md);
//   2. dx: a 1x1 data gradient (conv_dgrad_sm90.cuh), m as A over M pixels,
//      K = COUT, w_eff^T as B;
//   3. dw: the weight gradient (wgrad_sm90.cuh) with one tap, over x2 and m.
// The previous form, the mma.sync conv-GEMM and weight gradient with the
// mask applied as g is loaded, is `argus_pointwise_bwd_prev` in bwd_prev.cu.

#include "conv_dgrad_sm90.cuh"
#include "wgrad_sm90.cuh"

// g, out (M, COUT); x (M, CIN); wt = w_eff^T (COUT, CIN); dx (M, CIN) or
// nullptr (not needed); dw (CIN, COUT) f32; m (M, COUT), written when relu
// (the caller's m, or scratch) and not read otherwise (the caller takes g
// itself); ws holds ws_elems f32 for dw's partials (ops/kernels/wgrad_plan.py).
extern "C" int argus_pointwise_bwd(const void* g, const void* out, const void* x, const void* wt, void* dx, void* dw,
                                   void* m, void* ws, int64_t ws_elems, int M, int CIN, int COUT, int relu,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* a = g;
  cudaError_t e = cudaSuccess;
  if (relu) {  // m = g * (out > 0), once
    if (m == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if ((e = argus::relu_mask_sm90(g, out, m, static_cast<int64_t>(M) * COUT, st)) != cudaSuccess)
      return static_cast<int>(e);
    a = m;
  }
  if (dx != nullptr) {  // dx = bf16(m @ w_eff^T)
    const argus::DgradArgs p =
        argus::dgrad_args(argus::dgrad_seg(a, 1, 1, COUT, 1, 1, 0), nullptr, M, 1, 1, CIN, dx);
    if ((e = argus::launch_dgrad(p, wt, nullptr, st)) != cudaSuccess) return static_cast<int>(e);
  }
  // dw = x2^T m
  return static_cast<int>(argus::wgrad_sm90(x, 1, 1, CIN, 1, 1, 0, a, COUT, M, 1, 1, dw, ws, ws_elems, st));
}
