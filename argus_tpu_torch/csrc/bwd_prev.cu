// The eleven redesigned kernels composed from the engines they ran on
// before, the mma.sync conv-GEMM (conv_gemm.cuh) and weight gradient
// (wgrad.cuh): the block backwards (basic_fused_bwd.cu, proj_fused_bwd.cu,
// block_fused_bwd.cu, block_fused_rbwd.cu), the stage chain's backward
// (stage_fused_bwd.cu), the BasicBlock, identity bottleneck and projection
// forwards (basic_fused.cu, block_fused.cu, proj_fused.cu), the chain
// forwards (stage_fused.cu) and the pointwise backward and forward
// (pointwise_bwd.cu, pointwise.cu). No wrapper of the port calls this
// library: chip_smoke.py and scripts/time_torch_block_bwd.py time it beside
// the Hopper engines (same inputs, same call) and break both down by device
// kernel.

#include "conv_bwd.cuh"
#include "conv_dgrad_sm90.cuh"
#include "stage_fwd.cuh"

namespace argus {

// x, g, out, h1, m1, dx (N, H, W, C); w1d, w2d (9, C, C); dw1, dw2 (3, 3, C, C) f32.
inline cudaError_t basic_block_bwd_prev(const void* x, const void* g, const void* out, const void* h1,
                                        const void* w1d, const void* w2d, void* dx, void* m1, void* dw1,
                                        void* dw2, void* ws, int64_t ws_elems, int N, int H, int W, int C,
                                        cudaStream_t st) {
  // m1 = bf16(conv3x3^T(g * (out > 0))) * (h1 > 0)
  ConvGemmArgs p = gemm_args(make_seg(g, w2d, H, W, C, 3, 1, 1, out), nullptr, N, H, W, C, m1);
  p.emask = static_cast<const bf16*>(h1);
  ARGUS_TRY(launch_conv_gemm(p, st));
  // dw2[ky, kx] = shift(h1)^T (g * (out > 0))
  ARGUS_TRY(wgrad(h1, H, W, C, 3, 1, 1, g, out, C, N, H, W, dw2, ws, ws_elems, st));
  // dx = bf16(conv3x3^T(m1) + g * (out > 0))
  if (dx != nullptr) {
    p = gemm_args(make_seg(m1, w1d, H, W, C, 3, 1, 1), nullptr, N, H, W, C, dx);
    p.residual = static_cast<const bf16*>(g);
    p.rmask = static_cast<const bf16*>(out);
    ARGUS_TRY(launch_conv_gemm(p, st));
  }
  // dw1[ky, kx] = shift(x)^T m1
  return wgrad(x, H, W, C, 3, 1, 1, m1, nullptr, C, N, H, W, dw1, ws, ws_elems, st);
}

}  // namespace argus

// The previous launchers: the workspace is sized by bwd_prev.wgrad_workspace.
extern "C" int argus_basic_bwd_prev(const void* x, const void* g, const void* out, const void* h1,
                                    const void* w1d, const void* w2d, void* dx, void* m1, void* dw1,
                                    void* dw2, void* ws, int64_t ws_elems, int N, int H, int W, int C,
                                    void* stream) {
  return static_cast<int>(argus::basic_block_bwd_prev(x, g, out, h1, w1d, w2d, dx, m1, dw1, dw2, ws,
                                                      ws_elems, N, H, W, C,
                                                      static_cast<cudaStream_t>(stream)));
}

extern "C" int argus_proj_bwd_prev(const void* x, const void* g, const void* out, const void* h1,
                                   const void* h2, const void* w1t, const void* w2d, const void* w3t,
                                   const void* wsct, void* dx, void* m1, void* m2, void* dw1, void* dw2,
                                   void* dw3, void* dwsc, void* ws, int64_t ws_elems, int N, int H,
                                   int W, int CIN, int F, int COUT, int S, void* stream) {
  return static_cast<int>(argus::projection_block_bwd(
      x, g, out, h1, h2, w1t, w2d, w3t, wsct, dx, m1, m2, dw1, dw2, dw3, dwsc, ws, ws_elems, N, H,
      W, CIN, F, COUT, S, static_cast<cudaStream_t>(stream)));
}

extern "C" int argus_block_bwd_prev(const void* x, const void* g, const void* out, const void* h1,
                                    const void* h2, const void* w1t, const void* w2d, const void* w3t,
                                    void* dx, void* m1, void* m2, void* dw1, void* dw2, void* dw3,
                                    void* ws, int64_t ws_elems, int N, int H, int W, int CIN, int F,
                                    void* stream) {
  return static_cast<int>(argus::identity_block_bwd(x, g, out, h1, h2, w1t, w2d, w3t, dx, m1, m2,
                                                    dw1, dw2, dw3, ws, ws_elems, N, H, W, CIN, F,
                                                    static_cast<cudaStream_t>(stream)));
}

// the recompute: two forward launches of the conv-GEMM write h1/h2, then
// the identity backward above
extern "C" int argus_block_rbwd_prev(const void* x, const void* g, const void* out, const void* w1,
                                     const void* b1, const void* w2, const void* b2, const void* w1t,
                                     const void* w2d, const void* w3t, void* dx, void* h1, void* h2,
                                     void* m1, void* m2, void* dw1, void* dw2, void* dw3, void* ws,
                                     int64_t ws_elems, int N, int H, int W, int CIN, int F,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = argus::conv_gemm(argus::make_seg(x, w1, H, W, CIN, 1, 1, 0), nullptr, N, H, W, F,
                                   b1, nullptr, nullptr, h1, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = argus::conv_gemm(argus::make_seg(h1, w2, H, W, F, 3, 1, 1), nullptr, N, H, W, F, b2, nullptr,
                       nullptr, h2, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(argus::identity_block_bwd(x, g, out, h1, h2, w1t, w2d, w3t, dx, m1, m2,
                                                    dw1, dw2, dw3, ws, ws_elems, N, H, W, CIN, F,
                                                    st));
}

// The BasicBlock forward as two launches of the conv-GEMM: h1 = bf16(relu(
// conv3x3(x) + b1)), out = bf16(relu(conv3x3(h1) + b2 + f32(x))); x, h1,
// out (N, H, W, C); w1, w2 (3, 3, C, C) HWIO; b1, b2 (C,) f32.
extern "C" int argus_basic_fwd_prev(const void* x, void* h1, void* out, const void* w1, const void* b1,
                                    const void* w2, const void* b2, int N, int H, int W, int C, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = argus::conv_gemm(argus::make_seg(x, w1, H, W, C, 3, 1, 1), nullptr, N, H, W, C, b1, nullptr,
                                         nullptr, h1, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(argus::conv_gemm(argus::make_seg(h1, w2, H, W, C, 3, 1, 1), nullptr, N, H, W, C, b2,
                                           nullptr, x, out, st));
}

// The stage chain's backward as the block backwards of conv_bwd.cuh in turn
// (each applying its own relu mask as it loads the cotangent), the
// cotangent ping-ponging between gtmp0 and gtmp1; arguments as
// `argus_stage_bwd` (stage_fused_bwd.cu) takes them, the workspace sized by
// bwd_prev.wgrad_workspace.
extern "C" int argus_stage_bwd_prev(const void* x, const void* g, const void* out, const void* const* bnds,
                                    const void* const* h1s, const void* const* h2s, const void* const* proj,
                                    const void* const* ids, void* const* pdw, void* const* idw, void* dx, void* m1,
                                    void* m2, void* gtmp0, void* gtmp1, void* ws, int64_t ws_elems, int K, int N,
                                    int H, int W, int CIN, int F, int COUT, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Ho = H / S, Wo = W / S;
  const int has_proj = proj != nullptr ? 1 : 0;
  const int nblocks = has_proj + K;
  void* tmp[2] = {gtmp0, gtmp1};
  const void* gcur = g;
  int slot = 0;
  for (int j = K - 1; j >= 0; --j) {
    const int b = j + has_proj;
    const void* out_b = b == nblocks - 1 ? out : bnds[b];
    const void* x_b = b == 0 ? x : bnds[b - 1];
    void* dst = b == 0 ? dx : tmp[slot];
    const void* const* w = ids + 3 * j;
    void* const* d = idw + 3 * j;
    const cudaError_t e = argus::identity_block_bwd(x_b, gcur, out_b, h1s[b], h2s[b], w[0], w[1], w[2], dst, m1, m2,
                                                    d[0], d[1], d[2], ws, ws_elems, N, Ho, Wo, COUT, F, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    gcur = dst;
    slot ^= 1;
  }
  if (has_proj) {
    const void* out_0 = nblocks == 1 ? out : bnds[0];
    const cudaError_t e = argus::projection_block_bwd(x, gcur, out_0, h1s[0], h2s[0], proj[0], proj[1], proj[2],
                                                      proj[3], dx, m1, m2, pdw[0], pdw[1], pdw[2], pdw[3], ws,
                                                      ws_elems, N, H, W, CIN, F, COUT, S, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

// The identity bottleneck forward as three launches of the conv-GEMM
// (conv_gemm.cuh `identity_block`); arguments as `argus_block_fwd`
// (block_fused.cu) takes them.
extern "C" int argus_block_fwd_prev(const void* x, void* h1, void* h2, void* out, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* w3, const void* b3, int N, int H,
                                    int W, int CIN, int F, void* stream) {
  return static_cast<int>(argus::identity_block(x, h1, h2, out, w1, b1, w2, b2, w3, b3, N, H, W, CIN, F,
                                                static_cast<cudaStream_t>(stream)));
}

// The pointwise backward with the relu mask applied as the conv-GEMM and
// the weight gradient load g (m written by the mask pass only when it is
// emitted); arguments as `argus_pointwise_bwd` (pointwise_bwd.cu) takes
// them, m nullptr when not emitted, the workspace sized by
// bwd_prev.wgrad_workspace.
extern "C" int argus_pointwise_bwd_prev(const void* g, const void* out, const void* x, const void* wt, void* dx,
                                        void* dw, void* m, void* ws, int64_t ws_elems, int M, int CIN, int COUT,
                                        int relu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* a = g;
  const void* mask = relu ? out : nullptr;
  if (m != nullptr && relu) {
    const cudaError_t e = argus::relu_mask_sm90(g, out, m, static_cast<int64_t>(M) * COUT, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    a = m;
    mask = nullptr;
  }
  if (dx != nullptr) {
    const argus::ConvSeg s = argus::make_seg(a, wt, 1, 1, COUT, 1, 1, 0, mask);
    const cudaError_t e = argus::launch_conv_gemm(argus::gemm_args(s, nullptr, M, 1, 1, CIN, dx), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(argus::wgrad(x, 1, 1, CIN, 1, 1, 0, a, mask, COUT, M, 1, 1, dw, ws, ws_elems, st));
}

// The projection forward as three launches of the conv-GEMM (conv_gemm.cuh
// `projection_block`, the shortcut a second segment of the last); arguments
// as `argus_proj_fwd` (proj_fused.cu) takes them.
extern "C" int argus_proj_fwd_prev(const void* x, void* h1, void* h2, void* out, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* w3, const void* b3, const void* wsc,
                                   const void* bsc, int N, int H, int W, int CIN, int F, int COUT, int S,
                                   void* stream) {
  return static_cast<int>(argus::projection_block(x, h1, h2, out, w1, b1, w2, b2, w3, b3, wsc, bsc, N, H, W, CIN, F,
                                                  COUT, S, static_cast<cudaStream_t>(stream)));
}

// The chain forwards (stage_fwd.cuh) over the conv-GEMM's block forwards;
// arguments as `argus_stage_fwd` / `argus_stage_fwd_save` (stage_fused.cu)
// take them.
extern "C" int argus_stage_fwd_prev(const void* x, void* out, void* h1, void* h2, void* tmp0, void* tmp1,
                                    const void* const* proj, const void* const* ids, int K, int N, int H, int W,
                                    int CIN, int F, int COUT, int S, void* stream) {
  return static_cast<int>(argus::stage_fwd(argus::projection_block, argus::identity_block, x, out, h1, h2, tmp0, tmp1,
                                           proj, ids, K, N, H, W, CIN, F, COUT, S, static_cast<cudaStream_t>(stream)));
}

extern "C" int argus_stage_fwd_save_prev(const void* x, void* out, void* const* bnds, void* const* h1s,
                                         void* const* h2s, const void* const* proj, const void* const* ids, int K,
                                         int N, int H, int W, int CIN, int F, int COUT, int S, void* stream) {
  return static_cast<int>(argus::stage_fwd_save(argus::projection_block, argus::identity_block, x, out, bnds, h1s,
                                                h2s, proj, ids, K, N, H, W, CIN, F, COUT, S,
                                                static_cast<cudaStream_t>(stream)));
}

// The pointwise forward as one launch of the conv-GEMM over a 1x1 grid of M
// "images" (relu == 0: the gradient instantiation, the bias and residual
// without a relu); arguments as `argus_pointwise_fwd` (pointwise.cu) takes
// them.
extern "C" int argus_pointwise_fwd_prev(const void* x, const void* w, const void* b, const void* res, void* out,
                                        int M, int CIN, int COUT, int relu, void* stream) {
  const argus::ConvSeg s = argus::make_seg(x, w, 1, 1, CIN, 1, 1, 0);
  argus::ConvGemmArgs p = argus::gemm_args(s, nullptr, M, 1, 1, COUT, out);
  p.bias0 = static_cast<const float*>(b);
  p.residual = static_cast<const argus::bf16*>(res);
  p.relu = relu;
  return static_cast<int>(argus::launch_conv_gemm(p, static_cast<cudaStream_t>(stream)));
}
