// The f32 block and chain kernels: argus_tpu's fused identity and projection
// bottlenecks and its stage chains at the model's default compute dtype, on
// the f32 (TF32) instantiation of the mma.sync engines: the conv-GEMM
// (conv_gemm.cuh) and the weight gradient (wgrad.cuh), composed by
// conv_gemm.cuh's block forwards, stage_fwd.cuh's chain walks and
// conv_bwd.cuh's block and chain backwards.
//
// Replaces, in f32 (argus_tpu's kernels compute in the activation's dtype,
// `.astype(x.dtype)`), argus_tpu/ops/pallas/block_fused.py
// `_block_fwd_pallas` :270, `_block_fwd_save_pallas` :314 and
// `_block_bwd_saved_pallas` :394; proj_fused.py `_proj_fwd_pallas` :205
// (both modes) and `_proj_bwd_pallas` :363; stage_fused.py
// `_chain_fwd_pallas` :364 (save=True), `_chain_fwd_packed` :527 and
// `_chain_bwd_pallas` :586. The formulas and the order of the launches are
// the bf16 kernels' (block_fused.cu, proj_fused.cu, stage_fused.cu and the
// backwards): f32 in, f32 out, f32 h1/h2 saved, f32 masks and weight
// gradients; every product on the TF32 tensor cores (each operand rounded
// to TF32 as it is read, cvt.rna), every sum in f32, no operand rounded to
// bf16. cuDNN's f32 convs under PyTorch's default `cudnn.allow_tf32` round
// the same way.
//
// Why the mma.sync engines and not the Hopper ones: wgmma's TF32 form takes
// both operands K-major only (no transpose bit). The TMA forward engine's
// weights are (taps, C, COUT), COUT innermost, and the weight gradient
// reduces over pixels, along which NHWC activations are not K-major.
// mma.sync m16n8k8's fragments are read by plain 32-bit loads in any layout,
// so one engine serves the forward, the data gradient and the weight
// gradient. Bound: the TF32 tensor cores (495 TFLOP/s dense on an H100 SXM)
// at the 3x3s and the wide 1x1s, HBM at the stage-0 1x1s; this simple form
// reaches a fraction of the TF32 peak (PERF.md).
//
// Launchers take the bf16 launchers' arguments (the forwards') or
// bwd_prev.cu's (the backwards': no m3 scratch); ops/kernels/wgrad_plan.py
// sizes the weight gradients' workspace (`mma_workspace`).

#include "conv_bwd.cuh"
#include "stage_fwd.cuh"

// x, out (N, H, W, CIN); h1, h2 (N, H, W, F); w1 (CIN, F), w2 (3, 3, F, F),
// w3 (F, CIN) f32; b1, b2 (F,), b3 (CIN,) f32.
extern "C" int argus_block_fwd_f32(const void* x, void* h1, void* h2, void* out, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* w3, const void* b3, int N, int H, int W,
                                   int CIN, int F, void* stream) {
  return static_cast<int>(argus::identity_block<float>(x, h1, h2, out, w1, b1, w2, b2, w3, b3, N, H, W, CIN, F,
                                                       static_cast<cudaStream_t>(stream)));
}

// the projection forward: conv1, the 3x3 at stride S, conv3 and the shortcut
// as one launch with two K segments; arguments as `argus_proj_fwd`
extern "C" int argus_proj_fwd_f32(const void* x, void* h1, void* h2, void* out, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* w3, const void* b3, const void* wsc,
                                  const void* bsc, int N, int H, int W, int CIN, int F, int COUT, int S,
                                  void* stream) {
  return static_cast<int>(argus::projection_block<float>(x, h1, h2, out, w1, b1, w2, b2, w3, b3, wsc, bsc, N, H, W,
                                                         CIN, F, COUT, S, static_cast<cudaStream_t>(stream)));
}

// the chain forwards; arguments as `argus_stage_fwd` / `argus_stage_fwd_save`
extern "C" int argus_stage_fwd_f32(const void* x, void* out, void* h1, void* h2, void* tmp0, void* tmp1,
                                   const void* const* proj, const void* const* ids, int K, int N, int H, int W,
                                   int CIN, int F, int COUT, int S, void* stream) {
  return static_cast<int>(argus::stage_fwd(argus::projection_block<float>, argus::identity_block<float>, x, out, h1,
                                           h2, tmp0, tmp1, proj, ids, K, N, H, W, CIN, F, COUT, S,
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" int argus_stage_fwd_save_f32(const void* x, void* out, void* const* bnds, void* const* h1s,
                                        void* const* h2s, const void* const* proj, const void* const* ids, int K,
                                        int N, int H, int W, int CIN, int F, int COUT, int S, void* stream) {
  return static_cast<int>(argus::stage_fwd_save(argus::projection_block<float>, argus::identity_block<float>, x,
                                                out, bnds, h1s, h2s, proj, ids, K, N, H, W, CIN, F, COUT, S,
                                                static_cast<cudaStream_t>(stream)));
}

// the identity backward from saved h1/h2: w1t = w1^T, w2d the 3x3's
// stride-1 data-gradient taps (9, F, F), w3t = w3^T; dx nullptr skips its
// launch; dw1-3 f32
extern "C" int argus_block_bwd_f32(const void* x, const void* g, const void* out, const void* h1, const void* h2,
                                   const void* w1t, const void* w2d, const void* w3t, void* dx, void* m1, void* m2,
                                   void* dw1, void* dw2, void* dw3, void* ws, int64_t ws_elems, int N, int H, int W,
                                   int CIN, int F, void* stream) {
  return static_cast<int>(argus::identity_block_bwd<float>(x, g, out, h1, h2, w1t, w2d, w3t, dx, m1, m2, dw1, dw2,
                                                           dw3, ws, ws_elems, N, H, W, CIN, F,
                                                           static_cast<cudaStream_t>(stream)));
}

// the projection backward: w2d the 3x3's taps for the stride (`dgrad_w2`),
// wsct = wsc^T
extern "C" int argus_proj_bwd_f32(const void* x, const void* g, const void* out, const void* h1, const void* h2,
                                  const void* w1t, const void* w2d, const void* w3t, const void* wsct, void* dx,
                                  void* m1, void* m2, void* dw1, void* dw2, void* dw3, void* dwsc, void* ws,
                                  int64_t ws_elems, int N, int H, int W, int CIN, int F, int COUT, int S,
                                  void* stream) {
  return static_cast<int>(argus::projection_block_bwd<float>(x, g, out, h1, h2, w1t, w2d, w3t, wsct, dx, m1, m2, dw1,
                                                             dw2, dw3, dwsc, ws, ws_elems, N, H, W, CIN, F, COUT, S,
                                                             static_cast<cudaStream_t>(stream)));
}

// the chain backward; arguments as `argus_stage_bwd`
extern "C" int argus_stage_bwd_f32(const void* x, const void* g, const void* out, const void* const* bnds,
                                   const void* const* h1s, const void* const* h2s, const void* const* proj,
                                   const void* const* ids, void* const* pdw, void* const* idw, void* dx, void* m1,
                                   void* m2, void* gtmp0, void* gtmp1, void* ws, int64_t ws_elems, int K, int N,
                                   int H, int W, int CIN, int F, int COUT, int S, void* stream) {
  return static_cast<int>(argus::stage_chain_bwd<float>(x, g, out, bnds, h1s, h2s, proj, ids, pdw, idw, dx, m1, m2,
                                                        gtmp0, gtmp1, ws, ws_elems, K, N, H, W, CIN, F, COUT, S,
                                                        static_cast<cudaStream_t>(stream)));
}
