// Identity BasicBlock (ResNet-18/34) backward from the saved h1, on folded
// frozen-BN weights, NHWC bf16.
//
// Replaces: argus_tpu/ops/pallas/basic_fused.py `_bwd_pallas` (:167, body
// `_bwd_kernel` :110), the one-pass backward of every stride-1 identity
// BasicBlock in the keypoint family's training step:
//
//   m2  = g * (out > 0)                      (applied as g is loaded)
//   m1  = bf16(conv3x3^T(m2)) * (h1 > 0)     dw2[ky, kx] = shift(h1)^T m2
//   dx  = bf16(f32(conv3x3^T(m1)) + f32(m2)) dw1[ky, kx] = shift(x)^T m1
//
// with the TPU kernel's rounding points (`_bwd_kernel` :126, :143, :159):
// every sum in f32, m1 rounded to bf16 before its mask, dx rounded once; the
// dw are f32.
//
// Bound on the H100: four GEMMs of the forward conv's size (two data and
// two weight gradients), 6.2e11 FLOP at N = 512 and 256x256 frames, 0.63 ms
// of bf16 tensor-core issue; the bytes (x, g, out, h1 read, dx written) take
// 0.40 ms at stage 0. The TPU kernel carries dw1/dw2 in VMEM across its
// sequential grid, which Hopper cannot: each dw is a split reduction over
// all pixels with a fixed-order second pass over the partials
// (deterministic). Design: the wgmma/TMA engines (conv_dgrad_sm90.cuh,
// wgrad_sm90.cuh). Five launches and up to two split sums:
//   0. m2 = g * (out > 0), written once (`relu_mask_sm90`);
//   1. m1 from m2 as the 3x3's transposed taps (a forward conv,
//      w2d[ky, kx] = w2[2-ky, 2-kx]^T), masked by h1 in the epilogue;
//   2. dw2 from h1 and m2, three taps per staged m2 tile;
//   3. dx = bf16(conv3x3^T(m1) + m2), m2 as the residual;
//   4. dw1 from x and m1.
// m1 and m2 go through device memory (0.27 GB each at stage 0, written once
// and read back); one launch per block with m1 on chip is later work.

#include "conv_dgrad_sm90.cuh"
#include "wgrad_sm90.cuh"

namespace argus {

#define ARGUS_TRY(call)               \
  do {                                \
    const cudaError_t e_ = (call);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// x, g, out, h1, m1, m2, dx (N, H, W, C); w1d, w2d (9, C, C); dw1, dw2 (3, 3, C, C) f32.
inline cudaError_t basic_block_bwd_sm90(const void* x, const void* g, const void* out, const void* h1,
                                        const void* w1d, const void* w2d, void* dx, void* m1, void* m2,
                                        void* dw1, void* dw2, void* ws, int64_t ws_elems, int N, int H, int W,
                                        int C, cudaStream_t st) {
  // m2 = g * (out > 0), once; m1 = bf16(conv3x3^T(m2)) * (h1 > 0)
  ARGUS_TRY(relu_mask_sm90(g, out, m2, static_cast<int64_t>(N) * H * W * C, st));
  DgradArgs p = dgrad_args(dgrad_seg(m2, H, W, C, 3, 1, 1), nullptr, N, H, W, C, m1);
  p.emask = static_cast<const bf16*>(h1);
  ARGUS_TRY(launch_dgrad(p, w2d, nullptr, st));
  // dw2[ky, kx] = shift(h1)^T m2
  ARGUS_TRY(wgrad_sm90(h1, H, W, C, 3, 1, 1, m2, C, N, H, W, dw2, ws, ws_elems, st));
  // dx = bf16(conv3x3^T(m1) + m2)
  if (dx != nullptr) {
    p = dgrad_args(dgrad_seg(m1, H, W, C, 3, 1, 1), nullptr, N, H, W, C, dx);
    p.residual = static_cast<const bf16*>(m2);
    ARGUS_TRY(launch_dgrad(p, w1d, nullptr, st));
  }
  // dw1[ky, kx] = shift(x)^T m1
  return wgrad_sm90(x, H, W, C, 3, 1, 1, m1, C, N, H, W, dw1, ws, ws_elems, st);
}

}  // namespace argus

// dx may be nullptr; m1, m2 are scratch (N, H, W, C); ws holds ws_elems f32
// for the weight-gradient partials (ops/kernels/wgrad_plan.py).
extern "C" int argus_basic_bwd(const void* x, const void* g, const void* out, const void* h1, const void* w1d,
                               const void* w2d, void* dx, void* m1, void* m2, void* dw1, void* dw2, void* ws,
                               int64_t ws_elems, int N, int H, int W, int C, void* stream) {
  return static_cast<int>(argus::basic_block_bwd_sm90(x, g, out, h1, w1d, w2d, dx, m1, m2, dw1, dw2, ws, ws_elems,
                                                      N, H, W, C, static_cast<cudaStream_t>(stream)));
}
