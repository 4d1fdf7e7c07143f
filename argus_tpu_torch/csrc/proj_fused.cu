// Projection (stage-entry) bottleneck block forward on folded frozen-BN
// weights, NHWC bf16, stride S in {1, 2} on the 3x3 (torchvision v1.5).
//
// Replaces: argus_tpu/ops/pallas/proj_fused.py `_proj_fwd_pallas(save=False)`
// (:205, body `_proj_fwd_kernel` :171), the stage 1-3 entry blocks of eval and
// serving, and `_proj_fwd_pallas(save=True)` (body `_proj_fwd_save_kernel`
// :180), the training forward that also emits h1 and h2 for the one-pass
// backward (proj_fused_bwd.cu): the same launches, the caller keeping the
// buffers.
//
//   h1  = bf16(relu(x @ w1 + b1))                          1x1, CIN -> F
//   h2  = bf16(relu(conv3x3_s(h1) + b2))                   stride S, pad 1
//   out = bf16(relu(h2 @ w3 + x[::S, ::S] @ wsc + b3 + bsc))
//
// Bound on the H100: tensor-core issue (206 GFLOP a block at N = 512, the
// last GEMM with K = F + CIN, up to 1536 at stage 3); h1 at full input
// resolution is the largest device-memory round trip of the block. Design:
// three launches of the TMA forward engine (bottleneck_fwd_sm90.cuh
// `projection_block_fwd_sm90`): conv1 in its 1x1 mode at the input's
// resolution; the 3x3 at stride S, its A boxes taken through a tensor map
// that traverses h1 at stride S (so the box lands the output tile's pixels,
// and TMA's zero fill is the padding); conv3 and the shortcut as one launch
// with two K segments, h2 @ w3 then x through a stride-S map @ wsc, in one
// f32 accumulator, so no subsampled copy of x and no concatenated weights,
// b3 then bsc in the epilogue. The lane-merged stride-2 views of the TPU
// kernel (_LANE_MERGE_MAX) exist for Mosaic and are not ported. The previous
// form, three launches of the mma.sync conv-GEMM (conv_gemm.cuh
// `projection_block`), is `argus_proj_fwd_prev` in bwd_prev.cu.

#include "bottleneck_fwd_sm90.cuh"

extern "C" int argus_proj_fwd(const void* x, void* h1, void* h2, void* out, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* w3, const void* b3, const void* wsc,
                              const void* bsc, int N, int H, int W, int CIN, int F, int COUT, int S, void* stream) {
  return static_cast<int>(argus::projection_block_fwd_sm90(x, h1, h2, out, w1, b1, w2, b2, w3, b3, wsc, bsc, N, H, W,
                                                           CIN, F, COUT, S, static_cast<cudaStream_t>(stream)));
}
