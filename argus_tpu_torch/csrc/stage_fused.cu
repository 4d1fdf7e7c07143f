// Whole-stage forward chain: an optional projection block, then K identity
// blocks, on folded frozen-BN weights, NHWC bf16.
//
// Replaces: argus_tpu/ops/pallas/stage_fused.py `_chain_fwd_packed` (:527,
// body `_make_fwd_kernel_packed` :501), the forward chain that eval and
// serving run for stage 0 (projection at stride 1 + 2 identity blocks),
// `_chain_fwd_pallas(save=False)` (:364, body `_make_fwd_kernel` :235), the
// whole-stage chains of frozen stages 1-2 (projection at stride 2 + 3 or 5
// identity blocks), and `_chain_fwd_pallas(save=True)`, the training
// forward that keeps every block's output, h1 and h2 for the chain backward
// (stage_fused_bwd.cu).
//
// Bound on the H100: stage 0 has F = 64, so its 1x1s (K = 64 or 256) sit near
// the bf16 ridge and device-memory traffic matters as much as tensor-core
// issue: h1/h2 and each block boundary round trip through memory at 64x64
// resolution (~4.3 GB a block at N = 512); the frozen stages' chains are
// tensor-core bound (the 3x3s and the 1x1s at K >= 512). Design: the chain
// (stage_fwd.cuh) runs the block forwards of bottleneck_fwd_sm90.cuh in turn
// on one stream, three launches of the TMA forward engine per block (the
// projection's conv3 and shortcut one launch with two K segments),
// ping-ponging block outputs between two scratch buffers. The TPU's
// pair-packed, block-diagonal layout (stage_fused.py:415-438) only existed to
// fill a 128-wide MXU at F = 64 and is not ported. Keeping the running
// activation on chip across the chain is later work. The previous form, the
// same chain over the mma.sync conv-GEMM (conv_gemm.cuh), is
// `argus_stage_fwd_prev` / `argus_stage_fwd_save_prev` in bwd_prev.cu.

#include "bottleneck_fwd_sm90.cuh"
#include "stage_fwd.cuh"

// proj[8]: w1, b1, w2, b2, w3, b3, wsc, bsc, or nullptr for an identity-only
// chain; ids[6*K]: w1, b1, w2, b2, w3, b3 per identity block. h1 holds
// N*H*W*F elements, h2 and tmp0/tmp1 one block output each.
extern "C" int argus_stage_fwd(const void* x, void* out, void* h1, void* h2, void* tmp0, void* tmp1,
                               const void* const* proj, const void* const* ids, int K, int N, int H, int W, int CIN,
                               int F, int COUT, int S, void* stream) {
  return static_cast<int>(argus::stage_fwd(argus::projection_block_fwd_sm90, argus::identity_block_fwd_sm90, x, out,
                                           h1, h2, tmp0, tmp1, proj, ids, K, N, H, W, CIN, F, COUT, S,
                                           static_cast<cudaStream_t>(stream)));
}

// The training forward: block b writes its output to bnds[b] (the last block
// to `out`) and its h1/h2 to h1s[b]/h2s[b]; no buffer is reused.
extern "C" int argus_stage_fwd_save(const void* x, void* out, void* const* bnds, void* const* h1s, void* const* h2s,
                                    const void* const* proj, const void* const* ids, int K, int N, int H, int W,
                                    int CIN, int F, int COUT, int S, void* stream) {
  return static_cast<int>(argus::stage_fwd_save(argus::projection_block_fwd_sm90, argus::identity_block_fwd_sm90, x,
                                                out, bnds, h1s, h2s, proj, ids, K, N, H, W, CIN, F, COUT, S,
                                                static_cast<cudaStream_t>(stream)));
}
