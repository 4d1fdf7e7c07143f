// Whole-stage forward chain: an optional projection block, then K identity
// blocks, on folded frozen-BN weights, NHWC bf16.
//
// Replaces: argus_tpu/ops/pallas/stage_fused.py `_chain_fwd_packed` (:527,
// body `_make_fwd_kernel_packed` :501), the forward chain that eval and
// serving run for stage 0 (projection at stride 1 + 2 identity blocks), and
// `_chain_fwd_pallas(save=True)` (:364, body `_make_fwd_kernel` :235), the
// training forward that keeps every block's output, h1 and h2 for the chain
// backward (stage_fused_bwd.cu).
//
// Bound on the H100: stage 0 has F = 64, so its 1x1s (K = 64 or 256) sit near
// the bf16 ridge and device-memory traffic matters as much as tensor-core
// issue: h1/h2 and each block boundary round trip through memory at 64x64
// resolution. Design: the chain runs the block bodies of conv_gemm.cuh in
// turn on one stream (3 launches per block), ping-ponging block outputs
// between two scratch buffers. The TPU's pair-packed, block-diagonal layout
// (stage_fused.py:415-438) only existed to fill a 128-wide MXU at F = 64 and
// is not ported. Keeping the running activation on chip across the chain is
// the redesign item.

#include "conv_gemm.cuh"

// proj[8]: w1, b1, w2, b2, w3, b3, wsc, bsc, or nullptr for an identity-only
// chain; ids[6*K]: w1, b1, w2, b2, w3, b3 per identity block. h1 holds
// N*H*W*F elements, h2 and tmp0/tmp1 one block output each.
extern "C" int argus_stage_fwd(const void* x, void* out, void* h1, void* h2, void* tmp0,
                               void* tmp1, const void* const* proj, const void* const* ids, int K,
                               int N, int H, int W, int CIN, int F, int COUT, int S,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Ho = H / S, Wo = W / S;
  void* tmp[2] = {tmp0, tmp1};
  const void* cur = x;
  int slot = 0;
  if (proj != nullptr) {
    void* dst = K == 0 ? out : tmp[slot];
    const cudaError_t e =
        argus::projection_block(x, h1, h2, dst, proj[0], proj[1], proj[2], proj[3], proj[4],
                                proj[5], proj[6], proj[7], N, H, W, CIN, F, COUT, S, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    cur = dst;
    slot = 1;
  }
  for (int j = 0; j < K; ++j) {
    void* dst = (j == K - 1) ? out : tmp[slot];
    const void* const* w = ids + 6 * j;
    const cudaError_t e = argus::identity_block(cur, h1, h2, dst, w[0], w[1], w[2], w[3], w[4],
                                                w[5], N, Ho, Wo, COUT, F, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    cur = dst;
    slot ^= 1;
  }
  return static_cast<int>(cudaSuccess);
}

// The training forward: block b writes its output to bnds[b] (the last block
// to `out`) and its h1/h2 to h1s[b]/h2s[b]; no buffer is reused.
extern "C" int argus_stage_fwd_save(const void* x, void* out, void* const* bnds,
                                    void* const* h1s, void* const* h2s, const void* const* proj,
                                    const void* const* ids, int K, int N, int H, int W, int CIN,
                                    int F, int COUT, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Ho = H / S, Wo = W / S;
  const int nblocks = (proj != nullptr ? 1 : 0) + K;
  const void* cur = x;
  int b = 0;
  if (proj != nullptr) {
    void* dst = nblocks == 1 ? out : bnds[0];
    const cudaError_t e =
        argus::projection_block(x, h1s[0], h2s[0], dst, proj[0], proj[1], proj[2], proj[3],
                                proj[4], proj[5], proj[6], proj[7], N, H, W, CIN, F, COUT, S, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    cur = dst;
    b = 1;
  }
  for (int j = 0; j < K; ++j, ++b) {
    void* dst = b == nblocks - 1 ? out : bnds[b];
    const void* const* w = ids + 6 * j;
    const cudaError_t e = argus::identity_block(cur, h1s[b], h2s[b], dst, w[0], w[1], w[2], w[3],
                                                w[4], w[5], N, Ho, Wo, COUT, F, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    cur = dst;
  }
  return static_cast<int>(cudaSuccess);
}
