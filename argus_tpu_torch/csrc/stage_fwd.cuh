// The whole-stage forward chains (an optional projection block, then K
// identity blocks, NHWC bf16) over the block forwards they are given:
// stage_fused.cu runs them on the TMA forward engine's compositions
// (bottleneck_fwd_sm90.cuh), bwd_prev.cu on the mma.sync conv-GEMM's
// (conv_gemm.cuh), for timing. A block forward takes (x, h1, h2, out, its
// weights and biases, N, H, W, CIN, F[, COUT, S], stream), as both headers
// define them.

#pragma once

#include "common.cuh"

namespace argus {

// The no-save chain: proj[8] (w1, b1, w2, b2, w3, b3, wsc, bsc) or nullptr
// for an identity-only chain; ids[6*K] (w1, b1, w2, b2, w3, b3) per identity
// block. h1 holds N*H*W*F elements, h2 and tmp0/tmp1 one block output each:
// block outputs ping-pong between tmp0 and tmp1, the last lands in out.
template <class ProjFwd, class IdFwd>
inline cudaError_t stage_fwd(ProjFwd proj_fwd, IdFwd id_fwd, const void* x, void* out, void* h1, void* h2, void* tmp0,
                             void* tmp1, const void* const* proj, const void* const* ids, int K, int N, int H, int W,
                             int CIN, int F, int COUT, int S, cudaStream_t st) {
  const int Ho = H / S, Wo = W / S;
  void* tmp[2] = {tmp0, tmp1};
  const void* cur = x;
  int slot = 0;
  if (proj != nullptr) {
    void* dst = K == 0 ? out : tmp[slot];
    const cudaError_t e = proj_fwd(x, h1, h2, dst, proj[0], proj[1], proj[2], proj[3], proj[4], proj[5], proj[6],
                                   proj[7], N, H, W, CIN, F, COUT, S, st);
    if (e != cudaSuccess) return e;
    cur = dst;
    slot = 1;
  }
  for (int j = 0; j < K; ++j) {
    void* dst = (j == K - 1) ? out : tmp[slot];
    const void* const* w = ids + 6 * j;
    const cudaError_t e = id_fwd(cur, h1, h2, dst, w[0], w[1], w[2], w[3], w[4], w[5], N, Ho, Wo, COUT, F, st);
    if (e != cudaSuccess) return e;
    cur = dst;
    slot ^= 1;
  }
  return cudaSuccess;
}

// The training chain: block b writes its output to bnds[b] (the last block
// to `out`) and its h1/h2 to h1s[b]/h2s[b]; no buffer is reused.
template <class ProjFwd, class IdFwd>
inline cudaError_t stage_fwd_save(ProjFwd proj_fwd, IdFwd id_fwd, const void* x, void* out, void* const* bnds,
                                  void* const* h1s, void* const* h2s, const void* const* proj, const void* const* ids,
                                  int K, int N, int H, int W, int CIN, int F, int COUT, int S, cudaStream_t st) {
  const int Ho = H / S, Wo = W / S;
  const int nblocks = (proj != nullptr ? 1 : 0) + K;
  const void* cur = x;
  int b = 0;
  if (proj != nullptr) {
    void* dst = nblocks == 1 ? out : bnds[0];
    const cudaError_t e = proj_fwd(x, h1s[0], h2s[0], dst, proj[0], proj[1], proj[2], proj[3], proj[4], proj[5],
                                   proj[6], proj[7], N, H, W, CIN, F, COUT, S, st);
    if (e != cudaSuccess) return e;
    cur = dst;
    b = 1;
  }
  for (int j = 0; j < K; ++j, ++b) {
    void* dst = b == nblocks - 1 ? out : bnds[b];
    const void* const* w = ids + 6 * j;
    const cudaError_t e =
        id_fwd(cur, h1s[b], h2s[b], dst, w[0], w[1], w[2], w[3], w[4], w[5], N, Ho, Wo, COUT, F, st);
    if (e != cudaSuccess) return e;
    cur = dst;
  }
  return cudaSuccess;
}

}  // namespace argus
