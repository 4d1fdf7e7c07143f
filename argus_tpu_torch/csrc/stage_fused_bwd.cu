// Whole-stage chain backward: K identity blocks in reverse, then the optional
// projection block, from the residuals the save forward kept (every block's
// output, h1 and h2; stage_fused.cu `argus_stage_fwd_save`).
//
// Replaces: argus_tpu/ops/pallas/stage_fused.py `_chain_bwd_pallas` (:586,
// body `_make_bwd_kernel` :278), the stage-0 chain backward of the training
// step (projection at stride 1 + 2 identity blocks, F = 64). Each block's dx,
// rounded to bf16, is the next block's cotangent, as in the TPU chain
// (:319, :333), and each block's dw are its own f32 outputs.
//
// Bound on the H100: at F = 64 the 1x1 gradients (K or COUT = 64) sit near
// the bf16 ridge, so the running cotangent's and the masks' trips through
// device memory matter as much as tensor-core issue. Design: the block
// backwards of conv_bwd.cuh in turn on one stream, the cotangent ping-ponging
// between two scratch buffers, m1/m2 scratch shared by all blocks; keeping the
// cotangent on chip across the chain is the redesign item.

#include "conv_bwd.cuh"

// bnds[b]: block b's output for b < nblocks - 1 (the last is `out`); h1s/h2s
// per block; proj[4]: w1t, w2d, w3t, wsct or nullptr; ids[3*K]: w1t, w2d, w3t
// per identity block; pdw[4]: dw1, dw2, dw3, dwsc; idw[3*K]: dw1, dw2, dw3.
// m1 holds N*H*W*F elements, m2 N*Ho*Wo*F, gtmp0/gtmp1 one block output each;
// dx may be nullptr.
extern "C" int argus_stage_bwd(const void* x, const void* g, const void* out,
                               const void* const* bnds, const void* const* h1s,
                               const void* const* h2s, const void* const* proj,
                               const void* const* ids, void* const* pdw, void* const* idw,
                               void* dx, void* m1, void* m2, void* gtmp0, void* gtmp1, void* ws,
                               int64_t ws_elems, int K, int N, int H, int W, int CIN, int F,
                               int COUT, int S, void* stream) {
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
    const cudaError_t e =
        argus::identity_block_bwd(x_b, gcur, out_b, h1s[b], h2s[b], w[0], w[1], w[2], dst, m1, m2,
                                  d[0], d[1], d[2], ws, ws_elems, N, Ho, Wo, COUT, F, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    gcur = dst;
    slot ^= 1;
  }
  if (has_proj) {
    const void* out_0 = nblocks == 1 ? out : bnds[0];
    const cudaError_t e = argus::projection_block_bwd(
        x, gcur, out_0, h1s[0], h2s[0], proj[0], proj[1], proj[2], proj[3], dx, m1, m2, pdw[0],
        pdw[1], pdw[2], pdw[3], ws, ws_elems, N, H, W, CIN, F, COUT, S, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}
