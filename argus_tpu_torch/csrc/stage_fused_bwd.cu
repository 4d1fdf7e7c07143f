// Whole-stage chain backward: K identity blocks in reverse, then the optional
// projection block, from the residuals the save forward kept (every block's
// output, h1 and h2; stage_fused.cu `argus_stage_fwd_save`).
//
// Replaces: argus_tpu/ops/pallas/stage_fused.py `_chain_bwd_pallas` (:586,
// body `_make_bwd_kernel` :278), the stage-0 chain backward of the training
// step (projection at stride 1 + 2 identity blocks, F = 64). Each block's dx,
// rounded to bf16, is the next block's cotangent, as in the TPU chain
// (:319, :333), which the next block masks by its own input's relu
// (`_id_bwd_core` :90, `_proj_bwd_core` :158); each block's dw are its own
// f32 outputs.
//
// Bound on the H100: at F = 64 the 1x1 gradients (K or COUT = 64) sit near
// the bf16 ridge, so the running cotangent's and the masks' trips through
// device memory matter as much as tensor-core issue. Design: the Hopper
// compositions (identity_bwd_sm90.cuh, proj_bwd_sm90.cuh) in turn on one
// stream, each from its masked cotangent m3:
// - the incoming g is masked once, by the first block in backward order
//   (`relu_mask_sm90`);
// - every other block's m3 is written by the dx launch of the block after
//   it, whose epilogue applies the mask of its own input (the block
//   before's output): bf16(m1 @ w1^T + m3) * (bnd > 0), the TPU chain's
//   rounding followed by the next block's mask, bit for bit (a 0/1 mask
//   after a rounding is exact). That removes a mask pass per boundary (one
//   read of g and bnd and one write of m3) for one read of bnd in a dx
//   epilogue;
// - the chain's own dx, the stage input's gradient, is written unmasked;
// - m3 ping-pongs between two scratch buffers, m1/m2 scratch is shared by
//   all blocks, and one workspace holds the weight gradients' partials
//   (sized over every block's plans, ops/kernels/stage_fused.py
//   `chain_wgrad_plans`).
// The previous form, the mma.sync compositions of conv_bwd.cuh, is
// `argus_stage_bwd_prev` in bwd_prev.cu.

#include "identity_bwd_sm90.cuh"
#include "proj_bwd_sm90.cuh"

// bnds[b]: block b's output for b < nblocks - 1 (the last is `out`); h1s/h2s
// per block; proj[4]: w1t, w2d, w3t, wsct or nullptr (ops/kernels
// proj_fused.transposed_weights); ids[3*K]: w1t, w2d, w3t per identity
// block (block_fused.transposed_weights); pdw[4]: dw1, dw2, dw3, dwsc;
// idw[3*K]: dw1, dw2, dw3. m1 holds N*H*W*F elements, m2 N*Ho*Wo*F,
// gtmp0/gtmp1 one block output each (the m3s); dx may be nullptr; ws holds
// ws_elems f32.
extern "C" int argus_stage_bwd(const void* x, const void* g, const void* out, const void* const* bnds,
                               const void* const* h1s, const void* const* h2s, const void* const* proj,
                               const void* const* ids, void* const* pdw, void* const* idw, void* dx, void* m1,
                               void* m2, void* gtmp0, void* gtmp1, void* ws, int64_t ws_elems, int K, int N, int H,
                               int W, int CIN, int F, int COUT, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Ho = H / S, Wo = W / S;
  const int has_proj = proj != nullptr ? 1 : 0;
  const int nblocks = has_proj + K;
  const int64_t elems = static_cast<int64_t>(N) * Ho * Wo * COUT;
  void* tmp[2] = {gtmp0, gtmp1};
  // the last block's m3 = g * (out > 0)
  cudaError_t e = argus::relu_mask_sm90(g, out, tmp[0], elems, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int slot = 0;  // tmp[slot] holds the current block's m3
  for (int j = K - 1; j >= 0; --j) {
    const int b = j + has_proj;
    const void* x_b = b == 0 ? x : bnds[b - 1];
    // dx of block b: the chain's dx (unmasked), or block b-1's m3
    void* dst = b == 0 ? dx : tmp[slot ^ 1];
    const void* const* w = ids + 3 * j;
    void* const* d = idw + 3 * j;
    // its dx launch masks by block b-1's output (that block's m3)
    const void* dmask = b > 0 ? bnds[b - 1] : nullptr;
    e = argus::identity_block_bwd_m3_sm90(x_b, tmp[slot], h1s[b], h2s[b], w[0], w[1], w[2], dst, dmask, m1, m2,
                                          d[0], d[1], d[2], ws, ws_elems, N, Ho, Wo, COUT, F, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    slot ^= 1;
  }
  if (has_proj) {
    e = argus::projection_block_bwd_m3_sm90(x, tmp[slot], h1s[0], h2s[0], proj[0], proj[1], proj[2], proj[3], dx,
                                            nullptr, m1, m2, pdw[0], pdw[1], pdw[2], pdw[3], ws, ws_elems, N, H, W,
                                            CIN, F, COUT, S, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}
