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
// Bound on the H100: like the forward, 2 * 2*M*CIN*COUT FLOPs on g, out,
// x2 and dx (plus m) once each; device memory bounds the narrow stage-0
// and stage-1 cases. The TPU kernel carries dw in a VMEM accumulator across
// its sequential grid; Hopper has no such carry, so dw is the split-M
// reduction of wgrad.cuh (each block a contiguous range of rows, a second
// pass adding the partials in order: deterministic). Design: the relu mask
// is applied to g as the GEMMs load it (conv_gemm.cuh's masked A, wgrad.cuh's
// masked B), so m never goes to device memory unless it is asked for; then
// one vectorised pass writes it and both GEMMs read it unmasked.

#include "conv_gemm.cuh"
#include "wgrad.cuh"

namespace {

// m = g * (out > 0), 8 bf16 a thread (n8 vectors of 16 bytes)
__global__ void relu_mask_kernel(const uint4* __restrict__ g, const uint4* __restrict__ out,
                                 uint4* __restrict__ m, int64_t n8) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint4 gv = g[i];
    const uint4 ov = out[i];
    argus::bf16* gp = reinterpret_cast<argus::bf16*>(&gv);
    const argus::bf16* op = reinterpret_cast<const argus::bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (!argus::positive(op[e])) gp[e] = __float2bfloat16(0.f);
    m[i] = gv;
  }
}

}  // namespace

// g, out (M, COUT); x (M, CIN); wt = w_eff^T (COUT, CIN); dx (M, CIN) or
// nullptr (not needed); dw (CIN, COUT) f32; m (M, COUT) or nullptr (not
// emitted; with relu == 0 the caller takes g itself); ws holds ws_elems f32
// for dw's partials.
extern "C" int argus_pointwise_bwd(const void* g, const void* out, const void* x, const void* wt,
                                   void* dx, void* dw, void* m, void* ws, int64_t ws_elems, int M,
                                   int CIN, int COUT, int relu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* a = g;
  const void* mask = relu ? out : nullptr;
  if (m != nullptr && relu) {
    const int64_t n8 = static_cast<int64_t>(M) * COUT / 8;
    const int blocks = static_cast<int>(std::min<int64_t>((n8 + 255) / 256, 8 * 132));
    relu_mask_kernel<<<blocks, 256, 0, st>>>(static_cast<const uint4*>(g),
                                             static_cast<const uint4*>(out), static_cast<uint4*>(m),
                                             n8);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    a = m;
    mask = nullptr;
  }
  if (dx != nullptr) {
    const argus::ConvSeg s = argus::make_seg(a, wt, 1, 1, COUT, 1, 1, 0, mask);
    const cudaError_t e =
        argus::launch_conv_gemm(argus::gemm_args(s, nullptr, M, 1, 1, CIN, dx), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(
      argus::wgrad(x, 1, 1, CIN, 1, 1, 0, a, mask, COUT, M, 1, 1, dw, ws, ws_elems, st));
}
