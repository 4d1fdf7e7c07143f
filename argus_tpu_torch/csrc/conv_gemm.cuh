// Implicit-GEMM convolution over NHWC bf16 with a fused bias/residual/relu
// epilogue: the mma.sync tensor-core kernel behind the previous forms that
// bwd_prev.cu keeps for timing (conv_bwd.cuh's block and chain backwards,
// the BasicBlock, identity bottleneck and projection forwards through
// `identity_block` and `projection_block` below, the chain forwards, the
// pointwise backward and forward). No main path launches it: every block
// backward, the chain backward, every block and chain forward and the
// pointwise forward and backward run on the Hopper engines
// (conv_dgrad_sm90.cuh, conv_fwd_sm90.cuh, wgrad_sm90.cuh).
//
//   out[m, n] = bf16(relu(sum_k A[m, k] * B[k, n] (+ bias0[n]) (+ bias1[n])
//                         (+ residual[m, n] * (rmask[m, n] > 0))))
//               * (emask[m, n] > 0)
//
// with relu, every bias, the residual and both masks optional. The masks
// carry the backward's relu masks: a segment's A may be multiplied by
// (mask > 0) of a tensor shaped like its source as it is loaded
// (m3 = g * (out > 0)), the epilogue may zero the rounded result where
// another tensor is not positive (m2 = bf16(dh2) * (h2 > 0)), and the
// residual may be masked (dx = bf16(m1 @ w1^T + g * (out > 0))).
//
// M runs over the pixels of a grid (N*Ho*Wo), n over output channels, and k
// over one or two "segments": segment s reads source s at tap (ky, kx) of
// its (kh, kw) kernel and channel c, at source pixel (oh*stride - pad_h + ky,
// ow*stride - pad_w + kx), and multiplies weight rows of its own
// (kh*kw*C, COUT) matrix, so a 1x1, a 3x3/pad-1 at stride 1 or 2 and the
// strided 1x1 shortcut are all the same loop. The projection block's last
// step is ONE GEMM over K = F + CIN, with h2 @ w3 and x[::s, ::s] @ wsc
// sharing one f32 accumulator. Grid pixel (oh, ow) is written to output pixel
// (oh*ostride + oy, ow*ostride + ox) of an (N, OH, OW) output (the identity
// map unless set), so a data gradient at stride 2 runs as one launch per
// output parity class, each reading only the taps that land on it.
//
// Bound on the H100: at ResNet-50 serving shapes the 3x3s and the stage 1-3
// 1x1s are above the bf16 ridge (~295 FLOP per byte), so tensor-core issue
// bounds them; the stage-0 1x1s (K or COUT = 64) sit near the ridge. This
// simple form reaches about a tenth of the bf16 peak (PERF.md): mma.sync
// instead of wgmma, and 128x64 tiles re-read each A tile once per 64 output
// channels. Design:
// 128x64x32 block tiles, four warps of 64x32, mma.sync m16n8k16 (bf16 in, f32
// accumulate), A and B tiles fed by a 3-stage cp.async ring whose zero-fill
// form is also the conv's zero padding, ldmatrix from padded (bank-conflict
// free) shared rows. Each thread gathers one A row and walks k in 8-channel
// vectors with an incremental (segment, ky, kx, c) decoder: no divisions in
// the main loop. The wgmma/TMA forms are conv_dgrad_sm90.cuh (data
// gradient) and conv_fwd_sm90.cuh (forwards at stride 1 and 2, with the
// projection's shortcut as a second K segment); moving the pointwise
// forward onto them, and keeping h1/h2 on chip, are later work.

#pragma once

#include "common.cuh"

namespace argus {

struct ConvSeg {
  const bf16* src;   // NHWC source
  const bf16* w;     // (kh*kw*C, COUT) row-major weights of this segment (HWIO flattened)
  const bf16* mask;  // nullptr, or shaped like src: A = src * (mask > 0)
  int H, W, C;       // source dims; C % 8 == 0
  int kh, kw;        // kernel size (1, 2 or 3 each)
  int stride, pad_h, pad_w;  // source pixel oh*stride - pad_h + ky (a negative pad offsets)
};

struct ConvGemmArgs {
  ConvSeg seg0, seg1;
  int nseg;              // 1 or 2
  int N, Ho, Wo;         // the grid; M = N * Ho * Wo
  int OH, OW;            // output dims; grid pixel (oh, ow) -> (oh*ostride + oy, ow*ostride + ox)
  int ostride, oy, ox;
  int K0, K;             // rows of segment 0, rows in all
  int COUT;              // % 8 == 0
  const float* bias0;    // (COUT,) or nullptr
  const float* bias1;    // (COUT,) or nullptr
  const bf16* residual;  // (N, OH, OW, COUT) or nullptr, read at the output pixel
  const bf16* rmask;     // like residual, or nullptr: the residual counts where rmask > 0
  const bf16* emask;     // like residual, or nullptr: the output is zero where emask <= 0
  int relu;              // 1: a forward (relu, no masks, identity map); 0: a gradient (no relu)
  bf16* out;             // (N, OH, OW, COUT)
};

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kLdA = kBK + 8;  // padded shared row (80 bytes): ldmatrix rows hit distinct banks
constexpr int kLdB = kBN + 8;  // 144 bytes

// Walks one output pixel's k axis in 8-channel vectors: (segment, ky, kx, c).
struct RowGather {
  int n, oh, ow;
  bool valid;
  int seg, ky, kx, c;

  // Element offset of the current vector in its segment's source, or -1
  // where the tap falls in the zero padding or the row is past M.
  __device__ __forceinline__ int64_t offset(const ConvGemmArgs& p) const {
    if (!valid || seg >= p.nseg) return -1;
    const ConvSeg& s = seg == 0 ? p.seg0 : p.seg1;
    const int ih = oh * s.stride - s.pad_h + ky;
    const int iw = ow * s.stride - s.pad_w + kx;
    if (ih < 0 || ih >= s.H || iw < 0 || iw >= s.W) return -1;
    return ((static_cast<int64_t>(n) * s.H + ih) * s.W + iw) * s.C + c;
  }

  __device__ __forceinline__ void advance(const ConvGemmArgs& p) {
    if (seg >= p.nseg) return;
    const ConvSeg& s = seg == 0 ? p.seg0 : p.seg1;
    c += 8;
    if (c < s.C) return;
    c = 0;
    if (++kx < s.kw) return;
    kx = 0;
    if (++ky < s.kh) return;
    ky = 0;
    ++seg;
  }
};

// > 0 on bf16, the relu mask of the backward
__device__ __forceinline__ bool positive(bf16 v) { return __bfloat162float(v) > 0.f; }

// The output pixel of grid row m (the identity unless a parity class is set).
__device__ __forceinline__ int64_t out_pixel(const ConvGemmArgs& p, int m) {
  if (p.ostride == 1 && p.oy == 0 && p.ox == 0 && p.OH == p.Ho && p.OW == p.Wo) return m;
  const int ow = m % p.Wo;
  const int t = m / p.Wo;
  const int oh = t % p.Ho;
  const int n = t / p.Ho;
  return (static_cast<int64_t>(n) * p.OH + oh * p.ostride + p.oy) * p.OW + ow * p.ostride + p.ox;
}

// The A-operand masks' tiles, in dynamic shared memory, present only when a
// segment has a mask (kMaskSmem bytes, above the static 44.5 KB).
constexpr int kMaskSmem = kStages * kBM * kLdA * static_cast<int>(sizeof(bf16));

// kGrad = false: the forward instantiation (bias, residual, relu, the
// identity output map), free of the gradient's mask and remap code; true: the
// data-gradient instantiation (masks, output remap, no relu).
template <bool kGrad>
__global__ void __launch_bounds__(kThreads) conv_gemm_kernel(const __grid_constant__ ConvGemmArgs p) {
  __shared__ __align__(128) bf16 sA[kStages][kBM][kLdA];
  __shared__ __align__(128) bf16 sB[kStages][kBK][kLdB];
  extern __shared__ __align__(128) bf16 sM_dyn[];
  bf16(*sM)[kBM][kLdA] = reinterpret_cast<bf16(*)[kBM][kLdA]>(sM_dyn);
  const bool masked = kGrad && (p.seg0.mask != nullptr || (p.nseg > 1 && p.seg1.mask != nullptr));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // warp row: 64 output pixels
  const int wn = warp & 1;   // warp col: 32 output channels
  const int M = p.N * p.Ho * p.Wo;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread gathers A row (m0 + tid) for every k tile
  RowGather g;
  {
    const int m = m0 + tid;
    g.valid = m < M;
    const int mm = g.valid ? m : 0;
    g.ow = mm % p.Wo;
    const int t = mm / p.Wo;
    g.oh = t % p.Ho;
    g.n = t / p.Ho;
    g.seg = 0;
    g.ky = g.kx = g.c = 0;
  }

  const int KT = (p.K + kBK - 1) / kBK;
  int k_next = 0;  // first k of the next tile to load (A gather order)
  // bit (stage * 4 + v): this thread's A vector v of that stage is to be masked
  uint32_t mflags = 0;

  auto load_tile = [&](int stage, int kt) {
    // A: one 128-row x 32-k tile, this thread's row, four 8-channel vectors
    uint32_t bits = 0;
#pragma unroll
    for (int v = 0; v < kBK / 8; ++v) {
      const int k = k_next + v * 8;
      const int64_t off = (k < p.K) ? g.offset(p) : -1;
      const ConvSeg& s = g.seg == 0 ? p.seg0 : p.seg1;
      cp_async16(&sA[stage][tid][v * 8], off >= 0 ? s.src + off : p.seg0.w, off >= 0);
      if (masked && off >= 0 && s.mask != nullptr) {
        cp_async16(&sM[stage][tid][v * 8], s.mask + off, true);
        bits |= 1u << v;
      }
      g.advance(p);
    }
    if (kGrad) mflags = (mflags & ~(0xFu << (stage * 4))) | (bits << (stage * 4));
    k_next += kBK;
    // B: 32 k-rows x 64 channels = 256 vectors, two per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int vid = tid + i * kThreads;
      const int r = vid >> 3;
      const int cv = (vid & 7) * 8;
      const int k = kt * kBK + r;
      const int n = n0 + cv;
      const bool ok = k < p.K && n < p.COUT;
      const bf16* src = p.seg0.w;
      if (ok) {
        src = k < p.K0 ? p.seg0.w + static_cast<int64_t>(k) * p.COUT + n
                       : p.seg1.w + static_cast<int64_t>(k - p.K0) * p.COUT + n;
      }
      cp_async16(&sB[stage][r][cv], src, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    if (masked) {
      // this thread's own A row of the arrived tile: A *= (mask > 0)
      const int st = kt % kStages;
      const uint32_t bits = (mflags >> (st * 4)) & 0xFu;
#pragma unroll
      for (int v = 0; v < kBK / 8; ++v) {
        if (!((bits >> v) & 1u)) continue;
        bf16* a = &sA[st][tid][v * 8];
        const bf16* m = &sM[st][tid][v * 8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (!positive(m[e])) a[e] = __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < KT) load_tile(nk % kStages, nk);
    cp_async_commit();

    const int st = kt % kStages;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], &sA[st][wm * 64 + i * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &sB[st][ks * 16 + (lane & 15)][wn * 32 + j * 16 + (lane >> 4) * 8]);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: f32 bias (+ second bias) (+ bf16 residual), relu, one rounding
  // to bf16, then the output mask
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
    if (n >= p.COUT) continue;
    float bias_0 = 0.f, bias_1 = 0.f;
    if (p.bias0 != nullptr) {
      bias_0 = p.bias0[n];
      bias_1 = p.bias0[n + 1];
    }
    if (p.bias1 != nullptr) {
      bias_0 += p.bias1[n];
      bias_1 += p.bias1[n + 1];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 64 + i * 16 + (lane >> 2) + half * 8;
        if (m >= M) continue;
        float v0 = acc[i][j][half * 2 + 0] + bias_0;
        float v1 = acc[i][j][half * 2 + 1] + bias_1;
        const int64_t off = (kGrad ? out_pixel(p, m) : m) * p.COUT + n;
        if (p.residual != nullptr) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(p.residual + off);
          bool keep0 = true, keep1 = true;
          if (kGrad && p.rmask != nullptr) {
            const __nv_bfloat162 rm = *reinterpret_cast<const __nv_bfloat162*>(p.rmask + off);
            keep0 = positive(rm.x);
            keep1 = positive(rm.y);
          }
          if (keep0) v0 += __bfloat162float(r.x);
          if (keep1) v1 += __bfloat162float(r.y);
        }
        if (!kGrad) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        __nv_bfloat162 o;
        o.x = __float2bfloat16(v0);
        o.y = __float2bfloat16(v1);
        if (kGrad && p.emask != nullptr) {
          const __nv_bfloat162 em = *reinterpret_cast<const __nv_bfloat162*>(p.emask + off);
          if (!positive(em.x)) o.x = __float2bfloat16(0.f);
          if (!positive(em.y)) o.y = __float2bfloat16(0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + off) = o;
      }
    }
  }
}

// A square (ks x ks) segment with symmetric padding; kh, kw, pad_h and
// pad_w may be set apart afterwards.
inline ConvSeg make_seg(const void* src, const void* w, int H, int W, int C, int ks, int stride,
                        int pad, const void* mask = nullptr) {
  ConvSeg s;
  s.src = static_cast<const bf16*>(src);
  s.w = static_cast<const bf16*>(w);
  s.mask = static_cast<const bf16*>(mask);
  s.H = H;
  s.W = W;
  s.C = C;
  s.kh = s.kw = ks;
  s.stride = stride;
  s.pad_h = s.pad_w = pad;
  return s;
}

// Arguments of one launch over one segment, or two when `second` is given:
// no bias, residual, mask or relu until the caller sets them.
inline ConvGemmArgs gemm_args(const ConvSeg& first, const ConvSeg* second, int N, int Ho, int Wo,
                              int COUT, void* out) {
  ConvGemmArgs p;
  p.seg0 = first;
  p.seg1 = second ? *second : first;
  p.nseg = second ? 2 : 1;
  p.N = N;
  p.Ho = Ho;
  p.Wo = Wo;
  p.OH = Ho;
  p.OW = Wo;
  p.ostride = 1;
  p.oy = p.ox = 0;
  p.K0 = first.kh * first.kw * first.C;
  p.K = p.K0 + (second ? second->kh * second->kw * second->C : 0);
  p.COUT = COUT;
  p.bias0 = nullptr;
  p.bias1 = nullptr;
  p.residual = nullptr;
  p.rmask = nullptr;
  p.emask = nullptr;
  p.relu = 0;
  p.out = static_cast<bf16*>(out);
  return p;
}

inline cudaError_t launch_conv_gemm(const ConvGemmArgs& p, cudaStream_t stream) {
  const bool masked = p.seg0.mask != nullptr || (p.nseg > 1 && p.seg1.mask != nullptr);
  const bool remapped = p.ostride != 1 || p.oy != 0 || p.ox != 0 || p.OH != p.Ho || p.OW != p.Wo;
  const int64_t M = static_cast<int64_t>(p.N) * p.Ho * p.Wo;
  dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), static_cast<unsigned>((p.COUT + kBN - 1) / kBN));
  if (p.relu) {
    if (masked || remapped || p.rmask != nullptr || p.emask != nullptr) return cudaErrorInvalidValue;
    conv_gemm_kernel<false><<<grid, kThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  if (masked) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_gemm_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaskSmem);
    if (e != cudaSuccess) return e;
  }
  conv_gemm_kernel<true><<<grid, kThreads, masked ? kMaskSmem : 0, stream>>>(p);
  return cudaGetLastError();
}

// A forward launch: bias0 (+ bias1) (+ residual), relu.
inline cudaError_t conv_gemm(const ConvSeg& first, const ConvSeg* second, int N, int Ho, int Wo,
                             int COUT, const void* bias0, const void* bias1, const void* residual,
                             void* out, cudaStream_t stream) {
  ConvGemmArgs p = gemm_args(first, second, N, Ho, Wo, COUT, out);
  p.bias0 = static_cast<const float*>(bias0);
  p.bias1 = static_cast<const float*>(bias1);
  p.residual = static_cast<const bf16*>(residual);
  p.relu = 1;
  return launch_conv_gemm(p, stream);
}

// Bottleneck forwards on folded weights, composed from conv_gemm launches:
// h1 = relu(x @ w1 + b1), h2 = relu(conv3x3_s(h1) + b2), then the last 1x1
// with the identity residual or the fused projection shortcut. h1/h2 go
// through device memory (scratch buffers the caller allocates).

inline cudaError_t identity_block(const void* x, void* h1, void* h2, void* out, const void* w1,
                                  const void* b1, const void* w2, const void* b2, const void* w3,
                                  const void* b3, int N, int H, int W, int CIN, int F,
                                  cudaStream_t stream) {
  cudaError_t e;
  const ConvSeg sx = make_seg(x, w1, H, W, CIN, 1, 1, 0);
  if ((e = conv_gemm(sx, nullptr, N, H, W, F, b1, nullptr, nullptr, h1, stream)) != cudaSuccess)
    return e;
  const ConvSeg s1 = make_seg(h1, w2, H, W, F, 3, 1, 1);
  if ((e = conv_gemm(s1, nullptr, N, H, W, F, b2, nullptr, nullptr, h2, stream)) != cudaSuccess)
    return e;
  const ConvSeg s2 = make_seg(h2, w3, H, W, F, 1, 1, 0);
  return conv_gemm(s2, nullptr, N, H, W, CIN, b3, nullptr, x, out, stream);
}

inline cudaError_t projection_block(const void* x, void* h1, void* h2, void* out, const void* w1,
                                    const void* b1, const void* w2, const void* b2,
                                    const void* w3, const void* b3, const void* wsc,
                                    const void* bsc, int N, int H, int W, int CIN, int F, int COUT,
                                    int S, cudaStream_t stream) {
  cudaError_t e;
  const int Ho = H / S, Wo = W / S;
  const ConvSeg sx = make_seg(x, w1, H, W, CIN, 1, 1, 0);
  if ((e = conv_gemm(sx, nullptr, N, H, W, F, b1, nullptr, nullptr, h1, stream)) != cudaSuccess)
    return e;
  const ConvSeg s1 = make_seg(h1, w2, H, W, F, 3, S, 1);
  if ((e = conv_gemm(s1, nullptr, N, Ho, Wo, F, b2, nullptr, nullptr, h2, stream)) != cudaSuccess)
    return e;
  const ConvSeg s2 = make_seg(h2, w3, Ho, Wo, F, 1, 1, 0);
  const ConvSeg ssc = make_seg(x, wsc, H, W, CIN, 1, S, 0);
  return conv_gemm(s2, &ssc, N, Ho, Wo, COUT, b3, bsc, nullptr, out, stream);
}

}  // namespace argus
