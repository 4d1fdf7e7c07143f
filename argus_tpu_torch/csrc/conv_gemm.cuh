// Implicit-GEMM convolution over NHWC bf16 with a fused bias/residual/relu
// epilogue: the one tensor-core kernel behind the block, projection and stage
// kernels (block_fused.cu, proj_fused.cu, stage_fused.cu).
//
//   out[m, n] = bf16(relu(sum_k A[m, k] * B[k, n] + bias0[n] (+ bias1[n])
//                         (+ residual[m, n])))
//
// M runs over output pixels (N*Ho*Wo), n over output channels, and k over one
// or two "segments": segment s reads source s at tap (ky, kx) and channel c
// and multiplies weight rows of its own (ks*ks*C, COUT) matrix, so a 1x1, a
// 3x3/pad-1 at stride 1 or 2 and the strided 1x1 shortcut are all the same
// loop. The projection block's last step is ONE GEMM over K = F + CIN, with
// h2 @ w3 and x[::s, ::s] @ wsc sharing one f32 accumulator.
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
// the main loop. wgmma/TMA and keeping h1/h2 on chip are later work.

#pragma once

#include "common.cuh"

namespace argus {

struct ConvSeg {
  const bf16* src;  // NHWC source
  const bf16* w;    // (ks*ks*C, COUT) row-major weights of this segment (HWIO flattened)
  int H, W, C;      // source dims; C % 8 == 0
  int ks;           // square kernel size (1 or 3)
  int stride, pad;
};

struct ConvGemmArgs {
  ConvSeg seg0, seg1;
  int nseg;              // 1 or 2
  int N, Ho, Wo;         // output geometry; M = N * Ho * Wo
  int K0, K;             // rows of segment 0, rows in all
  int COUT;              // % 8 == 0
  const float* bias0;    // (COUT,)
  const float* bias1;    // (COUT,) or nullptr
  const bf16* residual;  // (M, COUT) or nullptr
  bf16* out;             // (M, COUT)
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

  // Source address of the current vector, or nullptr where the tap falls in
  // the zero padding (or the row is past M, or k is past K).
  __device__ __forceinline__ const bf16* addr(const ConvGemmArgs& p) const {
    if (!valid || seg >= p.nseg) return nullptr;
    const ConvSeg& s = seg == 0 ? p.seg0 : p.seg1;
    const int ih = oh * s.stride - s.pad + ky;
    const int iw = ow * s.stride - s.pad + kx;
    if (ih < 0 || ih >= s.H || iw < 0 || iw >= s.W) return nullptr;
    return s.src + ((static_cast<int64_t>(n) * s.H + ih) * s.W + iw) * s.C + c;
  }

  __device__ __forceinline__ void advance(const ConvGemmArgs& p) {
    if (seg >= p.nseg) return;
    const ConvSeg& s = seg == 0 ? p.seg0 : p.seg1;
    c += 8;
    if (c < s.C) return;
    c = 0;
    if (++kx < s.ks) return;
    kx = 0;
    if (++ky < s.ks) return;
    ky = 0;
    ++seg;
  }
};

__global__ void __launch_bounds__(kThreads) conv_gemm_kernel(const __grid_constant__ ConvGemmArgs p) {
  __shared__ __align__(128) bf16 sA[kStages][kBM][kLdA];
  __shared__ __align__(128) bf16 sB[kStages][kBK][kLdB];

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

  auto load_tile = [&](int stage, int kt) {
    // A: one 128-row x 32-k tile, this thread's row, four 8-channel vectors
#pragma unroll
    for (int v = 0; v < kBK / 8; ++v) {
      const int k = k_next + v * 8;
      const bf16* src = (k < p.K) ? g.addr(p) : nullptr;
      cp_async16(&sA[stage][tid][v * 8], src ? src : p.seg0.w, src != nullptr);
      g.advance(p);
    }
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

  // epilogue: f32 bias (+ second bias) (+ bf16 residual), relu, one rounding to bf16
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
    if (n >= p.COUT) continue;
    float bias_0 = p.bias0[n], bias_1 = p.bias0[n + 1];
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
        const int64_t off = static_cast<int64_t>(m) * p.COUT + n;
        if (p.residual != nullptr) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(p.residual + off);
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        }
        __nv_bfloat162 o;
        o.x = __float2bfloat16(fmaxf(v0, 0.f));
        o.y = __float2bfloat16(fmaxf(v1, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(p.out + off) = o;
      }
    }
  }
}

inline ConvSeg make_seg(const void* src, const void* w, int H, int W, int C, int ks, int stride,
                        int pad) {
  ConvSeg s;
  s.src = static_cast<const bf16*>(src);
  s.w = static_cast<const bf16*>(w);
  s.H = H;
  s.W = W;
  s.C = C;
  s.ks = ks;
  s.stride = stride;
  s.pad = pad;
  return s;
}

// One conv-GEMM launch over one segment, or two when `second` is given.
inline cudaError_t conv_gemm(const ConvSeg& first, const ConvSeg* second, int N, int Ho, int Wo,
                             int COUT, const void* bias0, const void* bias1, const void* residual,
                             void* out, cudaStream_t stream) {
  ConvGemmArgs p;
  p.seg0 = first;
  p.seg1 = second ? *second : first;
  p.nseg = second ? 2 : 1;
  p.N = N;
  p.Ho = Ho;
  p.Wo = Wo;
  p.K0 = first.ks * first.ks * first.C;
  p.K = p.K0 + (second ? second->ks * second->ks * second->C : 0);
  p.COUT = COUT;
  p.bias0 = static_cast<const float*>(bias0);
  p.bias1 = static_cast<const float*>(bias1);
  p.residual = static_cast<const bf16*>(residual);
  p.out = static_cast<bf16*>(out);
  const int64_t M = static_cast<int64_t>(N) * Ho * Wo;
  dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), static_cast<unsigned>((COUT + kBN - 1) / kBN));
  conv_gemm_kernel<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
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
