// Weight gradient of a convolution tap over NHWC bf16 or f32, reduced over
// every output pixel in f32: the mma.sync weight gradient of the port's f32
// block and chain backwards (conv_f32.cu through conv_bwd.cuh, TF32
// products) and of the previous bf16 block and chain backwards that
// bwd_prev.cu keeps for timing. Every bf16 block backward and the bf16 chain
// backward run on the Hopper engine instead (wgrad_sm90.cuh).
//
//   dW[tap, c, n] = sum_m A_tap[m, c] * B[m, n] * (bmask[m, n] > 0)
//
// m runs over the output pixels (N*Ho*Wo, up to 2.1M rows at stage 0), A_tap
// is the source pixel that forward tap (ky, kx) reads for output pixel m
// (oh*stride - pad + ky, ow*stride - pad + kx; zero in the padding) and B is
// the output-side gradient with an optional relu mask. One launch covers
// dw1 = x^T m1, dw3 = h2^T m3, dwsc = x[::s, ::s]^T m3 and all nine taps of
// dw2 = shift_s(h1)^T m2 (the tap is a grid dimension).
//
// Replaces the f32 VMEM weight-gradient accumulators of argus_tpu's one-pass
// backwards (block_fused.py `_bwd_saved_kernel` :350, proj_fused.py
// `_proj_bwd_kernel` :286, stage_fused.py `_make_bwd_kernel` :278), which
// carry the sum across the TPU's sequential grid. No grid carries a sum on
// Hopper, so M is split across blocks: each block reduces a contiguous range
// of rows into a 64x64 f32 tile of its own partial, and a second pass adds the
// partials in split order. The result is deterministic: the same inputs give
// the same bits on every run (no atomics).
//
// Bound on the H100: the reduction has the forward conv's FLOPs
// (2 * M * C * COUT per tap); at stage 0 (C or COUT = 64) the operand bytes
// matter as much. Design: 64x64 output tiles, 32 rows per stage of a 3-deep
// cp.async ring, four warps of 32x32, mma.sync m16n8k16 with both operands
// M-major in shared memory, so A's fragments come transposed through
// ldmatrix.trans (B's, as in the forward, too). The relu mask of B is applied
// by each thread to the vectors it loaded, before the tile is shared. The f32
// instantiation keeps the tile bytes (16 rows a stage) and runs mma.sync
// m16n8k8 on TF32: the reduction runs over pixels, along which neither NHWC
// operand is K-major, and wgmma's TF32 form takes K-major operands only; the
// m16n8k8 fragments are read by plain 32-bit loads from the pixel-major
// tiles (any layout, conflict-free on the padded rows), each value rounded
// to TF32 (cvt.rna), the sums in f32.
// The wgmma/TMA form is wgrad_sm90.cuh; moving these backwards onto it is
// later work.

#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace argus {

template <class T>
struct WgradArgsT {
  const T* a;      // (N, H, W, C) source of the forward conv
  int H, W, C;     // C % (16 / sizeof(T)) == 0
  int ks, stride, pad;
  const T* b;      // (N*Ho*Wo, COUT) output-side gradient
  const T* bmask;  // nullptr, or shaped like b: B = b * (bmask > 0)
  int COUT;        // % (16 / sizeof(T)) == 0
  int N, Ho, Wo;
  int splits, rows_per_split;
  float* out;  // (splits, ks*ks, C, COUT) partials, or dW itself when splits == 1
};

constexpr int kWBC = 64;   // output rows (source channels) per block
constexpr int kWBN = 64;   // output columns (gradient channels) per block
template <class T>
constexpr int kWBK = 64 / static_cast<int>(sizeof(T));  // reduction rows per stage: 32 bf16, 16 f32
constexpr int kWLd = 72;   // padded shared row: ldmatrix rows (bf16) and fragment loads (f32) on distinct banks
constexpr int kWStages = 3;
constexpr int kWThreads = 128;
constexpr int kWTargetBlocks = 4 * 132;  // four blocks on each of the H100's SMs
constexpr int kWMinRows = 2048;          // rows a split reduces at least

template <class T>
__global__ void __launch_bounds__(kWThreads) wgrad_kernel(const __grid_constant__ WgradArgsT<T> p) {
  constexpr int BK = kWBK<T>, VEC = 16 / static_cast<int>(sizeof(T)), VPR = kWBC / VEC;
  __shared__ __align__(128) T sA[kWStages][BK][kWLd];
  __shared__ __align__(128) T sB[kWStages][BK][kWLd];
  __shared__ __align__(128) T sBm[kWStages][BK][kWLd];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // warp row: 32 source channels
  const int wn = warp & 1;   // warp col: 32 gradient channels
  const int taps = p.ks * p.ks;
  const int tap = blockIdx.z % taps;
  const int split = blockIdx.z / taps;
  const int ky = tap / p.ks, kx = tap % p.ks;
  const int c0 = blockIdx.x * kWBC;
  const int n0 = blockIdx.y * kWBN;
  const int64_t M = static_cast<int64_t>(p.N) * p.Ho * p.Wo;
  const int64_t mbeg = static_cast<int64_t>(split) * p.rows_per_split;
  const int64_t mend = mbeg + p.rows_per_split < M ? mbeg + p.rows_per_split : M;
  const int KT = mbeg < mend ? static_cast<int>((mend - mbeg + BK - 1) / BK) : 0;
  const bool masked = p.bmask != nullptr;

  // BK rows x 64 channels = 256 vectors per operand tile, two per thread
  auto load_tile = [&](int stage, int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int vid = tid + i * kWThreads;
      const int r = vid / VPR;
      const int cv = (vid % VPR) * VEC;
      const int64_t m = mbeg + static_cast<int64_t>(t) * BK + r;
      const bool row = m < mend;
      // A: the tap's source pixel of output pixel m
      const T* asrc = p.a;
      bool aok = false;
      if (row && c0 + cv < p.C) {
        const int ow = static_cast<int>(m % p.Wo);
        const int64_t q = m / p.Wo;
        const int oh = static_cast<int>(q % p.Ho);
        const int64_t n = q / p.Ho;
        const int ih = oh * p.stride - p.pad + ky;
        const int iw = ow * p.stride - p.pad + kx;
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) {
          asrc = p.a + ((n * p.H + ih) * p.W + iw) * p.C + c0 + cv;
          aok = true;
        }
      }
      cp_async16(&sA[stage][r][cv], asrc, aok);
      const bool bok = row && n0 + cv < p.COUT;
      const int64_t boff = bok ? m * p.COUT + n0 + cv : 0;
      cp_async16(&sB[stage][r][cv], p.b + boff, bok);
      if (masked) cp_async16(&sBm[stage][r][cv], p.bmask + boff, bok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }

  for (int t = 0; t < KT; ++t) {
    cp_async_wait<kWStages - 2>();
    const int st = t % kWStages;
    if (masked) {
      // the two B vectors this thread loaded: B *= (bmask > 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int vid = tid + i * kWThreads;
        T* bv = &sB[st][vid / VPR][(vid % VPR) * VEC];
        const T* mv = &sBm[st][vid / VPR][(vid % VPR) * VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (!(as_f32(mv[e]) > 0.f)) bv[e] = T(0.f);
      }
    }
    __syncthreads();
    const int nt = t + kWStages - 1;
    if (nt < KT) load_tile(nt % kWStages, nt);
    cp_async_commit();

    if constexpr (std::is_same<T, float>::value) {
      // k-steps of 8 pixels: A[c][pixel] = sA[pixel][c], B[pixel][n] = sB[pixel][n]
      const int gr = lane >> 2, tc = lane & 3;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int p0 = kk * 8 + tc;
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = wm * 32 + i * 16 + gr;
          a[i][0] = tf32(sA[st][p0][c]);
          a[i][1] = tf32(sA[st][p0][c + 8]);
          a[i][2] = tf32(sA[st][p0 + 4][c]);
          a[i][3] = tf32(sA[st][p0 + 4][c + 8]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn * 32 + j * 8 + gr;
          const uint32_t b0 = tf32(sB[st][p0][n]);
          const uint32_t b1 = tf32(sB[st][p0 + 4][n]);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_tf32(acc[i][j], a[i], b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A fragments (rows = source channels, cols = pixels) from the
        // pixel-major tile: 8x8 matrix j covers pixels +8*(j>>1), channels +8*(j&1)
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4_trans(a[i], &sA[st][kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)]
                                     [wm * 32 + i * 16 + ((lane >> 3) & 1) * 8]);
        uint32_t b[4][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, &sB[st][kk * 16 + (lane & 15)][wn * 32 + j * 16 + (lane >> 4) * 8]);
          b[2 * j][0] = r[0];
          b[2 * j][1] = r[1];
          b[2 * j + 1][0] = r[2];
          b[2 * j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  float* out = p.out + (static_cast<int64_t>(split) * taps + tap) * p.C * p.COUT;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
    if (n >= p.COUT) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + wm * 32 + i * 16 + (lane >> 2) + half * 8;
        if (c >= p.C) continue;
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(c) * p.COUT + n) =
            make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
      }
    }
  }
}

// dW[i] = sum over s of partial[s][i], in split order; n4 float4s per partial.
__global__ void sum_splits_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                  int64_t n4, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float4 s = part[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v = part[k * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

// Splits of the reduction for a problem of M rows and `tiles` output tiles
// (taps included): enough blocks to fill the card, at least kWMinRows rows
// each. ops/kernels/wgrad_plan.py `mma_workspace` mirrors it to size the
// workspace.
inline int wgrad_splits(int64_t M, int64_t tiles) {
  const int64_t want = (kWTargetBlocks + tiles - 1) / tiles;
  const int64_t most = (M + kWMinRows - 1) / kWMinRows;
  return static_cast<int>(std::max<int64_t>(1, std::min(want, most)));
}

// dw (ks*ks, C, COUT) f32 = the tap-wise weight gradient of T operands;
// `ws` holds `ws_elems` f32 for the partials (fewer splits are taken if it
// is short).
template <class T = bf16>
inline cudaError_t wgrad(const void* a, int H, int W, int C, int ks, int stride, int pad,
                         const void* b, const void* bmask, int COUT, int N, int Ho, int Wo,
                         void* dw, void* ws, int64_t ws_elems, cudaStream_t stream) {
  WgradArgsT<T> p;
  p.a = static_cast<const T*>(a);
  p.H = H;
  p.W = W;
  p.C = C;
  p.ks = ks;
  p.stride = stride;
  p.pad = pad;
  p.b = static_cast<const T*>(b);
  p.bmask = static_cast<const T*>(bmask);
  p.COUT = COUT;
  p.N = N;
  p.Ho = Ho;
  p.Wo = Wo;
  const int taps = ks * ks;
  const int64_t M = static_cast<int64_t>(N) * Ho * Wo;
  const int64_t elems = static_cast<int64_t>(taps) * C * COUT;
  const int64_t tiles = static_cast<int64_t>(taps) * ((C + kWBC - 1) / kWBC) * ((COUT + kWBN - 1) / kWBN);
  int64_t splits = wgrad_splits(M, tiles);
  splits = std::min<int64_t>(splits, ws == nullptr ? 1 : std::max<int64_t>(1, ws_elems / elems));
  int64_t rps = (M + splits - 1) / splits;
  rps = (rps + kWBK<T> - 1) / kWBK<T> * kWBK<T>;
  splits = std::max<int64_t>(1, (M + rps - 1) / rps);
  p.splits = static_cast<int>(splits);
  p.rows_per_split = static_cast<int>(rps);
  p.out = static_cast<float*>(splits > 1 ? ws : dw);
  dim3 grid(static_cast<unsigned>((C + kWBC - 1) / kWBC), static_cast<unsigned>((COUT + kWBN - 1) / kWBN),
            static_cast<unsigned>(taps * splits));
  wgrad_kernel<T><<<grid, kWThreads, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int64_t n4 = elems / 4;
  const int blocks = static_cast<int>(std::min<int64_t>((n4 + 255) / 256, 4 * 132));
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float4*>(ws),
                                                static_cast<float4*>(dw), n4,
                                                static_cast<int>(splits));
  return cudaGetLastError();
}

}  // namespace argus
