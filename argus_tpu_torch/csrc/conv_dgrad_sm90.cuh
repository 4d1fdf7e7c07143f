// The data-gradient engine of the redesigned block and chain backwards
// (basic_fused_bwd.cu, and proj_fused_bwd.cu, block_fused_bwd.cu,
// block_fused_rbwd.cu and stage_fused_bwd.cu through proj_bwd_sm90.cuh and
// identity_bwd_sm90.cuh) and of the pointwise backward (pointwise_bwd.cu,
// its dx and its mask pass): an implicit-GEMM
// convolution over NHWC bf16 on Hopper's warpgroup MMA, in the gradient form
// of conv_gemm.cuh
//
//   out[m, n] = bf16(sum_k A[m, k] * B[k, n] (+ residual[m, n])) * (emask[m, n] > 0)
//
// or, in its forward mode (`bias` set, `launch_conv_bias_relu`), the
// folded forward conv of the recompute backward (block_fused_rbwd.cu)
//
//   out[m, n] = bf16(relu(sum_k A[m, k] * B[k, n] + bias[n]))   (bias f32)
//
// with A the gather of one or two segments (each a (kh, kw) conv over its
// own source, stride and padding offsets, as conv_gemm.cuh's ConvSeg) and B
// their (K_s, COUT) weight rows. Grid pixel (oh, ow) lands on output pixel
// (oh*ostride + oy, ow*ostride + ox): one launch per output parity class at
// stride 2, each with only the taps that land on it.
//
// The relu mask of the incoming gradient (m3 = g * (out > 0)) is not applied
// inside the GEMM: `relu_mask_sm90` writes the masked gradient once, and
// every data and weight gradient reads it plain. Applying it in shared
// memory as the A tiles arrive (a mask tile beside each A tile, zeroed
// chunks, then fence.proxy.async) redid the mask once per tap and doubled
// the first launch (2.69 against 1.40 ms at (512, 64, 64, 64), NVIDIA H100
// 80GB HBM3 at 700 W, scripts/time_torch_block_bwd.py); the pass costs one
// read of g and out and one write of m (0.8 GB at that shape).
//
// Bound on the H100: tensor-core issue at the block backwards' shapes
// (2 * M * K * COUT FLOP against a few bytes per MAC). Design:
// - a 128 x BN output tile per block of two warpgroups, each warpgroup 64
//   pixels through wgmma m64nBNk16 (bf16 in, f32 accumulate), A K-major
//   and B N-major from shared memory: 128 x 256 at one block per
//   SM where COUT >= 256, else 128 x 64 or 128 x 128 at two blocks per SM,
//   whose loads and MMAs overlap each other's (1.72 against 2.64 ms for
//   one block of 256 x 64 at (512, 64, 64, 64)); a launch of at most two
//   k-steps a tile (the 1x1 dx of an identity block, K = F <= 128) takes
//   128 x 128 tiles at any COUT: its epilogue is its pace, and two blocks
//   per SM keep twice the epilogue loads in flight (the stage-0 chain's
//   backward 14.61 against 15.00 ms on 256-wide tiles, NVIDIA H100 80GB
//   HBM3 at 700 W, scripts/time_torch_block_bwd.py);
// - k in steps of 64 (one 128-byte swizzle row), a ring of 3-4 stages in
//   dynamic shared memory, each segment's steps apart (no step straddles two
//   segments, a short last step is zero-filled);
// - B arrives by TMA (2-D map of the segment's weight rows, 64 x 64 boxes,
//   128-byte swizzle, zero fill past K and COUT) on an mbarrier;
// - A is gathered by cp.async, 16 bytes per (pixel, tap, 8 channels), into
//   the same swizzled layout (`swz`), then fence.proxy.async and the block
//   barrier hand it to wgmma; its zero-fill form is the padding. Where every
//   C % 64 == 0 a step is one tap of one source pixel per row (`kVec`);
// - a persistent grid (MINB blocks per SM) walks its tiles as one run of
//   steps, so the next tile's loads are in flight during an epilogue; wgmma
//   of step t overlaps the loads of the next steps (wait_group 1);
// - the epilogue's residual and mask are loaded into registers while the
//   tile's MMAs run, where registers allow (`kPre`); on tiles up to 128
//   wide they arrive and the output leaves as 16-byte vectors, a quad of
//   lanes transposing its four 8-column groups of a row with shuffles
//   (sm90.cuh `quad_split`, `kQuad`).

#pragma once

#include <algorithm>
#include <cstring>
#include <type_traits>

#include "sm90.cuh"

namespace argus {

struct DgradSeg {
  const bf16* src;  // NHWC source
  int H, W, C;      // C % 8 == 0
  int kh, kw, stride, pad_h, pad_w;
  int K, steps;     // kh*kw*C, ceil(K / 64)
};

struct DgradArgs {
  CUtensorMap w0, w1;  // each segment's (K_s, COUT) weight rows
  DgradSeg seg0, seg1;
  int nseg;
  int N, Ho, Wo;       // the grid; M = N * Ho * Wo
  int OH, OW, ostride, oy, ox;
  int COUT;
  const bf16* residual;  // like out, or nullptr
  const bf16* emask;     // like out, or nullptr
  const float* bias;     // (COUT,) f32: the forward mode (no residual, no mask), or nullptr
  bf16* out;             // (N, OH, OW, COUT)
};

constexpr int kDgThreads = 256;
constexpr int kDgBM = 128;          // output pixels of a tile: 64 a warpgroup, two threads gather each
constexpr int kDgSmemMax = 232448;  // the H100's dynamic shared memory per block

// A block of two warpgroups computes a kDgBM x BN output tile; MINB blocks
// share an SM (their shared memory within its 227 KB).
template <int BN, int MINB>
struct DgradCfg {
  static constexpr int kTileA = kDgBM * 128;  // bytes of one A step
  static constexpr int kStageBytes = kTileA + BN * 128;
  static constexpr int kStagesRaw = ((MINB == 1 ? kDgSmemMax : 113 * 1024) - 1088) / kStageBytes;
  static constexpr int kStages = kStagesRaw > 6 ? 6 : kStagesRaw;  // >= 3
  static constexpr int kAhead = kStages - 2;                         // steps loaded ahead
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 64;    // + alignment + barriers
  static constexpr bool kPre = BN * MINB <= 128;                     // epilogue operands prefetched
  // the epilogue moves 16-byte vectors (quad_split / quad_join); 256-wide
  // tiles (one block per SM, the long-K launches) keep per-lane pairs: the
  // vectors cost them 3% at (512, 8, 8, 512), K = 4608 (PERF.md)
  static constexpr bool kQuad = BN < 256;
};

// A decoder of one thread's k position in a segment: (ky, kx, c), walked in
// 8-channel chunks, or in whole 64-channel steps when every C % 64 == 0
struct KPos {
  int ky, kx, c;
  __device__ __forceinline__ void step(const DgradSeg& s, int by) {
    c += by;
    if (c < s.C) return;
    c = 0;
    if (++kx < s.kw) return;
    kx = 0;
    ++ky;
  }
};

// kVec: every segment's C is a multiple of 64, so a step is one tap and a
// thread's chunks of it are contiguous channels of one source pixel.
// kBias: the forward mode's epilogue, bias + relu (a separate instantiation,
// so the gradient launches carry no register or branch for it).
template <int BN, int MINB, bool kVec, bool kBias>
__device__ __forceinline__ void dgrad_sm90_body(const DgradArgs& p) {
  using Cfg = DgradCfg<BN, MINB>;
  constexpr int S = Cfg::kStages;
  constexpr int BM = kDgBM;
  constexpr int CPT = 4;  // 16-byte chunks a thread gathers a step
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * Cfg::kStageBytes);
  auto sA = [&](int st) { return smem + st * Cfg::kStageBytes; };
  auto sB = [&](int st) { return smem + st * Cfg::kStageBytes + Cfg::kTileA; };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row = tid >> 1;        // the A row this thread gathers
  const int j0 = (tid & 1) * CPT;  // its first chunk of the 64-wide step
  const int M = p.N * p.Ho * p.Wo;
  const int T = p.seg0.steps + (p.nseg > 1 ? p.seg1.steps : 0);  // steps of one tile
  // tiles (m block, n block), n fastest so that neighbours share their A rows;
  // this block takes tiles blockIdx.x, + gridDim.x, ... as one run of steps
  const int ntn = (p.COUT + BN - 1) / BN;
  const int ntiles = ((M + BM - 1) / BM) * ntn;
  const int mytiles = static_cast<int>(blockIdx.x) < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int G = mytiles * T;
  const bool remap = p.ostride != 1 || p.oy != 0 || p.ox != 0 || p.OH != p.Ho || p.OW != p.Wo;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the gather's state: the tile being loaded and its step
  int ltile = blockIdx.x, lts = 0;
  int ln0 = 0;
  bool valid = false;
  int on = 0, ooh = 0, oow = 0;
  KPos kp{0, 0, 0};
  auto seek = [&](const DgradSeg& s) {  // this thread's first chunk of a segment
    kp = KPos{0, 0, 0};
    if (!kVec)
      for (int i = 0; i < j0; ++i) kp.step(s, 8);
  };

  auto load = [&](int gt) {
    const int st = gt % S;
    const int ts = lts;
    if (ts == 0) {
      const int m = (ltile / ntn) * BM + row;
      ln0 = (ltile % ntn) * BN;
      valid = m < M;
      const int mm = valid ? m : 0;
      oow = mm % p.Wo;
      const int q = mm / p.Wo;
      ooh = q % p.Ho;
      on = q / p.Ho;
      seek(p.seg0);
    }
    if (++lts == T) {
      lts = 0;
      ltile += gridDim.x;
    }
    const bool second = ts >= p.seg0.steps;
    const DgradSeg& s = second ? p.seg1 : p.seg0;
    const int ks = second ? ts - p.seg0.steps : ts;
    if (second && ks == 0) seek(p.seg1);
    if (kVec) {
      // one tap, one source pixel: CPT contiguous chunks
      const int ih = ooh * s.stride - s.pad_h + kp.ky;
      const int iw = oow * s.stride - s.pad_w + kp.kx;
      const bool ok = valid && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W;
      const int64_t off = ok ? ((static_cast<int64_t>(on) * s.H + ih) * s.W + iw) * s.C + kp.c + j0 * 8 : 0;
#pragma unroll
      for (int v = 0; v < CPT; ++v) cp_async16(sA(st) + swz(row, j0 + v), s.src + off + v * 8, ok);
      kp.step(s, 64);
    } else {
#pragma unroll
      for (int v = 0; v < CPT; ++v) {
        const int k = ks * 64 + (j0 + v) * 8;
        const int ih = ooh * s.stride - s.pad_h + kp.ky;
        const int iw = oow * s.stride - s.pad_w + kp.kx;
        const bool ok = valid && k < s.K && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W;
        const int64_t off = ok ? ((static_cast<int64_t>(on) * s.H + ih) * s.W + iw) * s.C + kp.c : 0;
        cp_async16(sA(st) + swz(row, j0 + v), s.src + off, ok);
        kp.step(s, 8);
      }
#pragma unroll
      for (int v = CPT; v < 8; ++v) kp.step(s, 8);  // the other thread's chunks
    }
    if (tid == 0) {
      mbar_expect_tx(&full[st], BN * 128);
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        tma_load_2d(sB(st) + b * 8192, second ? &p.w1 : &p.w0, &full[st], ln0 + b * 64, ks * 64);
    }
  };

  // output element offset of this thread's row i of the tile at m0, or -1 past M
  auto row_off = [&](int m0, int i) -> int64_t {
    const int mr = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
    if (mr >= M) return -1;
    if (!remap) return static_cast<int64_t>(mr) * p.COUT;
    const int ow = mr % p.Wo;
    const int q = mr / p.Wo;
    const int oh = q % p.Ho;
    const int n = q / p.Ho;
    return ((static_cast<int64_t>(n) * p.OH + oh * p.ostride + p.oy) * p.OW + ow * p.ostride + p.ox) * p.COUT;
  };
  // the residual and the mask at row offset ro and column c, as T (a
  // 16-byte vector of an 8-column group, or a pair); zero and "keep" where
  // absent or out of bounds: predicated loads, no branch
  auto fetch = [&](int64_t ro, int c, auto& rv, auto& ev) {
    using T = std::remove_reference_t<decltype(rv)>;
    constexpr uint32_t kOne = 0x3F803F80u;  // two bf16 ones
    const bool ok = ro >= 0 && c < p.COUT;
    const int64_t off = ok ? ro + c : 0;
    if constexpr (sizeof(T) == 16) {
      rv = (ok && p.residual != nullptr) ? __ldg(reinterpret_cast<const uint4*>(p.residual + off)) : make_uint4(0u, 0u, 0u, 0u);
      ev = (ok && p.emask != nullptr) ? __ldg(reinterpret_cast<const uint4*>(p.emask + off)) : make_uint4(kOne, kOne, kOne, kOne);
    } else {
      rv = (ok && p.residual != nullptr) ? __ldg(reinterpret_cast<const unsigned int*>(p.residual + off)) : 0u;
      ev = (ok && p.emask != nullptr) ? __ldg(reinterpret_cast<const unsigned int*>(p.emask + off)) : kOne;
    }
  };
  // this lane's 8-column group of 32-column block jb of the tile at n0
  auto group_col = [&](int n0, int jb) { return n0 + 32 * jb + 8 * (lane & 3); };
  // the output pair of columns n, n + 1 from their accumulators a0, a1 and
  // their residual and mask pairs: (+ residual), one rounding, the mask; the
  // forward mode: + bias, relu, one rounding
  auto out_pair = [&](float a0, float a1, int n, uint32_t rw, uint32_t ew) -> uint32_t {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&rw);
    __nv_bfloat162 o;
    if (kBias) {
      const float2 bv = n < p.COUT ? __ldg(reinterpret_cast<const float2*>(p.bias + n)) : make_float2(0.f, 0.f);
      o.x = __float2bfloat16(fmaxf(a0 + bv.x, 0.f));
      o.y = __float2bfloat16(fmaxf(a1 + bv.y, 0.f));
    } else {
      const __nv_bfloat162 em = *reinterpret_cast<const __nv_bfloat162*>(&ew);
      o.x = __float2bfloat16(a0 + __bfloat162float(r.x));
      o.y = __float2bfloat16(a1 + __bfloat162float(r.y));
      if (!(__bfloat162float(em.x) > 0.f)) o.x = __float2bfloat16(0.f);
      if (!(__bfloat162float(em.y) > 0.f)) o.y = __float2bfloat16(0.f);
    }
    return *reinterpret_cast<const uint32_t*>(&o);
  };

  constexpr int R = BN / 2;
  constexpr int NB = BN / 32;  // 32-column blocks of a tile row: one vector a lane each
  constexpr int NP = Cfg::kPre ? 2 * NB : 1;
  uint4 pre_r[NP], pre_e[NP];
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;

#pragma unroll
  for (int t = 0; t < Cfg::kAhead; ++t) {
    if (t < G) load(t);
    cp_async_commit();
  }

  int ctile = blockIdx.x, ts = 0;  // the tile being consumed and its step
  for (int gt = 0; gt < G; ++gt) {
    const int st = gt % S;
    cp_async_wait<Cfg::kAhead - 1>();
    fence_proxy_async();
    mbar_wait(&full[st], (gt / S) & 1);
    __syncthreads();
    if (gt + Cfg::kAhead < G) load(gt + Cfg::kAhead);
    cp_async_commit();

    fence_regs(acc);
    wgmma_fence();
    const uint32_t a0 = smem_u32(sA(st)) + wg * 64 * 128;
    const uint32_t b0 = smem_u32(sB(st));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<BN, 0>(acc, sw128_desc(a0 + kk * 32, 0), sw128_desc(b0 + kk * 16 * 128, 64 * 128),
                   ts != 0 || kk != 0);  // a tile's first MMA overwrites the accumulator
    wgmma_commit();
    const int m0 = (ctile / ntn) * BM;
    const int n0 = (ctile % ntn) * BN;
    if (Cfg::kPre && !kBias && ts == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t ro = row_off(m0, i);
#pragma unroll
        for (int jb = 0; jb < NB; ++jb) {
          const int x = Cfg::kPre ? i * NB + jb : 0;
          fetch(ro, group_col(n0, jb), pre_r[x], pre_e[x]);
        }
      }
    }
    if (++ts != T) {
      wgmma_wait<1>();
      fence_regs(acc);
      continue;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    ts = 0;
    ctile += gridDim.x;

    // the tile's epilogue (`out_pair`); the next tile's first steps are
    // loading meanwhile. The accumulators are read in straight-line code,
    // the loads and stores predicated.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t ro = row_off(m0, i);
      if constexpr (Cfg::kQuad) {
        // the residual and the mask arrive as 16-byte vectors and the output
        // leaves as one (quad_split / quad_join)
        constexpr int JB = Cfg::kPre ? NB : (NB < 4 ? NB : 4);  // vectors of loads in flight together
#pragma unroll
        for (int jb0 = 0; jb0 < NB; jb0 += JB) {
          uint4 rv[JB], ev[JB];
#pragma unroll
          for (int jj = 0; jj < JB; ++jj) {
            if (kBias) {
              continue;
            } else if (Cfg::kPre) {
              const int x = Cfg::kPre ? i * NB + jb0 + jj : 0;
              rv[jj] = pre_r[x];
              ev[jj] = pre_e[x];
            } else {
              fetch(ro, group_col(n0, jb0 + jj), rv[jj], ev[jj]);
            }
          }
#pragma unroll
          for (int jj = 0; jj < JB; ++jj) {
            uint32_t rw[4] = {0u, 0u, 0u, 0u}, ew[4] = {0u, 0u, 0u, 0u}, ow[4];
            if (!kBias) {
              quad_split(rv[jj], rw);
              quad_split(ev[jj], ew);
            }
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const int j = (jb0 + jj) * 4 + g;
              ow[g] = out_pair(acc[j * 4 + i * 2], acc[j * 4 + i * 2 + 1], n0 + 8 * j + (lane & 3) * 2, rw[g], ew[g]);
            }
            const uint4 o4 = quad_join(ow);
            const int c = group_col(n0, jb0 + jj);
            if (ro >= 0 && c < p.COUT) *reinterpret_cast<uint4*>(p.out + ro + c) = o4;
          }
        }
      } else {
        // each lane loads and stores its own pairs, eight column pairs of
        // loads in flight together
#pragma unroll
        for (int jc = 0; jc < BN / 8; jc += 8) {
          uint32_t rv[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}, ev[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            if (!kBias) fetch(ro, n0 + 8 * (jc + jj) + (lane & 3) * 2, rv[jj], ev[jj]);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = jc + jj;
            const int n = n0 + 8 * j + (lane & 3) * 2;
            const uint32_t o = out_pair(acc[j * 4 + i * 2], acc[j * 4 + i * 2 + 1], n, rv[jj], ev[jj]);
            if (ro >= 0 && n < p.COUT) *reinterpret_cast<uint32_t*>(p.out + ro + n) = o;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int BN, int MINB, bool kVec>
__global__ void __launch_bounds__(kDgThreads, MINB) dgrad_sm90_kernel(const __grid_constant__ DgradArgs p) {
  dgrad_sm90_body<BN, MINB, kVec, false>(p);
}

// the forward mode under its own name, so that a profile tells the
// recompute's launches from the gradients'
template <int BN, int MINB, bool kVec>
__global__ void __launch_bounds__(kDgThreads, MINB) conv_fwd_sm90_kernel(const __grid_constant__ DgradArgs p) {
  dgrad_sm90_body<BN, MINB, kVec, true>(p);
}

// m = g * (ref > 0) over n16 16-byte vectors of bf16
__global__ void relu_mask_sm90_kernel(const uint4* __restrict__ g, const uint4* __restrict__ ref,
                                      uint4* __restrict__ m, int64_t n16) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n16;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint4 a = g[i];
    const uint4 r = ref[i];
    uint32_t* aw = reinterpret_cast<uint32_t*>(&a);
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(&rw[e]);
      aw[e] &= (__bfloat162float(rv.x) > 0.f ? 0x0000FFFFu : 0u) | (__bfloat162float(rv.y) > 0.f ? 0xFFFF0000u : 0u);
    }
    m[i] = a;
  }
}

// m = g * (ref > 0), all three of `elems` bf16 (elems % 8 == 0): the relu
// mask of a block's output gradient, written once
inline cudaError_t relu_mask_sm90(const void* g, const void* ref, void* m, int64_t elems, cudaStream_t stream) {
  const int64_t n16 = elems / 8;
  const int blocks = static_cast<int>(std::min<int64_t>((n16 + 255) / 256, 8 * 132));
  relu_mask_sm90_kernel<<<blocks, 256, 0, stream>>>(static_cast<const uint4*>(g), static_cast<const uint4*>(ref),
                                                   static_cast<uint4*>(m), n16);
  return cudaGetLastError();
}

// A square (ks x ks) segment with symmetric padding; kh, kw, pad_h and pad_w
// may be set apart afterwards (then call `finish_seg`).
inline DgradSeg dgrad_seg(const void* src, int H, int W, int C, int ks, int stride, int pad) {
  DgradSeg s;
  s.src = static_cast<const bf16*>(src);
  s.H = H;
  s.W = W;
  s.C = C;
  s.kh = s.kw = ks;
  s.stride = stride;
  s.pad_h = s.pad_w = pad;
  s.K = ks * ks * C;
  s.steps = (s.K + 63) / 64;
  return s;
}

inline void finish_seg(DgradSeg& s) {
  s.K = s.kh * s.kw * s.C;
  s.steps = (s.K + 63) / 64;
}

// One launch: segment `first` with weights w0 (first.K, COUT), and `second`
// with w1 when given, over the grid (N, Ho, Wo); the identity output map
// unless set after `dgrad_args`.
inline DgradArgs dgrad_args(const DgradSeg& first, const DgradSeg* second, int N, int Ho, int Wo, int COUT,
                            void* out) {
  DgradArgs p;
  memset(&p, 0, sizeof(p));
  p.seg0 = first;
  p.seg1 = second ? *second : first;
  p.nseg = second ? 2 : 1;
  p.N = N;
  p.Ho = Ho;
  p.Wo = Wo;
  p.OH = Ho;
  p.OW = Wo;
  p.ostride = 1;
  p.COUT = COUT;
  p.out = static_cast<bf16*>(out);
  return p;
}

// static: each kernel library keeps its own once-only state
template <int BN, int MINB, bool kVec, bool kBias>
static inline cudaError_t launch_dgrad_cfg(const DgradArgs& p, cudaStream_t stream) {
  using Cfg = DgradCfg<BN, MINB>;
  void (*kernel)(const DgradArgs);
  if constexpr (kBias)
    kernel = conv_fwd_sm90_kernel<BN, MINB, kVec>;
  else
    kernel = dgrad_sm90_kernel<BN, MINB, kVec>;
  static int sms = 0;  // set once per instantiation: the SM count and the shared-memory opt-in
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (e != cudaSuccess) return e;
    sms = n * MINB;
  }
  // a persistent grid: MINB blocks per SM, each walking its share of the tiles
  const int64_t M = static_cast<int64_t>(p.N) * p.Ho * p.Wo;
  const int64_t tiles = (M + kDgBM - 1) / kDgBM * ((p.COUT + BN - 1) / BN);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, kDgThreads, Cfg::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int BN, int MINB, bool kBias>
static inline cudaError_t launch_dgrad_tile(const DgradArgs& p, cudaStream_t stream) {
  const bool vec = p.seg0.C % 64 == 0 && (p.nseg == 1 || p.seg1.C % 64 == 0);
  return vec ? launch_dgrad_cfg<BN, MINB, true, kBias>(p, stream) : launch_dgrad_cfg<BN, MINB, false, kBias>(p, stream);
}

template <bool kBias>
static inline cudaError_t launch_dgrad_mode(DgradArgs& p, const void* w0, const void* w1, cudaStream_t stream) {
  cudaError_t e = make_tmap_2d(&p.w0, w0, p.seg0.K, p.COUT, p.COUT);
  if (e != cudaSuccess) return e;
  e = make_tmap_2d(&p.w1, p.nseg > 1 ? w1 : w0, p.nseg > 1 ? p.seg1.K : p.seg0.K, p.COUT, p.COUT);
  if (e != cudaSuccess) return e;
  if (p.COUT <= 64) return launch_dgrad_tile<64, 2, kBias>(p, stream);
  const int steps = p.seg0.steps + (p.nseg > 1 ? p.seg1.steps : 0);  // k-steps of one tile
  if (p.COUT <= 128 || steps <= 2) return launch_dgrad_tile<128, 2, kBias>(p, stream);
  return launch_dgrad_tile<256, 1, kBias>(p, stream);
}

// Builds the weights' tensor maps and launches; w0 is (first.K, COUT), w1
// (second.K, COUT) row-major. The gradient modes: `bias` must be unset.
inline cudaError_t launch_dgrad(DgradArgs p, const void* w0, const void* w1, cudaStream_t stream) {
  if (p.bias != nullptr) return cudaErrorInvalidValue;
  return launch_dgrad_mode<false>(p, w0, w1, stream);
}

// The forward mode: out = bf16(relu(conv + bias)) over one segment with
// weights w (first.K, COUT) row-major (an HWIO kernel), `bias` set, no
// residual or mask. Only a library that calls it compiles its kernels.
inline cudaError_t launch_conv_bias_relu(DgradArgs p, const void* w, cudaStream_t stream) {
  if (p.bias == nullptr || p.residual != nullptr || p.emask != nullptr || p.nseg != 1) return cudaErrorInvalidValue;
  return launch_dgrad_mode<true>(p, w, nullptr, stream);
}

}  // namespace argus
