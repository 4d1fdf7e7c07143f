// The TMA forward engine of the BasicBlock forward (basic_fused.cu) and the
// bottleneck forwards (bottleneck_fwd_sm90.cuh: the identity and projection
// blocks of block_fused.cu, proj_fused.cu and stage_fused.cu): a
// convolution at stride S in {1, 2} with padding KS/2, a 3x3 or a 1x1
// (template argument KS), over NHWC bf16 on Hopper's warpgroup MMA, every
// operand arriving by TMA, with an optional second K segment (a 1x1 over
// another source at its own stride) in the same f32 accumulator, and the
// folded forward epilogue
//
//   out[m, n] = bf16(relu(sum_k A[m, k] * B[k, n] + bias[n] (+ bias2[n])
//                         (+ f32(residual[m, n]))))
//
// (biases f32; bias2 the second segment's, with kSc; the residual, an
// identity shortcut like out, with kRes), the sum in that order and one
// rounding, as conv_dgrad_sm90.cuh's forward mode rounds. Any C and COUT
// that are multiples of 8.
//
// Bound on the H100: tensor-core issue for the 3x3s at C >= 128 and the
// 1x1s at K >= 1024; device memory for the 1x1s at the bottleneck's stage 1
// (conv3 reads x and h2 and writes out, ~1.2 GB at N = 512) and for the 3x3
// at C = 64 (ResNet-18's stage 0, K = 576), where a tile has only nine
// 64-k steps and the gather engine (conv_dgrad_sm90.cuh) pays 1.2-2.3 us a
// step for its per-thread cp.async gather, its proxy fence and its block
// barrier whatever the MMA size (PERF.md). Design:
// - an output tile of 128 pixels is a box of `bw` columns x `bh` rows x
//   `bn` images of the OUTPUT: Wo and Ho rounded up to powers of two, at
//   most 16 and 8, and bn = 128 / (bw * bh) (16 x 8 x 1 at ResNet-18's
//   stages 0-2, two whole 8 x 8 images at stage 3), so a small image wastes
//   little of a tile;
// - its A operand for tap (ky, kx) and channels c0..c0+63 is ONE tiled TMA
//   box of a 4-D tensor map over the source (64 ch x bw x bh x bn pixels)
//   at (c0, S * ow0 + kx - KS/2, S * oh0 + ky - KS/2, n0): at stride 2 the
//   map's traversal stride along W and H (sm90.cuh `make_tmap_nhwc`) takes
//   every other source pixel, so the box lands the same bw x bh x bn rows;
//   TMA's zero fill at negative or overflowing coordinates is the conv's
//   padding and, where C % 64 != 0, the channels of the last step past C;
//   64 bf16 channels are one 128-byte swizzle row per pixel, the K-major
//   layout wgmma's A takes. A 1x1 is the single tap at offset (0, 0);
// - B, the weight rows, arrives by TMA as 64 x 64 boxes (128-byte swizzle)
//   of a 3-D map over (taps, C, COUT) at (n0, c0, tap), so a short last
//   channel step reads zeros past C, not the next tap's rows;
// - a second K segment (the projection block's shortcut, x[::S, ::S] @ wsc
//   after conv3's h2 @ w3): steps T1.. of a tile read the second source
//   through its own strided map, a 1x1 at (c0, S2 * ow0, S2 * oh0, n0),
//   against its own weight map, into the same accumulator: no subsampled
//   copy of x and no concatenated weights;
// - warp specialisation: warp 8 issues the boxes into a ring of stages on
//   "full" mbarriers, warpgroups 0-1 (64 pixels each, wgmma m64nBNk16)
//   wait only on them and release a stage on its "empty" mbarrier once its
//   MMAs are done: no gather, no proxy fence, no block barrier in the loop;
//   at one block per SM (BN >= 128) the producer is a whole warpgroup that
//   hands its registers to the consumers (setmaxnreg 40 / 232), so their
//   128 accumulators a thread do not spill;
// - a persistent grid walks the tiles (n fastest), so the producer loads the
//   next tile's steps during an epilogue.
// The epilogue reads the biases (and the residual as 16-byte vectors,
// prefetched into registers during the tile's first step where they allow)
// and writes 16-byte vectors (sm90.cuh `quad_split`, `quad_join`).

#pragma once

#include <cstring>

#include "sm90.cuh"

namespace argus {

struct ConvFwdArgs {
  CUtensorMap amap;   // the source at its stride, boxes of 64 ch x bw x bh x bn pixels
  CUtensorMap wmap;   // (taps, C, COUT) weight rows, 64 x 64 x 1 boxes
  CUtensorMap amap2;  // the second segment's source at stride2 (kSc)
  CUtensorMap wmap2;  // its (1, C2, COUT) weight rows
  int N, H, W, C, COUT;   // H, W: the output's
  int stride;             // of the first segment
  int C2, stride2;        // the second segment's channels and stride (kSc)
  int bw, bh, bn;         // a tile's pixel box: bw * bh * bn == 128
  int tw, th, timg;       // tiles along W, along H, and image groups
  const float* bias;      // (COUT,) f32
  const float* bias2;     // (COUT,) f32, added after bias (kSc)
  const bf16* residual;   // like out (kRes), or nullptr
  bf16* out;              // (N, H, W, COUT)
};

constexpr int kFwConsumers = 256;  // two warpgroups of 64 output pixels
constexpr int kFwBM = 128;         // output pixels of a tile

template <int BN, int MINB>
struct FwdCfg {
  // + the producer: a warp at two blocks per SM, a warpgroup (its registers
  // handed to the consumers) at one
  static constexpr int kThreads = kFwConsumers + (MINB == 1 ? 128 : 32);
  static constexpr int kTileA = kFwBM * 128;                    // one box: 128 pixels x 64 channels
  static constexpr int kStageBytes = kTileA + BN * 128;         // + BN/64 weight boxes
  static constexpr int kBudget = (MINB == 1 ? 232448 : 113 * 1024) - 1024 - 128;
  static constexpr int kStagesRaw = kBudget / kStageBytes;
  static constexpr int kStages = kStagesRaw > 8 ? 8 : kStagesRaw;  // >= 3
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 128;  // + alignment + barriers
  static constexpr bool kPre = BN * MINB <= 128;                    // the residual prefetched
};

template <int KS, int BN, int MINB, bool kRes, bool kSc>
__global__ void __launch_bounds__(FwdCfg<BN, MINB>::kThreads, MINB)
    conv_fwd_tma_sm90_kernel(const __grid_constant__ ConvFwdArgs p) {
  using Cfg = FwdCfg<BN, MINB>;
  constexpr int S = Cfg::kStages;
  constexpr int kPad = KS / 2;  // the padding
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * Cfg::kStageBytes);
  uint64_t* empty = full + S;
  auto sA = [&](int st) { return smem + st * Cfg::kStageBytes; };
  auto sB = [&](int st) { return smem + st * Cfg::kStageBytes + Cfg::kTileA; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int CB = (p.C + 63) >> 6;          // 64-channel steps, the last zero-filled past C
  const int T1 = KS * KS * CB;             // the first segment's steps: tap-major, then channel block
  const int T = T1 + kSc * ((p.C2 + 63) >> 6);  // + the second segment's (a 1x1)
  const int ntn = (p.COUT + BN - 1) / BN;
  const int ntiles = p.tw * p.th * p.timg * ntn;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kFwConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a tile's pixel box: image group, row and column of its corner
  auto corner = [&](int tile, int& n0, int& oh0, int& ow0) {
    const int mt = tile / ntn;
    const int q = mt / p.tw;
    ow0 = (mt - q * p.tw) * p.bw;
    oh0 = (q % p.th) * p.bh;
    n0 = (q / p.th) * p.bn;
  };

  if (warp >= kFwConsumers / 32) {
    // the producer: one lane issues every box of every step of this
    // block's tiles, a stage at a time once its consumers have released it
    if (MINB == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kFwConsumers / 32 && lane == 0) {
      int gt = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        int n0, oh0, ow0;
        corner(tile, n0, oh0, ow0);
        const int c0 = (tile % ntn) * BN;
        for (int ts = 0; ts < T; ++ts, ++gt) {
          const int st = gt % S;
          if (gt >= S) mbar_wait(&empty[st], ((gt / S) - 1) & 1);
          mbar_expect_tx(&full[st], Cfg::kStageBytes);
          if (ts < T1) {  // the first segment: tap (ky, kx), channel block cb
            const int tap = ts / CB;
            const int cb = ts - tap * CB;
            const int ky = tap / KS, kx = tap - KS * ky;
            tma_load_4d(sA(st), &p.amap, &full[st], cb * 64, p.stride * ow0 + kx - kPad,
                        p.stride * oh0 + ky - kPad, n0);
#pragma unroll
            for (int b = 0; b < BN / 64; ++b)
              tma_load_3d(sB(st) + b * 8192, &p.wmap, &full[st], c0 + b * 64, cb * 64, tap);
          } else {  // the second: a 1x1 at stride2, channel block cb2
            const int cb2 = ts - T1;
            tma_load_4d(sA(st), &p.amap2, &full[st], cb2 * 64, p.stride2 * ow0, p.stride2 * oh0, n0);
#pragma unroll
            for (int b = 0; b < BN / 64; ++b)
              tma_load_3d(sB(st) + b * 8192, &p.wmap2, &full[st], c0 + b * 64, cb2 * 64, 0);
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns tile rows wg*64 .. wg*64+63
  if (MINB == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2;
  const int box = p.bw * p.bh;
  // output element offset of this thread's row i of the tile, or -1 outside the tensor
  auto row_off = [&](int n0, int oh0, int ow0, int i) -> int64_t {
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * i;
    const int ni = r / box;
    const int rem = r - ni * box;
    const int hi = rem / p.bw;
    const int n = n0 + ni, oh = oh0 + hi, ow = ow0 + rem - hi * p.bw;
    if (n >= p.N || oh >= p.H || ow >= p.W) return -1;
    return ((static_cast<int64_t>(n) * p.H + oh) * p.W + ow) * p.COUT;
  };
  // the residual's 8-column group at column c of row offset ro, a 16-byte vector
  auto fetch = [&](int64_t ro, int c, uint4& rv) {
    const bool ok = kRes && ro >= 0 && c < p.COUT;
    rv = ok ? __ldg(reinterpret_cast<const uint4*>(p.residual + ro + c)) : make_uint4(0u, 0u, 0u, 0u);
  };
  // this lane's 8-column group of 32-column block jb of the tile at c0
  auto group_col = [&](int c0, int jb) { return c0 + 32 * jb + 8 * (lane & 3); };

  constexpr int R = BN / 2;
  constexpr int NB = BN / 32;  // 32-column blocks of a tile row: one vector a lane each
  constexpr int NP = (kRes && Cfg::kPre) ? 2 * NB : 1;
  uint4 pre[NP];
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;

  int gt = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int n0, oh0, ow0;
    corner(tile, n0, oh0, ow0);
    const int c0 = (tile % ntn) * BN;
    for (int ts = 0; ts < T; ++ts, ++gt) {
      const int st = gt % S;
      mbar_wait(&full[st], (gt / S) & 1);
      fence_regs(acc);
      wgmma_fence();
      const uint32_t a0 = smem_u32(sA(st)) + wg * 64 * 128;
      const uint32_t b0 = smem_u32(sB(st));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<BN, 0>(acc, sw128_desc(a0 + kk * 32, 0), sw128_desc(b0 + kk * 16 * 128, 64 * 128),
                     ts != 0 || kk != 0);  // a tile's first MMA overwrites the accumulator
      wgmma_commit();
      if (kRes && Cfg::kPre && ts == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int64_t ro = row_off(n0, oh0, ow0, i);
#pragma unroll
          for (int jb = 0; jb < NB; ++jb) {
            const int x = (kRes && Cfg::kPre) ? i * NB + jb : 0;
            fetch(ro, group_col(c0, jb), pre[x]);
          }
        }
      }
      wgmma_wait<1>();  // the previous step's MMAs are done: release its stage
      fence_regs(acc);
      if (ts > 0 && lane == 0) mbar_arrive(&empty[(gt - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(gt - 1) % S]);

    // the epilogue: + bias (+ residual), relu, one rounding; the producer
    // is loading the next tile's first steps meanwhile. The residual
    // arrives and the output leaves as 16-byte vectors (quad_split /
    // quad_join in sm90.cuh).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t ro = row_off(n0, oh0, ow0, i);
      constexpr int JB = Cfg::kPre ? NB : (NB < 4 ? NB : 4);  // vectors of loads in flight together
#pragma unroll
      for (int jb0 = 0; jb0 < NB; jb0 += JB) {
        uint4 rv[JB];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          if (kRes && Cfg::kPre)
            rv[jj] = pre[(kRes && Cfg::kPre) ? i * NB + jb0 + jj : 0];
          else if (kRes)
            fetch(ro, group_col(c0, jb0 + jj), rv[jj]);
        }
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          uint32_t rw[4] = {0u, 0u, 0u, 0u}, ow[4];
          if (kRes) quad_split(rv[jj], rw);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int j = (jb0 + jj) * 4 + g;
            const int n = c0 + 8 * j + (lane & 3) * 2;
            const float2 bv =
                n < p.COUT ? __ldg(reinterpret_cast<const float2*>(p.bias + n)) : make_float2(0.f, 0.f);
            float vx = acc[j * 4 + i * 2] + bv.x, vy = acc[j * 4 + i * 2 + 1] + bv.y;
            if (kSc) {  // the second segment's bias, after the first's
              const float2 b2 =
                  n < p.COUT ? __ldg(reinterpret_cast<const float2*>(p.bias2 + n)) : make_float2(0.f, 0.f);
              vx += b2.x;
              vy += b2.y;
            }
            if (kRes) {
              const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&rw[g]);
              vx += __bfloat162float(r.x);
              vy += __bfloat162float(r.y);
            }
            __nv_bfloat162 o;
            o.x = __float2bfloat16(fmaxf(vx, 0.f));
            o.y = __float2bfloat16(fmaxf(vy, 0.f));
            ow[g] = *reinterpret_cast<const uint32_t*>(&o);
          }
          const uint4 o4 = quad_join(ow);
          const int c = group_col(c0, jb0 + jj);
          if (ro >= 0 && c < p.COUT) *reinterpret_cast<uint4*>(p.out + ro + c) = o4;
        }
      }
    }
  }
}

// static: each kernel library keeps its own once-only state
template <int KS, int BN, int MINB, bool kRes, bool kSc>
static inline cudaError_t launch_conv_fwd_tma_cfg(const ConvFwdArgs& p, cudaStream_t stream) {
  using Cfg = FwdCfg<BN, MINB>;
  static int sms = 0;  // set once per instantiation: the SM count and the shared-memory opt-in
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv_fwd_tma_sm90_kernel<KS, BN, MINB, kRes, kSc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (e != cudaSuccess) return e;
    sms = n * MINB;
  }
  const int64_t tiles = static_cast<int64_t>(p.tw) * p.th * p.timg * ((p.COUT + BN - 1) / BN);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  conv_fwd_tma_sm90_kernel<KS, BN, MINB, kRes, kSc><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// the instantiation: the residual, or the second segment (never both); the
// second segment is a template flag because a runtime test of it in the
// producer and epilogue made every forward launch 1.4-1.8x slower (PERF.md)
template <int KS, int BN, int MINB, bool kSc>
static inline cudaError_t launch_conv_fwd_tma_res(const ConvFwdArgs& p, cudaStream_t stream) {
  if constexpr (kSc)
    return launch_conv_fwd_tma_cfg<KS, BN, MINB, false, true>(p, stream);
  else
    return p.residual != nullptr ? launch_conv_fwd_tma_cfg<KS, BN, MINB, true, false>(p, stream)
                                 : launch_conv_fwd_tma_cfg<KS, BN, MINB, false, false>(p, stream);
}

// The tile box and tiles of an output (N, Ho, Wo, COUT): powers of two,
// bw * bh * bn == 128; a box may overrun the tensor on any side, where TMA
// zero-fills and the epilogue stores nothing.
inline void conv_fwd_tiles(ConvFwdArgs& p, int N, int Ho, int Wo, int COUT) {
  auto pow2 = [](int v, int cap) {
    int b = 1;
    while (b < v && b < cap) b *= 2;
    return b;
  };
  p.N = N;
  p.H = Ho;
  p.W = Wo;
  p.COUT = COUT;
  p.bw = pow2(Wo, 16);
  p.bh = pow2(Ho, 8);
  p.bn = kFwBM / (p.bw * p.bh);
  p.tw = (Wo + p.bw - 1) / p.bw;
  p.th = (Ho + p.bh - 1) / p.bh;
  p.timg = (N + p.bn - 1) / p.bn;
}

// The tile width: 64 (two blocks an SM) for COUT <= 64, 128 for COUT <= 128
// and for a 1x1 with the residual (the identity forward's conv3, K = F: 2-8
// k-steps a tile, is paced by its epilogue: 128-wide tiles, whose residual
// is prefetched, 0.38 against 0.48 ms on 256-wide tiles at F = 256,
// PERF.md), else 256 (the projection's conv3 and shortcut, K = F + CIN).
template <int KS, bool kSc>
static inline cudaError_t launch_conv_fwd_tiles(const ConvFwdArgs& p, cudaStream_t stream) {
  const bool res1x1 = KS == 1 && p.residual != nullptr;
  if (p.COUT <= 64) return launch_conv_fwd_tma_res<KS, 64, 2, kSc>(p, stream);
  if (p.COUT <= 128 || res1x1) return launch_conv_fwd_tma_res<KS, 128, 1, kSc>(p, stream);
  return launch_conv_fwd_tma_res<KS, 256, 1, kSc>(p, stream);
}

// out = bf16(relu(conv_S(src) + bias (+ f32(residual)))), a KS x KS conv (3
// or 1) at stride S (1 or 2), padding KS/2: src (N, H, W, C), w (KS, KS, C,
// COUT) HWIO, bias (COUT,) f32, residual (like out) or nullptr, out (N, Ho,
// Wo, COUT) with Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1; C % 8 == 0 and
// COUT % 8 == 0 (the last 64-channel step and the last tile's columns are
// zero-filled past C and COUT).
template <int KS>
inline cudaError_t launch_conv_fwd_tma(const void* src, const void* w, const float* bias, const void* residual,
                                       void* out, int N, int H, int W, int C, int COUT, int S, cudaStream_t stream) {
  static_assert(KS == 1 || KS == 3, "a 1x1 or a 3x3");
  if (C % 8 != 0 || COUT % 8 != 0 || S < 1 || S > 2) return cudaErrorInvalidValue;
  ConvFwdArgs p;
  memset(&p, 0, sizeof(p));
  conv_fwd_tiles(p, N, (H - 1) / S + 1, (W - 1) / S + 1, COUT);
  p.C = C;
  p.stride = S;
  p.bias = bias;
  p.residual = static_cast<const bf16*>(residual);
  p.out = static_cast<bf16*>(out);
  cudaError_t e = make_tmap_nhwc(&p.amap, src, N, H, W, C, S, p.bw, p.bh, p.bn);
  if (e == cudaSuccess) e = make_tmap_wrows(&p.wmap, w, KS * KS, C, COUT);
  return e == cudaSuccess ? launch_conv_fwd_tiles<KS, false>(p, stream) : e;
}

// out = bf16(relu(src @ w + src2[:, ::S, ::S] @ w2 + bias + bias2)): the
// projection block's conv3 and its shortcut as two 1x1 K segments of ONE
// f32 accumulator, the biases added in that order (projection_block_plain's),
// then relu and one rounding. src (N, Ho, Wo, C) against w (C, COUT), src2
// (N, H, W, C2) read at stride S (1 or 2) against w2 (C2, COUT), out (N, Ho,
// Wo, COUT) with Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1; C, C2 and COUT
// multiples of 8.
inline cudaError_t launch_conv_fwd_tma_sc(const void* src, const void* w, const float* bias, const void* src2,
                                          const void* w2, const float* bias2, void* out, int N, int H, int W, int C,
                                          int C2, int COUT, int S, cudaStream_t stream) {
  if (C % 8 != 0 || C2 % 8 != 0 || COUT % 8 != 0 || S < 1 || S > 2) return cudaErrorInvalidValue;
  ConvFwdArgs p;
  memset(&p, 0, sizeof(p));
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  conv_fwd_tiles(p, N, Ho, Wo, COUT);
  p.C = C;
  p.stride = 1;
  p.C2 = C2;
  p.stride2 = S;
  p.bias = bias;
  p.bias2 = bias2;
  p.out = static_cast<bf16*>(out);
  cudaError_t e = make_tmap_nhwc(&p.amap, src, N, Ho, Wo, C, 1, p.bw, p.bh, p.bn);
  if (e == cudaSuccess) e = make_tmap_wrows(&p.wmap, w, 1, C, COUT);
  if (e == cudaSuccess) e = make_tmap_nhwc(&p.amap2, src2, N, H, W, C2, S, p.bw, p.bh, p.bn);
  if (e == cudaSuccess) e = make_tmap_wrows(&p.wmap2, w2, 1, C2, COUT);
  return e == cudaSuccess ? launch_conv_fwd_tiles<1, true>(p, stream) : e;
}

}  // namespace argus
