// The weight-gradient engine of the redesigned block and chain backwards
// (basic_fused_bwd.cu, proj_bwd_sm90.cuh, identity_bwd_sm90.cuh) and of the
// pointwise backward (pointwise_bwd.cu) on Hopper's warpgroup MMA:
//
//   dW[tap, c, n] = sum_m A_tap[m, c] * B[m, n]
//
// m runs over the output pixels (N*Ho*Wo), A_tap is the source pixel that
// forward tap (ky, kx) reads for output pixel m (oh*stride - pad + ky,
// ow*stride - pad + kx; zero in the padding), B the dense (M, COUT)
// output-side gradient, already masked (`relu_mask_sm90` in
// conv_dgrad_sm90.cuh writes m3 / m2 once), so no mask is applied here.
// Same math as wgrad.cuh, which bwd_prev.cu keeps for timing.
//
// Bound on the H100: tensor-core issue (2 * M * C * COUT FLOP per tap).
// Design:
// - both operands pixel-major in shared memory, 64 pixels per step: wgmma
//   reads them M-major / N-major (transposed, which bf16 allows), so no
//   ldmatrix.trans and no register staging;
// - B arrives by 2-D TMA over (M, COUT) (64 x 64 boxes, 128-byte swizzle,
//   zero fill past M) on an mbarrier; A_tap is gathered by cp.async into the
//   same swizzled layout, its zero fill the padding and the stride-2 taps;
// - a warpgroup's job is 64 source channels x BN gradient channels x TAPS
//   taps: one tap at BN = 128 (64 where the job count is odd or COUT is
//   64), two blocks per SM whose loads and MMAs overlap each other's; or,
//   for a 3x3 over an odd count of 64-channel blocks, the three kx of one
//   ky row (one staged B tile feeds three taps' MMAs, 3 x m64n64
//   accumulators, one block per SM: 0.78 against 0.91 ms for one tap at
//   (512, 64, 64, 64), NVIDIA H100 80GB HBM3 at 700 W);
// - the two warpgroups of a block take two jobs on the same B rows, or,
//   where the job count is odd, the same job on two halves of each 128-row
//   step (`rowsplit`, each half its own partial);
// - the reduction over M is split so that the blocks fill whole waves of
//   132 * minb (`wg90_plan`); each block writes an f32 partial and a second
//   pass adds them in a fixed order: the same inputs give the same bits, no
//   atomics.

#pragma once

#include <algorithm>
#include <cstring>

#include "sm90.cuh"

namespace argus {

struct Wg90Args {
  CUtensorMap bmap;  // B, (M, COUT) rows
  const bf16* a;     // (N, H, W, C) source of the forward conv
  int H, W, C;       // C % 8 == 0
  int ks, stride, pad;
  int COUT, N, Ho, Wo;
  int cblocks, units, splits;  // ceil(C/64); blocks of one split of one n block; splits of M
  int steps_per_split;         // steps of 64 * (1 + rowsplit) rows
  float* out;  // (splits * (1 + rowsplit), ks*ks, C, COUT) partials, or dW when that count is 1
};

constexpr int kWgThreads = 256;
constexpr int kWgSms = 132;       // the H100 SXM's SMs: a wave is 132 * minb blocks
constexpr int kWgMaxWaves = 4;    // splits stop at this many waves
constexpr int kWgMinSteps = 16;   // steps a split reduces at least (1024 or 2048 rows)

template <int TAPS, int BN, int RS, int MINB>
struct Wg90Cfg {
  static constexpr int kRows = 64 * (1 + RS);      // pixel rows per step
  static constexpr int kBBytes = BN * kRows * 2;   // B tile: BN/64 boxes of kRows x 64
  static constexpr int kABytes = 2 * TAPS * 8192;  // two warpgroups x TAPS tiles of 64 x 64
  static constexpr int kStageBytes = kBBytes + kABytes;
  static constexpr int kBudget = MINB == 1 ? 220 * 1024 : 112 * 1024;  // shared memory of MINB blocks per SM
  static constexpr int kStages = kBudget / kStageBytes > 4 ? 4 : kBudget / kStageBytes;  // >= 3
  static constexpr int kWaitMma = kStages >= 4 ? 1 : 0;  // wgmma groups left in flight
  static constexpr int kAhead = kStages - 1 - kWaitMma;   // steps loaded ahead
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 64;
};

template <int TAPS, int BN, int RS, int MINB>
__global__ void __launch_bounds__(kWgThreads, MINB) wgrad_sm90_kernel(const __grid_constant__ Wg90Args p) {
  using Cfg = Wg90Cfg<TAPS, BN, RS, MINB>;
  constexpr int S = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * Cfg::kStageBytes);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lt = tid & 127;
  const int row = lt >> 1;   // the pixel row of the warpgroup's tile this thread gathers
  const int half = lt & 1;   // its chunks: half*4 .. half*4+3 (8 channels each)

  // block -> (n block, split, unit); warpgroup -> job (c block, tap group):
  // neighbouring blocks share their B rows
  const int unit = blockIdx.x % p.units;
  const int rest = blockIdx.x / p.units;
  const int split = rest % p.splits;
  const int n0 = (rest / p.splits) * BN;
  const int job = RS ? unit : unit * 2 + wg;
  const int cb = job % p.cblocks;
  const int tg = job / p.cblocks;
  const int taps = p.ks * p.ks;

  const int64_t M = static_cast<int64_t>(p.N) * p.Ho * p.Wo;
  const int64_t mbeg = static_cast<int64_t>(split) * p.steps_per_split * Cfg::kRows;
  const int64_t mlim = mbeg + static_cast<int64_t>(p.steps_per_split) * Cfg::kRows;
  const int64_t mend = mlim < M ? mlim : M;
  const int T = mbeg < mend ? static_cast<int>((mend - mbeg + Cfg::kRows - 1) / Cfg::kRows) : 0;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto sB = [&](int st) { return smem + st * Cfg::kStageBytes; };
  auto sA = [&](int st, int w, int i) { return smem + st * Cfg::kStageBytes + Cfg::kBBytes + (w * TAPS + i) * 8192; };

  auto load = [&](int t) {
    const int st = t % S;
    const int64_t r0 = mbeg + static_cast<int64_t>(t) * Cfg::kRows;
    if (tid == 0) {
      mbar_expect_tx(&full[st], Cfg::kBBytes);
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
#pragma unroll
        for (int h = 0; h <= RS; ++h)
          tma_load_2d(sB(st) + (b * (1 + RS) + h) * 8192, &p.bmap, &full[st], n0 + b * 64,
                      static_cast<int>(r0 + h * 64));
    }
    const int m = static_cast<int>(r0) + (RS ? wg * 64 : 0) + row;  // M < 2^31
    const bool valid = m < mend;
    int n = 0, oh = 0, ow = 0;
    if (valid) {
      ow = m % p.Wo;
      const int q = m / p.Wo;
      oh = q % p.Ho;
      n = q / p.Ho;
    }
#pragma unroll
    for (int i = 0; i < TAPS; ++i) {
      const int ky = TAPS == 3 ? tg : tg / p.ks, kx = TAPS == 3 ? i : tg % p.ks;  // a ky row of a 3x3, or one tap
      const int ih = oh * p.stride - p.pad + ky;
      const int iw = ow * p.stride - p.pad + kx;
      const bool inb = valid && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
      const bf16* base = p.a + ((static_cast<int64_t>(n) * p.H + ih) * p.W + iw) * p.C;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = cb * 64 + (half * 4 + v) * 8;
        const bool ok = inb && c < p.C;
        cp_async16(sA(st, wg, i) + swz(row, half * 4 + v), ok ? base + c : p.a, ok);
      }
    }
  };

  constexpr int R = BN / 2;
  float acc[TAPS][R];
#pragma unroll
  for (int i = 0; i < TAPS; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < Cfg::kAhead; ++t) {
    if (t < T) load(t);
    cp_async_commit();
  }

  for (int t = 0; t < T; ++t) {
    const int st = t % S;
    cp_async_wait<Cfg::kAhead - 1>();
    fence_proxy_async();
    mbar_wait(&full[st], (t / S) & 1);
    __syncthreads();
    if (t + Cfg::kAhead < T) load(t + Cfg::kAhead);
    cp_async_commit();

#pragma unroll
    for (int i = 0; i < TAPS; ++i) fence_regs(acc[i]);
    wgmma_fence();
    const uint32_t b0 = smem_u32(sB(st)) + (RS ? wg * 8192 : 0);
#pragma unroll
    for (int i = 0; i < TAPS; ++i) {
      const uint32_t a0 = smem_u32(sA(st, wg, i));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<BN, 1>(acc[i], sw128_desc(a0 + kk * 2048, 0), sw128_desc(b0 + kk * 2048, Cfg::kRows * 128), 1);
    }
    wgmma_commit();
    wgmma_wait<Cfg::kWaitMma>();
#pragma unroll
    for (int i = 0; i < TAPS; ++i) fence_regs(acc[i]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < TAPS; ++i) fence_regs(acc[i]);
  cp_async_wait<0>();

  const int part = RS ? split * 2 + wg : split;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
#pragma unroll
  for (int i = 0; i < TAPS; ++i) {
    float* out = p.out + (static_cast<int64_t>(part) * taps + tg * TAPS + i) * p.C * p.COUT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = cb * 64 + warp * 16 + (lane >> 2) + 8 * h;
      if (c >= p.C) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + (lane & 3) * 2;
        if (n >= p.COUT) continue;
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(c) * p.COUT + n) =
            make_float2(acc[i][j * 4 + h * 2], acc[i][j * 4 + h * 2 + 1]);
      }
    }
  }
}

// dW[i] = sum over s of partial[s][i], in partial order; n4 float4s per partial.
__global__ void wgrad_sum_sm90_kernel(const float4* __restrict__ part, float4* __restrict__ out, int64_t n4,
                                      int parts) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float4 s = part[i];
    for (int k = 1; k < parts; ++k) {
      const float4 v = part[k * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

// The work plan of one weight gradient, mirrored in Python by
// ops/kernels/wgrad_plan.py (which sizes the workspace and whose tests
// check the cover): the tile shape, the jobs, and the splits of M.
struct Wg90Plan {
  int taps_per_job, bn, rowsplit, minb;  // minb: blocks resident on one SM
  int cblocks, jobs, units, nblocks;  // units: blocks of one split per n block
  int splits, steps_per_split, parts;
  int64_t partial_elems;  // f32 the partials take (0 when parts == 1)
};

inline Wg90Plan wg90_plan(int64_t M, int C, int COUT, int ks) {
  Wg90Plan q;
  const int taps = ks * ks;
  q.cblocks = (C + 63) / 64;
  // a 3x3 over an odd count of 64-channel blocks: three taps a job, one
  // block per SM; else one tap a job, two blocks per SM (whose loads and
  // MMAs overlap each other's)
  const bool three = ks == 3 && q.cblocks % 2 == 1;
  q.taps_per_job = three ? 3 : 1;
  q.minb = three ? 1 : 2;
  q.jobs = q.cblocks * (taps / q.taps_per_job);
  q.rowsplit = q.jobs % 2;
  q.bn = (three || q.rowsplit || COUT <= 64) ? 64 : 128;
  q.units = q.rowsplit ? q.jobs : q.jobs / 2;
  q.nblocks = (COUT + q.bn - 1) / q.bn;
  const int64_t rows = 64 * (1 + q.rowsplit);
  const int64_t steps = (M + rows - 1) / rows;
  const int64_t tiles = static_cast<int64_t>(q.units) * q.nblocks;
  const int64_t elems = static_cast<int64_t>(taps) * C * COUT;
  // the split count whose blocks fill the last wave best, at most
  // kWgMaxWaves waves and at least kWgMinSteps steps a split (the first of
  // equally good counts: fewer partials)
  const int64_t slots = static_cast<int64_t>(kWgSms) * q.minb;  // blocks in one wave
  const int64_t most = std::min<int64_t>(std::max<int64_t>(1, steps / kWgMinSteps),
                                         std::max<int64_t>(1, (kWgMaxWaves * slots) / tiles));
  int64_t best = 1;
  double best_eff = -1.0;
  for (int64_t s = 1; s <= most; ++s) {
    const int64_t blocks = tiles * s;
    const int64_t waves = (blocks + slots - 1) / slots;
    const double eff = static_cast<double>(blocks) / static_cast<double>(waves * slots);
    if (eff > best_eff + 1e-9) {
      best_eff = eff;
      best = s;
    }
  }
  int64_t sps = (steps + best - 1) / best;
  q.splits = static_cast<int>(std::max<int64_t>(1, (steps + sps - 1) / sps));
  q.steps_per_split = static_cast<int>(std::max<int64_t>(1, sps));
  q.parts = q.splits * (1 + q.rowsplit);
  q.partial_elems = q.parts > 1 ? q.parts * elems : 0;
  return q;
}

// static: each kernel library keeps its own once-only state
template <int TAPS, int BN, int RS, int MINB>
static inline cudaError_t launch_wgrad_cfg(const Wg90Args& p, unsigned blocks, cudaStream_t stream) {
  using Cfg = Wg90Cfg<TAPS, BN, RS, MINB>;
  static bool opted = false;  // the shared-memory opt-in, once per instantiation
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(wgrad_sm90_kernel<TAPS, BN, RS, MINB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  wgrad_sm90_kernel<TAPS, BN, RS, MINB><<<blocks, kWgThreads, Cfg::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// dw (ks*ks, C, COUT) f32 = the tap-wise weight gradient of the source a
// (N, H, W, C) against the masked gradient b (N*Ho*Wo, COUT); `ws` holds
// `ws_elems` f32 for the partials, at least `wg90_plan(...).partial_elems`
// (the wrappers size it with the Python mirror, wgrad_plan.py), else the
// launch is refused.
inline cudaError_t wgrad_sm90(const void* a, int H, int W, int C, int ks, int stride, int pad, const void* b,
                              int COUT, int N, int Ho, int Wo, void* dw, void* ws, int64_t ws_elems,
                              cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(N) * Ho * Wo;
  const Wg90Plan q = wg90_plan(M, C, COUT, ks);
  if (q.parts > 1 && (ws == nullptr || ws_elems < q.partial_elems)) return cudaErrorInvalidValue;
  Wg90Args p;
  memset(&p, 0, sizeof(p));
  cudaError_t e = make_tmap_2d(&p.bmap, b, M, COUT, COUT);
  if (e != cudaSuccess) return e;
  p.a = static_cast<const bf16*>(a);
  p.H = H;
  p.W = W;
  p.C = C;
  p.ks = ks;
  p.stride = stride;
  p.pad = pad;
  p.COUT = COUT;
  p.N = N;
  p.Ho = Ho;
  p.Wo = Wo;
  p.cblocks = q.cblocks;
  p.units = q.units;
  p.splits = q.splits;
  p.steps_per_split = q.steps_per_split;
  p.out = static_cast<float*>(q.parts > 1 ? ws : dw);
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(q.units) * q.splits * q.nblocks);
  if (q.taps_per_job == 3)  // rowsplit: the job count 3 * cblocks is odd
    e = launch_wgrad_cfg<3, 64, 1, 1>(p, blocks, stream);
  else if (q.bn == 64)
    e = q.rowsplit ? launch_wgrad_cfg<1, 64, 1, 2>(p, blocks, stream) : launch_wgrad_cfg<1, 64, 0, 2>(p, blocks, stream);
  else  // bn 128 only without rowsplit
    e = launch_wgrad_cfg<1, 128, 0, 2>(p, blocks, stream);
  if (e != cudaSuccess || q.parts == 1) return e;
  const int64_t n4 = static_cast<int64_t>(ks) * ks * C * COUT / 4;
  const int sblocks = static_cast<int>(std::min<int64_t>((n4 + 255) / 256, 4 * kWgSms));
  wgrad_sum_sm90_kernel<<<sblocks, 256, 0, stream>>>(static_cast<const float4*>(ws), static_cast<float4*>(dw), n4,
                                                     q.parts);
  return cudaGetLastError();
}

}  // namespace argus
