// ResNet stem weight gradient from the saving forward's outputs: the pool
// cotangent routed to each window's first maximum, the relu mask, one
// rounding to bf16, then dW = sum over pixels of tap^T * dacc in f32.
//
//   dacc[n, i, j, c] = bf16(sum of g[n, u, v, c] over the pool windows (u, v)
//                      whose first element (row-major over conv rows 2u-1..2u+1
//                      and columns 2v-1..2v+1) equal to out[n, u, v, c] is
//                      (i, j), where y[n, i, j, c] > 0)
//   dW[ky, kx, ci, c]  = sum over n < n_images, i, j of
//                      x[n, 2i-3+ky, 2j-3+kx, ci] * dacc[n, i, j, c]   (f32)
//
// Replaces: argus_tpu/ops/pallas/stem_fused.py `_stem_bwd_pallas` (:304,
// body `_stem_bwd_kernel` :194): first-match take masks (`_POOL_TERMS`,
// XLA's select-and-scatter tie order), the relu mask, dacc rounded to the
// activation dtype, the dW accumulator carried across the TPU's sequential
// grid in f32 VMEM scratch over the first `n_images` images only.
//
// Bound on the H100: bytes at full width. 2 * 147 * 64 FLOP per conv pixel
// (1.58e11 at N = 512, 256x256: 0.16 ms on the tensor cores) against the
// reads of x, g, out and y (1.81 GB: 0.54 ms); a subsampled gradient reads
// n_images / N of it. Design: a persistent grid, one block an SM, walks a
// contiguous range of 16x16 conv-pixel tiles, warp-specialised:
// - a producer warp keeps the next tiles' operands in flight through a ring
//   of kStages shared-memory stages on mbarriers: y as one TMA box of 19 x 19
//   conv pixels x 64 channels (conv rows and columns i0-1 .. i0+17, the pool
//   windows' reach), out and g as 9 x 9 boxes of the windows that touch the
//   tile, and the 37 x 37 x 3 input patch as a box of 37 rows x 128
//   elements of x viewed as (N, H, W * 3), from column 2 j0 - 8 (its 3
//   channels cannot be a TMA dimension of their own: a global stride must
//   be a multiple of 16 bytes, and so must the box's innermost start, or
//   the copy faults); where W % 8 != 0 the view's row stride is not one
//   either, and the producer's lanes copy the patch by 4-byte cp.async.
//   Zero fill past the tensors is the conv's and the pool's padding, and a
//   tile past the edge;
// - twelve search warps find each window's first maximum in the staged y,
//   four channels an item (compared with out as bits: only out > 0 passes
//   its cotangent on, and a positive bf16 equals another exactly when its
//   bits do), gate its cotangent by out > 0 (the winner's y is out, so this
//   is the relu mask), then form each pixel's dacc from the up to four
//   windows it wins, in argus_tpu's order (window rows 2u+1 before 2u-1,
//   likewise columns), into shared memory in the 128-byte-swizzled layout
//   of a wgmma B operand;
// - three product warpgroups run dW^T (taps x channels) += A (taps x 256
//   pixels) * dacc (pixels x channels) on wgmma: M = taps in three 64-row
//   slices (147 real of 192), one a warpgroup, A in registers (the m16n8k16
//   fragment of each warp's 16 taps, gathered from the staged patch), B =
//   dacc from shared memory, 16 k-steps of 16 pixels (one tile row each).
//   One tile's product runs while the search warps find the next tile's
//   windows; two hardware barriers hand dacc over (full, free). The product
//   alone on staged data is about half the time of the mma.sync form it
//   replaces (PERF.md §6, scripts/time_torch_kernel_phases.py).
// Each block's f32 partial goes to the workspace; the last block of each
// group of blocks to finish (a ticket) adds its group's partials in block
// order, and the last group to finish adds the group sums in order: one
// launch, no atomics on dW, the same bits from run to run. The tickets are
// the host's, one set a CUDA stream, left 0 by their last blocks. The TPU's
// 4x4 space-to-depth feed and parity packing are not carried over.

#include <cstring>

#include "sm90.cuh"

// Phase cuts for scripts/time_torch_kernel_phases.py (all 0: the kernel):
// no window search and dacc, no product, only the patch staged, the
// partials added by one last block instead of the two-level tree
#ifndef STEM_NOSEARCH
#define STEM_NOSEARCH 0
#endif
#ifndef STEM_NOMMA
#define STEM_NOMMA 0
#endif
#ifndef STEM_XONLY
#define STEM_XONLY 0
#endif
#ifndef STEM_ONE_LEVEL
#define STEM_ONE_LEVEL 0
#endif

namespace argus {

constexpr int kBT = 16;                    // conv pixels per tile edge
constexpr int kBPix = kBT * kBT;           // pixels per tile: the product's K per tile
constexpr int kBW = kBT / 2 + 1;           // pool windows per tile edge that touch it (9)
constexpr int kYE = kBT + 3;               // y box edge: conv rows i0-1 .. i0+17 (19)
constexpr int kBPE = 2 * (kBT - 1) + 7;    // input patch edge (37)
constexpr int kBCIN = 3;
constexpr int kBCOUT = 64;
constexpr int kBKR = 7 * 7 * kBCIN;        // real taps (147)
constexpr int kXCol0 = 8;                  // the patch starts at column 2 j0 - kXCol0 (the taps' is 2 j0 - 3)
constexpr int kXRow = 128;                 // patch row: 42 columns x 3 channels and 2 elements
constexpr int kXWords = 63;                // 4-byte words a patch row copies by cp.async (42 columns)
constexpr int kStages = 2;
constexpr int kARing = 4;                  // register sets of A fragments in flight
constexpr int kMma = 384;                  // three product warpgroups: taps 0..191
constexpr int kSearch = 384;               // twelve search warps
constexpr int kBThreads = kMma + kSearch + 32;  // + the producer warp
constexpr int kBarSearch = 1, kBarDaccFull = 2, kBarDaccFree = 3;  // hardware barriers

constexpr int kYBytes = kYE * kYE * kBCOUT * 2;   // 46208
constexpr int kWinBytes = kBW * kBW * kBCOUT * 2; // 10368 (out, g)
constexpr int kXBytes = ((kBPE * kXRow * 2 + 127) / 128) * 128;
constexpr int kStageBytes = kYBytes + 2 * kWinBytes + kXBytes;  // multiple of 128
constexpr int kDaccBytes = kBPix * 128;           // 256 pixel rows of 64 channels, swizzled
constexpr int kGBytes = kBW * kBW * kBCOUT * 2;   // gated window cotangents
constexpr int kWBytes = kBW * kBW * kBCOUT;       // window winners (0..8, 9 none)
constexpr int kBwdSmem = 1024 + kStages * kStageBytes + kDaccBytes + kGBytes + kWBytes + 4 * kStages * 8;

struct StemBwdArgs {
  CUtensorMap ymap;    // y (N, Hc, Wc, 64): boxes of 64 x 19 x 19 x 1
  CUtensorMap omap;    // out (N, Hp, Wp, 64): boxes of 64 x 9 x 9 x 1
  CUtensorMap gmap;    // g, as out
  CUtensorMap xmap;    // x as (N, H, W * 3): boxes of 128 x 37 x 1 (xtma)
  const bf16* x;       // (N, H, W, 3)
  int xtma;            // the patch by TMA (W % 8 == 0), else by cp.async
  float* partial;      // (blocks + groups, 147, 64)
  float* dw;           // (147, 64)
  unsigned int* ticket;  // groups + 1 counters, 0 before the launch; the last blocks reset them
  int H, W, Hc, Wc, tiles_y, tiles_x, per, groups, gsize;
  int64_t tiles;       // n_images * tiles_y * tiles_x
};

// D (64 x 64 f32, one warpgroup) += A (64 x 16, registers: each warp's 16
// rows as the m16n8k16 A fragment) * B (16 x 64, shared memory, N-major)
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// the search warps' barrier
__device__ __forceinline__ void search_sync() { named_barrier(kBarSearch, kSearch); }

// the last of `count` blocks to arrive at *t (after a __threadfence of their
// writes) gets true and resets *t
__device__ __forceinline__ bool last_of(unsigned int* t, unsigned int count, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(t, 1u) == count - 1;
    if (last) *t = 0u;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// dst[e] = sum over k < n of src[k * stride + e] in k order, e < 147 * 64, as float4 columns
__device__ void sum_partials(const float* src, int64_t stride, int n, float* dst) {
  constexpr int kCols = kBKR * kBCOUT / 4;
  for (int c = threadIdx.x; c < kCols; c += kBThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(src + k * stride) + c);
      v.x = __fadd_rn(v.x, u.x);
      v.y = __fadd_rn(v.y, u.y);
      v.z = __fadd_rn(v.z, u.z);
      v.w = __fadd_rn(v.w, u.w);
    }
    reinterpret_cast<float4*>(dst)[c] = v;
  }
}

__global__ void __launch_bounds__(kBThreads, 1) stem_bwd_kernel(const __grid_constant__ StemBwdArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sDacc = smem;                                   // 1024-aligned: the wgmma B tile
  uint8_t* ring = smem + kDaccBytes;                       // kStages x [y | out | g | x]
  uint2* sG = reinterpret_cast<uint2*>(ring + kStages * kStageBytes);  // four channels' gated cotangents
  uint32_t* sWin = reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(sG) + kGBytes);  // four winners
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(sWin) + kWBytes);
  uint64_t* empty = full + kStages;
  __shared__ int flag;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t t_beg = static_cast<int64_t>(blockIdx.x) * p.per;
  const int64_t t_end = t_beg + p.per < p.tiles ? t_beg + p.per : p.tiles;
  const int ntile = static_cast<int>(t_end - t_beg);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], p.xtma ? 1 : 1 + 32);  // the TMA's expect_tx (and the producer lanes' cp.asyncs)
      mbar_init(&empty[s], (kMma + kSearch) / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kBThreads / 32 - 1) {
    // the producer
    for (int k = 0; k < ntile; ++k) {
      const int64_t t = t_beg + k;
      const int tx = static_cast<int>(t % p.tiles_x);
      const int ty = static_cast<int>((t / p.tiles_x) % p.tiles_y);
      const int n = static_cast<int>(t / (static_cast<int64_t>(p.tiles_x) * p.tiles_y));
      const int i0 = ty * kBT, j0 = tx * kBT;
      const int st = k % kStages;
      uint8_t* stage = ring + st * kStageBytes;
      if (k >= kStages) mbar_wait(&empty[st], ((k / kStages) - 1) & 1);
      // the patch: input rows 2 i0 - 3 .., columns from 2 j0 - 8 (3 ix0 a
      // multiple of 8 elements: 16 bytes)
      bf16* xs = reinterpret_cast<bf16*>(stage + kYBytes + 2 * kWinBytes);
      const int iy0 = 2 * i0 - 3, ix0 = 2 * j0 - kXCol0;
      if (lane == 0) {
        mbar_expect_tx(&full[st], (STEM_XONLY ? 0 : kYBytes + 2 * kWinBytes) + (p.xtma ? kBPE * kXRow * 2 : 0));
#if !STEM_XONLY
        tma_load_4d(stage, &p.ymap, &full[st], 0, j0 - 1, i0 - 1, n);
        tma_load_4d(stage + kYBytes, &p.omap, &full[st], 0, j0 / 2, i0 / 2, n);
        tma_load_4d(stage + kYBytes + kWinBytes, &p.gmap, &full[st], 0, j0 / 2, i0 / 2, n);
#endif
        if (p.xtma) tma_load_3d(xs, &p.xmap, &full[st], 3 * ix0, iy0, n);
      }
      if (p.xtma) continue;
      // by cp.async: the column ix0 is even, so a word never straddles the
      // image's edge (W % 4 == 0)
      for (int e = lane; e < kBPE * kXWords; e += 32) {
        const int r = e / kXWords, wd = e % kXWords;
        const int iy = iy0 + r, ix = ix0 + (2 * wd) / 3;  // the word's first element's column
        const bool ok = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
        const bf16* src = ok ? p.x + ((static_cast<int64_t>(n) * p.H + iy) * p.W + ix0) * kBCIN + 2 * wd : p.x;
        cp_async4(xs + r * kXRow + 2 * wd, src, ok);
      }
      cp_async_arrive(&full[st]);
    }
  } else if (warp >= kMma / 32) {
    // the search warps: each window's first maximum, then dacc
    const int sid = tid - kMma;
    for (int k = 0; k < ntile; ++k) {
      const int64_t t = t_beg + k;
      const int tx = static_cast<int>(t % p.tiles_x);
      const int ty = static_cast<int>((t / p.tiles_x) % p.tiles_y);
      const int i0 = ty * kBT, j0 = tx * kBT;
      const int st = k % kStages;
      const uint8_t* stage = ring + st * kStageBytes;
      const uint2* sy = reinterpret_cast<const uint2*>(stage);
      const uint2* so = reinterpret_cast<const uint2*>(stage + kYBytes);
      const uint2* sg = reinterpret_cast<const uint2*>(stage + kYBytes + kWinBytes);
      mbar_wait(&full[st], (k / kStages) & 1);

#if !STEM_NOSEARCH
      // each window's first maximum (9: none) and its cotangent where out > 0:
      // item (window, four channels), y box rows 2 wu + k / 3, columns 2 wv + k % 3
      for (int e = sid; e < kBW * kBW * (kBCOUT / 4); e += kSearch) {
        const int cq = e & 15, wpos = e >> 4;
        const int wu = wpos / kBW, wv = wpos % kBW;
        const uint2 o = so[wpos * 16 + cq];
        const uint2* yw = sy + (2 * wu * kYE + 2 * wv) * 16 + cq;
        uint32_t win[4] = {9, 9, 9, 9};
#pragma unroll
        for (int kk = 8; kk >= 0; --kk) {  // scanned backwards: the last match kept is the first
          const uint2 yv = yw[((kk / 3) * kYE + kk % 3) * 16];
          const uint32_t d0 = yv.x ^ o.x, d1 = yv.y ^ o.y;
          win[0] = (d0 & 0xffffu) == 0 ? kk : win[0];
          win[1] = (d0 >> 16) == 0 ? kk : win[1];
          win[2] = (d1 & 0xffffu) == 0 ? kk : win[2];
          win[3] = (d1 >> 16) == 0 ? kk : win[3];
        }
        // out > 0: a positive bf16 (sign clear, not zero)
        const uint2 gv = sg[wpos * 16 + cq];
        const uint32_t m0 = (static_cast<int16_t>(o.x & 0xffffu) > 0 ? 0xffffu : 0u) |
                            (static_cast<int16_t>(o.x >> 16) > 0 ? 0xffff0000u : 0u);
        const uint32_t m1 = (static_cast<int16_t>(o.y & 0xffffu) > 0 ? 0xffffu : 0u) |
                            (static_cast<int16_t>(o.y >> 16) > 0 ? 0xffff0000u : 0u);
        sG[wpos * 16 + cq] = make_uint2(gv.x & m0, gv.y & m1);
        sWin[wpos * 16 + cq] = win[0] | (win[1] << 8) | (win[2] << 16) | (win[3] << 24);
      }
#endif
      search_sync();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // y, out and g are read (the patch waits for the product)
      named_barrier(kBarDaccFree, kMma + kSearch);  // the previous tile's product has read dacc

#if !STEM_NOSEARCH
      // dacc of the 2 x 2 pixels of window cell (a, b): windows (a, b), (a+1,
      // b), (a, b+1), (a+1, b+1), rows 2u+1 before 2u-1, likewise columns,
      // summed in f32 and rounded once; pixels past the conv output get 0;
      // item (cell, four channels)
      for (int e = sid; e < (kBT / 2) * (kBT / 2) * (kBCOUT / 4); e += kSearch) {
        const int cq = e & 15, cell = e >> 4;
        const int a = cell >> 3, b = cell & 7;
        const int w00 = a * kBW + b, w10 = w00 + kBW, w01 = w00 + 1, w11 = w10 + 1;
        const uint2 g00 = sG[w00 * 16 + cq], g10 = sG[w10 * 16 + cq], g01 = sG[w01 * 16 + cq],
                    g11 = sG[w11 * 16 + cq];
        const uint32_t n00 = sWin[w00 * 16 + cq], n10 = sWin[w10 * 16 + cq], n01 = sWin[w01 * 16 + cq],
                       n11 = sWin[w11 * 16 + cq];
        // channel h's cotangent where the window's winner is kk, else 0
        auto take = [](uint32_t win, uint2 g, int h, int kk) {
          const uint32_t bits = ((h < 2 ? g.x : g.y) >> (16 * (h & 1))) << 16;
          return ((win >> (8 * h)) & 0xffu) == static_cast<uint32_t>(kk) ? __uint_as_float(bits) : 0.f;
        };
        float d[4][4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          d[0][h] = 0.f + take(n00, g00, h, 4);                                          // (2a, 2b)
          d[1][h] = (0.f + take(n01, g01, h, 3)) + take(n00, g00, h, 5);                 // (2a, 2b+1)
          d[2][h] = (0.f + take(n10, g10, h, 1)) + take(n00, g00, h, 7);                 // (2a+1, 2b)
          d[3][h] = (((0.f + take(n11, g11, h, 0)) + take(n10, g10, h, 2)) + take(n01, g01, h, 6)) +
                    take(n00, g00, h, 8);                                                // (2a+1, 2b+1)
        }
#pragma unroll
        for (int px = 0; px < 4; ++px) {
          const int li = 2 * a + (px >> 1), lj = 2 * b + (px & 1);
          const bool in = i0 + li < p.Hc && j0 + lj < p.Wc;
          const __nv_bfloat162 lo = __floats2bfloat162_rn(in ? d[px][0] : 0.f, in ? d[px][1] : 0.f);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(in ? d[px][2] : 0.f, in ? d[px][3] : 0.f);
          *reinterpret_cast<uint2*>(sDacc + swz(li * kBT + lj, cq >> 1) + (cq & 1) * 8) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
        }
      }
#endif
      fence_proxy_async();  // dacc's generic stores -> the wgmma's reads
      named_arrive(kBarDaccFull, kMma + kSearch);
      search_sync();  // sG and sWin are read: the next tile's search may write them
    }
  } else {
    // the product warpgroups: tile k's product runs while the search warps
    // find tile k + 1's windows
    const int wg = warp >> 2;  // warpgroup: taps 64 wg .. 64 wg + 63
    const int ka = wg * 64 + (warp & 3) * 16 + (lane >> 2), kb = ka + 8;
    // a tap's offset in the patch: row ky, column kx + kXCol0 - 3, channel ci
    auto tap_off = [](int k) {
      if (k >= kBKR) return 0;
      const int ky = k / (7 * kBCIN), rem = k % (7 * kBCIN);
      return ky * kXRow + (rem / kBCIN + kXCol0 - 3) * kBCIN + rem % kBCIN;
    };
    const int oa = tap_off(ka), ob = tap_off(kb);
    const int q2 = (lane & 3) * 2;  // the fragment's first pixel (column) of a k-step
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    uint32_t af[kARing][4];
    const uint32_t dacc_u32 = smem_u32(sDacc);
    named_arrive(kBarDaccFree, kMma + kSearch);  // dacc starts free
    for (int k = 0; k < ntile; ++k) {
      const int st = k % kStages;
      const bf16* xs = reinterpret_cast<const bf16*>(ring + st * kStageBytes + kYBytes + 2 * kWinBytes);
      mbar_wait(&full[st], (k / kStages) & 1);  // the patch
      named_barrier(kBarDaccFull, kMma + kSearch);

      // dW^T (taps x 64) += A (taps x 256 pixels) * dacc, a warpgroup's 64 taps,
      // k-step ks = tile row ks; A[tap][pixel (ks, j)] = patch[2 ks][6 j + off(tap)]
      // The A fragments go through a ring of kARing register sets: set ks %
      // kARing is written once the product that last read it (k-step ks -
      // kARing, one commit group a k-step) has completed, and each write is
      // fenced before the product that reads it.
#if !STEM_NOMMA
#pragma unroll
      for (int ks = 0; ks < kBT; ++ks) {
        uint32_t* a = af[ks % kARing];
        if (ks >= kARing) wgmma_wait<kARing - 1>();
        const bf16* xr = xs + 2 * ks * kXRow + 6 * q2;
        a[0] = pack_bf16x2(xr[oa], xr[oa + 6]);
        a[1] = pack_bf16x2(xr[ob], xr[ob + 6]);
        a[2] = pack_bf16x2(xr[oa + 48], xr[oa + 54]);
        a[3] = pack_bf16x2(xr[ob + 48], xr[ob + 54]);
        wgmma_fence();
        wgmma_m64n64_rs(acc, af[ks % kARing], sw128_desc(dacc_u32 + ks * kBT * 128, 0));
        wgmma_commit();
      }
#endif
      wgmma_wait<0>();
      if (k + 1 < ntile) named_arrive(kBarDaccFree, kMma + kSearch);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // the patch is read
    }
    fence_regs(acc);
    // this block's partial, rows < 147 of the warpgroup's D: d[4j + e] is
    // (tap 16 w + lane / 4 + 8 (e / 2), channel 8 j + 2 (lane % 4) + e % 2)
    float* dst = p.partial + static_cast<int64_t>(blockIdx.x) * kBKR * kBCOUT;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + q2;
      if (ka < kBKR) *reinterpret_cast<float2*>(dst + ka * kBCOUT + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
      if (kb < kBKR) *reinterpret_cast<float2*>(dst + kb * kBCOUT + c) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }

#if STEM_ONE_LEVEL
  if (!last_of(p.ticket, gridDim.x, &flag)) return;
  sum_partials(p.partial, kBKR * kBCOUT, gridDim.x, p.dw);
  return;
#endif
  // the group's sum by its last block, then the groups' by the last group
  const int grp = blockIdx.x / p.gsize;
  const int g0 = grp * p.gsize, gn = min(p.gsize, static_cast<int>(gridDim.x) - g0);
  if (!last_of(p.ticket + grp, gn, &flag)) return;
  const int64_t part = kBKR * kBCOUT;
  float* gsum = p.partial + (static_cast<int64_t>(gridDim.x) + grp) * part;
  sum_partials(p.partial + g0 * part, part, gn, gsum);
  if (!last_of(p.ticket + p.groups, p.groups, &flag)) return;
  sum_partials(p.partial + static_cast<int64_t>(gridDim.x) * part, part, p.groups, p.dw);
}

// Host: a 3-D bf16 tensor map of x (N, H, W, 3) viewed as (N, H, W * 3),
// boxes of 128 elements x 37 rows x 1 landing row-major, zero fill outside;
// W % 8 == 0 (a row's bytes a multiple of 16)
inline cudaError_t make_tmap_patch(CUtensorMap* map, const void* base, int N, int H, int W) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(3 * W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t row = static_cast<cuuint64_t>(3 * W) * 2;
  const cuuint64_t strides[2] = {row, row * H};
  const cuuint32_t box[3] = {kXRow, kBPE, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Host: a 4-D bf16 tensor map of an NHWC (N, H, W, 64) tensor, boxes of 64
// channels x bw x bh x 1 pixels landing row-major (no swizzle), zero fill
// outside the tensor
inline cudaError_t make_tmap_box(CUtensorMap* map, const void* base, int N, int H, int W, int bw, int bh) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {kBCOUT, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t row = kBCOUT * 2;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {kBCOUT, static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bh), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace argus

// dW (7, 7, 3, 64) f32 over the first n_images images: `blocks` (at most the
// tile count) persistent blocks in groups of `gsize`; partial: (blocks +
// groups, 147, 64) f32; ticket: groups + 1 uint32, 0, of the stream's own
// (the launch leaves them 0)
extern "C" int argus_stem_bwd(const void* x, const void* g, const void* out, const void* y, void* partial,
                              void* dw, void* ticket, int n_images, int H, int W, int blocks, int gsize,
                              void* stream) {
  using namespace argus;
  StemBwdArgs p;
  memset(&p, 0, sizeof(p));
  p.x = static_cast<const bf16*>(x);
  p.partial = static_cast<float*>(partial);
  p.dw = static_cast<float*>(dw);
  p.ticket = static_cast<unsigned int*>(ticket);
  p.H = H;
  p.W = W;
  p.Hc = (H - 1) / 2 + 1;
  p.Wc = (W - 1) / 2 + 1;
  const int Hp = (p.Hc - 1) / 2 + 1, Wp = (p.Wc - 1) / 2 + 1;
  p.tiles_y = (p.Hc + kBT - 1) / kBT;
  p.tiles_x = (p.Wc + kBT - 1) / kBT;
  p.tiles = static_cast<int64_t>(n_images) * p.tiles_y * p.tiles_x;
  if (blocks < 1 || blocks > p.tiles || gsize < 1 || H % 4 || W % 4 || ticket == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  p.per = static_cast<int>((p.tiles + blocks - 1) / blocks);
  blocks = static_cast<int>((p.tiles + p.per - 1) / p.per);  // every block has a tile
  p.gsize = gsize;
  p.groups = (blocks + gsize - 1) / gsize;
  cudaError_t e = make_tmap_box(&p.ymap, y, n_images, p.Hc, p.Wc, kYE, kYE);
  if (e == cudaSuccess) e = make_tmap_box(&p.omap, out, n_images, Hp, Wp, kBW, kBW);
  if (e == cudaSuccess) e = make_tmap_box(&p.gmap, g, n_images, Hp, Wp, kBW, kBW);
  p.xtma = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (e == cudaSuccess && p.xtma) e = make_tmap_patch(&p.xmap, x, n_images, H, W);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool ready = false;  // once: the shared-memory opt-in
  if (!ready) {
    e = cudaFuncSetAttribute(stem_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  stem_bwd_kernel<<<blocks, kBThreads, kBwdSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
