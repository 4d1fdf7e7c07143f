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
// n_images / N of it. Design: a block walks a contiguous range of 16x16 conv
// pixel tiles. Per tile it stages the (37 x 37 x 3) input patch, finds the
// first maximum of each of the 9 x 9 pool windows that touch the tile (y
// read through L1, compared with out), gates its cotangent by out > 0 (the
// winner's y is out, so this is the relu mask), then forms each pixel's
// dacc from the up to four windows it wins, in argus_tpu's order
// (window rows 2u+1 before 2u-1, likewise columns), into shared memory. The
// reduction dW^T (taps x channels) += A (taps x pixels) * dacc (pixels x
// channels) runs on the tensor cores (mma.sync m16n8k16; ten warps, one
// m16 tile of taps each, K = 147 padded to 160 with A gathered from the
// patch through per-tap offsets, as the forward gathers it). Each block
// writes its own f32 partial and a second kernel adds the partials in block
// order: the result is deterministic (no atomics). The TPU's 4x4
// space-to-depth feed and parity packing are not carried over.

#include "common.cuh"

namespace argus {

constexpr int kBT = 16;                    // conv pixels per tile edge
constexpr int kBPix = kBT * kBT;           // pixels per tile: the MMA's K per tile
constexpr int kBW = kBT / 2 + 1;           // pool windows per tile edge that touch it (9)
constexpr int kBPE = 2 * (kBT - 1) + 7;    // input patch edge (37)
constexpr int kBCIN = 3;
constexpr int kBCOUT = 64;
constexpr int kBKR = 7 * 7 * kBCIN;        // real taps (147)
constexpr int kBLdD = kBCOUT + 8;          // padded shared rows: conflict-free ldmatrix
constexpr int kBThreads = 320;             // ten warps: taps 0..159
constexpr int kBPatch = kBPE * kBPE * kBCIN;

constexpr int kSmemD = kBPix * kBLdD * 2;                        // dacc tile
constexpr int kSmemG = kBW * kBW * kBCOUT * 2;                   // gated window cotangents
constexpr int kSmemX = ((kBPatch * 2 + 15) / 16) * 16;           // input patch
constexpr int kSmemWin = kBW * kBW * kBCOUT;                     // window winners (0..8, 9 none)
constexpr int kSmemPB = kBPix * 4;                               // pixel -> patch offset
constexpr int kBwdSmem = kSmemD + kSmemG + kSmemX + kSmemWin + kSmemPB;

struct StemBwdArgs {
  const bf16* x;    // (N, H, W, 3)
  const bf16* g;    // (N, Hp, Wp, 64)
  const bf16* out;  // (N, Hp, Wp, 64)
  const bf16* y;    // (N, Hc, Wc, 64)
  float* partial;   // (blocks, 147, 64)
  int H, W, Hc, Wc, Hp, Wp, tiles_y, tiles_x;
  int64_t tiles;    // n_images * tiles_y * tiles_x
};

__global__ void __launch_bounds__(kBThreads) stem_bwd_kernel(const __grid_constant__ StemBwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sD = reinterpret_cast<bf16*>(smem);
  bf16* sG = reinterpret_cast<bf16*>(smem + kSmemD);
  bf16* sX = reinterpret_cast<bf16*>(smem + kSmemD + kSmemG);
  uint8_t* sWin = smem + kSmemD + kSmemG + kSmemX;
  int* sPB = reinterpret_cast<int*>(smem + kSmemD + kSmemG + kSmemX + kSmemWin);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bf16 zero = __float2bfloat16(0.f);

  // this thread's two A rows (taps ka, kb) as patch offsets; the K padding
  // (taps 147..159) reads any valid cell, and its rows are never written
  const int ka = warp * 16 + (lane >> 2), kb = ka + 8;
  auto tap_off = [](int k) {
    if (k >= kBKR) return 0;
    const int ky = k / (7 * kBCIN), rem = k % (7 * kBCIN);
    return (ky * kBPE + rem / kBCIN) * kBCIN + rem % kBCIN;
  };
  const int oa = tap_off(ka), ob = tap_off(kb);
  for (int i = tid; i < kBPix; i += kBThreads) sPB[i] = (2 * (i / kBT) * kBPE + 2 * (i % kBT)) * kBCIN;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int64_t per = (p.tiles + gridDim.x - 1) / gridDim.x;
  const int64_t t_beg = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t t_end = t_beg + per < p.tiles ? t_beg + per : p.tiles;
  for (int64_t t = t_beg; t < t_end; ++t) {
    const int tx = static_cast<int>(t % p.tiles_x);
    const int ty = static_cast<int>((t / p.tiles_x) % p.tiles_y);
    const int n = static_cast<int>(t / (static_cast<int64_t>(p.tiles_x) * p.tiles_y));
    const int i0 = ty * kBT, j0 = tx * kBT;  // first conv pixel of the tile
    const int u0 = i0 / 2, v0 = j0 / 2;      // first pool window touching it
    const int iy0 = 2 * i0 - 3, ix0 = 2 * j0 - 3;
    __syncthreads();  // the previous tile's readers are done

    for (int i = tid; i < kBPatch; i += kBThreads) {
      const int r = i / (kBPE * kBCIN), rem = i % (kBPE * kBCIN);
      const int iy = iy0 + r, ix = ix0 + rem / kBCIN;
      bf16 v = zero;
      if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
        v = p.x[((static_cast<int64_t>(n) * p.H + iy) * p.W + ix) * kBCIN + rem % kBCIN];
      sX[i] = v;
    }
    // each window's first maximum (9: none) and its cotangent where out > 0
    for (int e = tid; e < kBW * kBW * (kBCOUT / 2); e += kBThreads) {
      const int cp = e % (kBCOUT / 2), wpos = e / (kBCOUT / 2);
      const int u = u0 + wpos / kBW, v = v0 + wpos % kBW;
      uint8_t w0 = 9, w1 = 9;
      __nv_bfloat162 gg = __halves2bfloat162(zero, zero);
      if (u < p.Hp && v < p.Wp) {
        const int64_t po = ((static_cast<int64_t>(n) * p.Hp + u) * p.Wp + v) * kBCOUT + 2 * cp;
        const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.out[po]));
        const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(&p.g[po]);
        // scanned backwards, so the last match kept is the first in row-major order;
        // cells outside the conv output are the pool's zero padding
        for (int k = 8; k >= 0; --k) {
          const int cy = 2 * u - 1 + k / 3, cx = 2 * v - 1 + k % 3;
          float2 yv = make_float2(0.f, 0.f);
          if (cy >= 0 && cy < p.Hc && cx >= 0 && cx < p.Wc)
            yv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                &p.y[((static_cast<int64_t>(n) * p.Hc + cy) * p.Wc + cx) * kBCOUT + 2 * cp]));
          if (yv.x == o.x) w0 = static_cast<uint8_t>(k);
          if (yv.y == o.y) w1 = static_cast<uint8_t>(k);
        }
        gg = __halves2bfloat162(o.x > 0.f ? gv.x : zero, o.y > 0.f ? gv.y : zero);
      }
      sWin[wpos * kBCOUT + 2 * cp] = w0;
      sWin[wpos * kBCOUT + 2 * cp + 1] = w1;
      *reinterpret_cast<__nv_bfloat162*>(&sG[wpos * kBCOUT + 2 * cp]) = gg;
    }
    __syncthreads();

    // dacc of each pixel: the windows it wins, rows 2u+1 (window row 0) before
    // 2u-1 (window row 2), likewise columns, summed in f32 and rounded once
    for (int e = tid; e < kBPix * (kBCOUT / 2); e += kBThreads) {
      const int cp = e % (kBCOUT / 2), pix = e / (kBCOUT / 2);
      const int li = pix / kBT, lj = pix % kBT;
      float d0 = 0.f, d1 = 0.f;
      if (i0 + li < p.Hc && j0 + lj < p.Wc) {
        int wu[2], ru[2], wv[2], rv[2];
        const int nu = (li & 1) ? 2 : 1, nv = (lj & 1) ? 2 : 1;
        if (li & 1) { wu[0] = li / 2 + 1; ru[0] = 0; wu[1] = li / 2; ru[1] = 2; } else { wu[0] = li / 2; ru[0] = 1; }
        if (lj & 1) { wv[0] = lj / 2 + 1; rv[0] = 0; wv[1] = lj / 2; rv[1] = 2; } else { wv[0] = lj / 2; rv[0] = 1; }
        for (int a = 0; a < nu; ++a)
          for (int b = 0; b < nv; ++b) {
            const int idx = (wu[a] * kBW + wv[b]) * kBCOUT + 2 * cp;
            const int k = ru[a] * 3 + rv[b];
            const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sG[idx]));
            if (sWin[idx] == k) d0 += gf.x;
            if (sWin[idx + 1] == k) d1 += gf.y;
          }
      }
      __nv_bfloat162 o;
      o.x = __float2bfloat16(d0);
      o.y = __float2bfloat16(d1);
      *reinterpret_cast<__nv_bfloat162*>(&sD[pix * kBLdD + 2 * cp]) = o;
    }
    __syncthreads();

    // dW^T (160 x 64) += A (taps x 256 pixels) * dacc (256 pixels x 64)
#pragma unroll 2
    for (int ks = 0; ks < kBPix / 16; ++ks) {
      const int p0 = ks * 16 + (lane & 3) * 2;
      const int b0 = sPB[p0], b1 = sPB[p0 + 1], b8 = sPB[p0 + 8], b9 = sPB[p0 + 9];
      uint32_t a[4];
      a[0] = pack_bf16x2(sX[b0 + oa], sX[b1 + oa]);
      a[1] = pack_bf16x2(sX[b0 + ob], sX[b1 + ob]);
      a[2] = pack_bf16x2(sX[b8 + oa], sX[b9 + oa]);
      a[3] = pack_bf16x2(sX[b8 + ob], sX[b9 + ob]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &sD[(ks * 16 + (lane & 15)) * kBLdD + jj * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * jj], a, r[0], r[1]);
        mma_bf16(acc[2 * jj + 1], a, r[2], r[3]);
      }
    }
  }

  float* dst = p.partial + static_cast<int64_t>(blockIdx.x) * kBKR * kBCOUT;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + (lane & 3) * 2;
    if (ka < kBKR) {
      dst[ka * kBCOUT + c] = acc[j][0];
      dst[ka * kBCOUT + c + 1] = acc[j][1];
    }
    if (kb < kBKR) {
      dst[kb * kBCOUT + c] = acc[j][2];
      dst[kb * kBCOUT + c + 1] = acc[j][3];
    }
  }
}

// dW[e] = sum over blocks of partial[b, e], in block order
__global__ void stem_bwd_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw, int blocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kBKR * kBCOUT) return;
  float t = 0.f;
  for (int b = 0; b < blocks; ++b) t += partial[static_cast<int64_t>(b) * kBKR * kBCOUT + e];
  dw[e] = t;
}

}  // namespace argus

// dW (7, 7, 3, 64) f32 over the first n_images images; `blocks` (at most the
// tile count) blocks each write a (147, 64) f32 partial into `partial`
extern "C" int argus_stem_bwd(const void* x, const void* g, const void* out, const void* y, void* partial,
                              void* dw, int n_images, int H, int W, int blocks, void* stream) {
  using namespace argus;
  StemBwdArgs p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.out = static_cast<const bf16*>(out);
  p.y = static_cast<const bf16*>(y);
  p.partial = static_cast<float*>(partial);
  p.H = H;
  p.W = W;
  p.Hc = (H - 1) / 2 + 1;
  p.Wc = (W - 1) / 2 + 1;
  p.Hp = (p.Hc - 1) / 2 + 1;
  p.Wp = (p.Wc - 1) / 2 + 1;
  p.tiles_y = (p.Hc + kBT - 1) / kBT;
  p.tiles_x = (p.Wc + kBT - 1) / kBT;
  p.tiles = static_cast<int64_t>(n_images) * p.tiles_y * p.tiles_x;
  if (blocks < 1 || blocks > p.tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(stem_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  stem_bwd_kernel<<<blocks, kBThreads, kBwdSmem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stem_bwd_sum_kernel<<<(kBKR * kBCOUT + 255) / 256, 256, 0, s>>>(p.partial, static_cast<float*>(dw), blocks);
  return static_cast<int>(cudaGetLastError());
}
