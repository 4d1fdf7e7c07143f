// Gated gaussian-then-motion blur of the augmentation's per-op path, one
// launch for the batch. (N, 3, H, W) f32 or bf16 in and out.
//
// Replaces: argus_tpu/ops/pallas/blur.py `fused_random_blur` (:81, body
// `_blur_kernel` :44).
//
// Bound on the H100: bytes. One read and one write of the batch (0.12 ms
// for the flagship's 512 bf16 camera images at 256x256) against 5 + 5 + 9
// taps and two gates, ~50 operations an element in the image dtype (bf16x2
// runs them at 133.8 TFLOP/s: 0.04 ms). The form before this one (1.34 ms,
// 11x the bound) staged 32 x 32 tiles of each channel with a 38 x 38 halo by
// scalar 2-byte loads, rounded every op through f32 (two conversions an op)
// and took four block barriers for 1,024 outputs.
//
// Design, as the fused augmentation kernel's blurs (augment_fused.cu): one
// block per band of R rows (and, for widths whose band would not fit, per
// tile of CW columns) of one image, all three channels:
//   1. the band's rows and a 3-row halo each side (the vertical gaussian's
//      2 and the motion kernel's 1), clipped to the image, arrive in shared
//      memory by one bulk copy a channel where the rows are 16-byte
//      multiples and the band is the whole width, else by a cooperative load
//      (an odd width repeats column W - 1 in a pad pixel); a column tile
//      holds a 4-column halo each side;
//   2. per channel: the 5-tap vertical gaussian as a window sliding down a
//      column-pair strip in registers, into a row buffer; the horizontal 5
//      taps and the gaussian's gate, in place; the 3x3 motion kernel and its
//      gate, out. Where the rows are 16-byte multiples the last two take a
//      16-byte vector of pairs an item, loaded and stored whole.
// Two pixels a thread as one pair: bf16x2 (one packed instruction an op) or
// float2. Rounding points are the plain version's (each op in the image
// dtype, sums from 0 in tap order, the per-image scalars cast at the op):
// out equals it bit for bit. Edge clamps fall on the image's border only.
// The per-image scalars come from one packed f32 row [gauss 5 | motion 9 |
// gates 2].

#include "augment_common.cuh"
#include "sm90.cuh"

// Phase cuts for scripts/time_torch_kernel_phases.py (0: the kernel): stop
// after the load (BLUR_CUT 1), the vertical passes (2), the horizontal
// passes (3); the last stage of a cut writes one value that depends on it
#ifndef BLUR_CUT
#define BLUR_CUT 0
#endif

namespace argus {

constexpr int kBlurThreads = 256;  // beat 128, 384 and 512 at 512 x 256x256 in both dtypes
constexpr int kBlurHalo = 3;  // rows each side: the gaussian's 2 and the motion kernel's 1

struct BlurArgs {
  const void* x;         // (N, 3, H, W)
  const float* packed;   // (N, 16)
  void* out;             // (N, 3, H, W)
  int H, W;
  int R, CW;             // rows a band, columns a tile (even)
  int tiles_x, pitch;    // tiles a row; pairs a shared row
  int vec;               // one tile a row of 16-byte multiples: bulk copies in, 16-byte stores out
};

// bytes of a block's shared memory (ops/kernels/blur.py `smem_bytes` mirrors this)
__host__ __device__ constexpr int blur_smem(int R, int pitch, int isz) {
  return (3 * (R + 2 * kBlurHalo) + R + 2) * pitch * 2 * isz + 16;
}

template <typename T>
__global__ void __launch_bounds__(kBlurThreads) blur_kernel(const __grid_constant__ BlurArgs p) {
  typedef Pair<T> P;
  typedef typename P::V V;
  constexpr int NV = 16 / static_cast<int>(sizeof(V));  // pairs a 16-byte vector
  extern __shared__ __align__(128) uint8_t smem[];
  const int H = p.H, W = p.W, pitch = p.pitch;
  const int n = blockIdx.y, band = blockIdx.x / p.tiles_x, tx = blockIdx.x - band * p.tiles_x;
  // own rows [r0, r1), held rows [l0, l1); own columns [x0, x1), held [a, b) (a even)
  const int r0 = band * p.R, r1 = min(H, r0 + p.R);
  const int l0 = max(0, r0 - kBlurHalo), l1 = min(H, r1 + kBlurHalo);
  const int x0 = tx * p.CW, x1 = min(W, x0 + p.CW);
  const int a = max(0, x0 - 4), b = min(W, x1 + 4);
  const int PR = (b - a + 1) / 2;  // held pairs a row
  const int CH = (p.R + 2 * kBlurHalo) * pitch;  // pairs of a channel's band
  V* X = reinterpret_cast<V*>(smem);              // 3 x (R + 6) x pitch: band row 0 is image row r0 - 3
  V* G = X + 3 * CH;                              // (R + 2) x pitch: one channel's vertical gaussian, row 0 is r0 - 1
  uint64_t* bar = reinterpret_cast<uint64_t*>(G + (p.R + 2) * pitch);
  const int tid = threadIdx.x, nt = kBlurThreads;
  const size_t HW = static_cast<size_t>(H) * W;
  const T* img = static_cast<const T*>(p.x) + static_cast<size_t>(n) * 3 * HW;
  T* out = static_cast<T*>(p.out) + static_cast<size_t>(n) * 3 * HW;
  const int rb0 = r0 - kBlurHalo;  // X's row 0
  auto at = [&](int r) { return (min(max(r, 0), H - 1) - rb0) * pitch; };  // X's row of image row r, clamped

  // 1. the held rows
  if (p.vec) {
    if (tid == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const uint32_t bytes = static_cast<uint32_t>((l1 - l0) * W * sizeof(T));
      mbar_expect_tx(bar, 3 * bytes);
      for (int c = 0; c < 3; ++c)
        bulk_load(X + c * CH + (l0 - rb0) * pitch, img + c * HW + static_cast<size_t>(l0) * W, bytes, bar);
    }
  } else {
    for (int i = tid; i < (l1 - l0) * PR; i += nt) {
      const int r = l0 + i / PR, q = i - (i / PR) * PR;
      const int x = a + 2 * q;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T* src = img + c * HW + static_cast<size_t>(r) * W;
        X[c * CH + (r - rb0) * pitch + q] = P::make(to_f32(src[x]), to_f32(src[min(x + 1, W - 1)]));
      }
    }
  }
  // the per-image scalars in T (each cast at its op, as the plain version's)
  const float* pk = p.packed + n * 16;
  V w5[5], m9[9];
#pragma unroll
  for (int k = 0; k < 5; ++k) w5[k] = P::splat(rnd<T>(pk[k]));
#pragma unroll
  for (int k = 0; k < 9; ++k) m9[k] = P::splat(rnd<T>(pk[5 + k]));
  const float ggt = rnd<T>(pk[14]), mgt = rnd<T>(pk[15]);
  const V gg = P::splat(ggt), gg1 = P::splat(rnd<T>(__fsub_rn(1.f, ggt)));
  const V mg = P::splat(mgt), mg1 = P::splat(rnd<T>(__fsub_rn(1.f, mgt)));
  if (p.vec) {
    __syncthreads();  // the barrier's initialisation
    mbar_wait(bar, 0);
  }
  __syncthreads();

  // rows of the vertical gaussian and its gate: the own rows and one each side
  const int g0 = max(0, r0 - 1), g1 = min(H, r1 + 1), gb = r0 - 1;
  // pairs of the horizontal pass (columns x0 - 2 .. x1 + 1) and of the output
  const int hq0 = (max(0, x0 - 2) - a) / 2, hq1 = (min(W, x1 + 2) - a + 1) / 2;
  const int mq0 = (x0 - a) / 2, mq1 = (x1 - a + 1) / 2;
  const bool odd = W & 1;
  const int strips = max(1, nt / PR), slen = (g1 - g0 + strips - 1) / strips;
#if BLUR_CUT == 1
  if (P::lo(X[tid]) == 0.123f) out[tid] = from_f32<T>(1.f);
  return;
#endif
  for (int c = 0; c < 3; ++c) {
    V* Xc = X + c * CH;
    // 2a. the vertical gaussian: strips of rows a thread, a column pair each
    for (int i = tid; i < PR * strips; i += nt) {
      const int s = i / PR, q = i - s * PR;
      const int ra = g0 + s * slen, re = min(g1, ra + slen);
      if (ra >= re) continue;
      V win[5];
#pragma unroll
      for (int t = 0; t < 4; ++t) win[t] = Xc[at(ra - 2 + t) + q];
      for (int r = ra; r < re; ++r) {
        win[4] = Xc[at(r + 2) + q];
        G[(r - gb) * pitch + q] = tap5<T, true>(w5, win[0], win[1], win[2], win[3], win[4]);
#pragma unroll
        for (int t = 0; t < 4; ++t) win[t] = win[t + 1];
      }
    }
    __syncthreads();
#if BLUR_CUT == 2
    if (P::lo(G[tid]) == 0.123f) out[tid] = from_f32<T>(1.f);
    continue;
#endif
    // 2b. the horizontal gaussian and its gate, in place over X's rows: NV
    // pairs an item where the rows are whole 16-byte vectors, else a pair
    if (p.vec) {
      const int groups = PR / NV;
      for (int i = tid; i < (g1 - g0) * groups; i += nt) {
        const int r = g0 + i / groups, q0 = NV * (i - (i / groups) * groups);
        const V* gr = G + (r - gb) * pitch;
        V row[NV + 2];  // pairs q0 - 1 .. q0 + NV
        const uint4 u = *reinterpret_cast<const uint4*>(gr + q0);
#pragma unroll
        for (int t = 0; t < NV; ++t) row[t + 1] = reinterpret_cast<const V*>(&u)[t];
        row[0] = gr[max(q0 - 1, 0)];
        row[NV + 1] = gr[min(q0 + NV, PR - 1)];
        uint4* px = reinterpret_cast<uint4*>(Xc + (r - rb0) * pitch + q0);
        const uint4 xv = *px;
        uint4 res;
#pragma unroll
        for (int t = 1; t <= NV; ++t) {
          const int q = q0 + t - 1;
          const V cc = row[t];
          const V lf = q == 0 ? P::dup_lo(cc) : row[t - 1];
          const V rt = 2 * q + 2 >= W ? P::dup_hi(cc) : row[t + 1];
          reinterpret_cast<V*>(&res)[t - 1] =
              gate<T>(gg, gg1, hgauss<T, true>(w5, lf, cc, rt), reinterpret_cast<const V*>(&xv)[t - 1]);
        }
        *px = res;
      }
    }
    const int HQ = p.vec ? 0 : hq1 - hq0;
    for (int i = tid; i < (g1 - g0) * HQ; i += nt) {
      const int r = g0 + i / HQ, q = hq0 + i - (i / HQ) * HQ;
      const V* gr = G + (r - gb) * pitch;
      const V cc = gr[q];
      const V lf = a + 2 * q == 0 ? P::dup_lo(cc) : gr[q - 1];
      const V rt = a + 2 * q + 2 >= W ? P::dup_hi(cc) : gr[q + 1];
      V* px = Xc + (r - rb0) * pitch + q;
      V v = gate<T>(gg, gg1, hgauss<T, true>(w5, lf, cc, rt), *px);
      if (odd && a + 2 * q + 1 == W) v = P::dup_lo(v);  // the pad repeats column W - 1
      *px = v;
    }
    __syncthreads();
#if BLUR_CUT == 3
    if (P::lo(Xc[tid]) == 0.123f) out[tid] = from_f32<T>(1.f);
    continue;
#endif
    // 2c. the motion kernel and its gate, NV pairs an item, out
    const int groups = (mq1 - mq0 + NV - 1) / NV;
    T* oc = out + c * HW;
    for (int i = tid; i < (r1 - r0) * groups; i += nt) {
      const int r = r0 + i / groups, q0 = mq0 + NV * (i - (i / groups) * groups);
      V row[3][NV + 2];  // pairs q0 - 1 .. q0 + NV of rows r - 1, r, r + 1
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const V* src = Xc + at(r + ky - 1);
        if (p.vec) {
          const uint4 u = *reinterpret_cast<const uint4*>(src + q0);
#pragma unroll
          for (int t = 0; t < NV; ++t) row[ky][t + 1] = reinterpret_cast<const V*>(&u)[t];
        } else {
#pragma unroll
          for (int t = 1; t <= NV; ++t) row[ky][t] = src[min(q0 + t - 1, PR - 1)];
        }
        row[ky][0] = src[max(q0 - 1, 0)];
        row[ky][NV + 1] = src[min(q0 + NV, PR - 1)];
      }
      uint4 res;  // NV pairs: one 16-byte vector
      V* rv = reinterpret_cast<V*>(&res);
#pragma unroll
      for (int t = 1; t <= NV; ++t) {
        const int q = q0 + t - 1;
        V lf[3], cc[3], rt[3];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          cc[ky] = row[ky][t];
          lf[ky] = a + 2 * q == 0 ? P::dup_lo(cc[ky]) : row[ky][t - 1];
          rt[ky] = a + 2 * q + 2 >= W ? P::dup_hi(cc[ky]) : row[ky][t + 1];
        }
        rv[t - 1] = gate<T>(mg, mg1, motion9<T, true>(m9, lf, cc, rt), cc[1]);
      }
      T* dst = oc + static_cast<size_t>(r) * W + a + 2 * q0;
      if (p.vec) {
        *reinterpret_cast<uint4*>(dst) = res;
      } else {
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          if (q0 + t >= mq1) break;
          const int x = a + 2 * (q0 + t);
          if (!odd) {
            *reinterpret_cast<V*>(dst + 2 * t) = rv[t];
          } else {
            dst[2 * t] = from_f32<T>(P::lo(rv[t]));
            if (x + 1 < W) dst[2 * t + 1] = from_f32<T>(P::hi(rv[t]));
          }
        }
      }
    }
  }
}

template <typename T>
int blur_launch(const BlurArgs& p, int N, cudaStream_t st) {
  const int smem = blur_smem(p.R, p.pitch, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(blur_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bands = (p.H + p.R - 1) / p.R;
  blur_kernel<T><<<dim3(bands * p.tiles_x, N), kBlurThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace argus

// R rows a band and CW columns a tile (even), from ops/kernels/blur.py `band_plan`
extern "C" int argus_blur(const void* x, const void* packed, void* out, int N, int H, int W, int R, int CW,
                          int is_bf16, void* stream) {
  using namespace argus;
  if (N < 1 || H < 1 || W < 1 || R < 1 || CW < 2 || CW % 2) return static_cast<int>(cudaErrorInvalidValue);
  BlurArgs p;
  p.x = x;
  p.packed = static_cast<const float*>(packed);
  p.out = out;
  p.H = H;
  p.W = W;
  p.R = R;
  p.CW = CW;
  p.tiles_x = (W + CW - 1) / CW;
  p.pitch = p.tiles_x == 1 ? (W + 1) / 2 : CW / 2 + 4;
  const int isz = is_bf16 ? 2 : 4;
  p.vec = p.tiles_x == 1 && (W * isz) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? blur_launch<bf16>(p, N, st) : blur_launch<float>(p, N, st);
}
