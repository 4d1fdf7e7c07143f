// The whole augmentation stack in one launch: spaghetti arcs, planckian
// gains, the colour jiggle in the sampled order, the gated gaussian and
// motion blurs (edge clamp) and the plasma shadow. (N, 3, H, W) f32 or bf16.
//
// Replaces: argus_tpu/ops/pallas/augment_fused.py `fused_augment` (:278, body
// `_make_kernel` :140, phases "awjbp"; `jiggle_plan` :105).
//
// Bound on the H100: one read and one write of the batch (0.12 ms for the
// flagship's 512 bf16 camera images at 256x256) against ~325 f32 operations
// a pixel (chip_smoke.py `aug_ops`: ~90 of them the arc tests, 3 the
// bilinear upsample's nonzero taps); on the CUDA cores (67 TFLOP/s f32)
// that is ~0.16 ms: bound by operations. The function does not go in one
// sweep over the pixels: the contrast op needs the mean luma of the image as
// it stands before it, the blur needs neighbours after the jiggle, the plasma
// shade needs the min and max of the whole upsampled field, and one image
// (384 KB in bf16) does not fit a block's shared memory. Design: one block
// per image walks it in passes
//   (a) T = mh @ field into shared memory (H x S f32), then the min and max
//       of T @ mwt over the image (a block reduction); each pixel's
//       upsampled value is recomputed from T where it is applied. Each sum
//       runs over the nonzero range of its row of mh or column of mwt (two
//       entries of a bilinear matrix): the dense sum's value, since the
//       terms skipped are exact zeros, at 2 products a pixel instead of S;
//   (b) arcs, gains and the jiggle ops before the contrast op, into a
//       scratch image the wrapper allocates, and the luma sum (a fixed-order
//       reduction: deterministic);
//   (c) the contrast op and the rest of the jiggle, in place in the scratch;
//   (d) per 32x32 tile: the plasma shade, then the blurs through shared
//       memory with a clamped halo (augment_common.cuh), shade added, out.
// The jiggle plan (hue position, three affine op selectors) is device data:
// a branch uniform across the block costs nothing here, so one kernel serves
// every order and the host never reads the order back.
// Rounding points are argus_tpu's: each op in the image dtype with the f32
// scalars cast at the op; the luma mean, the hue, the arcs and the plasma in
// f32, without fused multiply-adds (see augment_common.cuh).

#include "augment_common.cuh"

namespace argus {

constexpr int kAugThreads = 512;

struct AugArgs {
  const void* img;      // (N, 3, H, W)
  const float* field;   // (N, S, S)
  const float* mh;      // (H, S)
  const float* mwt;     // (S, W)
  const float* packed;  // (N, row)
  const int* plan;      // [hue_pos, op0, op1, op2]
  void* scratch;        // (N, 3, H, W)
  void* out;            // (N, 3, H, W)
  int H, W, S, n_arcs, row;
};

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }

// torch.remainder / jnp's %: the floor modulus
__device__ __forceinline__ float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m += b;
  return m;
}

template <typename T>
__device__ __forceinline__ float luma(const float* v) {
  return add<T>(add<T>(mul<T>(rnd<T>(0.299f), v[0]), mul<T>(rnd<T>(0.587f), v[1])),
                mul<T>(rnd<T>(0.114f), v[2]));
}

// whether pixel (x, y) lies on any arc (ops/kernels/augment_common.py `arc_mask`); ring
// holds each arc's squared ring bounds (lo^2, hi^2), lo = max(1 - hws, 0),
// hi = 1 + hws. The sweep's cross products are taken only on the ring.
__device__ bool on_arcs(const float* w, const float* ring, int n_arcs, float x, float y) {
  for (int a = 0; a < n_arcs; ++a) {
    const float* p = w + 10 * a;
    const float dx = fm(fs(x, p[0]), p[2]);
    const float dy = fm(fs(y, p[1]), p[3]);
    const float rho2 = fa(fm(dx, dx), fm(dy, dy));
    if (!(rho2 > ring[2 * a] && rho2 < ring[2 * a + 1])) continue;
    const bool pu = fs(fm(p[5], dy), fm(p[6], dx)) >= 0.f;
    const bool pv = fs(fm(dx, p[8]), fm(dy, p[7])) >= 0.f;
    if ((pu && pv) || (p[9] > 0.5f && (pu || pv))) return true;
  }
  return false;
}

// RGB -> HSV, + shift on H, -> RGB, clipped, in f32 (ops/kernels/augment_common.py `adjust_hue`)
__device__ void hue_shift(float* v, float shift) {
  const float r = v[0], g = v[1], b = v[2];
  const float maxc = fmaxf(fmaxf(r, g), b), minc = fminf(fminf(r, g), b);
  const float delta = fs(maxc, minc);
  const float safe = delta == 0.f ? 1.f : delta;
  const float s = maxc == 0.f ? 0.f : __fdiv_rn(delta, maxc == 0.f ? 1.f : maxc);
  const float rc = __fdiv_rn(fs(maxc, r), safe), gc = __fdiv_rn(fs(maxc, g), safe),
              bc = __fdiv_rn(fs(maxc, b), safe);
  // branch by channel ordering, never by equality with the recomputed max
  float h = (r >= g && r >= b) ? fs(bc, gc) : (g >= b ? fs(fa(2.f, rc), bc) : fs(fa(4.f, gc), rc));
  if (delta == 0.f) h = 0.f;
  h = floor_mod(__fdiv_rn(h, 6.f), 1.f);
  h = floor_mod(fa(h, shift), 1.f);
  const float h6 = fm(h, 6.f);
  const float i = floorf(h6);
  const float f = fs(h6, i);
  const float vv = maxc;
  const float p = fm(vv, fs(1.f, s));
  const float q = fm(vv, fs(1.f, fm(s, f)));
  const float t = fm(vv, fs(1.f, fm(s, fs(1.f, f))));
  const int k = static_cast<int>(floor_mod(i, 6.f));  // 0..5, also where h rounds to 1.0
  float r2, g2, b2;
  switch (k) {
    case 0: r2 = vv; g2 = t; b2 = p; break;
    case 1: r2 = q; g2 = vv; b2 = p; break;
    case 2: r2 = p; g2 = vv; b2 = t; break;
    case 3: r2 = p; g2 = q; b2 = vv; break;
    case 4: r2 = t; g2 = p; b2 = vv; break;
    default: r2 = vv; g2 = p; b2 = q; break;
  }
  v[0] = clip01(r2);
  v[1] = clip01(g2);
  v[2] = clip01(b2);
}

// one jiggle op on a pixel: 3 the hue, else the affine pass
// clip(a x + b luma(x) + g mean) with (a, b, g) selected by the op
template <typename T>
__device__ __forceinline__ void jiggle_op(float* v, int op, const float* jf, float mean) {
  if (op == 3) {
    hue_shift(v, jf[3]);
    for (int c = 0; c < 3; ++c) v[c] = rnd<T>(v[c]);
    return;
  }
  const float a = rnd<T>(op == 0 ? jf[0] : (op == 1 ? jf[1] : jf[2]));
  const float bb = rnd<T>(op == 2 ? fs(1.f, jf[2]) : 0.f);
  const float gm = rnd<T>(op == 1 ? fm(fs(1.f, jf[1]), mean) : 0.f);
  const float lum = luma<T>(v);
  for (int c = 0; c < 3; ++c) v[c] = clip01(add<T>(add<T>(mul<T>(a, v[c]), mul<T>(bb, lum)), gm));
}

// the upsampled field at (y, x): sum over k of T[y][k] mwt[k][x], T = mh @
// field in shared memory, over the column's nonzero range of mwt only (the
// terms outside it are exact zeros, so the sum is the dense one's)
__device__ __forceinline__ float upsampled(const float* Ts, const float* mwt, const int* kr, int S, int W,
                                           int y, int x) {
  float acc = 0.f;
  for (int k = kr[2 * x]; k <= kr[2 * x + 1]; ++k) acc = fa(acc, fm(Ts[y * S + k], __ldg(mwt + k * W + x)));
  return acc;
}

// block-wide reduction of one value per thread, in a fixed order
template <typename Op>
__device__ float block_reduce(float v, float* red, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = red[0];
    for (int i = 1; i < (kAugThreads >> 5); ++i) r = op(r, red[i]);
    red[32] = r;
  }
  __syncthreads();
  return red[32];
}

// shared memory of a block: T (H x S), the shade tile, the reductions, the
// arcs' ring bounds, the nonzero ranges of mh's rows and mwt's columns (f32
// or int), then the blur buffers (T)
template <typename T>
size_t smem_bytes(int H, int W, int S, int n_arcs) {
  return sizeof(float) * (static_cast<size_t>(H) * S + kBT * kBT + 64 + 2 * n_arcs + 2 * H + 2 * W) +
         blur_buf_bytes<T>();
}

// first and last index of a nonzero among n entries at `stride` (an empty
// range, lo > hi, if all are zero)
__device__ __forceinline__ void nonzero_range(const float* v, int n, int stride, int* out) {
  int lo = n, hi = -1;
  for (int j = 0; j < n; ++j)
    if (__ldg(v + j * stride) != 0.f) {
      lo = min(lo, j);
      hi = j;
    }
  out[0] = lo;
  out[1] = hi;
}

template <typename T>
__global__ void __launch_bounds__(kAugThreads, 2) augment_kernel(const __grid_constant__ AugArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, W = p.W, S = p.S, HW = H * W;
  float* Ts = smem;                                       // H x S
  float* shade = Ts + H * S;                              // kBT x kBT
  float* red = shade + kBT * kBT;                         // 64
  float* ring = red + 64;                                 // 2 x n_arcs
  int* jr = reinterpret_cast<int*>(ring + 2 * p.n_arcs);  // 2 x H
  int* kr = jr + 2 * H;                                   // 2 x W
  T* buf = reinterpret_cast<T*>(kr + 2 * W);              // blur buffers
  const int n = blockIdx.x, tid = threadIdx.x;
  const size_t off = static_cast<size_t>(n) * 3 * HW;
  const T* img = static_cast<const T*>(p.img) + off;
  T* scr = static_cast<T*>(p.scratch) + off;
  T* out = static_cast<T*>(p.out) + off;
  const float* w = p.packed + static_cast<size_t>(n) * p.row;
  const int A = 10 * p.n_arcs;
  const float* gains = w + A;
  const float* jf = w + A + 3;
  const float* gw = w + A + 7;
  const float* mk = w + A + 12;
  const float ggate = w[A + 21], mgate = w[A + 22], intensity = w[A + 23], quantity = w[A + 24];

  // (a) T = mh @ field, and the min and max of T @ mwt; each sum runs over
  // the nonzero range of mh's row or mwt's column, in index order
  for (int y = tid; y < H; y += kAugThreads) nonzero_range(p.mh + y * S, S, 1, jr + 2 * y);
  for (int x = tid; x < W; x += kAugThreads) nonzero_range(p.mwt + x, S, W, kr + 2 * x);
  for (int a = tid; a < p.n_arcs; a += kAugThreads) {
    const float hws = w[10 * a + 4];
    const float lo = fmaxf(fs(1.f, hws), 0.f), hi = fa(1.f, hws);
    ring[2 * a] = fm(lo, lo);
    ring[2 * a + 1] = fm(hi, hi);
  }
  __syncthreads();
  const float* field = p.field + static_cast<size_t>(n) * S * S;
  for (int i = tid; i < H * S; i += kAugThreads) {
    const int y = i / S, k = i % S;
    float acc = 0.f;
    for (int j = jr[2 * y]; j <= jr[2 * y + 1]; ++j)
      acc = fa(acc, fm(__ldg(p.mh + y * S + j), __ldg(field + j * S + k)));
    Ts[i] = acc;
  }
  __syncthreads();
  float lmin = __int_as_float(0x7f800000), lmax = -lmin;
  for (int i = tid; i < HW; i += kAugThreads) {
    const float u = upsampled(Ts, p.mwt, kr, S, W, i / W, i % W);
    lmin = fminf(lmin, u);
    lmax = fmaxf(lmax, u);
  }
  const float fmin = block_reduce(lmin, red, [](float a, float b) { return fminf(a, b); });
  const float fmax = block_reduce(lmax, red, [](float a, float b) { return fmaxf(a, b); });
  const float range = fmaxf(fs(fmax, fmin), 1e-6f);

  // the jiggle as four ops in order; exactly one of them is the contrast
  int seq[4], k = 0, cpos = 0;
  const int hue_pos = p.plan[0];
  for (int r = 0; r < 3; ++r) {
    if (r == hue_pos) seq[k++] = 3;
    seq[k++] = p.plan[1 + r];
  }
  if (hue_pos == 3) seq[k++] = 3;
  for (int i = 0; i < 4; ++i)
    if (seq[i] == 1) cpos = i;

  // (b) arcs, gains, the ops before the contrast; the luma sum
  float lsum = 0.f;
  for (int i = tid; i < HW; i += kAugThreads) {
    float v[3];
    for (int c = 0; c < 3; ++c) v[c] = to_f32(img[c * HW + i]);
    if (on_arcs(w, ring, p.n_arcs, static_cast<float>(i % W), static_cast<float>(i / W)))
      v[0] = v[1] = v[2] = 0.f;
    for (int c = 0; c < 3; ++c) v[c] = clip01(mul<T>(v[c], rnd<T>(gains[c])));
    for (int o = 0; o < cpos; ++o) jiggle_op<T>(v, seq[o], jf, 0.f);
    for (int c = 0; c < 3; ++c) scr[c * HW + i] = from_f32<T>(v[c]);
    lsum = fa(lsum, luma<T>(v));
  }
  const float mean = __fdiv_rn(block_reduce(lsum, red, [](float a, float b) { return fa(a, b); }),
                               static_cast<float>(HW));

  // (c) the contrast and the ops after it
  for (int i = tid; i < HW; i += kAugThreads) {
    float v[3];
    for (int c = 0; c < 3; ++c) v[c] = to_f32(scr[c * HW + i]);
    for (int o = cpos; o < 4; ++o) jiggle_op<T>(v, seq[o], jf, mean);
    for (int c = 0; c < 3; ++c) scr[c * HW + i] = from_f32<T>(v[c]);
  }
  __syncthreads();  // the blur reads neighbours other threads wrote

  // (d) per tile: the plasma shade, then the blurs, shade added, out
  for (int y0 = 0; y0 < H; y0 += kBT) {
    for (int x0 = 0; x0 < W; x0 += kBT) {
      for (int i = tid; i < kBT * kBT; i += kAugThreads) {
        const int y = y0 + i / kBT, x = x0 + i % kBT;
        float sh = 0.f;
        if (y < H && x < W) {
          const float plasma = __fdiv_rn(fs(upsampled(Ts, p.mwt, kr, S, W, y, x), fmin), range);
          sh = rnd<T>(fm(plasma < quantity ? 1.f : 0.f, intensity));
        }
        shade[i] = sh;
      }
      __syncthreads();
      blur_tile<T>(scr, H, W, y0, x0, gw, mk, ggate, mgate, buf, [&](int c, int y, int x, float v) {
        const float sh = shade[(y - y0) * kBT + (x - x0)];
        out[c * HW + y * W + x] = from_f32<T>(clip01(add<T>(v, sh)));
      });
    }
  }
}

template <typename T>
int launch(const AugArgs& p, int N, cudaStream_t st) {
  const size_t smem = smem_bytes<T>(p.H, p.W, p.S, p.n_arcs);
  cudaError_t e = cudaFuncSetAttribute(augment_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  augment_kernel<T><<<N, kAugThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace argus

extern "C" int argus_augment_fused(const void* img, const void* field, const void* mh, const void* mwt,
                                   const void* packed, const void* plan, void* scratch, void* out, int N,
                                   int H, int W, int S, int n_arcs, int is_bf16, void* stream) {
  using namespace argus;
  AugArgs p;
  p.img = img;
  p.field = static_cast<const float*>(field);
  p.mh = static_cast<const float*>(mh);
  p.mwt = static_cast<const float*>(mwt);
  p.packed = static_cast<const float*>(packed);
  p.plan = static_cast<const int*>(plan);
  p.scratch = scratch;
  p.out = out;
  p.H = H;
  p.W = W;
  p.S = S;
  p.n_arcs = n_arcs;
  p.row = 10 * n_arcs + 25;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(p, N, st) : launch<float>(p, N, st);
}
