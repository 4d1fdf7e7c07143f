// ResNet stem forward in one launch: conv7x7/s2/pad3 (3 -> 64 channels) on
// folded frozen-BN weights, + f32 bias, relu, one rounding to bf16, then
// maxpool 3x3/s2/pad1. NHWC bf16 in and out. The saving variant (training
// with the stem trained) also writes the conv + bias + relu output y
// (N, H/2, W/2, 64) that the weight gradient (stem_fused_bwd.cu) reads.
//
// Replaces: argus_tpu/ops/pallas/stem_fused.py `_stem_fwd_pallas` (:244,
// body `_stem_fwd_kernel` :174), the no-save stem forward of eval and
// serving, and `_stem_fwd_save_pallas` (:280, body `_stem_fwd_save_kernel`
// :185), whose parity-packed yg (N, H/4, W/4, 256) holds the same values:
// yg[n, u, v, (p*2 + q)*64 + c] = y[n, 2u + p, 2v + q, c].
//
// Bound on the H100: at 256x256 input the conv is ~2*147*64 FLOP per conv
// pixel against 6 input bytes per conv pixel and 2 output bytes per pooled
// channel, so operations and bytes are about balanced near the bf16 ridge;
// what a naive kernel pays is the K = 147 contraction over 3 channels, which
// does not vectorise, and the 4x larger conv output written and read back.
// Design: one block computes a TP x TP tile of pooled outputs for all 64
// channels. It stages the (4 TP + 7)^2 x 3 input patch and the (160, 64)
// folded weights in shared memory, runs the (2 TP + 1)^2 conv outputs that the
// pool window needs as an implicit GEMM on the tensor cores (mma.sync
// m16n8k16, K = 147 padded to 160; A fragments gathered from the patch with a
// per-k offset table, since A[m, k] = patch[base(m) + off(k)]), keeps the
// bf16 conv tile in shared memory and pools from there: the conv output never
// touches device memory. Conv positions outside the image are stored as 0,
// which is exact for the pool because relu output is >= 0
// (stem_fused.py:24-28). The TPU's 4x4 space-to-depth feed and parity-packed
// weights exist for the MXU and are not ported. Neighbouring tiles overlap
// by one conv row and column (the window's first); the saving variant writes
// a conv position only from the tile whose interior (local row and column
// 1..16) holds it, so each position of y is written by exactly one block,
// 16-byte vectors from the shared conv tile.

#include "common.cuh"

namespace argus {

constexpr int kTP = 8;                 // pooled tile edge
constexpr int kCT = 2 * kTP + 1;       // conv tile edge the pool window needs
constexpr int kCM = kCT * kCT;         // conv positions per block (289)
constexpr int kMT = (kCM + 15) / 16;   // m16 tiles (19)
constexpr int kPE = 2 * (kCT - 1) + 7; // patch edge (39)
constexpr int kCIN = 3;
constexpr int kCOUT = 64;
constexpr int kKR = 7 * 7 * kCIN;      // real K (147)
constexpr int kKP = 160;               // K padded to a multiple of 16
constexpr int kLdW = kCOUT + 8;        // padded shared rows: conflict-free ldmatrix
constexpr int kLdY = kCOUT + 8;
constexpr int kStemThreads = 256;
constexpr int kPatch = kPE * kPE * kCIN;  // 4563

constexpr int kSmemW = kKP * kLdW * 2;
constexpr int kSmemY = kCM * kLdY * 2;
constexpr int kSmemX = ((kPatch * 2 + 15) / 16) * 16;
constexpr int kSmemOff = kKP * 4;
constexpr int kStemSmem = kSmemW + kSmemY + kSmemX + kSmemOff;

struct StemArgs {
  const bf16* x;     // (N, H, W, 3)
  const bf16* w;     // (147, 64): HWIO (7,7,3,64) flattened
  const float* b;    // (64,)
  bf16* out;         // (N, Hp, Wp, 64)
  bf16* y;           // (N, Hc, Wc, 64) conv + bias + relu, or nullptr (no save)
  int N, H, W, Hc, Wc, Hp, Wp, tiles_y, tiles_x;
};

__global__ void __launch_bounds__(kStemThreads) stem_kernel(const __grid_constant__ StemArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* sY = reinterpret_cast<bf16*>(smem + kSmemW);
  bf16* sX = reinterpret_cast<bf16*>(smem + kSmemW + kSmemY);
  int* sOff = reinterpret_cast<int*>(smem + kSmemW + kSmemY + kSmemX);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int t = blockIdx.x;
  const int tx = t % p.tiles_x;
  t /= p.tiles_x;
  const int ty = t % p.tiles_y;
  const int n = t / p.tiles_y;
  const int py0 = ty * kTP, px0 = tx * kTP;  // first pooled output of the tile
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // first conv output the pool reads
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // first input pixel the conv reads

  // weights: 147 x 64 bf16 as 16-byte vectors, zero rows up to K = 160
  for (int v = tid; v < kKP * kCOUT / 8; v += kStemThreads) {
    const int r = v / (kCOUT / 8), c = (v % (kCOUT / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < kKR) val = *reinterpret_cast<const uint4*>(&p.w[r * kCOUT + c]);
    *reinterpret_cast<uint4*>(&sW[r * kLdW + c]) = val;
  }
  // input patch, zero outside the image (the conv's zero padding)
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < kPatch; i += kStemThreads) {
    const int r = i / (kPE * kCIN), rem = i % (kPE * kCIN);
    const int iy = iy0 + r, ix = ix0 + rem / kCIN;
    bf16 v = zero;
    if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
      v = p.x[((static_cast<int64_t>(n) * p.H + iy) * p.W + ix) * kCIN + rem % kCIN];
    sX[i] = v;
  }
  // k -> patch offset of tap (ky, kx, c); -1 for the K padding
  for (int k = tid; k < kKP; k += kStemThreads) {
    int o = -1;
    if (k < kKR) {
      const int ky = k / (7 * kCIN), rem = k % (7 * kCIN);
      o = (ky * kPE + rem / kCIN) * kCIN + rem % kCIN;
    }
    sOff[k] = o;
  }
  __syncthreads();

  // conv tile as an implicit GEMM: M = 289 conv positions, N = 64, K = 160
  for (int mt = warp; mt < kMT; mt += kStemThreads / 32) {
    const int r0 = mt * 16 + (lane >> 2);
    const int r1 = r0 + 8;
    // patch offset of conv position m: its window's top-left input pixel
    const int base0 = r0 < kCM ? ((2 * (r0 / kCT)) * kPE + 2 * (r0 % kCT)) * kCIN : 0;
    const int base1 = r1 < kCM ? ((2 * (r1 / kCT)) * kPE + 2 * (r1 % kCT)) * kCIN : 0;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll 2
    for (int ks = 0; ks < kKP / 16; ++ks) {
      const int k0 = ks * 16 + (lane & 3) * 2;
      const int o0 = sOff[k0], o1 = sOff[k0 + 1], o8 = sOff[k0 + 8], o9 = sOff[k0 + 9];
      auto at = [&](int base, int o) { return o >= 0 ? sX[base + o] : zero; };
      uint32_t a[4];
      a[0] = pack_bf16x2(at(base0, o0), at(base0, o1));
      a[1] = pack_bf16x2(at(base1, o0), at(base1, o1));
      a[2] = pack_bf16x2(at(base0, o8), at(base0, o9));
      a[3] = pack_bf16x2(at(base1, o8), at(base1, o9));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &sW[(ks * 16 + (lane & 15)) * kLdW + jj * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * jj], a, r[0], r[1]);
        mma_bf16(acc[2 * jj + 1], a, r[2], r[3]);
      }
    }

    // bias + relu + one rounding; conv positions outside the conv output are 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = half ? r1 : r0;
      if (m >= kCM) continue;
      const int cy = cy0 + m / kCT, cx = cx0 + m % kCT;
      const bool inside = cy >= 0 && cy < p.Hc && cx >= 0 && cx < p.Wc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j * 8 + (lane & 3) * 2;
        __nv_bfloat162 o;
        o.x = __float2bfloat16(inside ? fmaxf(acc[j][half * 2] + p.b[c], 0.f) : 0.f);
        o.y = __float2bfloat16(inside ? fmaxf(acc[j][half * 2 + 1] + p.b[c + 1], 0.f) : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(&sY[m * kLdY + c]) = o;
      }
    }
  }
  __syncthreads();

  if (p.y != nullptr) {  // this tile's own conv positions: local rows and columns 1..2 TP
    for (int i = tid; i < 2 * kTP * 2 * kTP * (kCOUT / 8); i += kStemThreads) {
      const int v = i % (kCOUT / 8), pos = i / (kCOUT / 8);
      const int ly = 1 + pos / (2 * kTP), lx = 1 + pos % (2 * kTP);
      const int cy = cy0 + ly, cx = cx0 + lx;
      if (cy >= p.Hc || cx >= p.Wc) continue;
      *reinterpret_cast<uint4*>(&p.y[((static_cast<int64_t>(n) * p.Hc + cy) * p.Wc + cx) * kCOUT + v * 8]) =
          *reinterpret_cast<const uint4*>(&sY[(ly * kCT + lx) * kLdY + v * 8]);
    }
  }

  // maxpool 3x3/s2 over the conv tile: 8x8 pooled pixels x 32 channel pairs
  for (int i = tid; i < kTP * kTP * (kCOUT / 2); i += kStemThreads) {
    const int cp = i % (kCOUT / 2), pos = i / (kCOUT / 2);
    const int pyl = pos / kTP, pxl = pos % kTP;
    const int py = py0 + pyl, px = px0 + pxl;
    if (py >= p.Hp || px >= p.Wp) continue;
    __nv_bfloat162 mx = *reinterpret_cast<const __nv_bfloat162*>(
        &sY[((2 * pyl) * kCT + 2 * pxl) * kLdY + 2 * cp]);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        mx = __hmax2(mx, *reinterpret_cast<const __nv_bfloat162*>(
                              &sY[((2 * pyl + dy) * kCT + 2 * pxl + dx) * kLdY + 2 * cp]));
    *reinterpret_cast<__nv_bfloat162*>(
        &p.out[((static_cast<int64_t>(n) * p.Hp + py) * p.Wp + px) * kCOUT + 2 * cp]) = mx;
  }
}

}  // namespace argus

namespace {

int stem_launch(const void* x, const void* w, const void* b, void* out, void* y, int N, int H, int W,
                void* stream) {
  using namespace argus;
  StemArgs p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const float*>(b);
  p.out = static_cast<bf16*>(out);
  p.y = static_cast<bf16*>(y);
  p.N = N;
  p.H = H;
  p.W = W;
  p.Hc = (H - 1) / 2 + 1;  // conv 7x7 / s2 / pad 3
  p.Wc = (W - 1) / 2 + 1;
  p.Hp = (p.Hc - 1) / 2 + 1;  // pool 3x3 / s2 / pad 1
  p.Wp = (p.Wc - 1) / 2 + 1;
  p.tiles_y = (p.Hp + kTP - 1) / kTP;
  p.tiles_x = (p.Wp + kTP - 1) / kTP;
  cudaError_t e = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kStemSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = static_cast<int64_t>(N) * p.tiles_y * p.tiles_x;
  stem_kernel<<<static_cast<unsigned>(blocks), kStemThreads, kStemSmem,
                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int argus_stem_fwd(const void* x, const void* w, const void* b, void* out, int N, int H,
                              int W, void* stream) {
  return stem_launch(x, w, b, out, nullptr, N, H, W, stream);
}

// the training forward: also writes y (N, Hc, Wc, 64)
extern "C" int argus_stem_fwd_save(const void* x, const void* w, const void* b, void* out, void* y, int N,
                                   int H, int W, void* stream) {
  return stem_launch(x, w, b, out, y, N, H, W, stream);
}
