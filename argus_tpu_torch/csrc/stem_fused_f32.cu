// The ResNet stem's no-save forward in f32: conv7x7/s2/pad3 (3 -> 64
// channels) + folded frozen-BN bias + relu + maxpool3x3/s2/pad1, NHWC,
// (N, H, W, 3) -> (N, H/4, W/4, 64).
//
// Replaces, in f32, argus_tpu/ops/pallas/stem_fused.py `_stem_fwd_pallas`
// :244 (argus_tpu's kernels compute in the activation's dtype). The bf16
// kernel (stem_fused.cu) runs wgmma on bf16 operands; wgmma's TF32 form takes
// K-major operands only and packs 8 of this conv's 3-channel taps a row at
// most, so this form stays on mma.sync m16n8k8 (TF32 operands, rounded to
// nearest by cvt.rna as they are staged; f32 sums; no bf16 anywhere), as
// cuDNN's f32 conv runs under PyTorch's default `cudnn.allow_tf32`.
//
// Design (a simple form, right first): a persistent grid of one block an SM,
// 256 threads, the folded weights staged once a block as a (152, 64) TF32
// matrix (k = (ky*7 + kx)*3 + c, rows 147-151 zero). A tile is 4 pooled rows
// x 16 pooled columns of one image, all 64 channels: the 9 x 33 conv pixels
// under its pool windows (the one shared row and column recomputed), from
// 23 input rows x 71 columns staged in shared memory (zero outside the
// image). The conv is one implicit GEMM of 297 x 152 x 64 (A read from the
// staged rows through a per-k offset table: a k-row of taps is 21
// consecutive floats of an input row), the bias + relu epilogue writes the
// conv tile to shared memory (zero outside the conv output, which equals the
// pool's -inf padding because relu output is >= 0), then each thread pools
// 16 outputs and writes them channel-contiguous. Bound: TF32 operations
// (2 * N * (H/2)(W/2) * 147 * 64 at 495 TFLOP/s) against the image's and the
// output's bytes; the sum reaches a fraction of the TF32 peak (PERF.md).

#include "common.cuh"

namespace {

using argus::mma_tf32;
using argus::tf32;

constexpr int kThreads = 256;
constexpr int kPR = 4, kPC = 16;                      // pooled rows, columns a tile
constexpr int kCR = 2 * kPR + 1, kCC = 2 * kPC + 1;  // conv rows, columns a tile: 9 x 33
constexpr int kM = kCR * kCC;                         // 297 conv pixels
constexpr int kMT = (kM + 15) / 16;                   // 19 m16 tiles
constexpr int kIR = 2 * (kCR - 1) + 7;                // 23 input rows
constexpr int kIQ = (2 * (kCC - 1) + 7) * 3;          // 213 floats of an input row
constexpr int kInLd = 216;
constexpr int kK = 147, kKP = 152;                    // 7*7*3 taps, padded to the k-step of 8
constexpr int kWLd = 72;                              // conflict-free B fragment reads
constexpr int kCLd = 72;                              // conflict-free float2 epilogue writes
constexpr int kSmem = (kIR * kInLd + kKP * kWLd + kM * kCLd + 64) * 4 + kKP * 4;

struct StemArgs {
  const float* x;  // (N, H, W, 3)
  const float* w;  // (7, 7, 3, 64) = (147, 64)
  const float* b;  // (64,)
  float* out;      // (N, H/4, W/4, 64)
  int N, H, W;
};

__global__ void __launch_bounds__(kThreads, 1) stem_fwd_f32_kernel(const __grid_constant__ StemArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sIn = reinterpret_cast<uint32_t*>(smem);  // TF32 bits
  uint32_t* sW = sIn + kIR * kInLd;                    // TF32 bits
  float* sConv = reinterpret_cast<float*>(sW + kKP * kWLd);
  float* sBias = sConv + kM * kCLd;
  int* sKoff = reinterpret_cast<int*>(sBias + 64);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // m-tiles wm, wm+4, ...; channels wn*32 .. +31
  const int gr = lane >> 2, tc = lane & 3;
  const int Hc = p.H / 2, Wc = p.W / 2, Hp = p.H / 4, Wp = p.W / 4;
  const int tiles_r = (Hp + kPR - 1) / kPR, tiles_c = (Wp + kPC - 1) / kPC;
  const int tiles = p.N * tiles_r * tiles_c;

  for (int i = tid; i < kKP * 64; i += kThreads) {
    const int k = i >> 6, n = i & 63;
    sW[k * kWLd + n] = k < kK ? tf32(p.w[k * 64 + n]) : 0u;
  }
  for (int k = tid; k < kKP; k += kThreads) sKoff[k] = k < kK ? (k / 21) * kInLd + k % 21 : 0;
  if (tid < 64) sBias[tid] = p.b[tid];

  // this thread's A rows: conv pixel m -> its first input float in sIn
  int base[5][2];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wm + 4 * i) * 16 + gr + 8 * h;
      base[i][h] = m < kM ? 2 * (m / kCC) * kInLd + 6 * (m % kCC) : 0;
    }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / (tiles_r * tiles_c);
    const int pr0 = (tile / tiles_c) % tiles_r * kPR, pc0 = tile % tiles_c * kPC;
    const int cr0 = 2 * pr0 - 1, cc0 = 2 * pc0 - 1;
    const int ir0 = 2 * cr0 - 3, iq0 = (2 * cc0 - 3) * 3;

    // stage the input rows, TF32-rounded, zero outside the image
    const float* img = p.x + static_cast<int64_t>(n) * p.H * p.W * 3;
    for (int i = tid; i < kIR * kIQ; i += kThreads) {
      const int r = i / kIQ, q = i - r * kIQ;
      const int ih = ir0 + r, gq = iq0 + q;
      const bool ok = ih >= 0 && ih < p.H && gq >= 0 && gq < 3 * p.W;
      sIn[r * kInLd + q] = ok ? tf32(img[static_cast<int64_t>(ih) * p.W * 3 + gq]) : 0u;
    }
    __syncthreads();

    float acc[5][4][4];
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll 1
    for (int ks = 0; ks < kKP / 8; ++ks) {
      const int k0 = ks * 8 + tc;
      const int o0 = sKoff[k0], o1 = sKoff[k0 + 4];
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + gr;
        b[j][0] = sW[k0 * kWLd + col];
        b[j][1] = sW[(k0 + 4) * kWLd + col];
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        if (wm + 4 * i >= kMT) continue;
        const uint32_t a[4] = {sIn[base[i][0] + o0], sIn[base[i][1] + o0], sIn[base[i][0] + o1],
                               sIn[base[i][1] + o1]};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], a, b[j][0], b[j][1]);
      }
    }

    // bias + relu into the conv tile; zero outside the conv output
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wm + 4 * i) * 16 + gr + 8 * h;
        if (m >= kM) continue;
        const int cr = cr0 + m / kCC, cc = cc0 + m % kCC;
        const bool inside = cr >= 0 && cr < Hc && cc >= 0 && cc < Wc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wn * 32 + j * 8 + 2 * tc;
          const float v0 = inside ? fmaxf(acc[i][j][2 * h] + sBias[col], 0.f) : 0.f;
          const float v1 = inside ? fmaxf(acc[i][j][2 * h + 1] + sBias[col + 1], 0.f) : 0.f;
          *reinterpret_cast<float2*>(sConv + m * kCLd + col) = make_float2(v0, v1);
        }
      }
    }
    __syncthreads();

    // the 3x3/s2 max pool, 16 outputs a thread, channels contiguous
#pragma unroll 4
    for (int q = 0; q < kPR * kPC * 64 / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      const int ch = idx & 63, px = (idx >> 6) % kPC, py = idx / (kPC * 64);
      const int pr = pr0 + py, pc = pc0 + px;
      if (pr >= Hp || pc >= Wp) continue;
      const float* c = sConv + (2 * py * kCC + 2 * px) * kCLd + ch;
      float v = c[0];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v = fmaxf(v, c[(dy * kCC + dx) * kCLd]);
      p.out[((static_cast<int64_t>(n) * Hp + pr) * Wp + pc) * 64 + ch] = v;
    }
  }
}

// SMs of the current device (the persistent grid's size), read once a device
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return dev < 64 ? counts[dev] : 132;
}

}  // namespace

// x (N, H, W, 3), w (7, 7, 3, 64), b (1, 64), out (N, H/4, W/4, 64), all
// f32; H, W % 4 == 0.
extern "C" int argus_stem_fwd_f32(const void* x, const void* w, const void* b, void* out, int N, int H, int W,
                                  void* stream) {
  if (N <= 0 || H % 4 || W % 4) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(stem_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  StemArgs p{static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
             static_cast<float*>(out), N, H, W};
  const int tiles = N * ((H / 4 + kPR - 1) / kPR) * ((W / 4 + kPC - 1) / kPC);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  stem_fwd_f32_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
