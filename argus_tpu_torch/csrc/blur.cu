// Gated gaussian-then-motion blur of the augmentation's per-op path, one
// launch for the batch. (N, 3, H, W) f32 or bf16 in and out.
//
// Replaces: argus_tpu/ops/pallas/blur.py `fused_random_blur` (:81, body
// `_blur_kernel` :44).
//
// Bound on the H100: 5 + 5 + 9 taps and two gates, ~50 f32 operations an
// element against 2 (bf16) or 4 bytes read and written: memory-bound (one read
// and one write of the batch, 0.12 ms for the flagship's 512 bf16 camera
// images at 256x256). Design: a 2D grid of 32x32 output tiles per image; a
// block stages its tile (all three channels) with a clamped 3-pixel halo in
// shared memory, runs the rows, columns and motion stages there
// (augment_common.cuh) and writes each output once. The per-image scalars
// come from one packed f32 row [gauss 5 | motion 9 | gates 2].

#include "augment_common.cuh"

namespace argus {

template <typename T>
__global__ void __launch_bounds__(256) blur_kernel(const T* x, const float* packed, T* out, int H, int W) {
  __shared__ __align__(16) unsigned char raw[blur_buf_bytes<T>()];
  const int n = blockIdx.z;
  const float* w = packed + n * 16;
  const size_t off = static_cast<size_t>(n) * 3 * H * W;
  T* dst = out + off;
  blur_tile<T>(x + off, H, W, blockIdx.y * kBT, blockIdx.x * kBT, w, w + 5, w[14], w[15],
               reinterpret_cast<T*>(raw), [&](int c, int y, int xx, float v) {
                 dst[(static_cast<size_t>(c) * H + y) * W + xx] = from_f32<T>(v);
               });
}

}  // namespace argus

extern "C" int argus_blur(const void* x, const void* packed, void* out, int N, int H, int W, int is_bf16,
                          void* stream) {
  using namespace argus;
  const dim3 grid((W + kBT - 1) / kBT, (H + kBT - 1) / kBT, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pk = static_cast<const float*>(packed);
  if (is_bf16)
    blur_kernel<bf16><<<grid, 256, 0, st>>>(static_cast<const bf16*>(x), pk, static_cast<bf16*>(out), H, W);
  else
    blur_kernel<float><<<grid, 256, 0, st>>>(static_cast<const float*>(x), pk, static_cast<float*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
