// BatchNorm's two per-channel column reductions over an (M, C) view of an
// NHWC activation, bf16 or f32 in, f32 out:
//
//   stats:      sum x,  sum x^2
//   backward:   sum dy, sum dy * xhat,   xhat = (x - mean) * rstd in f32
//
// over the rows the caller's stride visits: virtual row v maps to physical
// row (v / R) * S + v % R, i.e. blocks of R contiguous rows every S rows
// (R = S = M reads every row).
//
// Replaces: argus_tpu/ops/pallas/bn_reduce.py `fused_stats` (:74, body
// `_stats_kernel` :51) and `fused_bn_bwd_reduce` (:149, body `_bwd_kernel`
// :122), which carry the sums across the TPU's sequential grid in VMEM
// scratch and visit every `stride`-th row block through the grid index map.
//
// Bound on the H100: memory. Each input byte is read once and the outputs
// are 2 C floats, so the time is the bytes over 3.35 TB/s (the flop count is
// a few operations per element). Design: a block reduces a contiguous range
// of virtual rows for a slab of up to 32 16-byte vectors of channels (256
// bf16 or 128 f32); its threads are (row group, channel vector), each loads
// 16 bytes per row (four rows in flight) and keeps f32 sums for its vector;
// the row groups are added in shared memory in a fixed order, and each block
// writes its own partial. A second kernel adds the partials in block order,
// so the result is deterministic (no atomics). The TPU's lane fold (C < 128
// viewed as (M/f, f C)) only fills its 128 lanes and is not carried over.

#include "common.cuh"

namespace argus {

constexpr int kRThreads = 256;
constexpr int kRUnroll = 4;

struct ReduceArgs {
  const void* x;      // (M, C)
  const void* dy;     // (M, C), backward only
  const float* mean;  // (C,), backward only
  const float* rstd;  // (C,), backward only
  float* partial;     // (splits, 2, C)
  int64_t n_rows;     // virtual rows
  int64_t R, S;       // block rows and block stride of the virtual -> physical map
  int64_t rows_per_split;
  int C;
};

template <typename T>
struct Vec;
template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  __device__ static void load(const void* base, int64_t off, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(base) + off);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const void* base, int64_t off, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
};

// grid (splits, slabs); slab = up to 32 channel vectors
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kRThreads) reduce_kernel(const __grid_constant__ ReduceArgs p) {
  constexpr int V = Vec<T>::kN;
  __shared__ float red[2][kRThreads * V];

  const int vecs = p.C / V;
  const int slab_vecs = vecs < 32 ? vecs : 32;
  const int c_vec = blockIdx.y * slab_vecs + threadIdx.x % slab_vecs;  // this thread's vector
  const int groups = kRThreads / slab_vecs;
  const int group = threadIdx.x / slab_vecs;
  const bool active = group < groups && c_vec < vecs;
  const int c0 = c_vec * V;

  float s0[V], s1[V], mu[V], rs[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s0[i] = 0.f;
    s1[i] = 0.f;
    mu[i] = 0.f;
    rs[i] = 0.f;
  }
  if (kBwd && active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mu[i] = p.mean[c0 + i];
      rs[i] = p.rstd[c0 + i];
    }
  }
  const int64_t vbeg = static_cast<int64_t>(blockIdx.x) * p.rows_per_split;
  const int64_t vend = vbeg + p.rows_per_split < p.n_rows ? vbeg + p.rows_per_split : p.n_rows;
  if (active) {
    for (int64_t v = vbeg + group; v < vend; v += static_cast<int64_t>(groups) * kRUnroll) {
      float xv[kRUnroll][V], gv[kRUnroll][V];
#pragma unroll
      for (int u = 0; u < kRUnroll; ++u) {
        const int64_t vr = v + static_cast<int64_t>(u) * groups;
        if (vr < vend) {
          const int64_t row = p.R == p.S ? vr : (vr / p.R) * p.S + vr % p.R;  // no 64-bit division at stride 1
          Vec<T>::load(p.x, row * p.C + c0, xv[u]);
          if (kBwd) Vec<T>::load(p.dy, row * p.C + c0, gv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            xv[u][i] = 0.f;
            gv[u][i] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (kBwd) {
            const float xhat = (xv[u][i] - mu[i]) * rs[i];
            s0[i] += gv[u][i];
            s1[i] += gv[u][i] * xhat;
          } else {
            s0[i] += xv[u][i];
            s1[i] += xv[u][i] * xv[u][i];
          }
        }
      }
    }
  }
  // the row groups' sums, added in group order by one thread per channel
  if (group < groups) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[0][group * slab_vecs * V + (threadIdx.x % slab_vecs) * V + i] = s0[i];
      red[1][group * slab_vecs * V + (threadIdx.x % slab_vecs) * V + i] = s1[i];
    }
  }
  __syncthreads();
  const int slab_c = slab_vecs * V;
  for (int c = threadIdx.x; c < 2 * slab_c; c += kRThreads) {
    const int q = c / slab_c, cc = c % slab_c;
    const int ch = blockIdx.y * slab_c + cc;
    if (ch >= p.C) continue;
    float t = 0.f;
    for (int gi = 0; gi < groups; ++gi) t += red[q][gi * slab_c + cc];
    p.partial[(static_cast<int64_t>(blockIdx.x) * 2 + q) * p.C + ch] = t;
  }
}

// out[q, c] = sum over splits of partial[s, q, c], in split order
__global__ void reduce_splits_kernel(const float* __restrict__ partial, float* __restrict__ out, int C,
                                     int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * C) return;
  float t = 0.f;
  for (int s = 0; s < splits; ++s) t += partial[static_cast<int64_t>(s) * 2 * C + e];
  out[e] = t;
}

template <typename T, bool kBwd>
int launch(const ReduceArgs& p, float* out, int splits, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  const int vecs = p.C / V;
  const int slab_vecs = vecs < 32 ? vecs : 32;
  const dim3 grid(splits, (vecs + slab_vecs - 1) / slab_vecs);
  reduce_kernel<T, kBwd><<<grid, kRThreads, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_splits_kernel<<<(2 * p.C + 255) / 256, 256, 0, stream>>>(p.partial, out, p.C, splits);
  return static_cast<int>(cudaGetLastError());
}

int run(const void* x, const void* dy, const void* mean, const void* rstd, void* partial, void* out,
        int64_t n_rows, int64_t R, int64_t S, int C, int is_f32, int splits, void* stream, bool bwd) {
  ReduceArgs p;
  p.x = x;
  p.dy = dy;
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.partial = static_cast<float*>(partial);
  p.n_rows = n_rows;
  p.R = R;
  p.S = S;
  p.rows_per_split = (n_rows + splits - 1) / splits;
  p.C = C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (is_f32) return bwd ? launch<float, true>(p, o, splits, s) : launch<float, false>(p, o, splits, s);
  return bwd ? launch<bf16, true>(p, o, splits, s) : launch<bf16, false>(p, o, splits, s);
}

}  // namespace argus

// out (2, C) f32: sum x, sum x^2 over the visited rows
extern "C" int argus_bn_stats(const void* x, void* partial, void* out, int64_t n_rows, int64_t R,
                              int64_t S, int C, int is_f32, int splits, void* stream) {
  return argus::run(x, nullptr, nullptr, nullptr, partial, out, n_rows, R, S, C, is_f32, splits, stream,
                    false);
}

// out (2, C) f32: sum dy, sum dy * (x - mean) * rstd over the visited rows
extern "C" int argus_bn_bwd_reduce(const void* x, const void* dy, const void* mean, const void* rstd,
                                   void* partial, void* out, int64_t n_rows, int64_t R, int64_t S, int C,
                                   int is_f32, int splits, void* stream) {
  return argus::run(x, dy, mean, rstd, partial, out, n_rows, R, S, C, is_f32, splits, stream, true);
}
