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
// a few operations per element). Design (`stream_kernel`), one launch a
// call, the work cut by the host's plan (bn_reduce.py `stats_plan`):
// - the visited rows are a 3-D tensor map (visited blocks of R rows, R
//   rows, C channels: the block stride S * C elements), read in boxes of
//   box_rows rows x one slab of at most 256 bytes of channels, so a strided
//   call is the same stream with the box coordinates skipping (S - R) rows
//   after every R: no gather and no division in the loop; TMA's zero fill
//   past M (stride 1) and past C adds nothing to a sum;
// - a persistent grid of one block an SM: block b reduces slab b % nslab
//   over its run of consecutive boxes; a producer warp keeps the run's
//   boxes in flight in a ring of eight 16 KB shared-memory stages on
//   mbarriers, eight consumer warps sum them in f32 (thread (g, j): 16-byte
//   vector j of every G-th row of a box, G = 256 / vectors a row) and
//   release each stage on its empty barrier;
// - the row groups are added in group order, each block writes its partial
//   sums, and the last block to finish (a ticket counter after a
//   __threadfence, reset by that block; the host keeps one a stream, so
//   launches on two streams never share one) adds the partials in split
//   order, as float4 columns of four channels, in `runs` runs a column
//   when C / 2 columns leave threads idle, then the runs in order: no
//   float atomics, the same bits from run to run.
// The previous form, a fixed grid of register loads and a second launch to
// add the partials, stays for timing as `argus_bn_stats_prev` /
// `argus_bn_bwd_reduce_prev` (bwd_prev.py). The TPU kernel's lane fold (C <
// 128 viewed as (M/f, f C)) only fills its 128 lanes and is not carried
// over.

#include <cstring>

#include "sm90.cuh"

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

// The previous form: grid (splits, slabs); slab = up to 32 channel vectors
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


// ───────────────────────────── the one-launch stream ─────────────────────────────

constexpr int kSConsumers = 256;              // eight consumer warps
constexpr int kSThreads = kSConsumers + 32;   // + the producer warp
constexpr int kSStages = 8;
constexpr int kSStage = 16384;                // a stage: one box (two in the backward)
constexpr int kSRed = 2 * kSConsumers * 8;    // floats of the row groups' sums (V <= 8)
constexpr int kSSmem = kSStages * kSStage + kSRed * 4 + 2 * kSStages * 8 + 128;

struct StreamArgs {
  CUtensorMap xmap;    // (nblk, R, C) of x, boxes of slab x box_rows x 1
  CUtensorMap dmap;    // the same over dy (kBwd)
  const float* mean;   // (C,), kBwd
  const float* rstd;   // (C,), kBwd
  float* partial;      // (grid, 2, slab)
  float* out;          // (2, C)
  unsigned int* ticket;  // 0 before the launch; the last block resets it
  int C, slab, box_rows, bpr, nslab, per, boxes, splits, runs;
};

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kSThreads, 1) stream_kernel(const __grid_constant__ StreamArgs p) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* red = reinterpret_cast<float*>(ring + kSStages * kSStage);  // [2][G][slab], then the final runs
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kSRed);
  uint64_t* empty = full + kSStages;
  __shared__ int last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int slab = blockIdx.x % p.nslab;
  const int i0 = (blockIdx.x / p.nslab) * p.per;  // this block's boxes [i0, i1)
  const int i1 = i0 + p.per < p.boxes ? i0 + p.per : p.boxes;
  const int box_bytes = p.box_rows * p.slab * static_cast<int>(sizeof(T));
  const int VR = p.slab / V;           // 16-byte vectors a box row
  const int G = kSConsumers / VR;      // row groups

  if (tid == 0) {
    for (int s = 0; s < kSStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kSConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kSConsumers / 32) {
    // the producer: box i is rows (i % bpr) * box_rows of visited block i / bpr
    if (lane == 0) {
      int blk = i0 / p.bpr;
      int rb = i0 - blk * p.bpr;
      for (int i = i0, k = 0; i < i1; ++i, ++k) {
        const int st = k % kSStages;
        if (k >= kSStages) mbar_wait(&empty[st], ((k / kSStages) - 1) & 1);
        mbar_expect_tx(&full[st], (kBwd ? 2 : 1) * box_bytes);
        tma_load_3d(ring + st * kSStage, &p.xmap, &full[st], slab * p.slab, rb * p.box_rows, blk);
        if (kBwd)
          tma_load_3d(ring + st * kSStage + box_bytes, &p.dmap, &full[st], slab * p.slab, rb * p.box_rows, blk);
        if (++rb == p.bpr) {
          rb = 0;
          ++blk;
        }
      }
    }
  } else {
    // the consumers: thread (g, j) sums vector j of rows g, g + G, ... of each box
    const int j = tid % VR, g = tid / VR;
    const bool active = g < G;
    const int c0 = slab * p.slab + j * V;  // this thread's first channel
    float s0[V], s1[V], mu[V], rs[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s0[i] = 0.f;
      s1[i] = 0.f;
      mu[i] = 0.f;
      rs[i] = 0.f;
    }
    if (kBwd && active && c0 < p.C) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        mu[i] = p.mean[c0 + i];
        rs[i] = p.rstd[c0 + i];
      }
    }
    for (int k = 0; i0 + k < i1; ++k) {
      const int st = k % kSStages;
      mbar_wait(&full[st], (k / kSStages) & 1);
      if (active) {
        const uint8_t* xs = ring + st * kSStage + j * 16;
#pragma unroll 4
        for (int r = g; r < p.box_rows; r += G) {
          float xv[V];
          Vec<T>::load(xs + r * VR * 16, 0, xv);  // a generic pointer into shared memory
          if (kBwd) {
            float gv[V];
            Vec<T>::load(xs + box_bytes + r * VR * 16, 0, gv);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              const float xhat = __fmul_rn(__fsub_rn(xv[i], mu[i]), rs[i]);
              s0[i] = __fadd_rn(s0[i], gv[i]);
              s1[i] = __fadd_rn(s1[i], __fmul_rn(gv[i], xhat));
            }
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) {
              s0[i] = __fadd_rn(s0[i], xv[i]);
              s1[i] = __fadd_rn(s1[i], __fmul_rn(xv[i], xv[i]));
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[(g * VR + j) * V + i] = s0[i];
        red[kSRed / 2 + (g * VR + j) * V + i] = s1[i];
      }
    }
  }
  __syncthreads();

  // the block's partial: the row groups added in group order
  for (int t = tid; t < 2 * p.slab; t += kSThreads) {
    const int q = t / p.slab, cl = t - q * p.slab;
    float v = 0.f;
    for (int gi = 0; gi < G; ++gi) v = __fadd_rn(v, red[q * (kSRed / 2) + gi * p.slab + cl]);
    p.partial[(static_cast<int64_t>(blockIdx.x) * 2 + q) * p.slab + cl] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: output column w (the four outputs o = 4w .. 4w + 3 of
  // the (2, C) output, one float4 of one slab's partials) sums the partials
  // of its slab's splits in split order, as `runs` contiguous runs, then the
  // runs in order; a thread sums four (run, column) pairs side by side, so
  // their loads are in flight together
  const int O = 2 * p.C, W4 = O / 4;
  const int L = (p.splits + p.runs - 1) / p.runs;
  const int pairs = W4 * p.runs;
  const int64_t split4 = static_cast<int64_t>(p.nslab) * 2 * p.slab / 4;  // float4s from one split to the next
  for (int base = tid; base < pairs; base += 4 * kSThreads) {
    float4 v[4];
    const float4* src[4];
    int s0[4], s1[4];  // the pair's splits [s0, s1)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pr = base + u * kSThreads;
      const int k = pr / W4, o = (pr - k * W4) * 4;
      const int q = o / p.C, c = o - q * p.C;
      const int sl = c / p.slab, cl = c - sl * p.slab;
      src[u] = reinterpret_cast<const float4*>(p.partial + (static_cast<int64_t>(sl) * 2 + q) * p.slab + cl);
      s0[u] = pr < pairs ? k * L : 0;
      s1[u] = pr < pairs ? ((k + 1) * L < p.splits ? (k + 1) * L : p.splits) : 0;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int sp = s0[u] + t;
        if (sp < s1[u]) {
          const float4 x = __ldcg(src[u] + sp * split4);
          v[u].x = __fadd_rn(v[u].x, x.x);
          v[u].y = __fadd_rn(v[u].y, x.y);
          v[u].z = __fadd_rn(v[u].z, x.z);
          v[u].w = __fadd_rn(v[u].w, x.w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pr = base + u * kSThreads;
      if (pr >= pairs) continue;
      const int k = pr / W4, o = (pr - k * W4) * 4;
      float* dst = p.runs == 1 ? p.out + o : red + k * O + o;
      dst[0] = v[u].x;
      dst[1] = v[u].y;
      dst[2] = v[u].z;
      dst[3] = v[u].w;
    }
  }
  if (p.runs > 1) {
    __syncthreads();
    for (int o = tid; o < O; o += kSThreads) {
      float v = 0.f;
      for (int k = 0; k < p.runs; ++k) v = __fadd_rn(v, red[k * O + o]);
      p.out[o] = v;
    }
  }
  if (tid == 0) *p.ticket = 0u;
}

// Host: a 3-D tensor map of the visited rows of an (M, C) view, dims
// innermost first (C, R, nblk) with the block stride S rows, boxes of slab
// x box_rows x 1, no swizzle (a box lands row-major), zero fill outside.
inline cudaError_t make_tmap_rows(CUtensorMap* map, const void* base, bool f32, int C, int R, int nblk, int S,
                                  int slab, int box_rows) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(R), static_cast<cuuint64_t>(nblk)};
  const cuuint64_t strides[2] = {C * e, static_cast<cuuint64_t>(S) * C * e};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(slab), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, bool kBwd>
static cudaError_t launch_stream(const StreamArgs& p, cudaStream_t stream) {
  static bool ready = false;  // once per instantiation: the shared-memory opt-in
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(stream_kernel<T, kBwd>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSSmem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  stream_kernel<T, kBwd><<<p.nslab * p.splits, kSThreads, kSSmem, stream>>>(p);
  return cudaGetLastError();
}

// the plan (bn_reduce.py `stats_plan`: R, S, nblk, C, is_f32, slab,
// box_rows, bpr, nslab, per, boxes, splits, runs, as the host caches them)
// and the maps; dy, mean, rstd nullptr for the statistics
int run_stream(const void* x, const void* dy, const void* mean, const void* rstd, void* partial, void* out,
               const int* plan, void* ticket, void* stream) {
  const int R = plan[0], S = plan[1], nblk = plan[2], C = plan[3], is_f32 = plan[4];
  const bool bwd = dy != nullptr;
  const int e = is_f32 ? 4 : 2;
  StreamArgs p;
  memset(&p, 0, sizeof(p));
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.partial = static_cast<float*>(partial);
  p.out = static_cast<float*>(out);
  p.ticket = static_cast<unsigned int*>(ticket);
  p.C = C;
  p.slab = plan[5];
  p.box_rows = plan[6];
  p.bpr = plan[7];
  p.nslab = plan[8];
  p.per = plan[9];
  p.boxes = plan[10];
  p.splits = plan[11];
  p.runs = plan[12];
  // the final runs are staged in `red` only when there are several
  if (ticket == nullptr || C % (16 / e) != 0 || p.slab % (16 / e) != 0 || p.slab % 4 != 0 ||
      p.slab / (16 / e) > kSConsumers || (bwd ? 2 : 1) * p.box_rows * p.slab * e > kSStage || p.runs < 1 ||
      (p.runs > 1 && 2 * C * p.runs > kSRed))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = make_tmap_rows(&p.xmap, x, is_f32, C, R, nblk, S, p.slab, p.box_rows);
  if (err == cudaSuccess && bwd) err = make_tmap_rows(&p.dmap, dy, is_f32, C, R, nblk, S, p.slab, p.box_rows);
  if (err == cudaSuccess) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_f32)
      err = bwd ? launch_stream<float, true>(p, st) : launch_stream<float, false>(p, st);
    else
      err = bwd ? launch_stream<bf16, true>(p, st) : launch_stream<bf16, false>(p, st);
  }
  return static_cast<int>(err);
}
}  // namespace argus

// The previous form (two launches; timing only): out (2, C) f32: sum x,
// sum x^2 over the visited rows
extern "C" int argus_bn_stats_prev(const void* x, void* partial, void* out, int64_t n_rows, int64_t R,
                                   int64_t S, int C, int is_f32, int splits, void* stream) {
  return argus::run(x, nullptr, nullptr, nullptr, partial, out, n_rows, R, S, C, is_f32, splits, stream,
                    false);
}

// The previous form (two launches; timing only): out (2, C) f32: sum dy,
// sum dy * (x - mean) * rstd over the visited rows
extern "C" int argus_bn_bwd_reduce_prev(const void* x, const void* dy, const void* mean, const void* rstd,
                                        void* partial, void* out, int64_t n_rows, int64_t R, int64_t S, int C,
                                        int is_f32, int splits, void* stream) {
  return argus::run(x, dy, mean, rstd, partial, out, n_rows, R, S, C, is_f32, splits, stream, true);
}

// out (2, C) f32: sum x, sum x^2 over the visited rows; ws: the grid's
// partials (nslab * splits, 2, slab) f32; plan: the 13 ints of
// `run_stream` (one pointer keeps the host's call short); ticket: one
// uint32, 0, of the stream's own (the launch leaves it 0)
extern "C" int argus_bn_stats(const void* x, void* ws, void* out, const void* plan, void* ticket, void* stream) {
  return argus::run_stream(x, nullptr, nullptr, nullptr, ws, out, static_cast<const int*>(plan), ticket, stream);
}

// out (2, C) f32: sum dy, sum dy * (x - mean) * rstd over the visited rows;
// as `argus_bn_stats`, with the plan of two streams
extern "C" int argus_bn_bwd_reduce(const void* x, const void* dy, const void* mean, const void* rstd, void* ws,
                                   void* out, const void* plan, void* ticket, void* stream) {
  return argus::run_stream(x, dy, mean, rstd, ws, out, static_cast<const int*>(plan), ticket, stream);
}
