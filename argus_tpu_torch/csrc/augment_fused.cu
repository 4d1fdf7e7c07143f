// The whole augmentation stack in one launch: spaghetti arcs, planckian
// gains, the colour jiggle in the sampled order, the gated gaussian and
// motion blurs (edge clamp) and the plasma shadow. (N, 3, H, W) f32 or bf16.
//
// Replaces: argus_tpu/ops/pallas/augment_fused.py `fused_augment` (:278, body
// `_make_kernel` :140, phases "awjbp"; `jiggle_plan` :105).
//
// Bound on the H100: one read and one write of the batch (0.12 ms for the
// flagship's 512 bf16 camera images at 256x256) against ~325 operations a
// pixel (chip_smoke.py `aug_ops`): ~180 in the image dtype (bf16x2 runs
// them at 133.8 TFLOP/s), the rest f32 (67 TFLOP/s: ~90 of them the arc
// tests, the hue, the luma mean, the plasma); ~0.12 ms of operations, so
// bound by bytes, about as much. The function does not go in one
// sweep over the pixels: the contrast op needs the mean luma of the image as
// it stands before it, the blur needs neighbours after the jiggle, and the
// plasma shade needs the min and max of the whole upsampled field.
//
// Design: a thread-block cluster of kCl blocks holds one image, a band of
// R = ceil(H / kCl) rows a block, in shared memory with a 3-row halo each
// side (the blurs' reach), so the batch is read once and written once
// (where the band does not fit, the kStream form below):
//   1. the band arrives by bulk copy (one contiguous run of rows a
//      channel; a cooperative load where the row bytes are not 16-byte
//      multiples), while the block forms its arc tables (each arc's dx a
//      column, dy a row) and T = mh @ field for its rows, over the nonzero
//      ranges of mh's rows and mwt's columns (the wrapper's, found once for
//      a pair of matrices);
//   2. arcs, gains and the jiggle ops before the contrast op, in place; the
//      partial luma sum and the min and max of the upsampled field;
//   3. one cluster barrier, then every block adds the cluster's partials
//      over distributed shared memory in rank order: the same mean, min and
//      max in every block, and the same bits from run to run;
//   4. the contrast op and the ops after it, in place, and the shade bit of
//      each pixel; a cluster barrier, then each block copies its halo rows
//      from the blocks that own them, over distributed shared memory (a
//      second barrier keeps them until every block has copied);
//   5. per channel: the 5-tap vertical gaussian as a window sliding down a
//      column strip in registers, the horizontal gaussian and its gate (in
//      place), then the 3x3 motion blur, its gate, the shade, out. Edge
//      clamps fall on the image's own border only.
// kStream, for images whose band does not fit (the wrapper picks the chunk
// height Rc < R): pass 2 reads the own rows chunk by chunk for the partials
// only; after the cluster's sums each chunk is read again with its 3-row
// halo, every op before the blurs runs on all its rows (pointwise ops
// recompute the halo exactly, so no rows cross between blocks), and the
// blurs follow. The image is read twice (and the halos), written once; the
// arcs' per-column dx is computed at the pixel, not kept in a table.
// Each thread works on two neighbouring pixels of a row at once, and walks
// its items by increments (no division an item). Rounding points are
// argus_tpu's: each image-dtype op in the image dtype with the f32 scalars
// cast at the op; the luma mean, the hue, the arcs and the plasma in f32,
// without fused multiply-adds. In the bf16 instantiation an image-dtype op
// is one packed bf16x2 instruction (two pixels): a correctly rounded bf16
// product or sum of two bf16 operands has the bits of the f32 op followed
// by one rounding, which is what the plain version computes
// (tests/test_torch_augment_sm90.py holds that premise).
// The jiggle plan (hue position, three affine op selectors) is device data:
// a branch uniform across the block costs nothing here, so one kernel serves
// every order and the host never reads the order back.

#include "augment_common.cuh"
#include "sm90.cuh"

// Phase cuts for scripts/time_torch_kernel_phases.py (0: the kernel): the
// resident form stops after step 1 (AUG_CUT 1), 2 (2) or 4 (3); AUG_NOHUE
// skips the hue op
#ifndef AUG_CUT
#define AUG_CUT 0
#endif
#ifndef AUG_NOHUE
#define AUG_NOHUE 0
#endif

namespace argus {

constexpr int kCl = 8;  // blocks of a cluster: one image (the portable cluster size)
constexpr int kAugThreads = 512;  // two blocks an SM (at most 64 registers a thread)
constexpr int kHalo = 3;  // rows of halo each side: the gaussian's 2 and the motion blur's 1

struct AugArgs {
  const void* img;      // (N, 3, H, W)
  const float* field;   // (N, S, S)
  const float* mh;      // (H, S)
  const float* mwt;     // (S, W)
  const float* packed;  // (N, row)
  const int* plan;      // [hue_pos, op0, op1, op2]
  const int* ranges;    // (H + W, 2): first and last nonzero of mh's rows, then of mwt's columns
  void* out;            // (N, 3, H, W)
  int H, W, S, n_arcs, row;
  int R;     // rows a block
  int Rc;    // rows a chunk: R (the band stays in shared memory) or fewer (kStream: chunks read twice)
  int Wp;    // a shared row: W rounded up to even (the last pair's second pixel repeats column W - 1)
  int bulk;  // the band arrives by bulk copy (W * itemsize % 16 == 0, img 16-byte aligned)
};

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }

// torch.remainder(a, 1) / jnp's a % 1 for the hue's finite values: the
// floor modulus equals a - floor(a) (both round the same exact value once;
// only the sign of a zero can differ, and it reaches no output)
__device__ __forceinline__ float frac1(float a) { return fs(a, floorf(a)); }

// RGB -> HSV, + shift on H, -> RGB, clipped, in f32 (ops/kernels/augment_common.py `adjust_hue`)
__device__ __forceinline__ void hue_shift(float* v, float shift) {
  const float r = v[0], g = v[1], b = v[2];
  const float maxc = fmaxf(fmaxf(r, g), b), minc = fminf(fminf(r, g), b);
  const float delta = fs(maxc, minc);
  const float safe = delta == 0.f ? 1.f : delta;
  const float s = maxc == 0.f ? 0.f : __fdiv_rn(delta, maxc == 0.f ? 1.f : maxc);
  // branch by channel ordering, never by equality with the recomputed max:
  // h = (off + num0 / safe) - num1 / safe, the two quotients the branch
  // takes (bc - gc, 2 + rc - bc, 4 + gc - rc; 0 + bc is bc)
  const bool rmax = r >= g && r >= b, gmax = !rmax && g >= b;
  const float off = rmax ? 0.f : (gmax ? 2.f : 4.f);
  const float n0 = fs(maxc, rmax ? b : (gmax ? r : g)), n1 = fs(maxc, rmax ? g : (gmax ? b : r));
  float h = fs(fa(off, __fdiv_rn(n0, safe)), __fdiv_rn(n1, safe));
  if (delta == 0.f) h = 0.f;
  h = frac1(__fdiv_rn(h, 6.f));
  h = frac1(fa(h, shift));
  const float h6 = fm(h, 6.f);
  const float i = floorf(h6);
  const float f = fs(h6, i);
  const float vv = maxc;
  const float p = fm(vv, fs(1.f, s));
  const float q = fm(vv, fs(1.f, fm(s, f)));
  const float t = fm(vv, fs(1.f, fm(s, fs(1.f, f))));
  const int k = static_cast<int>(i) % 6;  // i in 0..6 (6 where h rounds up to 1): the floor modulus by 6
  // sextant k: (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)
  const float r2 = k == 0 || k == 5 ? vv : (k == 1 ? q : (k == 4 ? t : p));
  const float g2 = k == 1 || k == 2 ? vv : (k == 0 ? t : (k == 3 ? q : p));
  const float b2 = k == 3 || k == 4 ? vv : (k == 2 ? t : (k == 5 ? q : p));
  v[0] = clip01(r2);
  v[1] = clip01(g2);
  v[2] = clip01(b2);
}

// the per-image scalars of the jiggle, cast to T at their ops
template <typename T>
struct Jiggle {
  typedef typename Pair<T>::V V;
  V a[3], b2, l[3];  // op k's factor a; saturation's luma factor; luma weights
  float cf1, hue;    // 1 - contrast factor (times the mean, then cast), the hue shift
};

template <typename T>
__device__ __forceinline__ typename Pair<T>::V luma2(const typename Pair<T>::V* v, const Jiggle<T>& j) {
  typedef Pair<T> P;
  return P::add(P::add(P::mul(j.l[0], v[0]), P::mul(j.l[1], v[1])), P::mul(j.l[2], v[2]));
}

// one jiggle op on a pair of pixels: 3 the hue (f32, rounded once a channel),
// else clip(a x + b luma(x) + g mean) with the terms the op has (the others
// are exact zeros: a product by a zero factor adds nothing)
template <typename T>
__device__ __forceinline__ void jiggle_op(typename Pair<T>::V* v, int op, const Jiggle<T>& j,
                                          typename Pair<T>::V gm) {
  typedef Pair<T> P;
  if (op == 3) {
    if (AUG_NOHUE) return;
    float lo[3] = {P::lo(v[0]), P::lo(v[1]), P::lo(v[2])};
    float hi[3] = {P::hi(v[0]), P::hi(v[1]), P::hi(v[2])};
    hue_shift(lo, j.hue);
    hue_shift(hi, j.hue);
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = P::make(lo[c], hi[c]);
    return;
  }
  if (op == 2) {
    const typename P::V bl = P::mul(j.b2, luma2<T>(v, j));
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = P::clip01(P::add(P::mul(j.a[2], v[c]), bl));
  } else if (op == 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = P::clip01(P::add(P::mul(j.a[1], v[c]), gm));
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = P::clip01(P::mul(j.a[0], v[c]));
  }
}

// whether a pixel at offsets (dx, dy) from an arc's centre, on its ring,
// lies in its sweep: sign tests on two cross products with u = (sw.x, sw.y)
// and v = (sw.z, sw.w), either (wide) or both
__device__ __forceinline__ bool in_sweep(float4 sw, bool wide, float dx, float dy) {
  const bool pu = fs(fm(sw.x, dy), fm(sw.y, dx)) >= 0.f;
  const bool pv = fs(fm(dx, sw.w), fm(dy, sw.z)) >= 0.f;
  return (pu && pv) || (wide && (pu || pv));
}

// whether the two pixels of a pair lie on any arc (ops/kernels/augment_common.py
// `arc_mask`): dxof(a) gives arc a's dx of the pair's two columns, dyr[a]
// its (dy, dy^2) of the row and squared ring bounds (lo^2, hi^2), lo =
// max(1 - hws, 0), hi = 1 + hws, swp[2 a] its sweep (ux, uy, vx, vy) and
// swp[2 a + 1] its (wide flag, cx, 1 / rx). The same f32 ops as the plain
// version, the column's, the row's and the arc's terms taken from the
// tables.
template <typename DX>
__device__ __forceinline__ void on_arcs(const float4* swp, const float4* dyr, int n_arcs, DX dxof, bool& o0,
                                        bool& o1) {
  bool a0 = false, a1 = false;
  for (int a = 0; a < n_arcs; ++a) {
    const float4 r = dyr[a];
    // rho2 = dx^2 + dy^2 rounded is at least dy^2: where dy^2 >= hi^2 the
    // row misses the ring (a branch uniform across the row's threads)
    if (r.y >= r.w) continue;
    const float2 d = dxof(a);
    const float rho0 = fa(fm(d.x, d.x), r.y), rho1 = fa(fm(d.y, d.y), r.y);
    const bool g0 = rho0 > r.z && rho0 < r.w, g1 = rho1 > r.z && rho1 < r.w;
    if (g0 || g1) {
      const float4 sw = swp[2 * a];
      const bool wide = swp[2 * a + 1].x > 0.5f;
      a0 = a0 || (g0 && in_sweep(sw, wide, d.x, r.x));
      a1 = a1 || (g1 && in_sweep(sw, wide, d.y, r.x));
    }
  }
  o0 = a0;
  o1 = a1;
}

// the upsampled field at (own row y, column x): sum over k of T[y][k]
// mwt[k][x] over the column's nonzero range of mwt (the terms outside it are
// exact zeros, so the sum is the dense one's)
__device__ __forceinline__ float upsampled(const float* Ty, const float* mwt, const int* kr, int W, int x) {
  float acc = 0.f;
  for (int k = kr[2 * x]; k <= kr[2 * x + 1]; ++k) acc = fa(acc, fm(Ty[k], __ldg(mwt + k * W + x)));
  return acc;
}

// ───────────── the cluster ─────────────

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }
// the value at `p` in block `rank`'s shared memory (p: an address of ours;
// every block lays its shared memory out alike), a 32-bit word at a time
template <typename V>
__device__ __forceinline__ V ld_cluster(const V* p, uint32_t rank) {
  static_assert(sizeof(V) % 4 == 0, "whole words");
  V v;
  uint32_t* d = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(V) / 4); ++i) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p) + 4 * i), "r"(rank));
    asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(d[i]) : "r"(remote) : "memory");
  }
  return v;
}

// a thread's next item (row r, pair q) of a walk over rows of PR pairs that
// advances by the block's thread count, dr rows and dq pairs (no division)
__device__ __forceinline__ void next_item(int& r, int& q, int dr, int dq, int PR) {
  q += dq;
  r += dr;
  if (q >= PR) {
    q -= PR;
    ++r;
  }
}

// ───────────── shared memory ─────────────

// byte offsets of a block's buffers (the wrapper's `smem_bytes` mirrors this)
struct AugSmem {
  int x, g, t, dx, dy, sw, kr, jr, shb, red, bar, total;
  __host__ __device__ AugSmem(int R, int Rc, int Wp, int S, int n_arcs, int isz) {
    auto up = [](int v) { return (v + 15) & ~15; };
    x = 0;                                                // 3 x (Rc + 6) x Wp, T: the chunk and its halo
    g = x + up(3 * (Rc + 2 * kHalo) * Wp * isz);          // (Rc + 2) x Wp, T: one channel's vertical gaussian
    t = g + up((Rc + 2) * Wp * isz);                      // R x S f32: mh @ field, own rows
    dx = t + up(R * S * 4);                               // n_arcs x Wp f32: each arc's dx a column (Rc = R only)
    dy = dx + up(Rc < R ? 0 : n_arcs * Wp * 4);           // (R + 6) x n_arcs x 4 f32: (dy, dy^2, lo^2, hi^2) a row
    sw = dy + up((R + 2 * kHalo) * n_arcs * 16);          // n_arcs x 8 f32: (ux, uy, vx, vy), (wide, cx, 1 / rx, -)
    kr = sw + up(n_arcs * 32);                            // Wp x 2 int: mwt's column ranges
    jr = kr + up(Wp * 8);                                 // R x 2 int: mh's row ranges
    shb = jr + up(R * 8);                                 // Rc x Wp / 2 bytes: the shade bits of a pair
    red = shb + up(Rc * (Wp / 2));                        // 48 f32: reductions, 4 f32: the cluster's partials
    bar = red + up(52 * 4);                               // the band's mbarrier
    total = bar + 16;
  }
};

template <typename T, bool kStream>
__global__ void __cluster_dims__(kCl, 1, 1) __launch_bounds__(kAugThreads, 2)
    augment_kernel(const __grid_constant__ AugArgs p) {
  typedef Pair<T> P;
  typedef typename P::V V;
  extern __shared__ __align__(128) uint8_t smem[];
  const int H = p.H, W = p.W, S = p.S, R = p.R, Rc = p.Rc, Wp = p.Wp, HW = H * W, A = p.n_arcs;
  const int PR = Wp / 2;  // pairs a row
  const AugSmem L(R, Rc, Wp, S, A, sizeof(T));
  V* X = reinterpret_cast<V*>(smem + L.x);
  V* G = reinterpret_cast<V*>(smem + L.g);
  float* Ts = reinterpret_cast<float*>(smem + L.t);
  float2* dxs = reinterpret_cast<float2*>(smem + L.dx);
  float4* dys = reinterpret_cast<float4*>(smem + L.dy);
  float4* swp = reinterpret_cast<float4*>(smem + L.sw);
  int* kr = reinterpret_cast<int*>(smem + L.kr);
  int* jr = reinterpret_cast<int*>(smem + L.jr);
  uint8_t* shb = smem + L.shb;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* part = red + 48;  // [luma sum, field min, field max]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int tid = threadIdx.x, nt = kAugThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t rank = cluster_rank();
  const int n = blockIdx.x / kCl;
  // own rows [r0, r1); rows held [l0, l1) (the halo clipped to the image),
  // their arc rows from dys's row 0, image row d0; a chunk [c0, c1) of the
  // own rows sits with its halo in X, image row r at band row r - (c0 - kHalo)
  const int r0 = min(H, static_cast<int>(rank) * R), r1 = min(H, r0 + R);
  const int d0 = r0 - kHalo;
  const int l0 = r1 > r0 ? max(0, r0 - kHalo) : r0, l1 = r1 > r0 ? min(H, r1 + kHalo) : r0;
  const int CH = (Rc + 2 * kHalo) * PR;  // pairs of a channel's band
  const int dr = nt / PR, dq = nt % PR;  // a walk's step

  const size_t off = static_cast<size_t>(n) * 3 * HW;
  const T* img = static_cast<const T*>(p.img) + off;
  T* out = static_cast<T*>(p.out) + off;
  const float* w = p.packed + static_cast<size_t>(n) * p.row;
  const float* gains = w + 10 * A;
  const float* jf = gains + 3;
  const float* gw = jf + 4;
  const float* mk = gw + 5;
  const float ggate = mk[9], mgate = mk[10], intensity = mk[11], quantity = mk[12];

  // image rows [a, b) (a < b) into the band whose row 0 is image row b0: a
  // bulk copy a channel, completing on `bar`, or a cooperative load (pair
  // (2q, 2q + 1) of a row; an odd W repeats column W - 1 in the last pair);
  // `await` completes either
  int parity = 0;
  auto issue = [&](int a, int b, int b0) {
    if (p.bulk) {
      if (tid == 0) {
        const uint32_t bytes = static_cast<uint32_t>((b - a) * W * sizeof(T));
        mbar_expect_tx(bar, 3 * bytes);
        for (int c = 0; c < 3; ++c)
          bulk_load(X + c * CH + (a - b0) * PR, img + (static_cast<size_t>(c) * H + a) * W, bytes, bar);
      }
      return;
    }
    for (int r = a + tid / PR, q = tid % PR; r < b; next_item(r, q, dr, dq, PR)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T* src = img + (static_cast<size_t>(c) * H + r) * W;
        X[c * CH + (r - b0) * PR + q] = P::make(to_f32(src[2 * q]), to_f32(src[min(2 * q + 1, W - 1)]));
      }
    }
  };
  auto await = [&]() {
    if (p.bulk) {
      mbar_wait(bar, parity);
      parity ^= 1;
    }
    __syncthreads();
  };

  // 1. the band, in the resident form; the tables meanwhile
  if (p.bulk && tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!kStream && r1 > r0) issue(r0, r1, r0 - kHalo);
  for (int i = tid; i < (kStream ? 0 : A * PR); i += nt) {  // column x >= W (the pad) takes column W - 1's
    const int a = i / PR, x = 2 * (i % PR);
    const float cx = w[10 * a], irx = w[10 * a + 2];
    dxs[i] = make_float2(fm(fs(static_cast<float>(x), cx), irx),
                         fm(fs(static_cast<float>(min(x + 1, W - 1)), cx), irx));
  }
  for (int a = tid; a < A; a += nt) {
    swp[2 * a] = make_float4(w[10 * a + 5], w[10 * a + 6], w[10 * a + 7], w[10 * a + 8]);
    swp[2 * a + 1] = make_float4(w[10 * a + 9], w[10 * a], w[10 * a + 2], 0.f);
  }
  for (int i = tid; i < (l1 - l0) * A; i += nt) {
    const int r = l0 + i / A, a = i % A;
    const float dy = fm(fs(static_cast<float>(r), w[10 * a + 1]), w[10 * a + 3]);
    const float hws = w[10 * a + 4];
    const float lo = fmaxf(fs(1.f, hws), 0.f), hi = fa(1.f, hws);
    dys[(r - d0) * A + a] = make_float4(dy, fm(dy, dy), fm(lo, lo), fm(hi, hi));
  }
  // the nonzero ranges of mwt's columns (the pad takes column W - 1's) and of mh's own rows
  const int2* rg = reinterpret_cast<const int2*>(p.ranges);
  for (int x = tid; x < Wp; x += nt) reinterpret_cast<int2*>(kr)[x] = rg[H + min(x, W - 1)];
  for (int y = tid; y < r1 - r0; y += nt) reinterpret_cast<int2*>(jr)[y] = rg[r0 + y];
  __syncthreads();
  const float* field = p.field + static_cast<size_t>(n) * S * S;
  for (int i = tid; i < (r1 - r0) * S; i += nt) {  // T = mh @ field over the own rows
    const int y = i / S, k = i % S;
    float acc = 0.f;
    for (int j = jr[2 * y]; j <= jr[2 * y + 1]; ++j)
      acc = fa(acc, fm(__ldg(p.mh + (r0 + y) * S + j), __ldg(field + j * S + k)));
    Ts[i] = acc;
  }

  // the jiggle as four ops in order, two bits each (op o at bits 2o); exactly
  // one of them is the contrast, at cpos
  int seq = 0, k = 0, cpos = 0;
  const int hue_pos = p.plan[0];
  for (int r = 0; r < 3; ++r) {
    if (r == hue_pos) seq |= 3 << (2 * k++);
    seq |= p.plan[1 + r] << (2 * k++);
  }
  if (hue_pos == 3) seq |= 3 << (2 * k++);
  for (int i = 0; i < 4; ++i)
    if (((seq >> (2 * i)) & 3) == 1) cpos = i;
  Jiggle<T> jg;
  jg.a[0] = P::splat(rnd<T>(jf[0]));
  jg.a[1] = P::splat(rnd<T>(jf[1]));
  jg.a[2] = P::splat(rnd<T>(jf[2]));
  jg.b2 = P::splat(rnd<T>(fs(1.f, jf[2])));
  jg.l[0] = P::splat(rnd<T>(0.299f));
  jg.l[1] = P::splat(rnd<T>(0.587f));
  jg.l[2] = P::splat(rnd<T>(0.114f));
  jg.cf1 = fs(1.f, jf[1]);
  jg.hue = jf[3];
  const V gn[3] = {P::splat(rnd<T>(gains[0])), P::splat(rnd<T>(gains[1])), P::splat(rnd<T>(gains[2]))};
  __syncthreads();  // T
  if (!kStream && r1 > r0) await();
#if AUG_CUT == 1
  if (P::lo(X[tid]) == 0.123f || Ts[tid] == 0.5f) out[tid] = from_f32<T>(1.f);
  return;
#endif

  // arcs, gains and the ops before the contrast on the pair (r, 2q)
  auto pre = [&](int r, int q, V* v) {
    if (A > 0) {
      bool o0, o1;
      if (!kStream) {  // dx from the table
        on_arcs(swp, dys + (r - d0) * A, A, [&](int a) { return dxs[a * PR + q]; }, o0, o1);
      } else {  // dx at the pixel (column W - 1 for the pad)
        const float x0 = static_cast<float>(2 * q), x1 = static_cast<float>(min(2 * q + 1, W - 1));
        on_arcs(swp, dys + (r - d0) * A, A, [&](int a) {
          const float4 c = swp[2 * a + 1];
          return make_float2(fm(fs(x0, c.y), c.z), fm(fs(x1, c.y), c.z));
        }, o0, o1);
      }
      if (o0 || o1) {
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = P::make(o0 ? 0.f : P::lo(v[c]), o1 ? 0.f : P::hi(v[c]));
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = P::clip01(P::mul(v[c], gn[c]));
    for (int o = 0; o < cpos; ++o) jiggle_op<T>(v, (seq >> (2 * o)) & 3, jg, P::splat(0.f));
  };

  // 2. arcs, gains and the ops before the contrast (in place where the band
  // stays); the luma sum and the field's min and max, chunk by chunk
  float lsum = 0.f, lmin = __int_as_float(0x7f800000), lmax = -lmin;
  const bool odd = W & 1;
  for (int c0 = r0; c0 < r1; c0 += Rc) {
    const int c1 = min(r1, c0 + Rc), b0 = c0 - kHalo;
    if (kStream) {
      __syncthreads();  // the last chunk is read
      issue(c0, c1, b0);
      await();
    }
    for (int r = c0 + tid / PR, q = tid % PR; r < c1; next_item(r, q, dr, dq, PR)) {
      const int x = 2 * q;
      V* px = X + (r - b0) * PR + q;
      V v[3] = {px[0], px[CH], px[2 * CH]};
      pre(r, q, v);
      if (!kStream) {
#pragma unroll
        for (int c = 0; c < 3; ++c) px[c * CH] = v[c];
      }
      const V lu = luma2<T>(v, jg);
      const float* Ty = Ts + (r - r0) * S;
      const float u0 = upsampled(Ty, p.mwt, kr, W, x);
      lsum = fa(lsum, P::lo(lu));
      lmin = fminf(lmin, u0);
      lmax = fmaxf(lmax, u0);
      if (!odd || x + 1 < W) {
        const float u1 = upsampled(Ty, p.mwt, kr, W, x + 1);
        lsum = fa(lsum, P::hi(lu));
        lmin = fminf(lmin, u1);
        lmax = fmaxf(lmax, u1);
      }
    }
  }
#if AUG_CUT == 2
  if (lsum == 1234.5f || lmin == 1234.5f) out[tid] = from_f32<T>(lmax);
  return;
#endif
  // the block's partials: warps in order, then the cluster's in rank order
  for (int o = 16; o > 0; o >>= 1) {
    lsum = fa(lsum, __shfl_down_sync(0xffffffffu, lsum, o));
    lmin = fminf(lmin, __shfl_down_sync(0xffffffffu, lmin, o));
    lmax = fmaxf(lmax, __shfl_down_sync(0xffffffffu, lmax, o));
  }
  if (lane == 0) {
    red[3 * warp] = lsum;
    red[3 * warp + 1] = lmin;
    red[3 * warp + 2] = lmax;
  }
  __syncthreads();
  if (tid == 0) {
    float s = red[0], mn = red[1], mx = red[2];
    for (int i = 1; i < nt / 32; ++i) {
      s = fa(s, red[3 * i]);
      mn = fminf(mn, red[3 * i + 1]);
      mx = fmaxf(mx, red[3 * i + 2]);
    }
    part[0] = s;
    part[1] = mn;
    part[2] = mx;
  }
  // 3. the cluster's partials, in rank order, in every block
  cluster_arrive();
  cluster_wait();
  if (tid < 3) {
    float v = ld_cluster(part + tid, 0u);
    for (uint32_t b = 1; b < kCl; ++b) {
      const float u = ld_cluster(part + tid, b);
      v = tid == 0 ? fa(v, u) : (tid == 1 ? fminf(v, u) : fmaxf(v, u));
    }
    red[tid] = v;
  }
  __syncthreads();
  const float mean = __fdiv_rn(red[0], static_cast<float>(HW));
  const float fmin = red[1], range = fmaxf(fs(red[2], fmin), 1e-6f);
  const V gm = P::splat(rnd<T>(fm(jg.cf1, mean)));

  // the contrast and the ops after it on a pair; the shade bits of (r, 2q)
  auto post = [&](V* v) {
    for (int o = cpos; o < 4; ++o) jiggle_op<T>(v, (seq >> (2 * o)) & 3, jg, gm);
  };
  auto shade_bits = [&](int r, int q) {
    const int x = 2 * q;
    const float* Ty = Ts + (r - r0) * S;
    const float pl0 = __fdiv_rn(fs(upsampled(Ty, p.mwt, kr, W, x), fmin), range);
    const float pl1 = __fdiv_rn(fs(upsampled(Ty, p.mwt, kr, W, min(x + 1, W - 1)), fmin), range);
    return static_cast<uint8_t>((pl0 < quantity ? 1 : 0) | (pl1 < quantity ? 2 : 0));
  };

  // 5. the blurs of the own rows [c0, c1) held in X, a channel at a time
  // (`cl`: wait for the cluster's halo copy after the first vertical pass)
  const V w5[5] = {P::splat(rnd<T>(gw[0])), P::splat(rnd<T>(gw[1])), P::splat(rnd<T>(gw[2])),
                   P::splat(rnd<T>(gw[3])), P::splat(rnd<T>(gw[4]))};
  const V gg = P::splat(rnd<T>(ggate)), gg1 = P::splat(rnd<T>(fs(1.f, ggate)));
  const V mg = P::splat(rnd<T>(mgate)), mg1 = P::splat(rnd<T>(fs(1.f, mgate)));
  const float s0 = rnd<T>(fm(0.f, intensity)), s1 = rnd<T>(fm(1.f, intensity));
  const V m9[9] = {P::splat(rnd<T>(mk[0])), P::splat(rnd<T>(mk[1])), P::splat(rnd<T>(mk[2])),
                   P::splat(rnd<T>(mk[3])), P::splat(rnd<T>(mk[4])), P::splat(rnd<T>(mk[5])),
                   P::splat(rnd<T>(mk[6])), P::splat(rnd<T>(mk[7])), P::splat(rnd<T>(mk[8]))};
  auto blur = [&](int c0, int c1, bool cl) {
    const int b0 = c0 - kHalo;
    auto at = [&](int r) { return (min(max(r, 0), H - 1) - b0) * PR; };  // the band row of image row r, clamped
    // rows of the vertical gaussian and its gate: the own rows and one each side
    const int g0 = c1 > c0 ? max(0, c0 - 1) : c0, g1 = c1 > c0 ? min(H, c1 + 1) : c0;
    const int gb = c0 - 1;  // G's row 0
    // the vertical pass: strips of rows a thread, a column pair each
    const int strips = max(1, nt / PR), slen = (g1 - g0 + strips - 1) / strips;
    __syncthreads();
    for (int c = 0; c < 3; ++c) {
      const V* Xc = X + c * CH;
      for (int i = tid; i < PR * strips; i += nt) {
        const int q = i % PR, s = i / PR;
        const int ra = g0 + s * slen, rb = min(g1, ra + slen);
        if (ra >= rb) continue;
        V win[5];
#pragma unroll
        for (int t = 0; t < 4; ++t) win[t] = Xc[at(ra - 2 + t) + q];
        for (int r = ra; r < rb; ++r) {
          win[4] = Xc[at(r + 2) + q];
          G[(r - gb) * PR + q] = tap5<T, false>(w5, win[0], win[1], win[2], win[3], win[4]);
#pragma unroll
          for (int t = 0; t < 4; ++t) win[t] = win[t + 1];
        }
      }
      __syncthreads();
      if (cl && c == 0) cluster_wait();  // every block has copied its halo from these rows
      // the horizontal pass and its gate, over X's rows in place
      for (int r = g0 + tid / PR, q = tid % PR; r < g1; next_item(r, q, dr, dq, PR)) {
        const V* gr = G + (r - gb) * PR;
        const V cc = gr[q];
        const V lf = q > 0 ? gr[q - 1] : P::dup_lo(cc);
        const V rt = q + 1 < PR ? gr[q + 1] : P::dup_hi(cc);
        V* px = X + c * CH + (r - b0) * PR + q;
        V v = gate<T>(gg, gg1, hgauss<T, false>(w5, lf, cc, rt), *px);
        if (odd && q + 1 == PR) v = P::dup_lo(v);  // the pad repeats column W - 1
        *px = v;
      }
      __syncthreads();
      // the motion blur, its gate, the shade, out
      T* oc = out + static_cast<size_t>(c) * HW;
      for (int r = c0 + tid / PR, q = tid % PR; r < c1; next_item(r, q, dr, dq, PR)) {
        V lf[3], cc[3], rt[3];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const V* gr = Xc + at(r + ky - 1);
          cc[ky] = gr[q];
          lf[ky] = q > 0 ? gr[q - 1] : P::dup_lo(cc[ky]);
          rt[ky] = q + 1 < PR ? gr[q + 1] : P::dup_hi(cc[ky]);
        }
        const uint8_t b = shb[(r - c0) * PR + q];
        const V sh = P::make(b & 1 ? s1 : s0, b & 2 ? s1 : s0);
        const V v = P::clip01(P::add(gate<T>(mg, mg1, motion9<T, false>(m9, lf, cc, rt), cc[1]), sh));
        T* dst = oc + static_cast<size_t>(r) * W + 2 * q;
        if (!odd) {
          *reinterpret_cast<V*>(dst) = v;
        } else {
          dst[0] = from_f32<T>(P::lo(v));
          if (2 * q + 1 < W) dst[1] = from_f32<T>(P::hi(v));
        }
      }
    }
  };

  if (!kStream) {
    // 4. the contrast and the ops after it, in place; the shade bits
    const int b0 = r0 - kHalo;
    for (int r = r0 + tid / PR, q = tid % PR; r < r1; next_item(r, q, dr, dq, PR)) {
      V* px = X + (r - b0) * PR + q;
      V v[3] = {px[0], px[CH], px[2 * CH]};
      post(v);
#pragma unroll
      for (int c = 0; c < 3; ++c) px[c * CH] = v[c];
      shb[(r - r0) * PR + q] = shade_bits(r, q);
    }
    // every block's rows are done (and the partials read): each takes its
    // halo rows from the blocks that own them
    cluster_arrive();
    cluster_wait();
    const int nh = (r0 - l0) + (l1 - r1);  // halo rows: [l0, r0), then [r1, l1)
    for (int j = tid / PR, q = tid % PR; j < nh; next_item(j, q, dr, dq, PR)) {
      const int r = j < r0 - l0 ? l0 + j : r1 + j - (r0 - l0);
      const int o = r / R;  // the owner, whose band row 0 is image row o R - kHalo
      const int src = (r - (o * R - kHalo)) * PR + q, dst = (r - b0) * PR + q;
#pragma unroll
      for (int c = 0; c < 3; ++c) X[c * CH + dst] = ld_cluster(X + c * CH + src, static_cast<uint32_t>(o));
    }
    cluster_arrive();  // done reading the others' rows: waited for before this block's rows change
#if AUG_CUT == 3
    __syncthreads();
    if (P::lo(X[tid]) == 0.123f || shb[tid] == 77) out[tid] = from_f32<T>(1.f);
    cluster_wait();
    return;
#endif
    blur(r0, r1, true);
  } else {
    cluster_arrive();  // done reading the others' partials: waited for before this block exits
    // 4. chunk by chunk: the chunk and its halo again from the image, every
    // op before the blurs on all its rows (the halo's too: pointwise ops
    // recompute exactly), the shade bits of its own rows, then the blurs
    for (int c0 = r0; c0 < r1; c0 += Rc) {
      const int c1 = min(r1, c0 + Rc), b0 = c0 - kHalo;
      const int h0 = max(0, c0 - kHalo), h1 = min(H, c1 + kHalo);
      fence_proxy_async();  // the last chunk's stores before the bulk copy overwrites them
      __syncthreads();
      issue(h0, h1, b0);
      await();
      for (int r = h0 + tid / PR, q = tid % PR; r < h1; next_item(r, q, dr, dq, PR)) {
        V* px = X + (r - b0) * PR + q;
        V v[3] = {px[0], px[CH], px[2 * CH]};
        pre(r, q, v);
        post(v);
#pragma unroll
        for (int c = 0; c < 3; ++c) px[c * CH] = v[c];
        if (r >= c0 && r < c1) shb[(r - c0) * PR + q] = shade_bits(r, q);
      }
      blur(c0, c1, false);
    }
    cluster_wait();
  }
}

template <typename T, bool kStream>
int launch(const AugArgs& p, int N, cudaStream_t st) {
  const int smem = AugSmem(p.R, p.Rc, p.Wp, p.S, p.n_arcs, sizeof(T)).total;
  cudaError_t e =
      cudaFuncSetAttribute(augment_kernel<T, kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  augment_kernel<T, kStream><<<N * kCl, kAugThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace argus

extern "C" int argus_augment_fused(const void* img, const void* field, const void* mh, const void* mwt,
                                   const void* packed, const void* plan, const void* ranges, void* out, int N,
                                   int H, int W, int S, int n_arcs, int Rc, int is_bf16, void* stream) {
  using namespace argus;
  AugArgs p;
  p.img = img;
  p.field = static_cast<const float*>(field);
  p.mh = static_cast<const float*>(mh);
  p.mwt = static_cast<const float*>(mwt);
  p.packed = static_cast<const float*>(packed);
  p.plan = static_cast<const int*>(plan);
  p.ranges = static_cast<const int*>(ranges);
  p.out = out;
  p.H = H;
  p.W = W;
  p.S = S;
  p.n_arcs = n_arcs;
  p.row = 10 * n_arcs + 25;
  p.R = (H + kCl - 1) / kCl;
  if (Rc < 1 || Rc > p.R) return static_cast<int>(cudaErrorInvalidValue);
  p.Rc = Rc;
  p.Wp = W + (W & 1);
  const int isz = is_bf16 ? 2 : 4;
  p.bulk = (W * isz) % 16 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Rc < p.R) return is_bf16 ? launch<bf16, true>(p, N, st) : launch<float, true>(p, N, st);
  return is_bf16 ? launch<bf16, false>(p, N, st) : launch<float, false>(p, N, st);
}
