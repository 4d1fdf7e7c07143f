// Hopper (sm_90a) building blocks of the wgmma/TMA engines
// (conv_dgrad_sm90.cuh, wgrad_sm90.cuh, conv_fwd_sm90.cuh): the
// shared-memory matrix descriptor of wgmma for the 128-byte swizzle, the
// warpgroup MMA itself (bf16 in, f32 accumulate), its fences, mbarriers,
// the 2-D, 3-D and 4-D TMA loads, the 4-D TMA store and its bulk groups, a
// named barrier, and the host-side tensor-map encoders reached
// through cudaGetDriverEntryPoint (no libcuda link).
//
// The 128-byte swizzle: a tile row is 64 bf16 (128 bytes, eight 16-byte
// chunks) and chunk j of row r sits at chunk j ^ (r % 8); TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes that layout, and the cp.async gathers
// write it by hand (`swz`). Every tile starts on a 1024-byte boundary, so
// the descriptor's base offset is 0.

#pragma once

#include <cuda.h>

#include "common.cuh"

namespace argus {

// byte offset of 16-byte chunk j of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

// wgmma's shared-memory descriptor, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
// K-major tiles (rows of 64 k): SBO = 1024 (8 rows), LBO unused. MN-major
// tiles (rows of 64 m or n, one row per k): SBO = 1024 (8 k rows), LBO =
// the distance between two 64-wide m/n blocks.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// generic-proxy shared writes (cp.async, the mask pass) -> visible to wgmma/TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x N f32, one warpgroup) = A (64 x 16) * B (16 x N) (+ D when sd is
// not 0), both from shared memory; _tAB: A K-major (0) or M-major (1), B
// N-major (1) in every engine.
__device__ __forceinline__ void wgmma_m64n64_t01(float (&d)[32], uint64_t da, uint64_t db, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(sd));
}
__device__ __forceinline__ void wgmma_m64n128_t01(float (&d)[64], uint64_t da, uint64_t db, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(sd));
}
__device__ __forceinline__ void wgmma_m64n64_t11(float (&d)[32], uint64_t da, uint64_t db, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(sd));
}
__device__ __forceinline__ void wgmma_m64n128_t11(float (&d)[64], uint64_t da, uint64_t db, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(sd));
}

__device__ __forceinline__ void wgmma_m64n256_t01(float (&d)[128], uint64_t da, uint64_t db, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(sd));
}

template <int N, int TA>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db, int sd);
template <>
__device__ __forceinline__ void wgmma<64, 0>(float (&d)[32], uint64_t da, uint64_t db, int sd) { wgmma_m64n64_t01(d, da, db, sd); }
template <>
__device__ __forceinline__ void wgmma<128, 0>(float (&d)[64], uint64_t da, uint64_t db, int sd) { wgmma_m64n128_t01(d, da, db, sd); }
template <>
__device__ __forceinline__ void wgmma<256, 0>(float (&d)[128], uint64_t da, uint64_t db, int sd) { wgmma_m64n256_t01(d, da, db, sd); }
template <>
__device__ __forceinline__ void wgmma<64, 1>(float (&d)[32], uint64_t da, uint64_t db, int sd) { wgmma_m64n64_t11(d, da, db, sd); }
template <>
__device__ __forceinline__ void wgmma<128, 1>(float (&d)[64], uint64_t da, uint64_t db, int sd) { wgmma_m64n128_t11(d, da, db, sd); }

// The epilogues' 16-byte vectors. A wgmma accumulator row gives the quad
// of lanes q = lane % 4 the pair of columns 8g + 2q, +1 of every 8-column
// group g; a 16-byte vector is one whole group. Four groups of a row move
// between the two layouts by a 4 x 4 transpose inside the quad (three
// shuffles), so the epilogue loads and stores whole 16-byte vectors.

// word k (0..3) of a vector
__device__ __forceinline__ uint32_t word4(uint32_t x, uint32_t y, uint32_t z, uint32_t w, int k) {
  return k & 2 ? (k & 1 ? w : z) : (k & 1 ? y : x);
}

// v: group q's vector (lane q of the quad); w[p]: this lane's pair of group p
__device__ __forceinline__ void quad_split(const uint4& v, uint32_t (&w)[4]) {
  const int q = threadIdx.x & 3;
  uint32_t r[4];  // round s: word q of group q ^ s
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t send = word4(v.x, v.y, v.z, v.w, q ^ s);
    r[s] = s == 0 ? send : __shfl_xor_sync(0xffffffffu, send, s);
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) w[g] = word4(r[0], r[1], r[2], r[3], g ^ q);
}

// the inverse: w[p], this lane's pair of group p -> group q's vector
__device__ __forceinline__ uint4 quad_join(const uint32_t (&w)[4]) {
  const int q = threadIdx.x & 3;
  uint32_t r[4];  // round s: word q ^ s of group q
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t send = word4(w[0], w[1], w[2], w[3], q ^ s);
    r[s] = s == 0 ? send : __shfl_xor_sync(0xffffffffu, send, s);
  }
  return make_uint4(word4(r[0], r[1], r[2], r[3], q), word4(r[0], r[1], r[2], r[3], 1 ^ q),
                    word4(r[0], r[1], r[2], r[3], 2 ^ q), word4(r[0], r[1], r[2], r[3], 3 ^ q));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// one arrival on the barrier (a consumer releasing a stage)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// waits until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 2-D TMA load of one box at (c0 innermost, c1) into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 3-D TMA load of one box at (c0 innermost, c1, c2)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 4-D TMA load of one box at (c0 innermost, c1, c2, c3); coordinates may be
// negative or run past the tensor, where the box is zero-filled
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 4-D TMA store of one box from shared memory at (c0 innermost, c1, c2, c3)
// into the tensor; elements outside the tensor are not written. The box
// leaves in the bulk group that `bulk_commit` closes.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// waits until at most N of this thread's bulk groups are still reading their
// shared-memory source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// waits until at most N of this thread's bulk groups are incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier of `threads` threads (a multiple of 32) on hardware barrier `id`
// (1-15; 0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Host: a 2-D bf16 tensor map of a row-major (rows, cols) matrix with a
// row stride of `ld` elements, boxes of 64 x 64 (128-byte rows), 128-byte
// swizzle, zero fill out of bounds. base and ld * 2 must be 16-byte
// aligned, which the wrappers' channel checks (% 8) guarantee.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess) return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

inline cudaError_t make_tmap_2d(CUtensorMap* map, const void* base, int64_t rows, int64_t cols, int64_t ld) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Host: a 3-D bf16 tensor map of a conv's weight rows (taps, C, COUT), an
// HWIO kernel with its taps flattened, dims innermost first (COUT, C, taps),
// boxes of 64 x 64 x 1 (one tap's 64 input channels x 64 output channels,
// 128-byte rows), 128-byte swizzle, zero fill out of bounds: a box's rows
// past C are zeros, not the next tap's rows. COUT % 8 == 0.
inline cudaError_t make_tmap_wrows(CUtensorMap* map, const void* base, int taps, int C, int COUT) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(COUT), static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(taps)};
  const cuuint64_t row = static_cast<cuuint64_t>(COUT) * 2;
  const cuuint64_t strides[2] = {row, row * C};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Host: a 4-D bf16 tensor map of an NHWC (N, H, W, C) activation, dims
// innermost first (C, W, H, N), traversed at stride S along W and H (the
// map's element strides), boxes of 64 channels x bw x bh x bn pixels (one
// 128-byte row per pixel), 128-byte swizzle, zero fill out of bounds
// (pixels outside the image, and channels past C where C % 64 != 0): the A
// operand of a conv tile at stride S, one box per (tap, 64 channels). A box
// dimension counts elements of the tensor and the map takes every S-th, so
// a box of S * bw columns lands bw pixels: bw x bh x bn x 128 bytes in
// shared memory at any S. base and C * 2 must be 16-byte aligned
// (C % 8 == 0); S * bw and S * bh at most 256, S at most 8.
inline cudaError_t make_tmap_nhwc(CUtensorMap* map, const void* base, int N, int H, int W, int C, int S, int bw,
                                  int bh, int bn) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t row = static_cast<cuuint64_t>(C) * 2;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(S * bw), static_cast<cuuint32_t>(S * bh),
                             static_cast<cuuint32_t>(bn)};
  const cuuint32_t estr[4] = {1, static_cast<cuuint32_t>(S), static_cast<cuuint32_t>(S), 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace argus
