// Building blocks of the Hopper (sm_90a) attention kernels, shared by
// flash_attention_fwd.cu and flash_attention_bwd.cu: the 128-byte swizzled
// tile layout, cp.async copies, TMA tile copies and the mbarriers they
// complete on, wgmma descriptors and products, their fences, and small
// conversions. Each source includes it into its own anonymous
// namespace, so nothing here has external linkage.
//
// Tiles: rows of 64 bf16 values (128 bytes) whose 16-byte chunks are
// XOR-swizzled by row % 8 (the 128-byte swizzle), 1024-byte aligned. One
// descriptor form (sw128_desc) serves such a tile as a K-major operand and,
// read along its other axis, as an MN-major one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSwRow = 64;  // bf16 values in a row of a swizzled tile
constexpr float kLog2e = 1.4426950408889634f;

// Element offset of 16-byte chunk `chunk` of row r in a swizzled tile.
__device__ __forceinline__ int sw_at(int r, int chunk) {
  return r * kSwRow + ((chunk ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier at `bar` in shared memory, expecting `count` arrivals a phase
// (one thread initialises it, then fence_mbarrier_init and a block barrier
// publish it)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes this thread's mbarrier initialisations visible to the async proxy
// (the copy engine completes TMA copies on them).
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on `bar` that also expects `bytes` of asynchronous copies to
// complete on it before its phase does.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One thread: the box at coordinates (c0, c1, c2) of the 3-D TMA tensor map
// `map` (the address of a __grid_constant__ CUtensorMap kernel parameter)
// into shared memory at dst, by the copy engine, completing its bytes on
// `bar`. With the map's 128-byte swizzle and dst 1024-byte aligned, a box
// of rows of 64 bf16 values lands in the layout of sw_at and sw128_desc.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major bf16 tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1024 bytes apart (the stride byte offset), the
// leading byte offset unused. Adding 2 moves it 16 columns along K.
__device__ __forceinline__ uint64_t sw128_desc(const __nv_bfloat16* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[64x32] (+)= a[64x16] . b[16x32] for the warpgroup, bf16 in, fp32
// accumulators, a and b K-major in shared memory through their descriptors;
// d in the mma.sync C layout (this warp's 16 rows, 8-column tile j in
// d[4j .. 4j+3]). Asynchronous: the caller fences, commits and waits.
__device__ __forceinline__ void wgmma_m64n32k16(float d[16], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with a and b both stored transposed ([k][m] and [k][n], MN-major).
__device__ __forceinline__ void wgmma_m64n32k16_tt(float d[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "n"(1));
}

#define OWLVIT_WGMMA_D32                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),   \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),   \
      "+f"(d[31])
#define OWLVIT_WGMMA_D32_LIST                                                        \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"                           \
  "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"

// d[64x64] += a[64x16] . b[16x64] for the warpgroup, bf16 in, fp32
// accumulators: a K-major in shared memory, b stored [k][n] (n contiguous:
// the transposed, MN-major operand) with the 128-byte swizzle, through a
// descriptor built as for K-major (adding 128 moves it 16 rows along K).
__device__ __forceinline__ void wgmma_m64n64k16_bt(float d[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OWLVIT_WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : OWLVIT_WGMMA_D32
      : "l"(a), "l"(b), "n"(1));
}

// The same with a from registers (this warp's 16 rows, the mma.sync A
// fragment).
__device__ __forceinline__ void wgmma_m64n64k16_bt(float d[32], const uint32_t a[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OWLVIT_WGMMA_D32_LIST
      ", {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : OWLVIT_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// d[64x64] (+)= a[64x16] . b[16x64] for the warpgroup, bf16 in, fp32
// accumulators, a and b both K-major in shared memory through their
// descriptors (b stored [n][k]); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float d[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OWLVIT_WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : OWLVIT_WGMMA_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// Wait until at most N of the wgmma groups this warp committed are pending
// (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until every wgmma this warp committed has completed.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving or reusing an accumulator or A register of an
// asynchronous wgmma before the wait that completes it.
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}
template <typename T, int N, int M>
__device__ __forceinline__ void fence_operands(T (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) fence_operand(x[i][j]);
}

// Orders this thread's generic-proxy writes to shared memory (cp.async, st)
// before the async proxy's reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x by the SFU (the instruction __expf uses after its multiply by log2(e))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// eight bf16 values x -> bf16(x * scale), as the TPU kernel scales its tiles
__device__ __forceinline__ void scale_bf16x8(uint4& x, float scale) {
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&x);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * scale);
}

}  // namespace
