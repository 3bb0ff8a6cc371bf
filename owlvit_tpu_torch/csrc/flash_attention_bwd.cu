// Packed flash-attention backward for Hopper (sm_90a).
//
// Replaces owlvit_tpu/ops/flash_attention.py::_pk_fused_bwd_kernel (mode
// "fused" of _pk_bwd). It computes the same function as the split pair
// _pk_dq_kernel + _pk_dkv_kernel (mode "both"), so it stands in for both.
// Contract, packed [B, S, D] with head h = columns h*64 .. h*64+63:
//   in   q, k, v, o, do [B, S, D] (bf16 or fp32), lse [B, H, S] fp32 from
//        the forward kernel
//   out  dq, dk, dv [B, S, D]; dq through an fp32 [B, S, D] buffer
//   p    = exp(q . (k*scale)^T - lse) over keys < valid_len (keys >=
//          valid_len get p = 0, so their dk and dv rows are 0)
//   delta = rowsum(do * o) in fp32, dp = do . v^T, ds = p * (dp - delta)
//   dq = ds . (k*scale), dk = ds^T . (q*scale), dv = p^T . do
// Query rows >= valid_len contribute nothing and their dq rows are 0.
// Rounding points kept from the TPU kernel: the scale is applied to the k and
// q tiles in the input dtype; ds is rounded to the input dtype before the dq
// and dk products, p before the dv product; every product accumulates in
// fp32.
//
// What bounds it: five products of 2*S*S*hd flops per (batch, head), so
// 10*B*H*S^2*hd tensor-core flops per launch, against 8*B*S*D*2 bytes of
// inputs and outputs (q, k, v, o, do read, dq, dk, dv written) in bf16: at
// B/16 (S = 2305) about 1.3 TFLOP against 0.9 GB, far above the H100's ~295
// flops per byte, so the bound is the tensor cores, plus the S^2 exps. What
// held the first designs far from it was latency: a 64-query turn does five
// dependent steps (scores, softmax terms, three products) between two block
// barriers, and one 8-warp block per SM left nothing to fill the gaps. Then
// the dq sum across key tiles, which needs a reduction in L2.
//
// Design. The TPU kernel holds a whole K/V row in VMEM and carries fp32 dk/dv
// scratch across a sequential query-block grid dimension. Hopper blocks run in
// parallel with nothing carried between them, so here one block of two
// warpgroups owns (batch, head, 128-key tile), each warpgroup 64 keys (each
// warp 16), with dk and dv in fp32 registers, and a loop inside the block
// walks the 64-row query tiles. At most 128 registers a thread and 90 KB of
// shared memory let two blocks share an SM, so one block's barriers and
// waits overlap the other's work.
//   Shared memory holds every bf16 tile as a wgmma operand: rows of 64
// values (128 bytes) with the 128-byte swizzle. k*scale (rounded to bf16 once,
// as the TPU kernel scales its tile) and v are loaded once; q, do, lse and
// delta come through a two-stage ring filled by cp.async, tile t+1 in flight
// while tile t is computed. Each turn rounds q*scale once into its own tile.
// Per 32 queries: s^T = (k*scale) . q^T and dp^T = v . do^T by wgmma
// m64n32k16 (bf16 in, fp32 accumulate, both operands from shared memory);
// then p = exp(s - lse) (one FMA and one ex2) and ds = p (dp - delta) in the
// accumulators; p^T, rounded to bf16 and re-packed in registers, is the A
// operand of dv += p^T . do (wgmma, do read along its other axis), which runs
// while ds^T, rounded to bf16, is stored. After the turn's second barrier
// dk += ds^T . (q*scale) and the tile's dq partial ds . (k*scale) run as
// wgmma from shared memory (q*scale, ds and k*scale read along their other
// axis; each warpgroup takes 32 of dq's 64 columns), over the key chunks that
// hold a valid key. The [64, 64] dq partial is added into the zeroed fp32
// buffer with four-wide vector reductions (red.global.add.v4.f32, sm_90),
// one pair of shuffles giving each thread four consecutive columns; the
// wrapper casts it. Reductions make dq differ from run to run in its last
// fp32 bits. The key tiles of one (batch, head) start their walk at
// different query tiles, so their reductions meet on different rows.
// Warpgroups whose 64 keys all lie at or past valid_len skip their products.
// delta comes from a first small kernel (8 threads a row, 16-byte loads).
// Ragged tiles (S = 2305 = 18*128 + 1, valid_len < S) are masked in the
// kernel, so nothing is padded. fp32 inputs take two FMA kernels, one by key
// tile (dk, dv) and one by query tile (dq), with no atomics.
// Given up: TMA and warp specialisation (cp.async feeds the ring; the
// products wait for their own wgmma), a deterministic dq (the split design
// costs two more S x S products, and the reductions measured a tenth of the
// time), ds kept in fp32 (the TPU kernel's rounding is the contract).
// Timing only: -DOWLVIT_PK_BWD_NO_DQ_RED builds the kernel with the dq
// partials computed but not added (dq wrong), to measure the reductions'
// share (tools/torch_pk_bwd_profile.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;       // head dim: B/32, B/16 and L/14 all use 64
constexpr int kBk = 128;      // bf16: keys per block
constexpr int kBq = 64;       // bf16: query rows per turn of the inner loop
constexpr int kSubQ = 32;     // bf16: query rows per pass of the score products
constexpr int kWarps = kBk / 16;  // each warp owns 16 keys
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;    // query tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kRowsF = 64;   // fp32: keys (or queries) per block, two threads each
constexpr int kTileF = 32;   // fp32: queries (or keys) per shared-memory tile
constexpr int kHalf = kHd / 2;

// The bf16 kernel's dynamic shared memory (89 KB, plus 1 KB to align it;
// two blocks fit on an SM). Every bf16 tile is a wgmma operand: rows of 64
// values (128 bytes) whose 16-byte chunks are XOR-swizzled by row % 8 (the
// 128-byte swizzle), 1024-byte aligned; the swizzle also spreads the stores
// of eight consecutive rows over distinct banks.
struct __align__(1024) BwdSmem {
  __nv_bfloat16 q[kStages][kBq * kHd];
  __nv_bfloat16 dout[kStages][kBq * kHd];
  __nv_bfloat16 qs[kBq * kHd];  // q * scale of the current tile
  __nv_bfloat16 k[kBk * kHd];   // k * scale
  __nv_bfloat16 v[kBk * kHd];
  __nv_bfloat16 ds[kBk * kHd];  // ds^T [key][query], bf16
  float lse[kStages][kBq];
  float delta[kStages][kBq];
};
constexpr int kSmemBytes = sizeof(BwdSmem) + 1024;

// Element offset of 16-byte chunk `chunk` of row r in a swizzled tile.
__device__ __forceinline__ int sw_at(int r, int chunk) {
  return r * kHd + ((chunk ^ (r & 7)) << 3);
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

// *p += (a, b, c, d), one vector reduction in L2 (16-byte aligned p).
__device__ __forceinline__ void red_add_v4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1,%2,%3,%4};\n" ::"l"(p), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// delta[b, h, i] = sum_d do[b, i, h*64 + d] * o[b, i, h*64 + d] in fp32; one
// thread per (row, head), neighbouring threads on neighbouring heads.
template <typename T>
__global__ void pk_bwd_delta(const T* __restrict__ dout, const T* __restrict__ o,
                             float* __restrict__ delta, int S, int H,
                             long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int h = (int)(idx % H);
  const long long row = idx / H;  // b * S + i
  const size_t off = (size_t)row * H * kHd + (size_t)h * kHd;
  float sum = 0.f;
#pragma unroll 16
  for (int d = 0; d < kHd; ++d) sum = fmaf(to_f(dout[off + d]), to_f(o[off + d]), sum);
  const long long b = row / S, i = row % S;
  delta[((size_t)b * H + h) * S + i] = sum;
}

// bf16 delta: eight threads per (row, head), each one 16-byte load of do and
// of o and eight fp32 FMAs, then a three-step shuffle sum; a warp reads 512
// contiguous bytes of each.
__global__ void __launch_bounds__(256)
    pk_bwd_delta_bf16(const __nv_bfloat16* __restrict__ dout,
                      const __nv_bfloat16* __restrict__ o, float* __restrict__ delta, int S,
                      int H, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rh = idx >> 3;  // (b * S + i) * H + h
  float sum = 0.f;
  if (rh < total) {
    const size_t off = (size_t)idx * 8;  // rh * 64 + (idx & 7) * 8
    const uint4 a = *reinterpret_cast<const uint4*>(dout + off);
    const uint4 c = *reinterpret_cast<const uint4*>(o + off);
    const __nv_bfloat16* ae = reinterpret_cast<const __nv_bfloat16*>(&a);
    const __nv_bfloat16* ce = reinterpret_cast<const __nv_bfloat16*>(&c);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(__bfloat162float(ae[e]), __bfloat162float(ce[e]), sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (rh < total && (idx & 7) == 0) {
    const int h = (int)(rh % H);
    const long long row = rh / H, b = row / S, i = row % S;
    delta[((size_t)b * H + h) * S + i] = sum;
  }
}

// Query tile q0 (q, do, lse, delta of one head) into ring stage `stage`, by
// cp.async: rows >= S zero-filled, lse and delta past valid_len zero-filled.
__device__ __forceinline__ void load_query_tile(BwdSmem& sm, int stage,
                                                const __nv_bfloat16* q,
                                                const __nv_bfloat16* dout,
                                                const float* lse, const float* delta,
                                                int q0, int S, int D, int valid_len) {
  for (int i = threadIdx.x; i < kBq * (kHd / 8); i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool in = q0 + r < S;
    const size_t at = (size_t)(in ? q0 + r : 0) * D + c * 8;
    cp_async16(sm.q[stage] + sw_at(r, c), q + at, in);
    cp_async16(sm.dout[stage] + sw_at(r, c), dout + at, in);
  }
  if (threadIdx.x < 2 * kBq) {
    const int r = threadIdx.x & (kBq - 1);
    const bool in = q0 + r < valid_len;
    const int at = in ? q0 + r : 0;
    if (threadIdx.x < kBq)
      cp_async4(sm.lse[stage] + r, lse + at, in);
    else
      cp_async4(sm.delta[stage] + r, delta + at, in);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    pk_bwd_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int S, int H, int valid_len,
                float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kBk;
  const int D = H * kHd;
  const size_t base = (size_t)b * S * D + (size_t)h * kHd;
  const size_t rbase = ((size_t)b * H + h) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma group row, column pair
  const int r0 = warp * 16 + g;            // this thread's key rows: r0, r0 + 8
  const int wg = warp >> 2;                // warpgroup: keys 64 wg .. 64 wg + 63

  if (k0 >= valid_len) {  // every key of the tile is masked: dk = dv = 0
    for (int i = threadIdx.x; i < kBk * (kHd / 8); i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      if (k0 + r < S) {
        const size_t at = base + (size_t)(k0 + r) * D + c;
        *reinterpret_cast<uint4*>(dk + at) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv + at) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  // query rows >= valid_len add nothing. The key tiles of one (batch, head)
  // start at different query tiles, so their dq reductions meet on
  // different rows.
  const int n_qt = (valid_len + kBq - 1) / kBq;
  const int qt_first = (int)(((long long)blockIdx.x * n_qt) / gridDim.x);
  auto tile_row = [&](int t) { return ((t + qt_first) % n_qt) * kBq; };
  const __nv_bfloat16* qh = q + base;
  const __nv_bfloat16* doh = dout + base;
  const float* lseh = lse + rbase;
  const float* deltah = delta + rbase;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {  // fill the ring while K and V load
    if (t < n_qt) load_query_tile(sm, t, qh, doh, lseh, deltah, tile_row(t), S, D, valid_len);
    cp_async_commit();
  }

  // k * scale (rounded to bf16 once, as the TPU kernel scales its k tile)
  // and v; the first turn's fence and barrier publish them to wgmma
  for (int i = threadIdx.x; i < kBk * (kHd / 8); i += kThreads) {
    const int r = i >> 3, c = i & 7;
    uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
    if (k0 + r < S) {
      kx = *reinterpret_cast<const uint4*>(k + base + (size_t)(k0 + r) * D + c * 8);
      vx = *reinterpret_cast<const uint4*>(v + base + (size_t)(k0 + r) * D + c * 8);
    }
    scale_bf16x8(kx, scale);
    *reinterpret_cast<uint4*>(sm.k + sw_at(r, c)) = kx;
    *reinterpret_cast<uint4*>(sm.v + sw_at(r, c)) = vx;
  }

  float dk_acc[kHd / 8][4], dv_acc[kHd / 8][4];  // rows r0 / r0+8, 8 column tiles
#pragma unroll
  for (int d = 0; d < kHd / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;
  const bool key0_ok = k0 + r0 < valid_len, key1_ok = k0 + r0 + 8 < valid_len;
  // the warpgroup's 64 keys hold a valid one (uniform over the warpgroup,
  // as wgmma needs)
  const bool live = k0 + wg * 64 < valid_len;
  const int n_kc = min(kWarps, (valid_len - k0 + 15) / 16);  // key chunks holding a valid key
  const int qg = warp & 3;  // dq: queries 16 qg .. 16 qg + 15, columns 32 wg .. 32 wg + 31
#ifdef OWLVIT_PK_BWD_NO_DQ_RED
  float sink = 0.f;
#endif

  for (int t = 0; t < n_qt; ++t) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();  // the tiles are read by wgmma
    __syncthreads();      // tile t is in, and every warp is done with turn t - 1
    {
      const int tn = t + kStages - 1;  // refill the stage turn t - 1 used
      if (tn < n_qt)
        load_query_tile(sm, tn % kStages, qh, doh, lseh, deltah, tile_row(tn), S, D,
                        valid_len);
      cp_async_commit();
    }
    const int stage = t % kStages;
    const __nv_bfloat16* tq = sm.q[stage];
    const __nv_bfloat16* tdo = sm.dout[stage];
    const int q0 = tile_row(t);

    // q * scale in the input dtype, once per tile
    for (int i = threadIdx.x; i < kBq * (kHd / 8); i += kThreads) {
      const int r = i >> 3, c = i & 7;
      uint4 x = *reinterpret_cast<const uint4*>(tq + sw_at(r, c));
      scale_bf16x8(x, scale);
      *reinterpret_cast<uint4*>(sm.qs + sw_at(r, c)) = x;
    }

    if (live) {
#pragma unroll
      for (int hq = 0; hq < kBq / kSubQ; ++hq) {
        // s^T (rows: keys r0, r0+8; columns: 32 queries) = (k*scale) . q^T
        // and dp^T = v . do^T over the warpgroup's 64 keys
        float s[kSubQ / 8][4], dp[kSubQ / 8][4];
#pragma unroll
        for (int j = 0; j < kSubQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        const uint64_t kdesc = sw128_desc(sm.k + wg * 64 * kHd);
        const uint64_t vdesc = sw128_desc(sm.v + wg * 64 * kHd);
        const uint64_t qdesc = sw128_desc(tq + hq * kSubQ * kHd);
        const uint64_t ddesc = sw128_desc(tdo + hq * kSubQ * kHd);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
          wgmma_m64n32k16(&s[0][0], kdesc + 2 * kk, qdesc + 2 * kk, kk);
          wgmma_m64n32k16(&dp[0][0], vdesc + 2 * kk, ddesc + 2 * kk, kk);
        }
        wgmma_commit();
        wgmma_wait();
        fence_operands(s);
        fence_operands(dp);
        // p = exp(s - lse) on valid (key, query) pairs, else 0; ds = p (dp - delta)
#pragma unroll
        for (int j = 0; j < kSubQ / 8; ++j) {
          const int qc = hq * kSubQ + j * 8 + t4 * 2;
          const float2 l = *reinterpret_cast<const float2*>(sm.lse[stage] + qc);
          const float2 dl = *reinterpret_cast<const float2*>(sm.delta[stage] + qc);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool q_ok = q0 + qc + e < valid_len;
            // exp(s - lse) = 2^(s log2(e) - lse log2(e)): one FMA and one ex2
            const float le = (e ? l.y : l.x) * kLog2e, de = e ? dl.y : dl.x;
            const float p0 = (q_ok && key0_ok) ? ex2(fmaf(s[j][e], kLog2e, -le)) : 0.f;
            const float p1 = (q_ok && key1_ok) ? ex2(fmaf(s[j][e + 2], kLog2e, -le)) : 0.f;
            s[j][e] = p0;
            s[j][e + 2] = p1;
            dp[j][e] = p0 * (dp[j][e] - de);
            dp[j][e + 2] = p1 * (dp[j][e + 2] - de);
          }
        }
        // p^T rounded to bf16: the C fragments of query tiles 2c, 2c+1 are
        // the A fragment of 16-query chunk c. dv += p^T . do on the
        // warpgroup's 64 keys, do read along its other axis, while ds^T
        // (rounded to bf16) goes to shared memory for the dk and dq products
        uint32_t pa[kSubQ / 16][4];
#pragma unroll
        for (int c = 0; c < kSubQ / 16; ++c) {
          pa[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
          pa[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
          pa[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
          pa[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < kSubQ / 16; ++c)
          wgmma_m64n64k16_bt(&dv_acc[0][0], pa[c],
                             sw128_desc(tdo + (hq * kSubQ + c * 16) * kHd));
        wgmma_commit();
#pragma unroll
        for (int c = 0; c < kSubQ / 16; ++c) {
          const int ch = (hq * kSubQ + c * 16) / 8, col = t4 * 2;
          *reinterpret_cast<uint32_t*>(sm.ds + sw_at(r0, ch) + col) =
              pack_bf16(dp[2 * c][0], dp[2 * c][1]);
          *reinterpret_cast<uint32_t*>(sm.ds + sw_at(r0 + 8, ch) + col) =
              pack_bf16(dp[2 * c][2], dp[2 * c][3]);
          *reinterpret_cast<uint32_t*>(sm.ds + sw_at(r0, ch + 1) + col) =
              pack_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1]);
          *reinterpret_cast<uint32_t*>(sm.ds + sw_at(r0 + 8, ch + 1) + col) =
              pack_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3]);
        }
        wgmma_wait();  // the dv product
        fence_operands(dv_acc);
        fence_operands(pa);
      }
    }
    fence_proxy_async();  // q * scale and ds^T are read by wgmma
    __syncthreads();      // q * scale and ds^T are in

    wgmma_fence();
    if (live) {  // dk += ds^T . (q*scale), q*scale read along its other axis
      const uint64_t dsdesc = sw128_desc(sm.ds + wg * 64 * kHd);
      const uint64_t qsdesc = sw128_desc(sm.qs);
#pragma unroll
      for (int c = 0; c < kBq / 16; ++c)
        wgmma_m64n64k16_bt(&dk_acc[0][0], dsdesc + 2 * c, qsdesc + 128 * c);
    }
    // dq[query, :] = ds[query, keys] . (k*scale)[keys, :] over the key
    // chunks that hold a valid key: warpgroup wg takes the tile's 64 queries
    // and columns 32 wg .. 32 wg + 31 (warp w: queries 16 qg .. 16 qg + 15),
    // ds read from ds^T and k*scale from its 64-column rows at an offset of
    // 32 wg columns, both along their other axis
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    {
      const uint64_t dsdesc = sw128_desc(sm.ds), kdesc = sw128_desc(sm.k + wg * 32);
      for (int c = 0; c < n_kc; ++c)
        wgmma_m64n32k16_tt(&acc[0][0], dsdesc + 128 * c, kdesc + 128 * c);
    }
    wgmma_commit();
    wgmma_wait();  // the dk and dq products
    fence_operands(acc);
    if (live) fence_operands(dk_acc);
    // each thread holds (row g: 2 columns, row g+8: 2 columns) per column
    // tile; one exchange with lane t4 ^ 1 gives the even lane four columns of
    // row g and the odd lane four of row g+8, added with one reduction each
    const bool odd = t4 & 1;
    const int row = q0 + qg * 16 + g + (odd ? 8 : 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][0] : acc[j][2], 1);
      const float x1 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][1] : acc[j][3], 1);
      const float4 val = odd ? make_float4(x0, x1, acc[j][2], acc[j][3])
                             : make_float4(acc[j][0], acc[j][1], x0, x1);
#ifdef OWLVIT_PK_BWD_NO_DQ_RED
      sink += val.x + val.y + val.z + val.w;
#else
      if (row < valid_len)
        red_add_v4(dq_acc + base + (size_t)row * D + wg * 32 + j * 8 + (t4 & 2) * 2, val.x,
                   val.y, val.z, val.w);
#endif
    }
  }
#ifdef OWLVIT_PK_BWD_NO_DQ_RED
  if (sink == 1.2345e-37f) dq_acc[base] = sink;  // keeps the dq product alive
#endif

  const int key0 = k0 + r0, key1 = key0 + 8;
#pragma unroll
  for (int d = 0; d < kHd / 8; ++d) {
    const int c = d * 8 + t4 * 2;
    if (key0 < S) {
      const size_t at = base + (size_t)key0 * D + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dk_acc[d][0], dk_acc[d][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dv_acc[d][0], dv_acc[d][1]);
    }
    if (key1 < S) {
      const size_t at = base + (size_t)key1 * D + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dk_acc[d][2], dk_acc[d][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dv_acc[d][2], dv_acc[d][3]);
    }
  }
}

// fp32, by key tile: two threads per key, each owning 32 of the 64 columns;
// queries stream through shared memory 32 rows at a time.
__global__ void __launch_bounds__(2 * kRowsF)
    pk_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int S, int H,
                    int valid_len, float scale) {
  __shared__ __align__(16) float sq[kTileF][kHd];
  __shared__ __align__(16) float sdo[kTileF][kHd];
  __shared__ float slse[kTileF], sdelta[kTileF];

  const int h = blockIdx.y, b = blockIdx.z;
  const int D = H * kHd;
  const size_t base = (size_t)b * S * D + (size_t)h * kHd;
  const size_t rbase = ((size_t)b * H + h) * S;
  const int key = blockIdx.x * kRowsF + (threadIdx.x >> 1);
  const int c0 = (threadIdx.x & 1) * kHalf;
  const bool key_ok = key < valid_len;

  float kr[kHalf], vr[kHalf], dka[kHalf], dva[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; d += 4) {
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (key < S) {
      kx = *reinterpret_cast<const float4*>(k + base + (size_t)key * D + c0 + d);
      vx = *reinterpret_cast<const float4*>(v + base + (size_t)key * D + c0 + d);
    }
    kr[d] = kx.x * scale;
    kr[d + 1] = kx.y * scale;
    kr[d + 2] = kx.z * scale;
    kr[d + 3] = kx.w * scale;
    vr[d] = vx.x;
    vr[d + 1] = vx.y;
    vr[d + 2] = vx.z;
    vr[d + 3] = vx.w;
    dka[d] = dka[d + 1] = dka[d + 2] = dka[d + 3] = 0.f;
    dva[d] = dva[d + 1] = dva[d + 2] = dva[d + 3] = 0.f;
  }

  const int n_tiles = (valid_len + kTileF - 1) / kTileF;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTileF;
    __syncthreads();
    for (int i = threadIdx.x; i < kTileF * (kHd / 4); i += 2 * kRowsF) {
      const int r = i / (kHd / 4), c = (i % (kHd / 4)) * 4;
      float4 qx = make_float4(0.f, 0.f, 0.f, 0.f), dx = qx;
      if (q0 + r < S) {
        qx = *reinterpret_cast<const float4*>(q + base + (size_t)(q0 + r) * D + c);
        dx = *reinterpret_cast<const float4*>(dout + base + (size_t)(q0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(&sq[r][c]) = qx;
      *reinterpret_cast<float4*>(&sdo[r][c]) = dx;
    }
    if (threadIdx.x < kTileF) {
      const int qi = q0 + threadIdx.x;
      slse[threadIdx.x] = qi < valid_len ? lse[rbase + qi] : 0.f;
      sdelta[threadIdx.x] = qi < valid_len ? delta[rbase + qi] : 0.f;
    }
    __syncthreads();

    for (int jq = 0; jq < kTileF; ++jq) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        s = fmaf(kr[d], sq[jq][c0 + d], s);
        dp = fmaf(vr[d], sdo[jq][c0 + d], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = (key_ok && q0 + jq < valid_len) ? expf(s - slse[jq]) : 0.f;
      const float ds = p * (dp - sdelta[jq]);
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        dva[d] = fmaf(p, sdo[jq][c0 + d], dva[d]);
        dka[d] = fmaf(ds, sq[jq][c0 + d] * scale, dka[d]);
      }
    }
  }

  if (key < S) {
#pragma unroll
    for (int d = 0; d < kHalf; d += 4) {
      const size_t at = base + (size_t)key * D + c0 + d;
      *reinterpret_cast<float4*>(dk + at) = make_float4(dka[d], dka[d + 1], dka[d + 2], dka[d + 3]);
      *reinterpret_cast<float4*>(dv + at) = make_float4(dva[d], dva[d + 1], dva[d + 2], dva[d + 3]);
    }
  }
}

// fp32, by query tile: two threads per query row; keys stream through shared
// memory 32 rows at a time. Writes dq directly (query rows >= valid_len: 0).
__global__ void __launch_bounds__(2 * kRowsF)
    pk_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int S, int H, int valid_len, float scale) {
  __shared__ __align__(16) float sk[kTileF][kHd];  // k * scale
  __shared__ __align__(16) float sv[kTileF][kHd];

  const int h = blockIdx.y, b = blockIdx.z;
  const int D = H * kHd;
  const size_t base = (size_t)b * S * D + (size_t)h * kHd;
  const int qi = blockIdx.x * kRowsF + (threadIdx.x >> 1);
  const int c0 = (threadIdx.x & 1) * kHalf;
  const bool q_ok = qi < valid_len;
  const float l = q_ok ? lse[((size_t)b * H + h) * S + qi] : 0.f;
  const float dl = q_ok ? delta[((size_t)b * H + h) * S + qi] : 0.f;

  float qr[kHalf], dor[kHalf], acc[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; d += 4) {
    float4 qx = make_float4(0.f, 0.f, 0.f, 0.f), dx = qx;
    if (qi < S) {
      qx = *reinterpret_cast<const float4*>(q + base + (size_t)qi * D + c0 + d);
      dx = *reinterpret_cast<const float4*>(dout + base + (size_t)qi * D + c0 + d);
    }
    qr[d] = qx.x;
    qr[d + 1] = qx.y;
    qr[d + 2] = qx.z;
    qr[d + 3] = qx.w;
    dor[d] = dx.x;
    dor[d + 1] = dx.y;
    dor[d + 2] = dx.z;
    dor[d + 3] = dx.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }

  const int n_tiles = (valid_len + kTileF - 1) / kTileF;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * kTileF;
    __syncthreads();
    for (int i = threadIdx.x; i < kTileF * (kHd / 4); i += 2 * kRowsF) {
      const int r = i / (kHd / 4), c = (i % (kHd / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (j0 + r < S) {
        kx = *reinterpret_cast<const float4*>(k + base + (size_t)(j0 + r) * D + c);
        vx = *reinterpret_cast<const float4*>(v + base + (size_t)(j0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(&sk[r][c]) =
          make_float4(kx.x * scale, kx.y * scale, kx.z * scale, kx.w * scale);
      *reinterpret_cast<float4*>(&sv[r][c]) = vx;
    }
    __syncthreads();

    for (int jk = 0; jk < kTileF; ++jk) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        s = fmaf(qr[d], sk[jk][c0 + d], s);
        dp = fmaf(dor[d], sv[jk][c0 + d], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = (q_ok && j0 + jk < valid_len) ? expf(s - l) : 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int d = 0; d < kHalf; ++d) acc[d] = fmaf(ds, sk[jk][c0 + d], acc[d]);
    }
  }

  if (qi < S) {
#pragma unroll
    for (int d = 0; d < kHalf; d += 4)
      *reinterpret_cast<float4*>(dq + base + (size_t)qi * D + c0 + d) =
          make_float4(acc[d], acc[d + 1], acc[d + 2], acc[d + 3]);
  }
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = fp32, 1 = bf16. delta is fp32
// [B, H, S] scratch. dq is fp32 [B, S, D]: bf16 adds into it with vector
// reductions, so it must be zeroed; fp32 writes it. Launches on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int owlvit_pk_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* lse, const void* dout,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int S, int H, int hd, int valid_len, float scale,
                             int dtype, void* stream) {
  if (hd != kHd || B < 1 || S < 1 || H < 1 || valid_len < 1 || valid_len > S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * S * H;
  const int dblocks = static_cast<int>((rows + 255) / 256);
  if (dtype == 1) {
    // the bf16 kernel's shared memory is above the 48 KB default: raise its
    // limit once per device
    constexpr int kMaxDevices = 64;
    static bool smem_set[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!smem_set[dev]) {
      err = cudaFuncSetAttribute(pk_bwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
      if (err == cudaSuccess)  // room for two blocks per SM
        err = cudaFuncSetAttribute(pk_bwd_bf16, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   static_cast<int>(cudaSharedmemCarveoutMaxShared));
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set[dev] = true;
    }
    using bf = __nv_bfloat16;
    pk_bwd_delta_bf16<<<static_cast<int>((rows * 8 + 255) / 256), 256, 0, st>>>(
        static_cast<const bf*>(dout), static_cast<const bf*>(o),
        static_cast<float*>(delta), S, H, rows);
    const dim3 grid((S + kBk - 1) / kBk, H, B);
    pk_bwd_bf16<<<grid, kThreads, kSmemBytes, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), static_cast<bf*>(dk), static_cast<bf*>(dv), S, H,
        valid_len, scale);
  } else if (dtype == 0) {
    pk_bwd_delta<float><<<dblocks, 256, 0, st>>>(
        static_cast<const float*>(dout), static_cast<const float*>(o),
        static_cast<float*>(delta), S, H, rows);
    const dim3 grid((S + kRowsF - 1) / kRowsF, H, B);
    pk_bwd_dkdv_f32<<<grid, 2 * kRowsF, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), S, H, valid_len, scale);
    pk_bwd_dq_f32<<<grid, 2 * kRowsF, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), S, H, valid_len, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
