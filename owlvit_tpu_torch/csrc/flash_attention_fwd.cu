// Packed flash-attention forward for Hopper (sm_90a).
//
// Replaces owlvit_tpu/ops/flash_attention.py::_pk_fwd_kernel (the Pallas TPU
// kernel behind _pk_fwd / flash_attention_packed). Same contract:
//   q, k, v  [B, S, D] packed, head h = columns h*64 .. h*64+63, no transpose
//   o        [B, S, D] in the input dtype: softmax(q*scale . k^T + keymask) . v
//   lse      [B, H, S] fp32 (the TPU's [B, G, S_pad, hg] with (G, hg) merged)
// Keys at index >= valid_len drop out exactly (p == 0), as the TPU kernel's
// -1e30 bias row makes them. scale is applied to the q tile in the input
// dtype (exact for hd = 64: scale = 2^-3). Accumulation is fp32; in bf16, p
// is rounded to bf16 before the p.v product and the division by l is fp32.
// Three softmax modes: the per-row running max (online softmax); a fixed
// shift C (exp(s - C), lse = C + log l, no max and no rescale); and, in
// bf16 only, the fast mode, the TPU kernel's fast_softmax branch (its
// _pk_fwd_kernel, the `fast_softmax and v.dtype != float32` lines): the
// running max as in the first mode, but the exp taken in bf16 on a bf16
// argument, p = exp(bf16(s - m)) in bf16, and l the fp32 sum of that
// rounded p. The exp is the SFU's fp32 ex2 of the rounded argument, p =
// bf16(2^(bf16(s - m) log2(e))): the TPU branch's function up to
// ex2.approx's last fp32 bits. (Sm_90's ex2.approx.ftz.bf16x2, two bf16
// exps in one SFU instruction, ran 6% faster on an H100, but it rounds the
// argument in the log2 domain and not its result to nearest: its lse sat
// 4e-3 from the branch's function, five times the exact softmax's distance
// from it. Both forms run slower than the per-row max, so the mode keeps
// the branch's function.) The mode is for frozen layers only (no backward
// recomputes this p).
//
// What bounds it: two products of 2*S*S*hd flops per (batch, head) against
// 4*B*S*D*2 bytes of q, k, v and o in bf16: at B/16 (S = 2305) about 0.5
// TFLOP against 0.45 GB at batch 32, far above the H100's ~295 flops per
// byte, so the bound is the tensor cores. Beside them run the S*S exps, one
// per score, on the SFU's ~16 a clock per SM: at the tensor cores' peak
// they take as long as the products, so a warpgroup's softmax has to run
// while products run. The first design (mma.sync from scalar shared loads,
// synchronous K/V tiles between two barriers, a 4-warp block per 64
// queries) was held at 15% of the bound by load instructions and latency.
//
// Design. The TPU kernel holds a whole K/V row in VMEM and does one
// full-row softmax; here one block of two warpgroups owns (batch, head,
// 128-row query tile), each warpgroup 64 rows (each warp 16), and a loop
// inside the block walks the 64-key K/V tiles, so nothing scales with S
// except the loop count, and ragged tails (S not a multiple of 64 or 128,
// or valid_len < S) are masked in the kernel: no padding is needed.
//   bf16: q*scale (rounded to bf16 once, as the TPU kernel scales its tile)
// is stored once into 128-byte-swizzled shared memory; K and V tiles come
// through a four-stage cp.async ring in the same layout, two tiles loading
// ahead of the one computed, one barrier per tile. s = (q*scale) . k^T by
// wgmma m64n64k16 with both operands K-major in shared memory; the online
// softmax in the accumulators (the row max by two quad shuffles, exp as one
// FMA and one ex2); p, rounded to bf16 and re-packed in registers, is the A
// operand of o += p . v by wgmma with v read along its other axis. Step t
// issues tile t's s product and tile t-1's p . v together and runs tile t's
// softmax while p . v runs (FlashAttention-3's overlap inside a
// warpgroup); the first s and the last p . v are peeled off the loop so
// that no product sits under a branch, and the warpgroup index is
// broadcast from lane 0: ptxas serialises every wgmma of a kernel where a
// product sits under a branch it cannot prove uniform, or where the loop's
// first and last steps take other branches. At most 128 registers a thread
// (106) and 81 KB of shared memory let two blocks share an SM.
//   fp32: one thread per query row with plain FMA (no fp32 tensor-core
// product keeps full fp32 precision); K/V rows are read as shared-memory
// broadcasts.
// Measured and given up: an 8-key product for a last tile of one key (S =
// 2305 = 36*64 + 1; no gain), q*scale held in registers as the s product's
// A operand (no gain: shared-memory bandwidth does not bound it), a branch
// that lets a warpgroup past S skip its products (slower than the 64 rows
// of work it saves), skipping o's rescale when no row max in the warp moved
// (slower), and a producer warp feeding the ring through mbarriers, with or
// without the two warpgroups issuing their products in turns (ping-pong):
// 1.45x slower, for reasons not measured. Not tried: TMA, a persistent
// schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kHd = 64;        // head dim: B/32, B/16 and L/14 all use 64
constexpr int kBq = 128;       // bf16: query rows per block, 64 per warpgroup
constexpr int kBk = 64;        // bf16: keys per K/V tile
constexpr int kThreads = 256;  // bf16: two warpgroups
constexpr int kStages = 4;     // bf16: K/V tiles in the cp.async ring
constexpr int kAhead = kStages - 2;  // bf16: tiles loading ahead of the one computed

constexpr int kBqF = 128;  // fp32: query rows per block (one per thread)
constexpr int kBkF = 32;   // fp32: keys per K/V tile

// The bf16 kernel's dynamic shared memory (80 KB, plus 1 KB to align it;
// two blocks fit on an SM). Every tile is a wgmma operand in the 128-byte
// swizzled layout of hopper_mma.cuh.
struct __align__(1024) FwdSmem {
  __nv_bfloat16 q[kBq * kHd];  // q * scale
  __nv_bfloat16 k[kStages][kBk * kHd];
  __nv_bfloat16 v[kStages][kBk * kHd];
};
constexpr int kSmemBytes = sizeof(FwdSmem) + 1024;

// K/V tile k0 of one head into ring stage `stage`, by cp.async: keys >=
// valid_len zero-filled (their p is 0, and 0 . v must stay 0).
__device__ __forceinline__ void load_kv_tile(FwdSmem& sm, int stage,
                                             const __nv_bfloat16* k,
                                             const __nv_bfloat16* v, int k0,
                                             int valid_len, int D) {
  for (int i = threadIdx.x; i < kBk * (kHd / 8); i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool in = k0 + r < valid_len;
    const size_t at = (size_t)(in ? k0 + r : 0) * D + c * 8;
    cp_async16(sm.k[stage] + sw_at(r, c), k + at, in);
    cp_async16(sm.v[stage] + sw_at(r, c), v + at, in);
  }
}

constexpr int kColTiles = kBk / 8;  // 8-key column tiles of a K/V tile's scores

// The softmax modes (the C entry point's `softmax` argument)
constexpr int kRowMax = 0;  // per-row running max
constexpr int kShift = 1;   // fixed shift C
constexpr int kFast = 2;    // bf16 only: running max, exp in bf16 (see above)

// the two fp32 values of a bf16x2 word: low half, high half
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// The online softmax of key tile k0 in the score accumulators (rows r0 and
// r0+8 of this thread, column tile j in s[j]): keys >= valid_len masked, p =
// exp(s - shift) in place (one FMA and one ex2), the partial row sums l
// updated. Per-row max and fast modes: m moves to the new row max, l is
// rescaled, and a0 / a1 return the factor o must be rescaled by. Fast mode:
// each pair of a row's s - m is rounded to bf16 (one pack, two integer ops
// to unpack), p = 2^(x log2(e)) (a multiply and an ex2 each) is rounded to
// bf16 the same way, and l adds the rounded p, which pack_p packs again
// exactly.
template <int kMode>
__device__ __forceinline__ void softmax_tile(float (&s)[kColTiles][4], int k0, int valid_len,
                                             int t4, float static_max, float& m0, float& m1,
                                             float& l0, float& l1, float& a0, float& a1) {
  if (k0 + kColTiles * 8 > valid_len) {
#pragma unroll
    for (int j = 0; j < kColTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + j * 8 + t4 * 2 + e >= valid_len) s[j][e] = s[j][e + 2] = -INFINITY;
  }
  // exp(s - shift) = 2^(s log2(e) - shift log2(e))
  float sh0, sh1;
  if (kMode == kShift) {
    sh0 = sh1 = static_max * kLog2e;
  } else {
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // the four threads of a group hold the same two rows
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key 0 is valid (valid_len >= 1), so mx is finite from the first tile
    a0 = ex2((m0 - mx0) * kLog2e);
    a1 = ex2((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
    sh0 = mx0 * kLog2e;
    sh1 = mx1 * kLog2e;
  }
  if (kMode == kFast) {
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {  // masked: 2^-inf == 0
      const uint32_t x0 = pack_bf16(s[j][0] - m0, s[j][1] - m0);
      const uint32_t x1 = pack_bf16(s[j][2] - m1, s[j][3] - m1);
      const uint32_t p0 = pack_bf16(ex2(bf16_lo(x0) * kLog2e), ex2(bf16_hi(x0) * kLog2e));
      const uint32_t p1 = pack_bf16(ex2(bf16_lo(x1) * kLog2e), ex2(bf16_hi(x1) * kLog2e));
      s[j][0] = bf16_lo(p0);
      s[j][1] = bf16_hi(p0);
      s[j][2] = bf16_lo(p1);
      s[j][3] = bf16_hi(p1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kColTiles; ++j) {
    s[j][0] = ex2(fmaf(s[j][0], kLog2e, -sh0));  // masked: 2^-inf == 0
    s[j][1] = ex2(fmaf(s[j][1], kLog2e, -sh0));
    s[j][2] = ex2(fmaf(s[j][2], kLog2e, -sh1));
    s[j][3] = ex2(fmaf(s[j][3], kLog2e, -sh1));
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
}

// s = (q*scale) . k^T for the warpgroup's 64 rows and a 64-key tile, by
// wgmma with both operands K-major in shared memory. Issued and committed,
// not waited for.
__device__ __forceinline__ void issue_scores(float (&s)[kColTiles][4], uint64_t qdesc,
                                             uint64_t kdesc) {
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    wgmma_m64n64k16_ss(&s[0][0], qdesc + 2 * kk, kdesc + 2 * kk, kk);
  wgmma_commit();
}

// o += p . v for a 64-key tile: p from registers (pa[c], the A fragment of
// 16-key chunk c), v read along its other axis. Issued and committed, not
// waited for. Keys past valid_len add 0: their p is 0 and their v rows
// were zero-filled.
__device__ __forceinline__ void issue_pv(float (&acc)[kHd / 8][4],
                                         const uint32_t (&pa)[kColTiles / 2][4], uint64_t vdesc) {
#pragma unroll
  for (int c = 0; c < kColTiles / 2; ++c) wgmma_m64n64k16_bt(&acc[0][0], pa[c], vdesc + 128 * c);
  wgmma_commit();
}

// p rounded to bf16: the score C fragments of column tiles 2c, 2c+1 are
// exactly the A fragment of 16-key chunk c. In the fast mode p is bf16
// already and the pack exact. (Keeping the packed p words as the A
// fragment, with no unpack and no pack, made ptxas serialise every wgmma,
// C7511, at 106 registers: tried as bits left in s and copied, and copied
// through a byte permute.)
__device__ __forceinline__ void pack_p(const float (&s)[kColTiles][4],
                                       uint32_t (&pa)[kColTiles / 2][4]) {
#pragma unroll
  for (int c = 0; c < kColTiles / 2; ++c) {
    pa[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
    pa[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
    pa[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
    pa[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    pk_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
                int H, int valid_len, float scale, float static_max) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBq;
  const int D = H * kHd;
  const size_t base = (size_t)b * S * D + (size_t)h * kHd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma group row, column pair
  // warpgroup: rows 64 wg .. 64 wg + 63; broadcast from lane 0 so that the
  // compiler sees it uniform over the warp (ptxas serialises every wgmma of
  // a kernel whose control flow around them it cannot prove uniform)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r0 = (warp & 3) * 16 + g;      // this thread's rows in it: r0, r0 + 8
  const __nv_bfloat16* kh = k + base;
  const __nv_bfloat16* vh = v + base;
  const int n_tiles = (valid_len + kBk - 1) / kBk;  // tiles past valid_len are all masked

#pragma unroll
  for (int t = 0; t < kAhead; ++t) {  // fill the ring while q loads
    if (t < n_tiles) load_kv_tile(sm, t, kh, vh, t * kBk, valid_len, D);
    cp_async_commit();
  }
  // q * scale in the input dtype, as the TPU kernel scales its q tile; rows
  // >= S zero; the first turn's fence and barrier publish it to wgmma
  for (int i = threadIdx.x; i < kBq * (kHd / 8); i += kThreads) {
    const int r = i >> 3, c = i & 7;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S) x = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * D + c * 8);
    scale_bf16x8(x, scale);
    *reinterpret_cast<uint4*>(sm.q + sw_at(r, c)) = x;
  }

  const uint64_t qdesc = sw128_desc(sm.q + wg * 64 * kHd);
  float acc[kHd / 8][4];  // o rows r0 / r0+8, 8 column tiles of 8
#pragma unroll
  for (int d = 0; d < kHd / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (dynamic mode)
  float l0 = 0.f, l1 = 0.f;              // partial row sums of this thread
  float a0 = 1.f, a1 = 1.f;              // o's rescale for the current tile's row max
  float s[kColTiles][4];                 // scores, then p, of the current tile
  uint32_t pa[kColTiles / 2][4];         // p of the previous tile in bf16

  // Waits for tile t, then refills the stage tile t - 2 used (every
  // warpgroup waited for that tile's p . v before this barrier).
  auto next_tile = [&](int t) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();  // the tiles (and q) are read by wgmma
    __syncthreads();
    const int tn = t + kAhead;
    if (tn < n_tiles) load_kv_tile(sm, tn % kStages, kh, vh, tn * kBk, valid_len, D);
    cp_async_commit();
  };

  // Every warpgroup runs the products, one whose rows all lie past S too
  // (on zero rows): a branch around them costs more than the one 64-row
  // tile in 37 it saves at S = 2305. Step t issues s of tile t and p . v of
  // tile t - 1 together and computes tile t's softmax while p . v runs; o
  // is rescaled once it is done. The first s and the last p . v are peeled
  // off the loop, so that the loop holds no branch around a product and
  // ptxas can keep them asynchronous.
  next_tile(0);
  wgmma_fence();
  issue_scores(s, qdesc, sw128_desc(sm.k[0]));
  wgmma_wait_n<0>();
  fence_operands(s);
  softmax_tile<kMode>(s, 0, valid_len, t4, static_max, m0, m1, l0, l1, a0, a1);
  pack_p(s, pa);
  for (int t = 1; t < n_tiles; ++t) {
    next_tile(t);
    wgmma_fence();
    issue_scores(s, qdesc, sw128_desc(sm.k[t % kStages]));
    issue_pv(acc, pa, sw128_desc(sm.v[(t - 1) % kStages]));
    wgmma_wait_n<1>();  // the s product, committed first
    fence_operands(s);
    softmax_tile<kMode>(s, t * kBk, valid_len, t4, static_max, m0, m1, l0, l1, a0, a1);
    wgmma_wait_n<0>();  // the p . v product: o and pa are free
    fence_operands(acc);
    fence_operands(pa);
    if (kMode != kShift) {
#pragma unroll
      for (int d = 0; d < kHd / 8; ++d) {
        acc[d][0] *= a0;
        acc[d][1] *= a0;
        acc[d][2] *= a1;
        acc[d][3] *= a1;
      }
    }
    pack_p(s, pa);
  }
  wgmma_fence();
  issue_pv(acc, pa, sw128_desc(sm.v[(n_tiles - 1) % kStages]));
  wgmma_wait_n<0>();
  fence_operands(acc);
  fence_operands(pa);
  cp_async_wait<0>();  // no copy outlives the block
  if (q0 + wg * 64 >= S) return;  // a warpgroup with no real row stores nothing

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row0 = q0 + wg * 64 + r0, row1 = row0 + 8;
#pragma unroll
  for (int d = 0; d < kHd / 8; ++d) {
    const int c = d * 8 + t4 * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row0 * D + c) =
          __floats2bfloat162_rn(acc[d][0] / l0, acc[d][1] / l0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row1 * D + c) =
          __floats2bfloat162_rn(acc[d][2] / l1, acc[d][3] / l1);
  }
  if (t4 == 0) {
    float* lrow = lse + ((size_t)b * H + h) * S;
    if (row0 < S) lrow[row0] = (kMode == kShift ? static_max : m0) + logf(l0);
    if (row1 < S) lrow[row1] = (kMode == kShift ? static_max : m1) + logf(l1);
  }
}

template <bool kStatic>
__global__ void __launch_bounds__(kBqF)
    pk_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int S, int H, int valid_len,
               float scale, float static_max) {
  __shared__ __align__(16) float sk[kBkF][kHd];
  __shared__ __align__(16) float sv[kBkF][kHd];

  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kBqF + threadIdx.x;
  const int D = H * kHd;
  const size_t base = (size_t)b * S * D + (size_t)h * kHd;

  float qr[kHd], acc[kHd];
#pragma unroll
  for (int d = 0; d < kHd; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) x = *reinterpret_cast<const float4*>(q + base + (size_t)row * D + d);
    qr[d] = x.x * scale;
    qr[d + 1] = x.y * scale;
    qr[d + 2] = x.z * scale;
    qr[d + 3] = x.w * scale;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int n_tiles = (valid_len + kBkF - 1) / kBkF;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBkF * (kHd / 4); i += kBqF) {
      const int r = i / (kHd / 4), c = (i % (kHd / 4)) * 4;
      const int key = kt * kBkF + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < S) {
        kx = *reinterpret_cast<const float4*>(k + base + (size_t)key * D + c);
        vx = *reinterpret_cast<const float4*>(v + base + (size_t)key * D + c);
      }
      *reinterpret_cast<float4*>(&sk[r][c]) = kx;
      *reinterpret_cast<float4*>(&sv[r][c]) = vx;
    }
    __syncthreads();

    float s[kBkF];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBkF; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kHd; d += 4) {
        const float4 kx = *reinterpret_cast<const float4*>(&sk[j][d]);
        dot = fmaf(qr[d], kx.x, dot);
        dot = fmaf(qr[d + 1], kx.y, dot);
        dot = fmaf(qr[d + 2], kx.z, dot);
        dot = fmaf(qr[d + 3], kx.w, dot);
      }
      s[j] = (kt * kBkF + j < valid_len) ? dot : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    float shift;
    if (kStatic) {
      shift = static_max;
    } else {
      const float a = expf(m - mx);
      m = mx;
      l *= a;
#pragma unroll
      for (int d = 0; d < kHd; ++d) acc[d] *= a;
      shift = mx;
    }
#pragma unroll
    for (int j = 0; j < kBkF; ++j) {
      const float p = expf(s[j] - shift);
      l += p;
#pragma unroll
      for (int d = 0; d < kHd; d += 4) {
        const float4 vx = *reinterpret_cast<const float4*>(&sv[j][d]);
        acc[d] = fmaf(p, vx.x, acc[d]);
        acc[d + 1] = fmaf(p, vx.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vx.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vx.w, acc[d + 3]);
      }
    }
  }

  if (row < S) {
#pragma unroll
    for (int d = 0; d < kHd; d += 4)
      *reinterpret_cast<float4*>(o + base + (size_t)row * D + d) =
          make_float4(acc[d] / l, acc[d + 1] / l, acc[d + 2] / l, acc[d + 3] / l);
    lse[((size_t)b * H + h) * S + row] = (kStatic ? static_max : m) + logf(l);
  }
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = fp32, 1 = bf16. softmax: 0 =
// per-row max, 1 = fixed shift static_max, 2 = fast (bf16 only; the caller
// resolves fp32 to 0, as the TPU kernel ignores its fast flag in fp32).
// Launches on `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int owlvit_pk_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int S, int H, int hd,
                             int valid_len, float scale, int softmax,
                             float static_max, int dtype, void* stream) {
  if (hd != kHd || B < 1 || S < 1 || H < 1 || valid_len < 1 || valid_len > S ||
      softmax < kRowMax || softmax > kFast || (dtype == 0 && softmax == kFast))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // the bf16 kernel's shared memory is above the 48 KB default: raise its
    // limit once per device, for every softmax mode
    constexpr int kMaxDevices = 64;
    static bool smem_set[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!smem_set[dev]) {
      decltype(&pk_fwd_bf16<kRowMax>) kerns[] = {pk_fwd_bf16<kRowMax>, pk_fwd_bf16<kShift>,
                                                  pk_fwd_bf16<kFast>};
      for (auto kern : kerns) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmemBytes);
        if (err == cudaSuccess)  // room for two blocks per SM
          err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     static_cast<int>(cudaSharedmemCarveoutMaxShared));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      smem_set[dev] = true;
    }
    const dim3 grid((S + kBq - 1) / kBq, H, B);
    auto kern = softmax == kShift ? pk_fwd_bf16<kShift>
                : softmax == kFast  ? pk_fwd_bf16<kFast>
                                    : pk_fwd_bf16<kRowMax>;
    kern<<<grid, kThreads, kSmemBytes, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), S, H, valid_len, scale, static_max);
  } else if (dtype == 0) {
    const dim3 grid((S + kBqF - 1) / kBqF, H, B);
    auto kern = softmax == kShift ? pk_fwd_f32<true> : pk_fwd_f32<false>;
    kern<<<grid, kBqF, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), S, H, valid_len, scale, static_max);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
