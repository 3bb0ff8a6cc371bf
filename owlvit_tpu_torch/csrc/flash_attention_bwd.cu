// Packed flash-attention backward for Hopper (sm_90a), in the two modes of
// owlvit_tpu/ops/flash_attention.py::_pk_bwd:
//   "fused"  one kernel for dq, dk and dv sharing p (owlvit_pk_bwd); replaces
//            _pk_fused_bwd_kernel.
//   "both"   the split pair: dq by query tile (owlvit_pk_dq; replaces
//            _pk_dq_kernel, and at one head the transposed _dq_kernel), then
//            dk and dv by key tile (owlvit_pk_dkv; replaces _pk_dkv_kernel,
//            and at one head _dkv_kernel).
// Contract, packed [B, S, D] with head h = columns h*64 .. h*64+63:
//   in   q, k, v, o, do [B, S, D] (bf16 or fp32), lse [B, H, S] fp32 from
//        the forward kernel
//   out  dq, dk, dv [B, S, D]; the fused bf16 kernel's dq through an fp32
//        [B, S, D] buffer
//   p    = exp(q . (k*scale)^T - lse) over keys < valid_len (keys >=
//          valid_len get p = 0, so their dk and dv rows are 0)
//   delta = rowsum(do * o) in fp32, dp = do . v^T, ds = p * (dp - delta)
//   dq = ds . (k*scale), dk = ds^T . (q*scale), dv = p^T . do
// Query rows >= valid_len contribute nothing and their dq rows are 0.
// Rounding points kept from the TPU kernels: the scale is applied to the k and
// q tiles in the input dtype; ds is rounded to the input dtype before the dq
// and dk products, p before the dv product; every product accumulates in
// fp32.
//
// What bounds it: five products of 2*S*S*hd flops per (batch, head) in the
// fused kernel (seven across the pair: s and dp are computed twice), so
// 10*B*H*S^2*hd tensor-core flops per launch, against 8*B*S*D*2 bytes of
// inputs and outputs (q, k, v, o, do read, dq, dk, dv written) in bf16: at
// B/16 (S = 2305) about 1.3 TFLOP against 0.9 GB, far above the H100's ~295
// flops per byte, so the bound is the tensor cores, plus the S^2 exps. What
// held the first designs far from it was latency: a 64-query turn does five
// dependent steps (scores, softmax terms, three products) between two block
// barriers, and one 8-warp block per SM left nothing to fill the gaps. Then
// the dq sum across key tiles, which needs a reduction in L2.
//
// Design of the key-tile kernel (pk_bwd_bf16<kDq>; kDq = true is the fused
// kernel, kDq = false the pair's dkv kernel). The TPU kernel holds a whole
// K/V row in VMEM and carries fp32 dk/dv scratch across a sequential
// query-block grid dimension. Hopper blocks run in parallel with nothing
// carried between them, so here one block of two warpgroups owns (batch,
// head, 128-key tile), each warpgroup 64 keys (each warp 16), with dk and dv
// in fp32 registers, and a loop inside the block walks the 64-row query
// tiles. At most 128 registers a thread and 90 KB of shared memory let two
// blocks share an SM, so one block's barriers and waits overlap the other's
// work.
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
// dk += ds^T . (q*scale) runs as wgmma from shared memory (q*scale read along
// its other axis), and in the fused kernel the tile's dq partial ds .
// (k*scale) beside it (ds and k*scale read along their other axis; each
// warpgroup takes 32 of dq's 64 columns), over the key chunks that hold a
// valid key. The [64, 64] dq partial is added into the zeroed fp32 buffer
// with four-wide vector reductions (red.global.add.v4.f32, sm_90), one pair
// of shuffles giving each thread four consecutive columns; the wrapper casts
// it. The reductions meet in an order that changes from launch to launch, so
// the fused kernel's dq differs from run to run in its last fp32 bits (one
// bf16 ulp after the cast); dk and dv do not. The key tiles of one (batch,
// head) start their walk at different query tiles, so their reductions meet
// on different rows. Warpgroups whose 64 keys all lie at or past valid_len
// skip their products.
//
// Design of the pair's dq kernel (pk_dq_bf16), the forward kernel's layout
// (flash_attention_fwd.cu) with lse given: one block of two warpgroups owns
// (batch, head, 128-query tile), each warpgroup 64 rows; q and do stay in
// shared memory, lse and delta in registers, and K/V tiles of 64 keys come
// through a three-stage cp.async ring, two tiles loading ahead. Each thread
// rounds the k*scale chunks it copied in place once they land, before the
// tile's barrier: the TPU kernel's rounding point. Per tile: s = q .
// (k*scale)^T and dp = do . v^T by wgmma m64n64k16 from shared memory; p =
// exp(s - lse) and ds = p (dp - delta) in the accumulators; ds, rounded to
// bf16 and re-packed in registers, is the A operand of dq += ds . (k*scale)
// (k*scale read along its other axis). dq stays in fp32 registers over the
// whole key walk, in a fixed order, and is written once in bf16: no atomics,
// no buffer, no cast, so the pair's dq is the same from launch to launch.
// The pair computes s and dp twice (seven S x S products against five).
//
// ptxas serialises every wgmma of a kernel (a C75xx note in -Xptxas -v's
// report) when a product sits under a branch it cannot prove uniform
// (C7520), or when other instructions write a product's accumulators
// between the fence and the commit (C7515); so the warpgroup index is
// broadcast from lane 0, and the dq accumulators are zeroed before the fence.
// delta comes from a first small kernel (8 threads a row, 16-byte loads),
// launched by the fused entry point and by the pair's dq entry point; the
// dkv entry point reads the delta the dq call wrote.
// Ragged tiles (S = 2305 = 18*128 + 1, valid_len < S) are masked in the
// kernels, so nothing is padded. fp32 inputs take two FMA kernels, one by key
// tile (dk, dv) and one by query tile (dq), with no atomics: the fused entry
// point launches both, the pair's entry points one each.
// Given up: TMA and warp specialisation (cp.async feeds the rings; the
// products wait for their own wgmma), ds kept in fp32 (the TPU kernels'
// rounding is the contract).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kHd = 64;       // head dim: B/32, B/16 and L/14 all use 64
constexpr int kBk = 128;      // bf16: keys per block
constexpr int kBq = 64;       // bf16: query rows per turn of the inner loop
constexpr int kSubQ = 32;     // bf16: query rows per pass of the score products
constexpr int kWarps = kBk / 16;  // each warp owns 16 keys
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;    // query tiles in the cp.async ring

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

// *p += (a, b, c, d), one vector reduction in L2 (16-byte aligned p).
__device__ __forceinline__ void red_add_v4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1,%2,%3,%4};\n" ::"l"(p), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
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

// kDq: the fused kernel (dq partials added into dq_acc); else the pair's
// dkv kernel (dq_acc unused).
template <bool kDq>
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
  // warpgroup: keys 64 wg .. 64 wg + 63; broadcast from lane 0 so that the
  // compiler sees it uniform over the warp (ptxas serialises every wgmma of
  // a kernel whose control flow around them it cannot prove uniform)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);

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
        fence_operands(s);  // the zeros are written before the fence
        fence_operands(dp);
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

    // the dq product's accumulators are zeroed before the fence, and held
    // there by fence_operands (the compiler may otherwise move the zeros
    // next to the product): ptxas serialises every wgmma of the kernel
    // (C7515) when other instructions write a product's accumulators
    // between the fence and the commit
    float acc[4][4];
    if constexpr (kDq) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      fence_operands(acc);
    }
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
    if constexpr (kDq) {
      const uint64_t dsdesc = sw128_desc(sm.ds), kdesc = sw128_desc(sm.k + wg * 32);
      for (int c = 0; c < n_kc; ++c)
        wgmma_m64n32k16_tt(&acc[0][0], dsdesc + 128 * c, kdesc + 128 * c);
    }
    wgmma_commit();
    wgmma_wait();  // the dk and dq products
    if (live) fence_operands(dk_acc);
    if constexpr (kDq) {
      fence_operands(acc);
      // each thread holds (row g: 2 columns, row g+8: 2 columns) per column
      // tile; one exchange with lane t4 ^ 1 gives the even lane four columns
      // of row g and the odd lane four of row g+8, added with one reduction
      // each
      const bool odd = t4 & 1;
      const int row = q0 + qg * 16 + g + (odd ? 8 : 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x0 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][0] : acc[j][2], 1);
        const float x1 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][1] : acc[j][3], 1);
        const float4 val = odd ? make_float4(x0, x1, acc[j][2], acc[j][3])
                               : make_float4(acc[j][0], acc[j][1], x0, x1);
        if (row < valid_len)
          red_add_v4(dq_acc + base + (size_t)row * D + wg * 32 + j * 8 + (t4 & 2) * 2, val.x,
                     val.y, val.z, val.w);
      }
    }
  }

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

// The pair's bf16 dq kernel: one block of two warpgroups per (batch, head,
// 128-query tile), each warpgroup 64 query rows (each warp 16), 64-key K/V
// tiles through a three-stage ring.
constexpr int kDqBq = 128;  // query rows per block
constexpr int kDqBk = 64;   // keys per K/V tile
constexpr int kDqStages = 3;
constexpr int kDqAhead = kDqStages - 1;  // tiles loading ahead of the one computed
constexpr int kDqColTiles = kDqBk / 8;   // 8-key column tiles of a tile's scores

// The dq kernel's dynamic shared memory (80 KB, plus 1 KB to align it; two
// blocks fit on an SM), every tile in the 128-byte swizzled layout.
struct __align__(1024) DqSmem {
  __nv_bfloat16 q[kDqBq * kHd];
  __nv_bfloat16 dout[kDqBq * kHd];
  __nv_bfloat16 k[kDqStages][kDqBk * kHd];  // k * scale, once the tile has landed
  __nv_bfloat16 v[kDqStages][kDqBk * kHd];
};
constexpr int kDqSmemBytes = sizeof(DqSmem) + 1024;

// K/V tile k0 of one head into ring stage `stage`, by cp.async: keys >=
// valid_len zero-filled. Thread x copies chunks x and x + kThreads of each.
__device__ __forceinline__ void load_kv_tile(DqSmem& sm, int stage, const __nv_bfloat16* k,
                                             const __nv_bfloat16* v, int k0, int valid_len,
                                             int D) {
  for (int i = threadIdx.x; i < kDqBk * (kHd / 8); i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool in = k0 + r < valid_len;
    const size_t at = (size_t)(in ? k0 + r : 0) * D + c * 8;
    cp_async16(sm.k[stage] + sw_at(r, c), k + at, in);
    cp_async16(sm.v[stage] + sw_at(r, c), v + at, in);
  }
}

// k * scale in the input dtype, in place, on the chunks of a landed K tile
// that this thread copied (its own cp.async writes are visible to it once
// waited for; the tile's barrier publishes the result)
__device__ __forceinline__ void scale_own_k_chunks(__nv_bfloat16* tile, float scale) {
  for (int i = threadIdx.x; i < kDqBk * (kHd / 8); i += kThreads) {
    uint4* at = reinterpret_cast<uint4*>(tile + sw_at(i >> 3, i & 7));
    uint4 x = *at;
    scale_bf16x8(x, scale);
    *at = x;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    pk_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int S, int H, int valid_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kDqBq;
  const int D = H * kHd;
  const size_t base = (size_t)b * S * D + (size_t)h * kHd;
  const size_t rbase = ((size_t)b * H + h) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma group row, column pair
  // warpgroup: rows 64 wg .. 64 wg + 63; broadcast from lane 0 so that the
  // compiler sees it uniform over the warp
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r0 = (warp & 3) * 16 + g;  // this thread's rows in it: r0, r0 + 8
  const __nv_bfloat16* kh = k + base;
  const __nv_bfloat16* vh = v + base;
  const int n_tiles = (valid_len + kDqBk - 1) / kDqBk;  // tiles past valid_len add nothing

#pragma unroll
  for (int t = 0; t < kDqAhead; ++t) {  // fill the ring while q and do load
    if (t < n_tiles) load_kv_tile(sm, t, kh, vh, t * kDqBk, valid_len, D);
    cp_async_commit();
  }
  // q and do, rows >= S zero; the first tile's fence and barrier publish them
  for (int i = threadIdx.x; i < kDqBq * (kHd / 8); i += kThreads) {
    const int r = i >> 3, c = i & 7;
    uint4 x = make_uint4(0u, 0u, 0u, 0u), y = x;
    if (q0 + r < S) {
      const size_t at = base + (size_t)(q0 + r) * D + c * 8;
      x = *reinterpret_cast<const uint4*>(q + at);
      y = *reinterpret_cast<const uint4*>(dout + at);
    }
    *reinterpret_cast<uint4*>(sm.q + sw_at(r, c)) = x;
    *reinterpret_cast<uint4*>(sm.dout + sw_at(r, c)) = y;
  }
  // this thread's two query rows: lse * log2(e), infinite for rows >=
  // valid_len so that their p, and so their dq, is 0; and delta
  const int row0 = q0 + wg * 64 + r0, row1 = row0 + 8;
  const float le0 = row0 < valid_len ? lse[rbase + row0] * kLog2e : INFINITY;
  const float le1 = row1 < valid_len ? lse[rbase + row1] * kLog2e : INFINITY;
  const float dl0 = row0 < valid_len ? delta[rbase + row0] : 0.f;
  const float dl1 = row1 < valid_len ? delta[rbase + row1] : 0.f;

  const uint64_t qdesc = sw128_desc(sm.q + wg * 64 * kHd);
  const uint64_t ddesc = sw128_desc(sm.dout + wg * 64 * kHd);
  float acc[kHd / 8][4];  // dq rows r0 / r0+8, 8 column tiles of 8
#pragma unroll
  for (int d = 0; d < kHd / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float s[kDqColTiles][4], dp[kDqColTiles][4];  // scores then p; dp then ds
  uint32_t pa[kDqColTiles / 2][4];              // ds in bf16, the A fragments

  // Every warpgroup runs the products, one whose rows all lie past S too (on
  // zero rows), and every step takes the same path around them.
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kDqStages;
    cp_async_wait<kDqAhead - 1>();  // tile t is in
    scale_own_k_chunks(sm.k[stage], scale);
    fence_proxy_async();  // the tiles (and q, do) are read by wgmma
    __syncthreads();      // every warp is done with tile t - 1
    {
      const int tn = t + kDqAhead;  // refill the stage tile t - 1 used
      if (tn < n_tiles) load_kv_tile(sm, tn % kDqStages, kh, vh, tn * kDqBk, valid_len, D);
      cp_async_commit();
    }
    const uint64_t kdesc = sw128_desc(sm.k[stage]);
    const uint64_t vdesc = sw128_desc(sm.v[stage]);
    // s = q . (k*scale)^T and dp = do . v^T for the warpgroup's 64 rows, both
    // operands K-major in shared memory; the first k-step overwrites
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      wgmma_m64n64k16_ss(&s[0][0], qdesc + 2 * kk, kdesc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      wgmma_m64n64k16_ss(&dp[0][0], ddesc + 2 * kk, vdesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait();
    fence_operands(s);
    fence_operands(dp);
    const int k0 = t * kDqBk;
    if (k0 + kDqBk > valid_len) {  // keys >= valid_len: p = 2^-inf = 0
#pragma unroll
      for (int j = 0; j < kDqColTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + j * 8 + t4 * 2 + e >= valid_len) s[j][e] = s[j][e + 2] = -INFINITY;
    }
    // p = exp(s - lse) = 2^(s log2(e) - lse log2(e)); ds = p (dp - delta),
    // rounded to bf16: the C fragments of column tiles 2c, 2c+1 are the A
    // fragment of 16-key chunk c
#pragma unroll
    for (int j = 0; j < kDqColTiles; ++j) {
      dp[j][0] = ex2(fmaf(s[j][0], kLog2e, -le0)) * (dp[j][0] - dl0);
      dp[j][1] = ex2(fmaf(s[j][1], kLog2e, -le0)) * (dp[j][1] - dl0);
      dp[j][2] = ex2(fmaf(s[j][2], kLog2e, -le1)) * (dp[j][2] - dl1);
      dp[j][3] = ex2(fmaf(s[j][3], kLog2e, -le1)) * (dp[j][3] - dl1);
    }
#pragma unroll
    for (int c = 0; c < kDqColTiles / 2; ++c) {
      pa[c][0] = pack_bf16(dp[2 * c][0], dp[2 * c][1]);
      pa[c][1] = pack_bf16(dp[2 * c][2], dp[2 * c][3]);
      pa[c][2] = pack_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1]);
      pa[c][3] = pack_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3]);
    }
    // dq += ds . (k*scale), k*scale read along its other axis
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kDqColTiles / 2; ++c)
      wgmma_m64n64k16_bt(&acc[0][0], pa[c], kdesc + 128 * c);
    wgmma_commit();
    wgmma_wait();
    fence_operands(acc);
    fence_operands(pa);
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (q0 + wg * 64 >= S) return;  // a warpgroup with no real row stores nothing

#pragma unroll
  for (int d = 0; d < kHd / 8; ++d) {
    const int c = d * 8 + t4 * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row0 * D + c) =
          __floats2bfloat162_rn(acc[d][0], acc[d][1]);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row1 * D + c) =
          __floats2bfloat162_rn(acc[d][2], acc[d][3]);
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

// Raise `kern`'s dynamic shared memory limit to `bytes` (above the 48 KB
// default) and ask for the largest carveout (room for two blocks per SM),
// once per device: done[] is that kernel's own flags.
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t set_smem_once(Kernel kern, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

bool valid_shape(int B, int S, int H, int hd, int valid_len) {
  return hd == kHd && B >= 1 && S >= 1 && H >= 1 && valid_len >= 1 && valid_len <= S;
}

// delta = rowsum(do * o) in fp32 [B, H, S], on `st`
void launch_delta(const void* dout, const void* o, void* delta, int B, int S, int H,
                  int dtype, cudaStream_t st) {
  const long long rows = (long long)B * S * H;
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    pk_bwd_delta_bf16<<<static_cast<int>((rows * 8 + 255) / 256), 256, 0, st>>>(
        static_cast<const bf*>(dout), static_cast<const bf*>(o), static_cast<float*>(delta), S,
        H, rows);
  } else {
    pk_bwd_delta<float><<<static_cast<int>((rows + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(dout), static_cast<const float*>(o),
        static_cast<float*>(delta), S, H, rows);
  }
}

// the bf16 key-tile kernel's shared memory limit, set before its first launch
template <bool kDq>
cudaError_t bwd_bf16_smem() {
  static bool smem_set[kMaxDevices];
  return set_smem_once(pk_bwd_bf16<kDq>, kSmemBytes, smem_set);
}

// the bf16 key-tile kernel: fused (kDq, dq added into the fp32 dq_acc) or
// the pair's dkv kernel
template <bool kDq>
void launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
                     int B, int S, int H, int valid_len, float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const dim3 grid((S + kBk - 1) / kBk, H, B);
  pk_bwd_bf16<kDq><<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc), static_cast<bf*>(dk),
      static_cast<bf*>(dv), S, H, valid_len, scale);
}

void launch_dkdv_f32(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                     int H, int valid_len, float scale, cudaStream_t st) {
  const dim3 grid((S + kRowsF - 1) / kRowsF, H, B);
  pk_bwd_dkdv_f32<<<grid, 2 * kRowsF, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), S, H, valid_len, scale);
}

void launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int S, int H,
                   int valid_len, float scale, cudaStream_t st) {
  const dim3 grid((S + kRowsF - 1) / kRowsF, H, B);
  pk_bwd_dq_f32<<<grid, 2 * kRowsF, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), S, H, valid_len, scale);
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = fp32, 1 = bf16. delta is fp32
// [B, H, S] scratch. Each launches on `stream` and returns cudaGetLastError()
// (0 on success); none synchronises.

// Mode "fused": dq, dk and dv. dq is fp32 [B, S, D]: bf16 adds into it with
// vector reductions, so it must be zeroed; fp32 writes it.
extern "C" int owlvit_pk_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* lse, const void* dout,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int S, int H, int hd, int valid_len, float scale,
                             int dtype, void* stream) {
  if (!valid_shape(B, S, H, hd, valid_len) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const cudaError_t err = bwd_bf16_smem<true>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  launch_delta(dout, o, delta, B, S, H, dtype, st);
  if (dtype == 1) {
    launch_bwd_bf16<true>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, valid_len, scale, st);
  } else {
    launch_dkdv_f32(q, k, v, dout, lse, delta, dk, dv, B, S, H, valid_len, scale, st);
    launch_dq_f32(q, k, v, dout, lse, delta, dq, B, S, H, valid_len, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Mode "both", first half: delta (written for owlvit_pk_dkv) and dq in the
// input dtype, by query tile.
extern "C" int owlvit_pk_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* delta, void* dq, int B,
                            int S, int H, int hd, int valid_len, float scale, int dtype,
                            void* stream) {
  if (!valid_shape(B, S, H, hd, valid_len) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    static bool smem_set[kMaxDevices];
    const cudaError_t err = set_smem_once(pk_dq_bf16, kDqSmemBytes, smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  launch_delta(dout, o, delta, B, S, H, dtype, st);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const dim3 grid((S + kDqBq - 1) / kDqBq, H, B);
    pk_dq_bf16<<<grid, kThreads, kDqSmemBytes, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf*>(dq), S, H, valid_len, scale);
  } else {
    launch_dq_f32(q, k, v, dout, lse, delta, dq, B, S, H, valid_len, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Mode "both", second half: dk and dv in the input dtype, by key tile, from
// the delta owlvit_pk_dq wrote on the same stream.
extern "C" int owlvit_pk_dkv(const void* q, const void* k, const void* v, const void* lse,
                             const void* dout, const void* delta, void* dk, void* dv, int B,
                             int S, int H, int hd, int valid_len, float scale, int dtype,
                             void* stream) {
  if (!valid_shape(B, S, H, hd, valid_len) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const cudaError_t err = bwd_bf16_smem<false>();
    if (err != cudaSuccess) return static_cast<int>(err);
    launch_bwd_bf16<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, B, S, H, valid_len,
                           scale, st);
  } else {
    launch_dkdv_f32(q, k, v, dout, lse, delta, dk, dv, B, S, H, valid_len, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}
