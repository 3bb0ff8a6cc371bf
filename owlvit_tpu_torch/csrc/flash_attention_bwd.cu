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
// Design of the fused kernel (pk_bwd_bf16; reached by
// OWLVIT_PACKED_BWD=fused, the A/B yardstick: the default backward is the
// pair). The TPU kernel holds a whole
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
// its other axis), and the tile's dq partial ds . (k*scale) beside it (ds
// and k*scale read along their other axis; each warpgroup takes 32 of dq's
// 64 columns), over the key chunks that hold a valid key. The [64, 64] dq
// partial is added into the zeroed fp32 buffer with four-wide vector
// reductions (red.global.add.v4.f32, sm_90), one pair of shuffles giving
// each thread four consecutive columns; the wrapper casts it. The
// reductions meet in an order that changes from launch to launch, so the
// fused kernel's dq differs from run to run in its last fp32 bits (one bf16
// ulp after the cast): it is not reproducible, and so not the default. dk
// and dv are. The key tiles of one (batch, head) start their walk at
// different query tiles, so their reductions meet on different rows.
// Warpgroups whose 64 keys all lie at or past valid_len skip their products.
//
// Design of the pair's dq kernel (pk_dq_bf16; replaces _pk_dq_kernel, and at
// one head the transposed _dq_kernel). Three S x S products (s, dp, dq) of
// 2*S*S*64 flops per (batch, head) bound it on the tensor cores: 0.79 ms at
// [32, 2305, 768] on an H100 SXM, against 0.15 ms for its bytes. What keeps
// it from that bound is shared memory: s and dp read both operands from it
// (q and do as A: registers for them would cost two blocks an SM), so a
// warpgroup's 64-key tile moves ~48 KB through it for 384 clocks of
// products. One block of two warpgroups owns (batch, head, 128-query tile),
// each warpgroup 64 rows; q and do stay in shared memory, lse and delta in
// registers (delta = rowsum(do * o) summed by the block itself, as the delta
// kernel sums it, and written for the dkv kernel: one launch in bf16), and
// K/V tiles of 64 keys come through a four-stage ring fed by
// TMA (3-D maps whose key extent is valid_len, so the copy engine zero-fills
// keys past it; 128-byte swizzle, the layout of sw_at). One thread issues
// the first four tiles; after that the last of the block's warps to finish
// with a stage (a counter in shared memory) refills it, so the walk has no
// block barrier and no producer warp, and a warpgroup waits only on the
// stage's mbarrier. Step t issues s(t) = q . k^T and dq(t-1) += ds(t-1) .
// k (ds in registers as the A operand, k read along its other axis), runs
// half of tile t's exps while dq(t-1) runs, issues dp(t) = do . v^T once
// dq(t-1) has released the fragments, runs the other half while dp(t) runs,
// and packs ds(t) = bf16(p (dp - delta)); the first s/dp and the last dq
// are peeled off the loop. dq stays in fp32
// registers over the whole key walk, in a fixed order, and is written once
// in bf16: no atomics, so the pair's dq is the same from launch to launch.
// k*scale is rounded to bf16 once (the TPU kernel's rounding point): where
// the scale is a power of two <= 1 (1/8 at head dim 64) that rounding is
// exact, so the kernel reads k and takes the scale into the exps' FMA and
// dq's store, with the same bits; any other scale goes through a scratch
// that a small launch fills first. A warpgroup whose rows all lie past S
// leaves after the prologue. Steps, timed in turns on an H100 80GB HBM3 at 700 W
// at [32, 2305, 768] (tools/torch_pk_bwd_profile.py): the parent's
// cp.async ring with a block barrier and a rounding pass per tile, 2.03-2.09
// ms; full overlap (s, dp, dq's accumulators and ds live together) spilled
// at 128 registers and ptxas serialised every wgmma (C7512): 2.90 ms; the
// same at one block an SM: 2.63; dp after dq (kept): 1.92 against 2.05;
// k*scale from a scratch instead of the rounding pass: 1.79 against 2.01;
// TMA: 1.67 against 1.73; the warpgroup past S leaving: within the noise
// (kept); the maps' L2 promotion 128 B: no change (dropped); four
// warpgroups and 256 queries a block (one block an SM, the K/V stream
// halved): 1.80 against 1.71 (dropped); the scale folded: the delta launch
// 0.147 -> 0.080 ms; delta summed in the dq kernel (no delta launch): 1.65
// against 1.68; half the exps moved behind dp: 1.61 against 1.65.
// Computing on stale tiles instead of loading them (a measurement, not a
// design) is 9% faster: what the K/V stream costs.
// The pair computes s and dp twice (seven S x S products against five).
//
// Design of the pair's dk/dv kernel (pk_dkv_bf16; replaces _pk_dkv_kernel,
// and at one head the transposed _dkv_kernel). Four S x S products (s^T,
// dp^T, dv, dk) of 2*S*S*64 flops per (batch, head) bound it on the tensor
// cores: 1.06 ms at [32, 2305, 768] on an H100 SXM, against 0.14 ms for its
// bytes; beside them S*S exps, half the tensor cores' time at the MUFU's 16
// a clock an SM. It keeps nothing that the fused kernel's dq product forced
// on it. One block of two warpgroups owns (batch, head, 128-key tile), each
// warpgroup 64 keys, one block an SM (234 registers a thread): the
// warpgroup's k and v rows stay in registers as wgmma A fragments for the
// whole walk (loaded once; where bf16(k * scale) is not exact, rounded
// there), so every product reads only its B tile from shared memory (half
// the shared-memory traffic of two shared operands), and dk, dv and the
// 64-query s^T and dp^T accumulators live beside them. 64-query tiles of q
// and do come through a four-stage ring fed by TMA (the dq kernel's 3-D
// maps, row extent valid_len); lse and delta cannot (a [B, H, S] row at S =
// 2305 starts 9,220 bytes after the last, not a multiple of 16), so the
// loading warp's lanes copy them by cp.async and each arrives on the stage's
// mbarrier once its copies land (cp.async.mbarrier.arrive.noinc: 1 + 32
// arrivals a phase). The last live warp out of a stage refills it, as in the
// dq kernel: no block barrier in the walk. The scores of two tiles take
// turns in two accumulator sets (234 registers). Step t issues
// s^T(t + 1) = k . q^T into the free set, rounds tile t's p^T and ds^T =
// p^T (dp^T - delta) to bf16 and packs them as A fragments while it runs,
// issues tile t's dv += p^T . do and dk += ds^T . q (q and do read along
// their other axis) and dp^T(t + 1) = v . do^T, and runs tile t + 1's exps
// once s^T(t + 1) is done, behind those three: no product of the
// warpgroup waits for its own pack. The first s^T and dp^T and the last dv
// and dk are peeled off the loop. Only the last query tile can hold rows
// past valid_len, so only its exps test them. Where the scale is a power
// of two <= 1 (1/8 at head dim 64) bf16(q * scale) and bf16(k * scale) are
// exact, so the kernel reads q and k and takes the scale into the exps' FMA
// and dk's store, with the same bits; any other scale reads q * scale tiles
// from a scratch that a small launch fills first (kQs), k * scale from its
// rounded fragments. No key mask runs in the walk: a key's p reaches only its
// own dk and dv rows, which are written as 0 for keys >= valid_len; a query
// row >= valid_len (zero-filled, or real past valid_len) reads lse as +inf,
// so its p is 0. dk and dv are summed in registers in a fixed order and
// written once: the same inputs give the same bits. A warpgroup whose keys
// all lie past valid_len writes its zero rows and leaves. Steps, timed in
// turns at [32, 2305, 768] on an H100 80GB HBM3 at 700 W
// (tools/torch_pk_bwd_profile.py, pk_dkv alone): the fused kernel with its
// dq product compiled out, 3.22 ms; ds^T from registers (no ds^T store, one
// block barrier a turn), 2.91; the scale folded, 2.61; the TMA ring with
// 64-query products, register k and v and one block an SM, 2.55; s^T(t)
// issued with dv/dk(t - 1) and dp^T(t), 2.49-2.51; two score sets,
// s^T(t + 1) beside the pack, 2.38; the mask test on the last tile only,
// 2.29. Measurements, not designs: without the ex2 the kernel is 6.5%
// faster, without the pack's FP32 arithmetic 8.9%; walking each key tile's
// queries twice takes more than twice as long (no fixed cost a block shows,
// so a persistent grid would buy nothing); p^T packed before dp^T's wait,
// no gain.
//
// ptxas serialises every wgmma of a kernel (a C75xx note in -Xptxas -v's
// report) when a product sits under a branch it cannot prove uniform
// (C7520), when other instructions write a product's accumulators between
// the fence and the commit (C7515), or when it runs out of registers for
// them (C7512); so the warpgroup index is broadcast from lane 0, and the
// accumulators are zeroed before the fence.
// The fused entry point gets delta from a first small kernel (8 threads a
// row, 16-byte loads; fp32 and the pair's fp32 dq entry point alike); the
// dkv entry point reads the delta the dq call wrote.
// Ragged tiles (S = 2305 = 18*128 + 1, valid_len < S) are masked in the
// kernels, so nothing is padded. fp32 inputs take two FMA kernels, one by key
// tile (dk, dv) and one by query tile (dq), with no atomics: the fused entry
// point launches both, the pair's entry points one each.
// Given up: ds kept in fp32 (the TPU kernels' rounding is the contract).

#include <cuda.h>  // CUtensorMap; its encoder is reached through the runtime (no -lcuda)
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
// contiguous bytes of each. The dq kernel sums its rows' delta the same way.
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

// xs = bf16(x * scale), eight values a thread, where that rounding is not
// exact: the dq kernel's K tiles (x = k) and the dkv kernel's q * scale
// tiles (x = q); n8: the number of 8-value chunks
__global__ void __launch_bounds__(256)
    scaled_bf16(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ xs,
                long long n8, float scale) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n8) return;
  uint4 v = *reinterpret_cast<const uint4*>(x + idx * 8);
  scale_bf16x8(v, scale);
  *reinterpret_cast<uint4*>(xs + idx * 8) = v;
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

// The fused kernel: dk and dv by key tile, dq partials added into dq_acc.
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
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    fence_operands(acc);
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
    {
      const uint64_t dsdesc = sw128_desc(sm.ds), kdesc = sw128_desc(sm.k + wg * 32);
      for (int c = 0; c < n_kc; ++c)
        wgmma_m64n32k16_tt(&acc[0][0], dsdesc + 128 * c, kdesc + 128 * c);
    }
    wgmma_commit();
    wgmma_wait();  // the dk and dq products
    if (live) fence_operands(dk_acc);
    {
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
// tiles through a four-stage ring fed by TMA: tile t computed, tile t - 1
// still read by its dq product, tiles t + 1 and t + 2 landed or in flight.
constexpr int kDqWgs = 2;             // warpgroups per block
constexpr int kDqThreads = 128 * kDqWgs;
constexpr int kDqBq = 64 * kDqWgs;    // query rows per block
constexpr int kDqBk = 64;             // keys per K/V tile
constexpr int kDqStages = 4;
constexpr int kDqColTiles = kDqBk / 8;  // 8-key column tiles of a tile's scores
constexpr int kDqTileBytes = 2 * kDqBk * kHd * 2;  // one K and one V tile, bf16

// The dq kernel's dynamic shared memory (97 KB with the mbarriers, plus 1 KB
// to align it; two blocks fit on an SM), every tile in the 128-byte swizzled
// layout.
struct __align__(1024) DqSmem {
  __nv_bfloat16 q[kDqBq * kHd];
  __nv_bfloat16 dout[kDqBq * kHd];
  __nv_bfloat16 k[kDqStages][kDqBk * kHd];  // k, or k * scale (owlvit_pk_dq)
  __nv_bfloat16 v[kDqStages][kDqBk * kHd];
  float delta[kDqBq];             // rowsum(do * o) of the block's rows
  uint64_t full[kDqStages];      // the stage's K and V tiles have landed
  unsigned int done[kDqStages];  // warps done with the stage, counted up
};
constexpr int kDqSmemBytes = sizeof(DqSmem) + 1024;

// acc (+)= a . b^T for the warpgroup's 64 rows and a 64-key tile, a and b
// K-major in shared memory (s = q . k^T, dp = do . v^T); the first k-step
// overwrites. Issued and committed as one group, not waited for.
__device__ __forceinline__ void issue_scores(float (&acc)[kDqColTiles][4], uint64_t adesc,
                                             uint64_t bdesc) {
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    wgmma_m64n64k16_ss(&acc[0][0], adesc + 2 * kk, bdesc + 2 * kk, kk);
  wgmma_commit();
}

// dq += ds . k for a 64-key tile: ds from registers (pa[c], the A fragment
// of 16-key chunk c), k read along its other axis. Issued and committed as
// one group, not waited for.
__device__ __forceinline__ void issue_dq(float (&acc)[kHd / 8][4],
                                         const uint32_t (&pa)[kDqColTiles / 2][4],
                                         uint64_t kdesc) {
#pragma unroll
  for (int c = 0; c < kDqColTiles / 2; ++c)
    wgmma_m64n64k16_bt(&acc[0][0], pa[c], kdesc + 128 * c);
  wgmma_commit();
}

// Keys >= valid_len of key tile k0 get s = -inf, so that p = 0 and ds = 0
// whatever their k and v rows hold.
__device__ __forceinline__ void mask_tile(float (&s)[kDqColTiles][4], int k0, int valid_len,
                                          int t4) {
  if (k0 + kDqBk > valid_len) {
#pragma unroll
    for (int j = 0; j < kDqColTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + j * 8 + t4 * 2 + e >= valid_len) s[j][e] = s[j][e + 2] = -INFINITY;
  }
}

// p = exp(s - lse) = 2^(s sl - lse log2(e)) in fp32, in place in s, on
// column tiles J0 .. J1 - 1 (one FMA and one ex2; sl = log2(e) times the
// scale the product still lacks, le = lse log2(e) of this thread's rows
// r0, r0 + 8)
template <int J0, int J1>
__device__ __forceinline__ void p_cols(float (&s)[kDqColTiles][4], float sl, float le0,
                                       float le1) {
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    s[j][0] = ex2(fmaf(s[j][0], sl, -le0));
    s[j][1] = ex2(fmaf(s[j][1], sl, -le0));
    s[j][2] = ex2(fmaf(s[j][2], sl, -le1));
    s[j][3] = ex2(fmaf(s[j][3], sl, -le1));
  }
}

// ds = p (dp - delta) in fp32, rounded to bf16: the C fragments of column
// tiles 2c, 2c+1 are the A fragment of 16-key chunk c
__device__ __forceinline__ void pack_ds(const float (&p)[kDqColTiles][4],
                                        const float (&dp)[kDqColTiles][4], float dl0, float dl1,
                                        uint32_t (&pa)[kDqColTiles / 2][4]) {
#pragma unroll
  for (int c = 0; c < kDqColTiles / 2; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * c + h;
      pa[c][2 * h] = pack_bf16(p[j][0] * (dp[j][0] - dl0), p[j][1] * (dp[j][1] - dl0));
      pa[c][2 * h + 1] = pack_bf16(p[j][2] * (dp[j][2] - dl1), p[j][3] * (dp[j][3] - dl1));
    }
  }
}

__global__ void __launch_bounds__(kDqThreads, 2)
    pk_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ dout,
               const __nv_bfloat16* __restrict__ o, const float* __restrict__ lse,
               float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S, int H,
               int valid_len, float kscale,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap) {
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
  const int n_tiles = (valid_len + kDqBk - 1) / kDqBk;  // tiles past valid_len add nothing

  // K/V tile t into its stage, by the copy engine (one thread): the maps'
  // key extent is valid_len, so keys >= valid_len land as zeros
  auto load = [&](int t) {
    const int st = t % kDqStages;
    mbar_expect_tx(&sm.full[st], kDqTileBytes);
    tma_load_3d(sm.k[st], &kmap, &sm.full[st], h * kHd, t * kDqBk, b);
    tma_load_3d(sm.v[st], &vmap, &sm.full[st], h * kHd, t * kDqBk, b);
  };
  if (threadIdx.x == 0) {  // fill the ring while q and do load
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(&sm.full[st], 1);
      sm.done[st] = 0;
    }
    fence_mbarrier_init();
    for (int t = 0; t < kDqStages && t < n_tiles; ++t) load(t);
  }
  // q and do into shared memory, rows >= S zero; delta = rowsum(do * o) of
  // the block's rows, written for pk_dkv: the eight lanes of a row (its
  // eight 16-byte chunks) sum as pk_bwd_delta_bf16 does, so the bits are
  // the same
  for (int i = threadIdx.x; i < kDqBq * (kHd / 8); i += kDqThreads) {
    const int r = i >> 3, c = i & 7;
    uint4 x = make_uint4(0u, 0u, 0u, 0u), y = x, z = x;
    if (q0 + r < S) {
      const size_t at = base + (size_t)(q0 + r) * D + c * 8;
      x = *reinterpret_cast<const uint4*>(q + at);
      y = *reinterpret_cast<const uint4*>(dout + at);
      z = *reinterpret_cast<const uint4*>(o + at);
    }
    *reinterpret_cast<uint4*>(sm.q + sw_at(r, c)) = x;
    *reinterpret_cast<uint4*>(sm.dout + sw_at(r, c)) = y;
    const __nv_bfloat16* ye = reinterpret_cast<const __nv_bfloat16*>(&y);
    const __nv_bfloat16* ze = reinterpret_cast<const __nv_bfloat16*>(&z);
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(__bfloat162float(ye[e]), __bfloat162float(ze[e]), sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (c == 0) {
      sm.delta[r] = sum;
      if (q0 + r < S) delta[rbase + q0 + r] = sum;
    }
  }
  fence_proxy_async();  // q and do are read by wgmma
  __syncthreads();      // q, do, delta, the barriers and the counters are in place
  // A warpgroup whose rows all lie at or past S (the second of the last
  // query tile at S = 2305) has nothing to compute: it leaves, and the
  // stages' releases count the other warps alone.
  const unsigned live_warps = 4 * min(kDqWgs, (S - q0 + 63) / 64);
  if (q0 + wg * 64 >= S) return;
  // this thread's two query rows: lse * log2(e), infinite for rows >=
  // valid_len so that their p, and so their dq, is 0; and delta
  const int row0 = q0 + wg * 64 + r0, row1 = row0 + 8;
  const float le0 = row0 < valid_len ? lse[rbase + row0] * kLog2e : INFINITY;
  const float le1 = row1 < valid_len ? lse[rbase + row1] * kLog2e : INFINITY;
  const float dl0 = row0 < valid_len ? sm.delta[wg * 64 + r0] : 0.f;
  const float dl1 = row1 < valid_len ? sm.delta[wg * 64 + r0 + 8] : 0.f;

  const float sl = kscale * kLog2e;  // exact: kscale is 1 or a power of two
  const uint64_t qdesc = sw128_desc(sm.q + wg * 64 * kHd);
  const uint64_t ddesc = sw128_desc(sm.dout + wg * 64 * kHd);
  float acc[kHd / 8][4];  // dq rows r0 / r0+8, 8 column tiles of 8
#pragma unroll
  for (int d = 0; d < kHd / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  fence_operands(acc);  // the zeros are written before the first product's fence
  float s[kDqColTiles][4], dp[kDqColTiles][4];  // scores, then p; dp
  uint32_t pa[kDqColTiles / 2][4];              // ds of the previous tile in bf16

  // tile t has landed in its stage (the stage's use t / kDqStages)
  auto wait_tile = [&](int t) { mbar_wait(&sm.full[t % kDqStages], (t / kDqStages) & 1); };
  // This warp's products that read tile t have completed; the last of the
  // block's warps to say so refills the stage with tile t + kDqStages.
  // No block barrier: a warpgroup waits only for the tiles it reads.
  auto release = [&](int t) {
    if (lane == 0 && atomicAdd(&sm.done[t % kDqStages], 1u) % live_warps == live_warps - 1 &&
        t + kDqStages < n_tiles)
      load(t + kDqStages);
    __syncwarp();
  };

  // Step t issues tile t's s product, then tile t - 1's dq product from the
  // ds fragments it still holds, and computes half of tile t's p (the exps)
  // while that dq product runs (the forward's overlap); then the dp
  // product, and the other half of the exps while it runs; then ds, packed
  // to bf16 once both products are done. dp is issued only once dq is done
  // with the fragments: s, dp, dq's accumulators and the fragments all live
  // at once would not fit two blocks an SM. The first s and dp and the last
  // dq are peeled off the loop, so that no product sits under a branch and
  // every step takes the same path around them.
  constexpr int kHalf = kDqColTiles / 2;
  wait_tile(0);
  wgmma_fence();
  issue_scores(s, qdesc, sw128_desc(sm.k[0]));
  wgmma_wait_n<0>();
  fence_operands(s);
  mask_tile(s, 0, valid_len, t4);
  p_cols<0, kHalf>(s, sl, le0, le1);
  wgmma_fence();
  issue_scores(dp, ddesc, sw128_desc(sm.v[0]));
  p_cols<kHalf, kDqColTiles>(s, sl, le0, le1);
  wgmma_wait_n<0>();
  fence_operands(dp);
  pack_ds(s, dp, dl0, dl1, pa);
  for (int t = 1; t < n_tiles; ++t) {
    const int stage = t % kDqStages;
    wait_tile(t);
    wgmma_fence();
    issue_scores(s, qdesc, sw128_desc(sm.k[stage]));
    issue_dq(acc, pa, sw128_desc(sm.k[(t - 1) % kDqStages]));
    wgmma_wait_n<1>();  // s, committed first
    fence_operands(s);
    mask_tile(s, t * kDqBk, valid_len, t4);
    p_cols<0, kHalf>(s, sl, le0, le1);  // half the exps while dq(t - 1) runs
    wgmma_wait_n<0>();  // tile t - 1's dq product: acc and pa are free
    fence_operands(acc);
    fence_operands(pa);
    release(t - 1);
    wgmma_fence();
    issue_scores(dp, ddesc, sw128_desc(sm.v[stage]));
    p_cols<kHalf, kDqColTiles>(s, sl, le0, le1);  // the other half while dp(t) runs
    wgmma_wait_n<0>();
    fence_operands(dp);
    pack_ds(s, dp, dl0, dl1, pa);
  }
  wgmma_fence();
  issue_dq(acc, pa, sw128_desc(sm.k[(n_tiles - 1) % kDqStages]));
  wgmma_wait_n<0>();
  fence_operands(acc);
  fence_operands(pa);

#pragma unroll
  for (int d = 0; d < kHd / 8; ++d) {
    const int c = d * 8 + t4 * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row0 * D + c) =
          __floats2bfloat162_rn(acc[d][0] * kscale, acc[d][1] * kscale);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row1 * D + c) =
          __floats2bfloat162_rn(acc[d][2] * kscale, acc[d][3] * kscale);
  }
}

// The pair's bf16 dk/dv kernel: one block of two warpgroups per (batch,
// head, 128-key tile), one block an SM, each warpgroup 64 keys (each warp
// 16) with their k and v rows in registers as wgmma A fragments and dk, dv
// in fp32 registers; 64-query tiles of q and do (and q * scale where that
// rounding is not exact, kQs) come through a four-stage ring fed by TMA,
// lse and delta beside them by cp.async on the stage's mbarrier.
constexpr int kDkvWgs = 2;              // warpgroups per block
constexpr int kDkvThreads = 128 * kDkvWgs;
constexpr int kDkvBk = 64 * kDkvWgs;    // keys per block
constexpr int kDkvBq = 64;              // query rows per tile
constexpr int kDkvStages = 4;
constexpr int kDkvCols = kDkvBq / 8;    // 8-query column tiles of a tile's scores
constexpr int kDkvTileBytes = kDkvBq * kHd * 2;  // one bf16 q, do or q*scale tile
// a stage completes on one arrival with its TMA bytes (the loading warp's
// lane 0) and one cp.async arrival from each of that warp's 32 lanes
constexpr int kDkvArrivals = 1 + 32;

// The dkv kernel's dynamic shared memory (75 KB, 99 KB with the q * scale
// tiles, plus 1 KB to align it), every tile in the 128-byte swizzled layout.
template <bool kQs>
struct __align__(1024) DkvSmem {
  __nv_bfloat16 q[kDkvStages][kDkvBq * kHd];
  __nv_bfloat16 dout[kDkvStages][kDkvBq * kHd];
  __nv_bfloat16 qs[kQs ? kDkvStages : 1][kDkvBq * kHd];  // q * scale (kQs only)
  float lse[kDkvStages][kDkvBq];
  float delta[kDkvStages][kDkvBq];
  uint64_t full[kDkvStages];      // the stage's tiles, lse and delta have landed
  unsigned int done[kDkvStages];  // warps done with the stage, counted up
};
template <bool kQs>
constexpr int dkv_smem_bytes() { return sizeof(DkvSmem<kQs>) + 1024; }

// The thread's A fragments (rows r, r + 8 of the warpgroup's 64 keys; every
// 16-column chunk of the head) of a bf16 [B, S, D] tensor at row `key`
// (rows >= S are zero), each value rounded to bf16(x * scale) when kScale.
template <bool kScale>
__device__ __forceinline__ void load_rows_a(uint32_t (&a)[kHd / 16][4],
                                            const __nv_bfloat16* __restrict__ x, size_t base,
                                            int key, int S, int D, int t4, float scale) {
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = key + (e & 1) * 8, col = kk * 16 + (e >> 1) * 8 + t4 * 2;
      uint32_t w = 0u;
      if (row < S) w = *reinterpret_cast<const uint32_t*>(x + base + (size_t)row * D + col);
      if constexpr (kScale) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
        w = pack_bf16(__bfloat162float(__float2bfloat16_rn(__low2float(v) * scale)),
                      __bfloat162float(__float2bfloat16_rn(__high2float(v) * scale)));
      }
      a[kk][e] = w;
    }
  }
}

// acc (=)= a . b^T over the head's 64 columns: a the warpgroup's 64 key rows
// from registers, b a 64-row tile K-major in shared memory (s^T = k . q^T,
// dp^T = v . do^T); the first k-step overwrites. One commit group, not
// waited for.
__device__ __forceinline__ void issue_rows(float (&acc)[kDkvCols][4],
                                           const uint32_t (&a)[kHd / 16][4], uint64_t bdesc) {
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    wgmma_m64n64k16_rs(&acc[0][0], a[kk], bdesc + 2 * kk, kk);
  wgmma_commit();
}

// acc += a . b over a 64-query tile: a (p^T or ds^T) from registers (a[c],
// the A fragment of 16-query chunk c), b the tile read along its other
// axis (do for dv, q or q * scale for dk). Not committed.
__device__ __forceinline__ void issue_cols(float (&acc)[kHd / 8][4],
                                           const uint32_t (&a)[kDkvCols / 2][4], uint64_t bdesc) {
#pragma unroll
  for (int c = 0; c < kDkvCols / 2; ++c) wgmma_m64n64k16_bt(&acc[0][0], a[c], bdesc + 128 * c);
}

template <bool kQs>
__global__ void __launch_bounds__(kDkvThreads, 1)
    pk_dkv_bf16(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                int valid_len, float scale, const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap dmap,
                const __grid_constant__ CUtensorMap qsmap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<kQs>& sm = *reinterpret_cast<DkvSmem<kQs>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kDkvBk;
  const int D = H * kHd;
  const size_t base = (size_t)b * S * D + (size_t)h * kHd;
  const size_t rbase = ((size_t)b * H + h) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma group row, column pair
  // warpgroup: keys k0 + 64 wg .. + 63; broadcast from lane 0 so that the
  // compiler sees it uniform over the warp
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int key0 = k0 + wg * 64 + (warp & 3) * 16 + g, key1 = key0 + 8;  // this thread's rows

  // dk and dv rows of this thread: keys >= valid_len get 0 (their p was
  // never masked: it reaches only their own rows)
  auto store = [&](const float (&dka)[kHd / 8][4], const float (&dva)[kHd / 8][4], float ks) {
#pragma unroll
    for (int d = 0; d < kHd / 8; ++d) {
      const int c = d * 8 + t4 * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = r ? key1 : key0;
        if (key >= S) continue;
        const bool ok = key < valid_len;
        const size_t at = base + (size_t)key * D + c;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
            ok ? dka[d][2 * r] * ks : 0.f, ok ? dka[d][2 * r + 1] * ks : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(ok ? dva[d][2 * r] : 0.f, ok ? dva[d][2 * r + 1] : 0.f);
      }
    }
  };
  float dka[kHd / 8][4], dva[kHd / 8][4];  // dk, dv rows key0 / key1, 8 column tiles of 8
#pragma unroll
  for (int d = 0; d < kHd / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  if (k0 >= valid_len) {  // every key of the block is masked
    store(dka, dva, 0.f);
    return;
  }

  // query rows >= valid_len add nothing: the walk stops at the last tile
  // holding a valid row, and inside it their lse reads as +inf (p = 0)
  const int n_qt = (valid_len + kDkvBq - 1) / kDkvBq;
  const unsigned live_warps = 4 * min(kDkvWgs, (valid_len - k0 + 63) / 64);
  // query tile t into its stage, by one whole warp: lane 0 has the copy
  // engine bring q and do (and q * scale) (the maps' row extent is
  // valid_len: rows past it land as zeros), each lane copies 2 of the
  // tile's 64 lse and delta values by cp.async (zero past valid_len) and
  // arrives on the stage's mbarrier once they have landed
  auto load = [&](int t) {
    const int st = t % kDkvStages, q0 = t * kDkvBq;
    if (lane == 0) {
      mbar_expect_tx(&sm.full[st], (kQs ? 3 : 2) * kDkvTileBytes);
      tma_load_3d(sm.q[st], &qmap, &sm.full[st], h * kHd, q0, b);
      tma_load_3d(sm.dout[st], &dmap, &sm.full[st], h * kHd, q0, b);
      if constexpr (kQs) tma_load_3d(sm.qs[st], &qsmap, &sm.full[st], h * kHd, q0, b);
    }
#pragma unroll
    for (int i = lane; i < kDkvBq; i += 32) {
      const bool in = q0 + i < valid_len;
      const size_t at = rbase + (in ? q0 + i : 0);
      cp_async4(sm.lse[st] + i, lse + at, in);
      cp_async4(sm.delta[st] + i, delta + at, in);
    }
    cp_async_mbar_arrive_noinc(&sm.full[st]);
  };
  if (warp == 0) {  // fill the ring while the k and v rows load
    if (lane == 0) {
      for (int st = 0; st < kDkvStages; ++st) {
        mbar_init(&sm.full[st], kDkvArrivals);
        sm.done[st] = 0;
      }
      fence_mbarrier_init();
    }
    __syncwarp();
    for (int t = 0; t < kDkvStages && t < n_qt; ++t) load(t);
  }
  // k (k * scale rounded to bf16 where that is not exact) and v rows as A
  // fragments, for the whole walk
  uint32_t kf[kHd / 16][4], vf[kHd / 16][4];
  load_rows_a<kQs>(kf, k, base, key0, S, D, t4, scale);
  load_rows_a<false>(vf, v, base, key0, S, D, t4, 1.f);
  __syncthreads();  // the mbarriers and the counters are in place
  // A warpgroup whose keys all lie at or past valid_len (the second of the
  // last key tile at S = 2305) has nothing to compute: it writes its zero
  // rows and leaves, and the stages' releases count the other warps alone.
  if (k0 + wg * 64 >= valid_len) {
    store(dka, dva, 0.f);
    return;
  }
  fence_operands(dka);  // the zeros are written before the first product's fence
  fence_operands(dva);

  // where the scale is exact in bf16 (kQs false) the products read k and q
  // unscaled: the exps' FMA takes the scale for s^T, dk's store for dk
  const float sl = (kQs ? 1.f : scale) * kLog2e;
  // s^T, then p^T, of two tiles in turn; dp^T (keys x queries)
  float sa[kDkvCols][4], sb[kDkvCols][4], dp[kDkvCols][4];
  uint32_t pa[kDkvCols / 2][4], da[kDkvCols / 2][4];  // p^T and ds^T in bf16, A fragments

  auto wait_tile = [&](int t) {
    mbar_wait(&sm.full[t % kDkvStages], (t / kDkvStages) & 1);
  };
  // This warp's products that read tile t have completed; the last of the
  // block's live warps to say so refills the stage with tile t + kDkvStages.
  // No block barrier: a warpgroup waits only for the tiles it reads.
  auto release = [&](int t) {
    unsigned last = 0;
    if (lane == 0)
      last = atomicAdd(&sm.done[t % kDkvStages], 1u) % live_warps == live_warps - 1;
    last = __shfl_sync(0xffffffffu, last, 0);
    if (last && t + kDkvStages < n_qt) load(t + kDkvStages);
    __syncwarp();
  };
  auto qdesc = [&](int t) { return sw128_desc(sm.q[t % kDkvStages]); };
  auto ddesc = [&](int t) { return sw128_desc(sm.dout[t % kDkvStages]); };
  auto qkdesc = [&](int t) {  // dk's B: q, or q * scale
    return sw128_desc(kQs ? sm.qs[t % kDkvStages] : sm.q[t % kDkvStages]);
  };
  // p^T = exp(s^T - lse) = 2^(s sl - lse log2(e)) in place in s (one FMA and
  // one ex2); lse of rows >= valid_len reads as +inf, a test that only the
  // last tile needs
  auto exps = [&](float (&s)[kDkvCols][4], int t) {
    const float* l = sm.lse[t % kDkvStages];
    const int q0 = t * kDkvBq;
    if (q0 + kDkvBq <= valid_len) {  // every row of the tile is valid
#pragma unroll
      for (int j = 0; j < kDkvCols; ++j) {
        const float2 lv = *reinterpret_cast<const float2*>(l + j * 8 + t4 * 2);
        const float le0 = lv.x * kLog2e, le1 = lv.y * kLog2e;
        s[j][0] = ex2(fmaf(s[j][0], sl, -le0));
        s[j][1] = ex2(fmaf(s[j][1], sl, -le1));
        s[j][2] = ex2(fmaf(s[j][2], sl, -le0));
        s[j][3] = ex2(fmaf(s[j][3], sl, -le1));
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < kDkvCols; ++j) {
      const int c = j * 8 + t4 * 2;
      const float2 lv = *reinterpret_cast<const float2*>(l + c);
      const float le0 = q0 + c < valid_len ? lv.x * kLog2e : INFINITY;
      const float le1 = q0 + c + 1 < valid_len ? lv.y * kLog2e : INFINITY;
      s[j][0] = ex2(fmaf(s[j][0], sl, -le0));
      s[j][1] = ex2(fmaf(s[j][1], sl, -le1));
      s[j][2] = ex2(fmaf(s[j][2], sl, -le0));
      s[j][3] = ex2(fmaf(s[j][3], sl, -le1));
    }
  };
  // p^T rounded to bf16, and ds^T = p^T (dp^T - delta) in fp32 rounded to
  // bf16: the C fragments of column tiles 2c, 2c+1 are the A fragment of
  // 16-query chunk c
  auto pack = [&](const float (&s)[kDkvCols][4], int t) {
    const float* dl = sm.delta[t % kDkvStages];
#pragma unroll
    for (int c = 0; c < kDkvCols / 2; ++c) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 2 * c + hh;
        const float2 d = *reinterpret_cast<const float2*>(dl + j * 8 + t4 * 2);
        pa[c][2 * hh] = pack_bf16(s[j][0], s[j][1]);
        pa[c][2 * hh + 1] = pack_bf16(s[j][2], s[j][3]);
        da[c][2 * hh] = pack_bf16(s[j][0] * (dp[j][0] - d.x), s[j][1] * (dp[j][1] - d.y));
        da[c][2 * hh + 1] = pack_bf16(s[j][2] * (dp[j][2] - d.x), s[j][3] * (dp[j][3] - d.y));
      }
    }
  };

  // Tile t's p^T sits in `cur` (its exps done) and its dp^T is done; tile
  // t - 1's dv and dk are done. A step issues s^T(t + 1) into `nxt`, packs
  // tile t's p^T and ds^T while it runs, issues tile t's dv and dk and then
  // dp^T(t + 1), and runs tile t + 1's exps once s^T(t + 1) is done, behind
  // those three. The two score buffers take turns, so that no product waits
  // for the pack and no step writes a buffer a product still reads.
  auto step = [&](float (&cur)[kDkvCols][4], float (&nxt)[kDkvCols][4], int t) {
    wait_tile(t + 1);
    wgmma_fence();
    issue_rows(nxt, kf, qdesc(t + 1));
    pack(cur, t);
    wgmma_fence();
    issue_cols(dva, pa, ddesc(t));
    issue_cols(dka, da, qkdesc(t));
    wgmma_commit();
    issue_rows(dp, vf, ddesc(t + 1));
    wgmma_wait_n<2>();  // s^T(t + 1), committed first
    fence_operands(nxt);
    exps(nxt, t + 1);
    wgmma_wait_n<1>();  // tile t's dv and dk: pa and da are free, the stage too
    fence_operands(dka);
    fence_operands(dva);
    fence_operands(pa);
    fence_operands(da);
    release(t);
    wgmma_wait_n<0>();  // dp^T(t + 1)
    fence_operands(dp);
  };
  // the last tile's dv and dk
  auto finish = [&](const float (&cur)[kDkvCols][4], int t) {
    pack(cur, t);
    wgmma_fence();
    issue_cols(dva, pa, ddesc(t));
    issue_cols(dka, da, qkdesc(t));
    wgmma_commit();
    wgmma_wait_n<0>();
    fence_operands(dka);
    fence_operands(dva);
    fence_operands(pa);
    fence_operands(da);
  };

  // The first s^T and dp^T are peeled off the loop and the last dv and dk
  // follow it, so that no product sits under a branch that differs
  // between the steps.
  wait_tile(0);
  wgmma_fence();
  issue_rows(sa, kf, qdesc(0));
  issue_rows(dp, vf, ddesc(0));
  wgmma_wait_n<1>();
  fence_operands(sa);
  exps(sa, 0);
  wgmma_wait_n<0>();
  fence_operands(dp);
  int t = 0;
  for (; t + 2 < n_qt; t += 2) {
    step(sa, sb, t);
    step(sb, sa, t + 1);
  }
  if (t + 1 < n_qt) {
    step(sa, sb, t);
    finish(sb, t + 1);
  } else {
    finish(sa, t);
  }
  store(dka, dva, kQs ? 1.f : scale);
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

// cuTensorMapEncodeTiled from the driver, through the runtime (so that the
// library needs no -lcuda); null if the driver does not have it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of 64-row tiles of a bf16 [B, S, D] tensor x (the dq kernel's
// K and V tiles, the dkv kernel's q, do and q * scale tiles): a 3-D view
// (column, row, sequence) whose row extent is valid_len, so that the copy
// engine zero-fills rows >= valid_len as it does past a tensor's end; a box
// is 64 columns (one head) x 64 rows x 1 sequence, landing as 128-byte rows
// with the 128-byte swizzle (sw_at, sw128_desc).
cudaError_t tile_map(CUtensorMap* map, const void* x, int B, int S, int D, int valid_len) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)valid_len, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};  // bytes
  const cuuint32_t box[3] = {kHd, 64, 1}, elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the bf16 dq kernel's shared memory limit, set before its first launch
cudaError_t dq_bf16_smem() {
  static bool smem_set[kMaxDevices];
  return set_smem_once(pk_dq_bf16, kDqSmemBytes, smem_set);
}

// the fused bf16 kernel's shared memory limit, set before its first launch
cudaError_t bwd_bf16_smem() {
  static bool smem_set[kMaxDevices];
  return set_smem_once(pk_bwd_bf16, kSmemBytes, smem_set);
}

// the bf16 dkv kernel's shared memory limit, set before its first launch
template <bool kQs>
cudaError_t dkv_bf16_smem() {
  static bool smem_set[kMaxDevices];
  return set_smem_once(pk_dkv_bf16<kQs>, dkv_smem_bytes<kQs>(), smem_set);
}

// the fused bf16 kernel (dq added into the fp32 dq_acc)
void launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
                     int B, int S, int H, int valid_len, float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const dim3 grid((S + kBk - 1) / kBk, H, B);
  pk_bwd_bf16<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc), static_cast<bf*>(dk),
      static_cast<bf*>(dv), S, H, valid_len, scale);
}

// the bf16 dkv kernel, q * scale tiles from qsmap (kQs) or the scale folded
template <bool kQs>
void launch_dkv_bf16(const void* k, const void* v, const void* lse, const void* delta, void* dk,
                     void* dv, int B, int S, int H, int valid_len, float scale,
                     const CUtensorMap& qmap, const CUtensorMap& dmap, const CUtensorMap& qsmap,
                     cudaStream_t st) {
  using bf = __nv_bfloat16;
  const dim3 grid((S + kDkvBk - 1) / kDkvBk, H, B);
  pk_dkv_bf16<kQs><<<grid, kDkvThreads, dkv_smem_bytes<kQs>(), st>>>(
      static_cast<const bf*>(k), static_cast<const bf*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf*>(dk), static_cast<bf*>(dv), S, H,
      valid_len, scale, qmap, dmap, qsmap);
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
    const cudaError_t err = bwd_bf16_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  launch_delta(dout, o, delta, B, S, H, dtype, st);
  if (dtype == 1) {
    launch_bwd_bf16(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, valid_len, scale, st);
  } else {
    launch_dkdv_f32(q, k, v, dout, lse, delta, dk, dv, B, S, H, valid_len, scale, st);
    launch_dq_f32(q, k, v, dout, lse, delta, dq, B, S, H, valid_len, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Mode "both", first half: delta (written for owlvit_pk_dkv) and dq in the
// input dtype, by query tile. bf16: one kernel computes both; its K tiles
// are k * scale rounded to bf16 once (the TPU kernel's rounding point).
// Where scale is a power of two <= 1 that rounding is exact, so ks may be
// null: the kernel then reads k itself and applies the scale to its fp32
// scores and dq, which gives the same bits. Else ks is [B, S, D] bf16
// scratch, filled with k * scale by a launch before it. fp32 takes no ks.
extern "C" int owlvit_pk_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* delta, void* dq, void* ks,
                            int B, int S, int H, int hd, int valid_len, float scale, int dtype,
                            void* stream) {
  int exp2 = 0;
  const bool exact = scale > 0.f && scale <= 1.f && frexpf(scale, &exp2) == 0.5f;
  if (!valid_shape(B, S, H, hd, valid_len) || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && ks == nullptr && !exact))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    cudaError_t err = dq_bf16_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
    CUtensorMap kmap, vmap;  // K tiles from ks (or k), V tiles from v
    const int D = H * kHd;
    if ((err = tile_map(&kmap, ks ? ks : k, B, S, D, valid_len)) != cudaSuccess ||
        (err = tile_map(&vmap, v, B, S, D, valid_len)) != cudaSuccess)
      return static_cast<int>(err);
    using bf = __nv_bfloat16;
    if (ks) {
      const long long n8 = (long long)B * S * D / 8;
      scaled_bf16<<<static_cast<int>((n8 + 255) / 256), 256, 0, st>>>(
          static_cast<const bf*>(k), static_cast<bf*>(ks), n8, scale);
    }
    const dim3 grid((S + kDqBq - 1) / kDqBq, H, B);
    pk_dq_bf16<<<grid, kDqThreads, kDqSmemBytes, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(dout), static_cast<const bf*>(o),
        static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf*>(dq), S, H,
        valid_len, ks ? 1.f : scale, kmap, vmap);
  } else {
    launch_delta(dout, o, delta, B, S, H, dtype, st);
    launch_dq_f32(q, k, v, dout, lse, delta, dq, B, S, H, valid_len, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 dq kernel's dynamic shared memory in bytes. Launches nothing.
extern "C" int owlvit_pk_dq_smem_bytes() { return kDqSmemBytes; }

// Mode "both", second half: dk and dv in the input dtype, by key tile, from
// the delta owlvit_pk_dq wrote on the same stream. bf16: q * scale is
// rounded to bf16 (the TPU kernel's rounding point); where scale is a power
// of two <= 1 that rounding is exact, so qs may be null and the kernel
// applies the scale to its fp32 scores and dk, which gives the same bits.
// Else qs is [B, S, D] bf16 scratch, filled with q * scale by a launch
// before it. fp32 takes no qs.
extern "C" int owlvit_pk_dkv(const void* q, const void* k, const void* v, const void* lse,
                             const void* dout, const void* delta, void* dk, void* dv, void* qs,
                             int B, int S, int H, int hd, int valid_len, float scale, int dtype,
                             void* stream) {
  int exp2 = 0;
  const bool exact = scale > 0.f && scale <= 1.f && frexpf(scale, &exp2) == 0.5f;
  if (!valid_shape(B, S, H, hd, valid_len) || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && qs == nullptr && !exact))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    cudaError_t err = qs ? dkv_bf16_smem<true>() : dkv_bf16_smem<false>();
    if (err != cudaSuccess) return static_cast<int>(err);
    CUtensorMap qmap, dmap, qsmap;  // q, do and q * scale tiles (qsmap: a copy of qmap if unused)
    const int D = H * kHd;
    if ((err = tile_map(&qmap, q, B, S, D, valid_len)) != cudaSuccess ||
        (err = tile_map(&dmap, dout, B, S, D, valid_len)) != cudaSuccess ||
        (err = tile_map(&qsmap, qs ? qs : q, B, S, D, valid_len)) != cudaSuccess)
      return static_cast<int>(err);
    if (qs) {
      const long long n8 = (long long)B * S * D / 8;
      scaled_bf16<<<static_cast<int>((n8 + 255) / 256), 256, 0, st>>>(
          static_cast<const bf*>(q), static_cast<bf*>(qs), n8, scale);
      launch_dkv_bf16<true>(k, v, lse, delta, dk, dv, B, S, H, valid_len, scale, qmap, dmap,
                            qsmap, st);
    } else {
      launch_dkv_bf16<false>(k, v, lse, delta, dk, dv, B, S, H, valid_len, scale, qmap, dmap,
                             qsmap, st);
    }
  } else {
    launch_dkdv_f32(q, k, v, dout, lse, delta, dk, dv, B, S, H, valid_len, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 dkv kernel's dynamic shared memory in bytes, without (qs = 0) or
// with (qs = 1) its q * scale tiles. Launches nothing.
extern "C" int owlvit_pk_dkv_smem_bytes(int qs) {
  return qs ? dkv_smem_bytes<true>() : dkv_smem_bytes<false>();
}
