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
// flops per byte, so the bound is the tensor cores, plus the S^2 exps.
//
// Design. The TPU kernel holds a whole K/V row in VMEM and carries fp32 dk/dv
// scratch across a sequential query-block grid dimension. Hopper blocks run in
// parallel with nothing carried between them, so here one block owns (batch,
// head, 64-key tile): its K and V tiles stay in shared memory, dk and dv stay
// in fp32 registers, and a loop inside the block walks the 64-row query
// tiles. Each turn computes s^T = (k*scale) . q^T and dp^T = v . do^T with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), then p and ds, and re-packs
// their accumulators in registers as the A operand of the dv and dk products.
// dq needs a sum over all key tiles, that is over blocks: ds^T goes through
// shared memory, the block's [64, 64] dq partial is added with fp32 atomics
// into the zeroed buffer, and the wrapper casts it. Atomics make dq differ
// from run to run in its last fp32 bits. delta comes from a first small
// kernel. Ragged tiles (S = 2305 = 36*64 + 1, valid_len < S) are masked in
// the kernel, so nothing is padded. fp32 inputs take two FMA kernels, one by
// key tile (dk, dv) and one by query tile (dq), with no atomics.
// Given up for now: wgmma, TMA, a pipelined K/V ring, ldmatrix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;   // head dim: B/32, B/16 and L/14 all use 64
constexpr int kBk = 64;   // bf16: keys per block
constexpr int kBq = 64;   // bf16: query rows per turn of the inner loop
constexpr int kThreads = 128;
constexpr int kRow = kHd + 8;  // shared row stride (bf16): fragment reads hit 32 banks

constexpr int kRowsF = 64;   // fp32: keys (or queries) per block, two threads each
constexpr int kTileF = 32;   // fp32: queries (or keys) per shared-memory tile
constexpr int kHalf = kHd / 2;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16(x * scale) for two values, as the TPU kernel scales its q tile
__device__ __forceinline__ uint32_t pack_scaled(__nv_bfloat16 lo, __nv_bfloat16 hi,
                                                float scale) {
  return pack_bf16(__bfloat162float(lo) * scale, __bfloat162float(hi) * scale);
}

// c[16x8] += a[16x16] . b[16x8], bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 64 rows x 64 bf16 of one head, rows >= S zero-filled, into shared memory.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* sm,
                                               const __nv_bfloat16* g, int row0,
                                               int S, int D) {
  for (int i = threadIdx.x; i < 64 * (kHd / 8); i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(sm + r * kRow + c) = val;
  }
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

__global__ void __launch_bounds__(kThreads)
    pk_bwd_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int S, int H, int valid_len,
                float scale) {
  __shared__ __align__(16) __nv_bfloat16 sk[kBk * kRow];   // k * scale
  __shared__ __align__(16) __nv_bfloat16 sv[kBk * kRow];
  __shared__ __align__(16) __nv_bfloat16 sq[kBq * kRow];   // q, unscaled
  __shared__ __align__(16) __nv_bfloat16 sdo[kBq * kRow];
  __shared__ __align__(16) __nv_bfloat16 sds[kBk * kRow];  // ds^T [key][query]
  __shared__ float slse[kBq], sdelta[kBq];

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kBk;
  const int D = H * kHd;
  const size_t base = (size_t)b * S * D + (size_t)h * kHd;
  const size_t rbase = ((size_t)b * H + h) * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma group row, column pair
  const int r0 = warp * 16 + g;            // this thread's key rows: r0, r0 + 8

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

  for (int i = threadIdx.x; i < kBk * (kHd / 8); i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
    if (k0 + r < S) {
      kx = *reinterpret_cast<const uint4*>(k + base + (size_t)(k0 + r) * D + c);
      vx = *reinterpret_cast<const uint4*>(v + base + (size_t)(k0 + r) * D + c);
    }
    __nv_bfloat16* ke = reinterpret_cast<__nv_bfloat16*>(&kx);
#pragma unroll
    for (int e = 0; e < 8; ++e)  // the scale in the input dtype, as the TPU kernel
      ke[e] = __float2bfloat16_rn(__bfloat162float(ke[e]) * scale);
    *reinterpret_cast<uint4*>(sk + r * kRow + c) = kx;
    *reinterpret_cast<uint4*>(sv + r * kRow + c) = vx;
  }
  __syncthreads();

  uint32_t ka[kHd / 16][4], va[kHd / 16][4];  // A fragments of this warp's 16 keys
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    ka[kk][0] = ld32(sk + r0 * kRow + c);
    ka[kk][1] = ld32(sk + (r0 + 8) * kRow + c);
    ka[kk][2] = ld32(sk + r0 * kRow + c + 8);
    ka[kk][3] = ld32(sk + (r0 + 8) * kRow + c + 8);
    va[kk][0] = ld32(sv + r0 * kRow + c);
    va[kk][1] = ld32(sv + (r0 + 8) * kRow + c);
    va[kk][2] = ld32(sv + r0 * kRow + c + 8);
    va[kk][3] = ld32(sv + (r0 + 8) * kRow + c + 8);
  }

  float dk_acc[kHd / 8][4], dv_acc[kHd / 8][4];  // rows r0 / r0+8, 8 column tiles
#pragma unroll
  for (int d = 0; d < kHd / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;
  const bool key0_ok = k0 + r0 < valid_len, key1_ok = k0 + r0 + 8 < valid_len;
  const int qr0 = warp * 16 + g;  // dq phase: this thread's query rows qr0, qr0 + 8

  const int n_qt = (valid_len + kBq - 1) / kBq;  // query rows >= valid_len add nothing
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBq;
    __syncthreads();  // every warp is done with the previous turn's tiles
    load_tile_bf16(sq, q + base, q0, S, D);
    load_tile_bf16(sdo, dout + base, q0, S, D);
    if (threadIdx.x < kBq) {
      const int qi = q0 + threadIdx.x;
      slse[threadIdx.x] = qi < valid_len ? lse[rbase + qi] : 0.f;
      sdelta[threadIdx.x] = qi < valid_len ? delta[rbase + qi] : 0.f;
    }
    __syncthreads();

    // s^T (rows: keys r0, r0+8; columns: queries) and dp^T = v . do^T
    float s[kBq / 8][4], dp[kBq / 8][4];
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        const int at = (j * 8 + g) * kRow + kk * 16 + t4 * 2;
        uint32_t bq[2] = {ld32(sq + at), ld32(sq + at + 8)};
        uint32_t bd[2] = {ld32(sdo + at), ld32(sdo + at + 8)};
        mma_16816(s[j], ka[kk], bq);
        mma_16816(dp[j], va[kk], bd);
      }
    }
    // p = exp(s - lse) on valid (key, query) pairs, else 0; ds = p (dp - delta)
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + t4 * 2 + e;
        const bool q_ok = q0 + qc < valid_len;
        const float l = slse[qc], dl = sdelta[qc];
        const float p0 = (q_ok && key0_ok) ? __expf(s[j][e] - l) : 0.f;
        const float p1 = (q_ok && key1_ok) ? __expf(s[j][e + 2] - l) : 0.f;
        s[j][e] = p0;
        s[j][e + 2] = p1;
        dp[j][e] = p0 * (dp[j][e] - dl);
        dp[j][e + 2] = p1 * (dp[j][e + 2] - dl);
      }

    // dv += p^T (bf16) . do and dk += ds^T (bf16) . (q*scale): the C
    // fragments of query tiles 2kk, 2kk+1 are the A fragment of chunk kk
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      const __nv_bfloat16* dop = sdo + (kk * 16 + t4 * 2) * kRow + g;
      const __nv_bfloat16* qp = sq + (kk * 16 + t4 * 2) * kRow + g;
#pragma unroll
      for (int d = 0; d < kHd / 8; ++d) {
        uint32_t bd[2], bq[2];
        bd[0] = pack_raw(dop[d * 8], dop[kRow + d * 8]);
        bd[1] = pack_raw(dop[8 * kRow + d * 8], dop[9 * kRow + d * 8]);
        bq[0] = pack_scaled(qp[d * 8], qp[kRow + d * 8], scale);
        bq[1] = pack_scaled(qp[8 * kRow + d * 8], qp[9 * kRow + d * 8], scale);
        mma_16816(dv_acc[d], pa, bd);
        mma_16816(dk_acc[d], da, bq);
      }
    }

    // ds^T (rounded to bf16) to shared memory for the dq product
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
      const int c = j * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(sds + r0 * kRow + c) = pack_bf16(dp[j][0], dp[j][1]);
      *reinterpret_cast<uint32_t*>(sds + (r0 + 8) * kRow + c) =
          pack_bf16(dp[j][2], dp[j][3]);
    }
    __syncthreads();

    // dq[query, :] += ds[query, keys] . (k*scale)[keys, :]; warp w owns
    // queries 16w .. 16w+15 of the tile
    float dq[kHd / 8][4];
#pragma unroll
    for (int d = 0; d < kHd / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const __nv_bfloat16* dsp = sds + (kk * 16 + t4 * 2) * kRow + qr0;
      uint32_t a[4];
      a[0] = pack_raw(dsp[0], dsp[kRow]);
      a[1] = pack_raw(dsp[8], dsp[kRow + 8]);
      a[2] = pack_raw(dsp[8 * kRow], dsp[9 * kRow]);
      a[3] = pack_raw(dsp[8 * kRow + 8], dsp[9 * kRow + 8]);
      const __nv_bfloat16* kp = sk + (kk * 16 + t4 * 2) * kRow + g;
#pragma unroll
      for (int d = 0; d < kHd / 8; ++d) {
        uint32_t bk[2];
        bk[0] = pack_raw(kp[d * 8], kp[kRow + d * 8]);
        bk[1] = pack_raw(kp[8 * kRow + d * 8], kp[9 * kRow + d * 8]);
        mma_16816(dq[d], a, bk);
      }
    }
    const int row0 = q0 + qr0, row1 = row0 + 8;
#pragma unroll
    for (int d = 0; d < kHd / 8; ++d) {
      const int c = d * 8 + t4 * 2;
      if (row0 < valid_len) {
        float* at = dq_acc + base + (size_t)row0 * D + c;
        atomicAdd(at, dq[d][0]);
        atomicAdd(at + 1, dq[d][1]);
      }
      if (row1 < valid_len) {
        float* at = dq_acc + base + (size_t)row1 * D + c;
        atomicAdd(at, dq[d][2]);
        atomicAdd(at + 1, dq[d][3]);
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
// [B, H, S] scratch. dq is fp32 [B, S, D]: bf16 adds into it with atomics, so
// it must be zeroed; fp32 writes it. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
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
    using bf = __nv_bfloat16;
    pk_bwd_delta<bf><<<dblocks, 256, 0, st>>>(
        static_cast<const bf*>(dout), static_cast<const bf*>(o),
        static_cast<float*>(delta), S, H, rows);
    const dim3 grid((S + kBk - 1) / kBk, H, B);
    pk_bwd_bf16<<<grid, kThreads, 0, st>>>(
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
