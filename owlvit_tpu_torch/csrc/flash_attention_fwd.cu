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
// Two softmax modes: the per-row running max (online softmax), or a fixed
// shift C (exp(s - C), lse = C + log l, no max and no rescale).
//
// What bounds it: at S ~ 2305, hd = 64 (B/16) each block reads its 64x64 q
// tile once and streams K/V tiles that stay in L2, so by arithmetic intensity
// it is compute-bound on the two products (4*S*S*hd flops per head) and the
// S*S exps, not bound by HBM. It runs far below the tensor cores' peak; which
// unit inside the SM limits it (loads not overlapped with math, exp issue)
// has not been measured.
//
// Design. The TPU kernel holds a whole K/V row in VMEM and does one
// full-row softmax; here one block owns (batch, head, 64-row query tile) and
// loops over 64-key K/V tiles staged through shared memory, so nothing scales
// with S except the loop count, and ragged tails (S not a multiple of 64, or
// valid_len < S) are masked in the kernel: no padding is needed.
//   bf16: 4 warps, each owns 16 query rows; q.k^T and p.v run on the tensor
//         cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate). The
//         score accumulators are re-packed in registers as the A operand of
//         p.v, so p never touches shared memory.
//   fp32: one thread per query row with plain FMA (no fp32 tensor-core
//         product keeps full fp32 precision); K/V rows are read as
//         shared-memory broadcasts.
// Given up for now: TMA and wgmma, a multi-stage cp.async pipeline (loads and
// math do not overlap inside a block), ldmatrix, and a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;   // head dim: B/32, B/16 and L/14 all use 64
constexpr int kBq = 64;   // bf16: query rows per block
constexpr int kBk = 64;   // bf16: keys per K/V tile
constexpr int kThreads = 128;
constexpr int kRow = kHd + 8;  // shared row stride (bf16): fragment reads hit 32 banks

constexpr int kBqF = 128;  // fp32: query rows per block (one per thread)
constexpr int kBkF = 32;   // fp32: keys per K/V tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
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
  for (int i = threadIdx.x; i < kBk * (kHd / 8); i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(sm + r * kRow + c) = val;
  }
}

__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* sq, int r, int c,
                                           float scale) {
  // scale in the input dtype, as the TPU kernel does on its q tile
  return pack_bf16(__bfloat162float(sq[r * kRow + c]) * scale,
                   __bfloat162float(sq[r * kRow + c + 1]) * scale);
}

template <bool kStatic>
__global__ void __launch_bounds__(kThreads)
    pk_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
                int H, int valid_len, float scale, float static_max) {
  __shared__ __align__(16) __nv_bfloat16 sq[kBq * kRow];
  __shared__ __align__(16) __nv_bfloat16 sk[kBk * kRow];
  __shared__ __align__(16) __nv_bfloat16 sv[kBk * kRow];

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBq;
  const int D = H * kHd;
  const size_t base = (size_t)b * S * D + (size_t)h * kHd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma group row, column pair
  const int r0 = warp * 16 + g;            // this thread's rows: r0, r0 + 8

  load_tile_bf16(sq, q + base, q0, S, D);
  __syncthreads();
  uint32_t qa[kHd / 16][4];  // A fragments of the scaled q rows
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qa[kk][0] = q_pair(sq, r0, c, scale);
    qa[kk][1] = q_pair(sq, r0 + 8, c, scale);
    qa[kk][2] = q_pair(sq, r0, c + 8, scale);
    qa[kk][3] = q_pair(sq, r0 + 8, c + 8, scale);
  }

  float acc[kHd / 8][4];  // o rows r0 / r0+8, 8 column tiles of 8
#pragma unroll
  for (int d = 0; d < kHd / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (dynamic mode)
  float l0 = 0.f, l1 = 0.f;              // partial row sums of this thread

  const int n_tiles = (valid_len + kBk - 1) / kBk;  // tiles past valid_len are all masked
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16(sk, k + base, kt * kBk, S, D);
    load_tile_bf16(sv, v + base, kt * kBk, S, D);
    __syncthreads();

    float s[kBk / 8][4];  // scores: key tiles of 8, rows r0 (0,1) and r0+8 (2,3)
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        const __nv_bfloat16* kp = sk + (j * 8 + g) * kRow + kk * 16 + t4 * 2;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(kp);
        bf[1] = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_16816(s[j], qa[kk], bf);
      }
    }
    if ((kt + 1) * kBk > valid_len) {
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (kt * kBk + j * 8 + t4 * 2 + e >= valid_len)
            s[j][e] = s[j][e + 2] = -INFINITY;
    }

    float shift0, shift1;
    if (kStatic) {
      shift0 = shift1 = static_max;
    } else {
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      // the four threads of a group hold the same two rows
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // key 0 is valid (valid_len >= 1), so mx is finite from the first tile
      const float a0 = __expf(m0 - mx0), a1 = __expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int d = 0; d < kHd / 8; ++d) {
        acc[d][0] *= a0;
        acc[d][1] *= a0;
        acc[d][2] *= a1;
        acc[d][3] *= a1;
      }
      shift0 = mx0;
      shift1 = mx1;
    }
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      s[j][0] = __expf(s[j][0] - shift0);  // masked: exp(-inf) == 0
      s[j][1] = __expf(s[j][1] - shift0);
      s[j][2] = __expf(s[j][2] - shift1);
      s[j][3] = __expf(s[j][3] - shift1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // p (rounded to bf16) . v: the score C fragments of key tiles 2kk, 2kk+1
    // are exactly the A fragment of a 16-key chunk
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp = sv + (kk * 16 + t4 * 2) * kRow + g;
#pragma unroll
      for (int d = 0; d < kHd / 8; ++d) {
        uint32_t bf[2];
        bf[0] = pack_raw(vp[d * 8], vp[kRow + d * 8]);
        bf[1] = pack_raw(vp[8 * kRow + d * 8], vp[9 * kRow + d * 8]);
        mma_16816(acc[d], pa, bf);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row0 = q0 + r0, row1 = row0 + 8;
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
    if (row0 < S) lrow[row0] = (kStatic ? static_max : m0) + logf(l0);
    if (row1 < S) lrow[row1] = (kStatic ? static_max : m1) + logf(l1);
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

// C entry point, bound with ctypes. dtype: 0 = fp32, 1 = bf16. Launches on
// `stream` and returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int owlvit_pk_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int S, int H, int hd,
                             int valid_len, float scale, int use_static,
                             float static_max, int dtype, void* stream) {
  if (hd != kHd || B < 1 || S < 1 || H < 1 || valid_len < 1 || valid_len > S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((S + kBq - 1) / kBq, H, B);
    auto kern = use_static ? pk_fwd_bf16<true> : pk_fwd_bf16<false>;
    kern<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), S, H, valid_len, scale, static_max);
  } else if (dtype == 0) {
    const dim3 grid((S + kBqF - 1) / kBqF, H, B);
    auto kern = use_static ? pk_fwd_f32<true> : pk_fwd_f32<false>;
    kern<<<grid, kBqF, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), S, H, valid_len, scale, static_max);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
