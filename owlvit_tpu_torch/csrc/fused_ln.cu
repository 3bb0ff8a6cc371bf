// Fused residual add + LayerNorm for Hopper (sm_90a), forward and backward.
//
// Replaces owlvit_tpu/ops/fused_ln.py::_fwd_kernel and ::_bwd_kernel (the
// Pallas TPU kernels behind add_ln). Same contract, over rows of [N, D]:
//   forward   r = x + h, rounded to the input dtype and stored;
//             y = (r - mean) * rsqrt(var + eps) * scale + bias, with fp32
//             statistics taken from the rounded r, the variance two-pass
//             (the mean of the squared deviations), y cast to the input dtype
//   backward  from r (the statistics recomputed), dy and dr:
//             dyh = dy * scale, m1 = mean(dyh), m2 = mean(dyh * xhat),
//             g = dr + rstd * (dyh - m1 - xhat * m2) in the input dtype;
//             dscale = sum over rows of dy * xhat, dbias = sum of dy, fp32
// scale and bias are fp32 (the models' master parameters).
//
// What bounds it: bytes. Each row is read and written once with a handful of
// flops per element: the forward moves x, h in and r, y out, the backward r,
// dy, dr in and g out. At [32*2305, 768] bf16 that is 453 MB each way, 0.135
// ms at 3.35 TB/s. To reach that rate the card needs ~18 KB in flight per SM
// at all times (3.35 TB/s x ~0.7 us of latency over 132 SMs).
//
// Forward. One warp owns a row: its lanes read x and h with 16-byte loads (8
// bf16 or 4 fp32 per lane per load, neighbouring lanes on neighbouring
// addresses), hold r in registers, and reduce the row's sums with butterfly
// shuffles, so r, the statistics and xhat never go back to memory between
// passes; a grid of ceil(N / 8) blocks keeps enough rows in flight. Ragged N
// needs no padding: a warp past the last row does nothing.
//
// Backward. The TPU kernel takes 256-row blocks in a sequential grid and
// writes one (8, D) partial of dscale and dbias per block that XLA sums
// outside. Here a warp also owns a row, but the backward cannot be left to
// occupancy as the forward is: it reads r, waits on two reductions for the
// statistics, then reads dy, waits on two more, then reads dr, and with one
// row's values in registers per pass the first design (157-164 registers, one
// 8-warp block per SM) had a third of a row's bytes in flight per warp.
// So each warp keeps its next rows in flight in a ring in shared memory: a
// stage holds one row of r, of dy and of dr, which one lane asks for with
// three bulk copies (cp.async.bulk, no tensor map) completing on the stage's
// mbarrier; the lanes wait on it and read the row from shared memory, and
// when the row is done the lane orders the warp's reads before the async
// proxy (fence.proxy.async) and refills the stage with the row kStages
// ahead. Bytes in flight are then set by the ring's depth, not by
// occupancy. The kernel is a template on the 16-byte vectors per lane (D /
// 256 in bf16, D / 128 in fp32), dispatched from D on the host, so every
// array has the size of the D in hand; scale and this lane's columns of
// dscale and dbias live in registers for the whole kernel. ptxas keeps a
// lane's values of the row in registers from pass to pass (it merges the
// passes' shared-memory reads), so the ring's shape follows the registers:
// bf16 D = 768 takes 128 registers, two 8-warp blocks per SM and 3 stages
// (16 warps x 2 rows ahead x 4.5 KB); bf16 D = 1024 would spill at that
// cap and takes one block per SM with 4 stages (219 registers; forcing a
// re-read per pass with ld.volatile kept two blocks but measured slower).
// On an H100 at [32*2305, 768] bf16: 0.178 ms, 76% of the bound (the first
// design, one row per warp in registers: 0.339 ms).
//   Deterministic sums: a fixed grid (as many blocks as fit on the card at
// once, asked once per device, dtype and D; fewer for small N), each warp
// walking a fixed sequence of rows with a stride of the grid's warps; the
// warps of a block then add their columns in shared memory in warp order,
// each block writes one fp32 partial row, and a second small kernel sums the
// partial rows in block order. No atomics: two launches give the same bits.
// D must be a multiple of 32 lanes times one 16-byte load (256 in bf16, 128
// in fp32) and at most 1024: 768 (B/32, B/16) and 1024 (L/14) are the
// models'; the wrapper raises on any other D.
// Given up: a tensor-map (TMA) copy (rows are contiguous, so the plain bulk
// copy does), a warp that only copies (each warp feeds its own ring), g
// staged through shared memory for a bulk store (16-byte stores from
// registers), L2 evict-first hints with streaming stores of g (3% slower at
// D = 768), a wider partials' reduce (no gain), more than one row per warp
// at small D, and a persistent forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;  // rows in flight per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 1024;

// 16 bytes of T as floats: load, store, and rounding to T
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float v[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static float round(float x) { return x; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float v[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float v[8]) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  // the fp32 sum of two bf16 values rounded once to bf16 is the correctly
  // rounded bf16 sum (24 bits >= 2 * 8 + 2), so r matches a bf16 add
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// every lane gets the same total (a + b == b + a at each butterfly stage)
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kN = 4 or 8 floats of an fp32 parameter vector, 16-byte aligned
template <int kN>
__device__ __forceinline__ void load_f32x(const float* p, float v[kN]) {
#pragma unroll
  for (int i = 0; i < kN; i += 4) Pack<float>::load(p + i, v + i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ r,
                      T* __restrict__ y, int N, int D, float eps) {
  using P = Pack<T>;
  constexpr int E = P::kN;
  constexpr int kMaxV = kMaxD / (32 * E);  // 16-byte loads per lane, at most
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= N) return;
  const int nv = D / (32 * E);
  const size_t base = (size_t)row * D;

  float v[kMaxV][E];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxV; ++i) {
    if (i < nv) {
      const int c = (i * 32 + lane) * E;
      float a[E], b[E];
      P::load(x + base + c, a);
      P::load(h + base + c, b);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[i][e] = P::round(a[e] + b[e]);
        sum += v[i][e];
      }
      P::store(r + base + c, v[i]);
    }
  }
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxV; ++i) {
    if (i < nv) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[i][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
#pragma unroll
  for (int i = 0; i < kMaxV; ++i) {
    if (i < nv) {
      const int c = (i * 32 + lane) * E;
      float sc[E], bi[E], out[E];
      load_f32x<E>(scale + c, sc);
      load_f32x<E>(bias + c, bi);
#pragma unroll
      for (int e = 0; e < E; ++e) out[e] = (v[i][e] - mean) * rstd * sc[e] + bi[e];
      P::store(y + base + c, out);
    }
  }
}

// The backward's shared-memory ring: one per warp, kStages rows deep, each
// stage one row of r, of dy and of dr (D values each, contiguous), filled by
// bulk copies that complete on the stage's mbarrier.
template <typename T, int NV>
struct BwdRing {
  static constexpr int kRowBytes = NV * 32 * 16;     // D * sizeof(T)
  static constexpr int kStageBytes = 3 * kRowBytes;  // r, dy, dr
  // Two blocks per SM where a lane's values fit their 128 registers: ptxas
  // keeps the row (NV x 8 bf16 or NV x 4 fp32 values a lane, read in each
  // pass) in registers beside scale, dscale and dbias, and at 32 values a
  // lane (bf16 D = 1024) it spilled; forcing re-reads from shared memory
  // (ld.volatile) measured slower there than one block with a deeper ring.
  static constexpr bool kTwo = NV * 16 / static_cast<int>(sizeof(T)) <= 24;
  // as many stages (2 to 4) as fit the block's share of an SM's 228 KB
  static constexpr int kFit = (kTwo ? 110 : 200) * 1024 / (kWarps * kStageBytes);
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  static constexpr int kBarBytes = kWarps * kStages * 8;
  static constexpr int kSmemBytes = kBarBytes + kWarps * kStages * kStageBytes;
  static constexpr int kMinBlocks = kTwo && kSmemBytes <= 110 * 1024 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global -> shared
// by the bulk-copy engine, completing on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, (BwdRing<T, NV>::kMinBlocks))
    add_ln_bwd_kernel(const T* __restrict__ r, const T* __restrict__ dy,
                      const T* __restrict__ dr, const float* __restrict__ scale,
                      T* __restrict__ g, float* __restrict__ part_scale,
                      float* __restrict__ part_bias, int N, float eps) {
  using P = Pack<T>;
  using Ring = BwdRing<T, NV>;
  constexpr int E = P::kN;
  constexpr int D = NV * 32 * E;
  constexpr int kS = Ring::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp * kS;
  unsigned char* ring = smem + Ring::kBarBytes + warp * kS * Ring::kStageBytes;

  // this warp's rows, in order: first, first + stride, ...
  const long long first = (long long)blockIdx.x * kWarps + warp;
  const long long stride = (long long)gridDim.x * kWarps;
  const int n_rows = first < N ? static_cast<int>((N - 1 - first) / stride) + 1 : 0;

  // lane 0 puts row j of this warp (r, dy, dr) in flight into stage j % kS
  auto fetch = [&](int j) {
    const size_t at = (size_t)(first + j * stride) * D;
    unsigned char* st = ring + (j % kS) * Ring::kStageBytes;
    const uint32_t b = smem_u32(bar + j % kS);
    mbar_expect_tx(b, Ring::kStageBytes);
    bulk_g2s(st, r + at, Ring::kRowBytes, b);
    bulk_g2s(st + Ring::kRowBytes, dy + at, Ring::kRowBytes, b);
    bulk_g2s(st + 2 * Ring::kRowBytes, dr + at, Ring::kRowBytes, b);
  };
  if (lane == 0) {
    for (int s = 0; s < kS; ++s) mbar_init(smem_u32(bar + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < kS && j < n_rows; ++j) fetch(j);
  }
  __syncwarp();

  // this lane's columns (i * 32 + lane) * E + e: scale, and dscale and dbias
  float sc[NV][E], acc_s[NV][E], acc_b[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    load_f32x<E>(scale + (i * 32 + lane) * E, sc[i]);
#pragma unroll
    for (int e = 0; e < E; ++e) acc_s[i][e] = acc_b[i][e] = 0.f;
  }

  for (int j = 0; j < n_rows; ++j) {
    mbar_wait(smem_u32(bar + j % kS), (j / kS) & 1);
    const T* rs = reinterpret_cast<const T*>(ring + (j % kS) * Ring::kStageBytes);
    const T* dys = rs + D;
    const T* drs = rs + 2 * D;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v[E];
      P::load(rs + (i * 32 + lane) * E, v);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[e];
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v[E];
      P::load(rs + (i * 32 + lane) * E, v);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[e] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v[E], dv[E];
      P::load(rs + (i * 32 + lane) * E, v);
      P::load(dys + (i * 32 + lane) * E, dv);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (v[e] - mean) * rstd;
        const float dyh = dv[e] * sc[i][e];
        s1 += dyh;
        s2 += dyh * xh;
        acc_s[i][e] += dv[e] * xh;
        acc_b[i][e] += dv[e];
      }
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    const size_t at = (size_t)(first + j * stride) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * E;
      float v[E], dv[E], d[E], out[E];
      P::load(rs + c, v);
      P::load(dys + c, dv);
      P::load(drs + c, d);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (v[e] - mean) * rstd;
        out[e] = d[e] + rstd * (dv[e] * sc[i][e] - m1 - xh * m2);
      }
      P::store(g + at + c, out);
    }
    // the stage is read: order the lanes' reads before the copy that refills it
    __syncwarp();
    if (lane == 0 && j + kS < n_rows) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(j + kS);
    }
  }

  // the block's partial: warps add in warp order (deterministic), in the
  // rings' memory once every warp is done with its own
  float* s_scale = reinterpret_cast<float*>(smem + Ring::kBarBytes);
  float* s_bias = s_scale + D;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = (i * 32 + lane) * E + e;
          s_scale[c] = (w == 0 ? 0.f : s_scale[c]) + acc_s[i][e];
          s_bias[c] = (w == 0 ? 0.f : s_bias[c]) + acc_b[i][e];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < D; c += kThreads) {
    part_scale[(size_t)blockIdx.x * D + c] = s_scale[c];
    part_bias[(size_t)blockIdx.x * D + c] = s_bias[c];
  }
}

// dscale[c] = sum over the n partial rows, in row order: each of the 8
// thread rows of a block sums a fixed strided subset, then thread row 0 adds
// the 8 in order
constexpr int kRedCols = 32, kRedRows = 8;

__global__ void __launch_bounds__(kRedCols * kRedRows)
    add_ln_bwd_reduce(const float* __restrict__ part_scale,
                      const float* __restrict__ part_bias,
                      float* __restrict__ dscale, float* __restrict__ dbias,
                      int n, int D) {
  __shared__ float ss[kRedRows][kRedCols], sb[kRedRows][kRedCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kRedCols + tx;
  float s = 0.f, b = 0.f;
  if (c < D) {
#pragma unroll 8
    for (int i = ty; i < n; i += kRedRows) {
      s += part_scale[(size_t)i * D + c];
      b += part_bias[(size_t)i * D + c];
    }
  }
  ss[ty][tx] = s;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < D) {
    for (int j = 1; j < kRedRows; ++j) {
      s += ss[j][tx];
      b += sb[j][tx];
    }
    dscale[c] = s;
    dbias[c] = b;
  }
}

template <typename T>
int launch_fwd(const void* x, const void* h, const void* scale, const void* bias,
               void* r, void* y, int N, int D, float eps, cudaStream_t st) {
  const int blocks = (N + kWarps - 1) / kWarps;
  add_ln_fwd_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(r), static_cast<T*>(y), N, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte vectors per lane that a row of D values takes (32 lanes), at most
template <typename T>
constexpr int kMaxNV = kMaxD / (32 * Pack<T>::kN);

// f(std::integral_constant<int, nv>()) for nv 16-byte vectors per lane, the
// backward's template parameter (1 .. kMaxNV<T>); `bad` for any other nv
template <typename T, int NV = 1, typename F>
int dispatch_nv(int nv, int bad, F&& f) {
  if constexpr (NV > kMaxNV<T>) {
    return bad;
  } else {
    if (nv == NV) return f(std::integral_constant<int, NV>());
    return dispatch_nv<T, NV + 1>(nv, bad, static_cast<F&&>(f));
  }
}

template <typename T, int NV>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(add_ln_bwd_kernel<T, NV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              BwdRing<T, NV>::kSmemBytes);
}

// the blocks of add_ln_bwd_kernel<T, NV> the card holds at once: SMs x
// occupancy, with the kernel's dynamic shared memory
template <typename T, int NV>
int resident_blocks(int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      allow_smem<T, NV>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, add_ln_bwd_kernel<T, NV>, kThreads,
                                                    BwdRing<T, NV>::kSmemBytes) != cudaSuccess)
    return -static_cast<int>(cudaGetLastError());
  return sms * per_sm;
}

template <typename T, int NV>
int launch_bwd(const void* r, const void* dy, const void* dr, const void* scale, void* g,
               void* part_scale, void* part_bias, void* dscale, void* dbias, int N, int D,
               int blocks, float eps, cudaStream_t st) {
  const cudaError_t attr = allow_smem<T, NV>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  add_ln_bwd_kernel<T, NV><<<blocks, kThreads, BwdRing<T, NV>::kSmemBytes, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(dy), static_cast<const T*>(dr),
      static_cast<const float*>(scale), static_cast<T*>(g), static_cast<float*>(part_scale),
      static_cast<float*>(part_bias), N, eps);
  const dim3 red_block(kRedCols, kRedRows);
  add_ln_bwd_reduce<<<(D + kRedCols - 1) / kRedCols, red_block, 0, st>>>(
      static_cast<const float*>(part_scale), static_cast<const float*>(part_bias),
      static_cast<float*>(dscale), static_cast<float*>(dbias), blocks, D);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int N, int D, int dtype) {
  const int per_warp = 32 * (dtype == 1 ? 8 : 4);  // 32 lanes x one 16-byte load
  return N >= 1 && D >= per_warp && D <= kMaxD && D % per_warp == 0;
}

// 16-byte vectors per lane of a row of D values: the backward's template
int vectors_per_lane(int D, int dtype) { return D / (32 * (dtype == 1 ? 8 : 4)); }

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = fp32, 1 = bf16 (x, h, r, y,
// dy, dr, g); scale, bias, the partials, dscale and dbias are fp32. Pointers
// are 16-byte aligned and rows contiguous. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int owlvit_add_ln_fwd(const void* x, const void* h, const void* scale,
                                 const void* bias, void* r, void* y, int N, int D,
                                 float eps, int dtype, void* stream) {
  if (!shape_ok(N, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, h, scale, bias, r, y, N, D, eps, st);
  if (dtype == 0) return launch_fwd<float>(x, h, scale, bias, r, y, N, D, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of the backward kernel at width D that `device` (the current
// device) holds at once, or minus a CUDA error. The caller runs min(this,
// ceil(N / 8)) blocks, asking once per device, dtype and D.
extern "C" int owlvit_add_ln_bwd_resident_blocks(int D, int dtype, int device) {
  const int bad = -static_cast<int>(cudaErrorInvalidValue);
  if (!shape_ok(1, D, dtype)) return bad;
  const int nv = vectors_per_lane(D, dtype);
  if (dtype == 1)
    return dispatch_nv<__nv_bfloat16>(nv, bad, [&](auto v) {
      return resident_blocks<__nv_bfloat16, decltype(v)::value>(device);
    });
  if (dtype == 0)
    return dispatch_nv<float>(
        nv, bad, [&](auto v) { return resident_blocks<float, decltype(v)::value>(device); });
  return bad;
}

// The backward kernel's dynamic shared memory in bytes at width D (its rings
// and their mbarriers), or minus a CUDA error. Launches nothing.
extern "C" int owlvit_add_ln_bwd_smem_bytes(int D, int dtype) {
  const int bad = -static_cast<int>(cudaErrorInvalidValue);
  if (!shape_ok(1, D, dtype)) return bad;
  const int nv = vectors_per_lane(D, dtype);
  if (dtype == 1)
    return dispatch_nv<__nv_bfloat16>(
        nv, bad, [](auto v) { return BwdRing<__nv_bfloat16, decltype(v)::value>::kSmemBytes; });
  if (dtype == 0)
    return dispatch_nv<float>(
        nv, bad, [](auto v) { return BwdRing<float, decltype(v)::value>::kSmemBytes; });
  return bad;
}

// part_scale and part_bias are fp32 [blocks, D] scratch, one row per block;
// blocks is at most ceil(N / 8) and at most the resident blocks (each warp
// walks rows with a stride of blocks * 8).
extern "C" int owlvit_add_ln_bwd(const void* r, const void* dy, const void* dr,
                                 const void* scale, void* g, void* part_scale,
                                 void* part_bias, void* dscale, void* dbias, int N,
                                 int D, int blocks, float eps, int dtype,
                                 void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (!shape_ok(N, D, dtype) || blocks < 1 || blocks > (N + kWarps - 1) / kWarps) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = vectors_per_lane(D, dtype);
  if (dtype == 1)
    return dispatch_nv<__nv_bfloat16>(nv, bad, [&](auto v) {
      return launch_bwd<__nv_bfloat16, decltype(v)::value>(
          r, dy, dr, scale, g, part_scale, part_bias, dscale, dbias, N, D, blocks, eps, st);
    });
  if (dtype == 0)
    return dispatch_nv<float>(nv, bad, [&](auto v) {
      return launch_bwd<float, decltype(v)::value>(r, dy, dr, scale, g, part_scale, part_bias,
                                                   dscale, dbias, N, D, blocks, eps, st);
    });
  return bad;
}
