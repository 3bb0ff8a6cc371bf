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
// ms at 3.35 TB/s.
//
// Design. The TPU kernel takes 256-row blocks in a sequential grid and, for
// the backward, writes one (8, D) partial of dscale and dbias per block that
// XLA sums outside. Here one warp owns a row: its lanes read it with 16-byte
// loads (8 bf16 or 4 fp32 per lane per load, neighbouring lanes on
// neighbouring addresses), hold it in registers, and reduce the row's sums
// with butterfly shuffles, so r, the statistics and xhat never go back to
// memory between passes. Ragged N needs no padding: a warp past the last row
// does nothing. The backward runs a fixed number of blocks (as many as fit on
// the card at once, which the wrapper asks once per device; fewer for small
// N), each warp walking rows with a fixed stride and keeping its columns'
// dscale and dbias sums in registers; the warps of a block then add theirs into shared memory in warp
// order, each block writes one fp32 partial row, and a second small kernel
// sums the partial rows in block order. No atomics: the sums are the same
// from run to run. D must be a multiple of 32 lanes times one 16-byte load
// (256 in bf16, 128 in fp32) and at most 1024: 768 (B/32, B/16) and 1024
// (L/14) are taken; the wrapper raises on any other D.
// Given up for now: more than one row per warp at small D, and a persistent
// forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    add_ln_bwd_kernel(const T* __restrict__ r, const T* __restrict__ dy,
                      const T* __restrict__ dr, const float* __restrict__ scale,
                      T* __restrict__ g, float* __restrict__ part_scale,
                      float* __restrict__ part_bias, int N, int D, float eps) {
  using P = Pack<T>;
  constexpr int E = P::kN;
  constexpr int kMaxV = kMaxD / (32 * E);
  __shared__ float s_scale[kMaxD], s_bias[kMaxD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = D / (32 * E);

  float acc_s[kMaxV][E], acc_b[kMaxV][E];  // this lane's columns of dscale, dbias
#pragma unroll
  for (int i = 0; i < kMaxV; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc_s[i][e] = acc_b[i][e] = 0.f;

  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < N; row += stride) {
    const size_t base = (size_t)row * D;
    float xh[kMaxV][E], dyh[kMaxV][E];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      if (i < nv) {
        P::load(r + base + (i * 32 + lane) * E, xh[i]);
#pragma unroll
        for (int e = 0; e < E; ++e) sum += xh[i][e];
      }
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      if (i < nv) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          xh[i][e] -= mean;
          sq += xh[i][e] * xh[i][e];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      if (i < nv) {
        const int c = (i * 32 + lane) * E;
        float dv[E], sc[E];
        P::load(dy + base + c, dv);
        load_f32x<E>(scale + c, sc);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          xh[i][e] *= rstd;  // xhat
          dyh[i][e] = dv[e] * sc[e];
          s1 += dyh[i][e];
          s2 += dyh[i][e] * xh[i][e];
          acc_s[i][e] += dv[e] * xh[i][e];
          acc_b[i][e] += dv[e];
        }
      }
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      if (i < nv) {
        const int c = (i * 32 + lane) * E;
        float d[E], out[E];
        P::load(dr + base + c, d);
#pragma unroll
        for (int e = 0; e < E; ++e)
          out[e] = d[e] + rstd * (dyh[i][e] - m1 - xh[i][e] * m2);
        P::store(g + base + c, out);
      }
    }
  }

  // the block's partial: warps add in warp order (deterministic)
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < kMaxV; ++i) {
        if (i < nv) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int c = (i * 32 + lane) * E + e;
            s_scale[c] = (w == 0 ? 0.f : s_scale[c]) + acc_s[i][e];
            s_bias[c] = (w == 0 ? 0.f : s_bias[c]) + acc_b[i][e];
          }
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

// the blocks of add_ln_bwd_kernel<T> the card holds at once: SMs x occupancy
template <typename T>
int resident_blocks(int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, add_ln_bwd_kernel<T>,
                                                    kThreads, 0) != cudaSuccess)
    return -static_cast<int>(cudaGetLastError());
  return sms * per_sm;
}

template <typename T>
int launch_bwd(const void* r, const void* dy, const void* dr, const void* scale,
               void* g, void* part_scale, void* part_bias, void* dscale,
               void* dbias, int N, int D, int blocks, float eps, cudaStream_t st) {
  add_ln_bwd_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(dy),
      static_cast<const T*>(dr), static_cast<const float*>(scale),
      static_cast<T*>(g), static_cast<float*>(part_scale),
      static_cast<float*>(part_bias), N, D, eps);
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

// The blocks of the backward kernel that `device` (the current device) holds
// at once, or minus a CUDA error. The caller runs min(this, ceil(N / 8))
// blocks, asking once per device and dtype.
extern "C" int owlvit_add_ln_bwd_resident_blocks(int dtype, int device) {
  if (dtype == 1) return resident_blocks<__nv_bfloat16>(device);
  if (dtype == 0) return resident_blocks<float>(device);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// part_scale and part_bias are fp32 [blocks, D] scratch, one row per block;
// blocks is at most ceil(N / 8) and at most the resident blocks (each warp
// walks rows with a stride of blocks * 8).
extern "C" int owlvit_add_ln_bwd(const void* r, const void* dy, const void* dr,
                                 const void* scale, void* g, void* part_scale,
                                 void* part_bias, void* dscale, void* dbias, int N,
                                 int D, int blocks, float eps, int dtype,
                                 void* stream) {
  if (!shape_ok(N, D, dtype) || blocks < 1 || blocks > (N + kWarps - 1) / kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(r, dy, dr, scale, g, part_scale, part_bias,
                                     dscale, dbias, N, D, blocks, eps, st);
  if (dtype == 0)
    return launch_bwd<float>(r, dy, dr, scale, g, part_scale, part_bias, dscale,
                             dbias, N, D, blocks, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
