// The DETR matcher's assignment and the IoU label propagation on the card,
// one block per image: the two sequential steps of the train step's loss.
//
// jv_assign replaces owlvit_tpu/ops/matcher.py::hungarian, the JAX package's
// Jonker-Volgenant solver in lax control flow (a while_loop per Dijkstra and
// per augmentation inside a scan over rows), which XLA runs on the device
// with no host round trip. propagate_labels replaces
// owlvit_tpu/ops/losses.py::_propagate_labels, the fori_loop over patches
// that relabels every patch overlapping a foreground patch by IoU > 0.85.
// Neither is a Pallas kernel; both run on every train step.
//
// jv_assign(cost [B, R, C] fp32, row_mask [B, R] bool) -> col4row [B, R]
// int32, -1 for masked rows. Step for step the JAX solver (and the port's
// numpy `hungarian`, its plain version), so that the assignment is the same
// under ties: rows in order, a masked row skipped; a do-while Dijkstra from
// the row over all columns, d = ((min_val + cost[i][j]) - u[i]) - v[j] in
// fp32 in that order (each add and subtract rounded alone: __fadd_rn and
// __fsub_rn, which nvcc does not contract into FMAs), the strict
// d < shortest[j], the argmin over every column with visited ones at inf
// taking the first index of the least value (a NaN least, -0 equal to +0,
// as numpy's and XLA's argmin have it); then the dual updates and the
// augmentation along pred_row back from the sink.
//   What bounds it: neither bytes nor operations. The work is a chain of
// dependent Dijkstra steps (hundreds an image on crowded scenes, about one a
// row at random weights), so the design cuts the latency of one step:
//   - The valid rows are listed once at the start (a warp ballot over
//     row_mask) and the solve runs over that list: u, col4row and pred_row
//     hold positions in it, and the row loop reads no mask.
//   - Thread t owns columns t, t + 512, ... (K = ceil(C / 512) of them, a
//     template parameter: C <= 4096). Their shortest, v, pred_row and
//     visited flags live in its registers for the whole solve, so a row's
//     reset is register writes and a relax stores nothing; at the row's end
//     the owners of the visited columns (the only ones an augmenting path
//     can cross) publish their pred_row to shared memory, where row4col
//     stays.
//   - One block barrier a Dijkstra step, no serial section: each thread
//     takes the first least of its columns by float compares (exact here:
//     shortest is never NaN or -0), then maps it to an order-preserving
//     32-bit key (a NaN least, -0 as +0); a warp reduces with two redux.sync
//     (__reduce_min_sync: the least key, then the least column among the
//     lanes holding it); lane 0 writes the pair to a shared slot that is
//     double-buffered by step parity; after the barrier every warp reduces
//     the 16 slots itself, so every thread knows the column and its value
//     and reads row4col[column] for the next row.
//   - The dual updates are owner-computes: the rows visited apart from the
//     root are exactly row4col[j] of the visited columns j other than the
//     sink, so j's owner adds min_val - shortest[j] to u[row4col[j]] and
//     updates its own v[j] in registers (the rounded operations of the JAX
//     solver); one thread adds min_val to u[root]. One more barrier a row,
//     after the duals (the augmentation rewrites row4col); thread 0 then
//     walks the path while the next row's first step relaxes.
//   - The cost rows of the first valid rows are staged in shared memory at
//     the start by bulk asynchronous copies (cp.async.bulk), one mbarrier a
//     row, waited on when the solve reaches that row (a row's Dijkstra visits
//     no later row). As many rows as fit beside the state (all of them at
//     G = 16, C = 2304 and at C = 576; 23 of 64 at C = 2304); the others are
//     read from device memory (L2 on a repeat) at each step.
//   Layout: dynamic shared memory holds the staged rows' mbarriers and rows,
// then row4col and pred_row over the C columns, then u, col4row and the
// list of valid rows over R (8 C + 12 R bytes of state: 29.5 KB at C =
// 3600, R = 64). One block an image: B blocks, a quarter of the SMs at B =
// 32.
//   A row whose Dijkstra does not end within C steps (possible only with
// inf or NaN costs, where the plain solver loops forever) stops the image's
// solve: it and the rows after it stay -1 (ops/matcher.py::assign drops
// their labels, and the loss gathers patch P - 1 for them).
//
// propagate_labels(boxes [B, P, 4] fp32 xyxy, classes [B, P] int64,
// background, threshold) -> classes [B, P] int64: for j = 0 .. P-1 in order,
// a patch whose class is not background at its turn gives its class to
// every patch k with iou_above(j, k); a patch relabelled earlier in the walk
// propagates in its turn (quirk #7 of the reference: it iterates a tensor
// it mutates). iou_above is exactly ops/boxes.py::pairwise_iou_above:
// inter > t * union && union > 0, with union = (area_j + area_k) - inter,
// every product and sum rounded alone (__fmul_rn / __fadd_rn / __fsub_rn:
// nvcc would otherwise contract area_j + area_k - iw * ih into FMAs, which
// the host and XLA on the CPU do not, and a box at the threshold flips).
//   What bounds it: the foreground turns, each a relabel pass and a
// block-wide reduction; the bytes (boxes and classes read once, classes
// written once) are ~2.4 MB at [32, 2304]. Thread t owns patches t, t + 512,
// ... (K = ceil(P / 512)): their boxes (one float4 load each) and its
// warp's bounding box of each k's 32 boxes live in its registers, the
// foreground flags as a bit mask; all boxes and classes in shared memory.
// In a turn f each thread relabels its patches and finds its least patch
// above f that is not background after its writes (`__ffs` of the mask):
// the least of those over the block is the walk's next turn (a patch at or
// below f never takes another), and its class in shared memory is that
// turn's label. The patch is reduced like jv_assign's keys (one redux.sync
// a level): one barrier a turn, no scan over background patches. For t >=
// 0 the predicate runs only for boxes that overlap the turn's box in both
// axes (inter > t * union needs inter > 0), and a warp first tests its
// bounding box of each k, so most warps skip most of a turn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxColumns = 4096;  // columns (patches) of an image, at most
constexpr int kMaxK = kMaxColumns / kThreads;  // columns a thread owns, at most
constexpr int kMaxSmem = 232448;   // the most a block may opt in to on sm_90
constexpr int kStaticSmem = 1024;  // room left for the kernels' static shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;    // no key, no column

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// A 32-bit key whose unsigned order is numpy's argmin order of the values:
// a NaN least, -0 equal to +0 (the add makes -0 +0), else the float order.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(__fadd_rn(f, 0.f));
  return f != f ? 0u : b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
}

// the value of a key (a NaN for key 0; +0 for the key of either zero)
__device__ __forceinline__ float key_value(unsigned k) {
  return k == 0u ? __int_as_float(0x7fc00000)
                 : __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// The least (key, second) over the block, second the least among the
// holders of the least key: each warp reduces its lanes, lane 0 writes the
// pair to slot `par` (alternate it from call to call: a warp may write the
// next call's pair while another still reads this one's), one barrier, then
// every warp reduces the slots itself. Every thread returns the same pair.
__device__ __forceinline__ uint2 block_min(unsigned key, unsigned second, uint2 (*part)[kWarps],
                                           int par) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned wk = __reduce_min_sync(kFull, key);
  const unsigned ws = __reduce_min_sync(kFull, key == wk ? second : kNone);
  if (lane == 0) part[par][warp] = make_uint2(wk, ws);
  __syncthreads();
  const uint2 p = lane < kWarps ? part[par][lane] : make_uint2(kNone, kNone);
  const unsigned gk = __reduce_min_sync(kFull, p.x);
  return make_uint2(gk, __reduce_min_sync(kFull, p.x == gk ? p.y : kNone));
}

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

// the staged rows' mbarriers, rounded up to keep the rows 16-byte aligned
__host__ __device__ __forceinline__ size_t stage_bar_bytes(int rows) {
  return (static_cast<size_t>(rows) * 8 + 15) / 16 * 16;
}

// whether column j = tid + k * kThreads of a thread exists: always for
// k < K - 1, since K = ceil(C / kThreads)
template <int K>
__device__ __forceinline__ bool owned(int k, int j, int C) {
  return k + 1 < K || j < C;
}

__host__ __device__ __forceinline__ size_t assign_smem_bytes(int R, int C, int stage_rows) {
  return stage_bar_bytes(stage_rows) + static_cast<size_t>(stage_rows) * C * 4 +
         static_cast<size_t>(C) * 8 + static_cast<size_t>(R) * 12;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    jv_assign_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ row_mask,
                     int* __restrict__ col4row_out, int R, int C, int stage_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* stage = reinterpret_cast<float*>(smem + stage_bar_bytes(stage_cap));
  int* row4col = reinterpret_cast<int*>(stage + static_cast<size_t>(stage_cap) * C);
  int* pred_row = row4col + C;
  float* u = reinterpret_cast<float*>(pred_row + C);
  int* col4row = reinterpret_cast<int*>(u + R);
  int* valid = col4row + R;
  __shared__ uint2 part[2][kWarps];
  __shared__ int s_valid;

  const int tid = threadIdx.x;
  const float* cb = cost + static_cast<size_t>(blockIdx.x) * R * C;
  int* out = col4row_out + static_cast<size_t>(blockIdx.x) * R;

  if (tid < 32) {  // the valid rows in order; a masked row's output is -1
    const unsigned char* mb = row_mask + static_cast<size_t>(blockIdx.x) * R;
    int n = 0;
    for (int base = 0; base < R; base += 32) {
      const int r = base + tid;
      const bool real = r < R && mb[r];
      const unsigned bal = __ballot_sync(kFull, real);
      if (real) {
        valid[n + __popc(bal & ((1u << tid) - 1u))] = r;
      } else if (r < R) {
        out[r] = -1;
      }
      n += __popc(bal);
    }
    __syncwarp();
    if (tid == 0) {
      s_valid = n;
      const int ns = min(n, stage_cap);
      for (int p = 0; p < ns; ++p) mbar_init(smem_u32(bar + p), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int p = 0; p < ns; ++p) {
        const uint32_t b = smem_u32(bar + p);
        mbar_expect_tx(b, C * 4);
        bulk_g2s(stage + static_cast<size_t>(p) * C, cb + static_cast<size_t>(valid[p]) * C,
                 C * 4, b);
      }
    }
  }
  for (int j = tid; j < C; j += kThreads) row4col[j] = -1;
  for (int r = tid; r < R; r += kThreads) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  float v[K], sh[K];
  int pr[K];  // pred_row of the thread's columns
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;
  __syncthreads();

  const int V = s_valid, ns = min(V, stage_cap);
  const float inf = inf_f();
  int par = 0;
  for (int cur = 0; cur < V; ++cur) {
    if (cur < ns) mbar_wait(smem_u32(bar + cur), 0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sh[k] = inf;
      pr[k] = cur;
    }
    unsigned vis = 0;  // bit k: column tid + k * kThreads visited
    int i = cur, sink = -1;
    float min_val = 0.f;
    // Dijkstra from row cur; the first step runs unconditionally (do-while)
    for (int step = 0; step < C; ++step) {
      const float ui = u[i];
      float c[K];
      if (i < ns) {
        const float* row = stage + static_cast<size_t>(i) * C;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = tid + k * kThreads;
          c[k] = owned<K>(k, j, C) ? row[j] : 0.f;
        }
      } else {
        const float* row = cb + static_cast<size_t>(valid[i]) * C;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = tid + k * kThreads;
          c[k] = owned<K>(k, j, C) ? __ldg(row + j) : 0.f;
        }
      }
      // this thread's first least value (visited columns at inf); float
      // compares suffice here: shortest is never NaN (d < shortest is false
      // for a NaN d) and never -0 (no operand of d can be -0)
      float best = inf;
      unsigned best_j = tid < C ? tid : kNone;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = tid + k * kThreads;
        if (owned<K>(k, j, C) && !((vis >> k) & 1u)) {
          const float d = __fsub_rn(__fsub_rn(__fadd_rn(min_val, c[k]), ui), v[k]);
          if (d < sh[k]) {
            sh[k] = d;
            pr[k] = i;
          }
          if (sh[k] < best) {
            best = sh[k];
            best_j = j;
          }
        }
      }
      const uint2 m = block_min(best_j == kNone ? kNone : order_key(best), best_j, part, par);
      par ^= 1;
      min_val = key_value(m.x);
      const int bj = static_cast<int>(m.y);
      if ((bj & (kThreads - 1)) == tid) vis |= 1u << (bj / kThreads);
      const int nxt = row4col[bj];
      if (nxt < 0) {
        sink = bj;
        break;
      }
      i = nxt;
    }
    if (sink < 0) break;  // no free column reached: inf or NaN costs

    // dual updates: u[cur] += min_val; each visited column j's owner moves
    // u[row4col[j]] (a row visited on the way) and its own v[j] by
    // min_val - shortest[j], and publishes pred_row[j] (the augmenting path
    // runs over visited columns only)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if ((vis >> k) & 1u) {
        const int j = tid + k * kThreads;
        const float delta = __fsub_rn(min_val, sh[k]);
        const int r = row4col[j];
        if (r >= 0) u[r] = __fadd_rn(u[r], delta);
        v[k] = __fsub_rn(v[k], delta);
        pred_row[j] = pr[k];
      }
    }
    if (tid == 0) u[cur] = __fadd_rn(u[cur], min_val);
    // row4col read above before the augmentation rewrites it; pred_row and u
    // written before it and the next row read them. The next row's own
    // writes of pred_row come after its first step's barrier, which thread
    // 0 reaches once the augmentation is done.
    __syncthreads();

    // augment along the alternating path back from the sink
    if (tid == 0) {
      int j = sink;
      for (int link = 0; link <= R; ++link) {
        const int r = pred_row[j];
        row4col[j] = r;
        const int nj = col4row[r];
        col4row[r] = j;
        j = nj;
        if (r == cur) break;
      }
    }
  }
  __syncthreads();
  for (int p = tid; p < V; p += kThreads) out[valid[p]] = col4row[p];
  if (tid == 0) {  // no copy outlives the block (a solve stopped early)
    for (int p = 0; p < ns; ++p) mbar_wait(smem_u32(bar + p), 0);
  }
}

// numpy's maximum and minimum: a NaN in either operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// pairwise_iou_above's predicate for boxes a and c of areas area_a, area_c
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 c, float area_c,
                                          float t) {
  const float iw = nan_max(__fsub_rn(nan_min(a.z, c.z), nan_max(a.x, c.x)), 0.f);
  const float ih = nan_max(__fsub_rn(nan_min(a.w, c.w), nan_max(a.y, c.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_c), inter);
  return inter > __fmul_rn(t, uni) && uni > 0.f;
}

// boxes, then classes
size_t propagate_smem_bytes(int P) { return static_cast<size_t>(P) * 20; }

// The least key over the block (as block_min, one value)
__device__ __forceinline__ unsigned block_min_key(unsigned key, unsigned (*part)[kWarps],
                                                  int par) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned wk = __reduce_min_sync(kFull, key);
  if (lane == 0) part[par][warp] = wk;
  __syncthreads();
  return __reduce_min_sync(kFull, lane < kWarps ? part[par][lane] : kNone);
}

// The least (or, with `most`, the greatest) non-NaN x over the warp, +inf
// (-inf) if there is none
__device__ __forceinline__ float warp_extreme(float x, bool most) {
  const unsigned none = most ? 0u : kNone;
  const unsigned key = x != x ? none : order_key(x);
  const unsigned k = most ? __reduce_max_sync(kFull, key) : __reduce_min_sync(kFull, key);
  return k == none ? (most ? -inf_f() : inf_f()) : key_value(k);
}

// The least of this thread's patches tid + k * kThreads above f (any, for
// f = kNone) whose bit k of fg is set; kNone if there is none.
template <int K>
__device__ __forceinline__ unsigned first_above(unsigned f, unsigned fg) {
  const int tid = threadIdx.x;
  const int kmin = f == kNone || static_cast<int>(f) < tid
                       ? 0 : (static_cast<int>(f) - tid) / kThreads + 1;
  const unsigned above = kmin < K ? fg & (~0u << kmin) : 0u;
  return above ? tid + (__ffs(above) - 1) * kThreads : kNone;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    propagate_labels_kernel(const float4* __restrict__ boxes,
                            const long long* __restrict__ cls_in,
                            long long* __restrict__ cls_out, int P, int background, float t) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* bx = reinterpret_cast<float4*>(smem);
  int* cls = reinterpret_cast<int*>(bx + P);
  __shared__ unsigned part[2][kWarps];
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * P;
  // For t >= 0 a pair passes the predicate only if the boxes overlap in
  // both axes (inter > t * union >= 0 needs iw > 0 and ih > 0), which four
  // compares decide (false for NaN coordinates, as the predicate is). The
  // warp first tests the bounding box of its 32 boxes of each k, so that
  // most warps skip most turns at no cost per patch.
  const bool cull = t >= 0.f;
  float4 mine[K], group[K];  // own boxes; the warp's bounding box of each k
  unsigned fg = 0;  // bit k: patch tid + k * kThreads is not background
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = tid + k * kThreads;
    const float nan = __int_as_float(0x7fc00000);
    mine[k] = make_float4(nan, nan, nan, nan);  // no patch: outside every bounding box
    if (owned<K>(k, c, P)) {
      mine[k] = __ldg(boxes + base + c);
      const int label = static_cast<int>(__ldg(cls_in + base + c));
      bx[c] = mine[k];
      cls[c] = label;
      if (label != background) fg |= 1u << k;
    }
    group[k] = make_float4(warp_extreme(mine[k].x, false), warp_extreme(mine[k].y, false),
                           warp_extreme(mine[k].z, true), warp_extreme(mine[k].w, true));
  }
  // The turn's patch f is the least candidate; the barrier also publishes
  // bx and cls, whose slot f only its owner writes, and only with f's own
  // label after f's turn has read it.
  int par = 0;
  unsigned f = block_min_key(first_above<K>(kNone, fg), part, par);
  par ^= 1;
  while (f < static_cast<unsigned>(P)) {
    const int lab = cls[f];
    const float4 a = bx[f];
    const float area_a = box_area(a);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 g = group[k];
      if (!cull || (g.x < a.z && a.x < g.z && g.y < a.w && a.y < g.w)) {
        const float4 b = mine[k];
        const int c = tid + k * kThreads;
        if ((!cull || (b.x < a.z && a.x < b.z && b.y < a.w && a.y < b.w)) &&
            owned<K>(k, c, P) && iou_above(a, area_a, b, box_area(b), t)) {
          if (cls[c] != lab) cls[c] = lab;
          fg |= 1u << k;
        }
      }
    }
    f = block_min_key(first_above<K>(f, fg), part, par);
    par ^= 1;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = tid + k * kThreads;
    if (owned<K>(k, c, P)) cls_out[base + c] = cls[c];
  }
}

// Let `kernel` take smem bytes of dynamic shared memory (an opt-in above
// 48 KB); 0 or a CUDA error.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem + kStaticSmem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// the instantiation for K = ceil(C / kThreads) columns a thread
template <int K = 1>
int launch_jv_assign(const float* cost, const unsigned char* row_mask, int* col4row, int B, int R,
                     int C, cudaStream_t stream) {
  if constexpr (K < kMaxK) {
    if (C > K * kThreads)
      return launch_jv_assign<K + 1>(cost, row_mask, col4row, B, R, C, stream);
  }
  // as many valid rows' costs as fit beside the state: bulk copies need C
  // a multiple of 4 floats and a 16-byte aligned cost
  int stage = 0;
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0) {
    const long long room = static_cast<long long>(kMaxSmem) - kStaticSmem -
                           static_cast<long long>(assign_smem_bytes(R, C, 0)) - 16;
    const long long fit = room > 0 ? room / (4LL * C + 8) : 0;
    stage = static_cast<int>(fit < R ? fit : R);
  }
  const size_t smem = assign_smem_bytes(R, C, stage);
  const int err = allow_smem(jv_assign_kernel<K>, smem);
  if (err) return err;
  jv_assign_kernel<K><<<B, kThreads, smem, stream>>>(cost, row_mask, col4row, R, C, stage);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for K = ceil(P / kThreads) patches a thread
template <int K = 1>
int launch_propagate(const float4* boxes, const long long* cls_in, long long* cls_out, int B,
                     int P, int background, float threshold, cudaStream_t stream) {
  if constexpr (K < kMaxK) {
    if (P > K * kThreads)
      return launch_propagate<K + 1>(boxes, cls_in, cls_out, B, P, background, threshold, stream);
  }
  const size_t smem = propagate_smem_bytes(P);
  const int err = allow_smem(propagate_labels_kernel<K>, smem);
  if (err) return err;
  propagate_labels_kernel<K><<<B, kThreads, smem, stream>>>(boxes, cls_in, cls_out, P,
                                                            background, threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cost fp32 [B, R, C], row_mask bool [B, R] (one byte each), col4row int32
// [B, R]; R <= C <= 4096. One block per image.
extern "C" int owlvit_jv_assign(const void* cost, const void* row_mask, void* col4row, int B,
                                int R, int C, void* stream) {
  if (B < 0 || R < 0 || C < 1 || R > C || C > kMaxColumns)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0) return 0;
  return launch_jv_assign(static_cast<const float*>(cost),
                          static_cast<const unsigned char*>(row_mask), static_cast<int*>(col4row),
                          B, R, C, static_cast<cudaStream_t>(stream));
}

// boxes fp32 [B, P, 4] xyxy (16-byte aligned), classes int64 [B, P] in and
// out (distinct buffers); background is the class that does not propagate.
// P <= 4096. One block per image.
extern "C" int owlvit_propagate_labels(const void* boxes, const void* classes_in,
                                       void* classes_out, int B, int P, int background,
                                       float threshold, void* stream) {
  if (B < 0 || P < 0 || P > kMaxColumns || reinterpret_cast<uintptr_t>(boxes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || P == 0) return 0;
  return launch_propagate(static_cast<const float4*>(boxes),
                          static_cast<const long long*>(classes_in),
                          static_cast<long long*>(classes_out), B, P, background, threshold,
                          static_cast<cudaStream_t>(stream));
}
