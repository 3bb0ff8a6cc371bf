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
// fp32 in that order (each add and subtract rounded alone), the strict
// d < shortest[j], the argmin over every column with visited ones masked to
// inf taking the first index of the least value (a NaN counts as least, as
// numpy's and XLA's argmin have it); then the dual updates and the
// augmentation along pred_row back from the sink.
//   Layout: the image's solver state lives in shared memory for the whole
// solve: v, shortest, pred_row and row4col over the C columns, u and col4row
// over the R rows, the visited flags of both (17 C + 9 R bytes: 61,776 at
// C = 3600, R = 64, so the kernel opts in to dynamic shared memory above
// 48 KB). Each Dijkstra step reads one cost row from device memory
// (coalesced, C floats), the 512 threads relax their columns and keep a
// running argmin, and the block reduces it by warp shuffles and one pass
// over the warps' results; thread 0 then takes the column and decides the
// next row. Two block barriers a step. The dual updates run on all threads;
// the augmentation (a walk of at most R links) on thread 0.
//   What bounds it: neither bytes nor operations. The work is a chain of
// dependent Dijkstra steps, each a few microseconds of barriers and a
// block-wide reduction; the bytes (the cost read once is B R C 4) give a
// bound far below it. One block per image: B blocks, so at B = 32 a quarter
// of the SMs. A simple correct kernel first; steps at random weights are
// few (a free column is usually the first one found).
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
//   Layout: the image's boxes and classes in shared memory (20 P bytes:
// 72,000 at P = 3600). The walk finds the next foreground patch 32 at a
// time by a warp ballot over the classes (every warp reads the same shared
// classes, so all reach the same answer), and for a foreground patch the
// block relabels its columns between two barriers: the first keeps a write
// from landing before every thread has read the classes it walked past, the
// second makes the writes visible to the next turn. What bounds it: the
// foreground turns, each a pass over P boxes between two barriers; the
// bytes (boxes and classes read once, classes written once) are ~2 MB at
// [32, 2304].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // the most a block may opt in to on sm_90

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// (a, ia) before (b, ib) in numpy's argmin order: a NaN is least (the first
// NaN wins), else the lesser value, equal values the lower index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

// (val, idx) of this thread takes (ov, oj) if it comes first; idx -1: none.
__device__ __forceinline__ void take_min(float& val, int& idx, float ov, int oj) {
  if (oj >= 0 && (idx < 0 || before(ov, oj, val, idx))) {
    val = ov;
    idx = oj;
  }
}

size_t assign_smem_bytes(int R, int C) {
  return static_cast<size_t>(C) * 17 + static_cast<size_t>(R) * 9;
}

__global__ void __launch_bounds__(kThreads)
    jv_assign_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ row_mask,
                     int* __restrict__ col4row_out, int R, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  float* shortest = v + C;
  int* pred_row = reinterpret_cast<int*>(shortest + C);
  int* row4col = pred_row + C;
  float* u = reinterpret_cast<float*>(row4col + C);
  int* col4row = reinterpret_cast<int*>(u + R);
  unsigned char* visited = reinterpret_cast<unsigned char*>(col4row + R);
  unsigned char* row_visited = visited + C;
  __shared__ float red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ int s_i, s_sink, s_done;
  __shared__ float s_min_val;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cb = cost + static_cast<size_t>(blockIdx.x) * R * C;
  const unsigned char* mb = row_mask + static_cast<size_t>(blockIdx.x) * R;
  const float inf = inf_f();

  for (int j = tid; j < C; j += kThreads) {
    v[j] = 0.f;
    row4col[j] = -1;
  }
  for (int r = tid; r < R; r += kThreads) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  __syncthreads();

  for (int cur = 0; cur < R; ++cur) {
    if (!mb[cur]) continue;  // the same global byte for every thread
    for (int j = tid; j < C; j += kThreads) {
      shortest[j] = inf;
      pred_row[j] = cur;
      visited[j] = 0;
    }
    for (int r = tid; r < R; r += kThreads) row_visited[r] = 0;
    if (tid == 0) {
      s_i = cur;
      s_min_val = 0.f;
      s_sink = 0;
      s_done = 0;
    }
    __syncthreads();

    // Dijkstra from row cur; the first step runs unconditionally (do-while)
    for (int step = 0; step < C; ++step) {
      const int i = s_i;
      const float min_val = s_min_val;
      const float ui = u[i];
      const float* crow = cb + static_cast<size_t>(i) * C;
      float best = inf;
      int best_j = -1;
      for (int j = tid; j < C; j += kThreads) {
        float m = inf;
        if (!visited[j]) {
          const float d = __fsub_rn(__fsub_rn(__fadd_rn(min_val, crow[j]), ui), v[j]);
          m = shortest[j];
          if (d < m) {
            m = d;
            shortest[j] = d;
            pred_row[j] = i;
          }
        }
        take_min(best, best_j, m, j);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
        take_min(best, best_j, ov, oj);
      }
      if (lane == 0) {
        red_val[warp] = best;
        red_idx[warp] = best_j;
      }
      __syncthreads();
      if (tid == 0) {
        float bv = red_val[0];
        int bj = red_idx[0];
        for (int w = 1; w < kWarps; ++w) take_min(bv, bj, red_val[w], red_idx[w]);
        row_visited[i] = 1;
        s_min_val = bv;
        visited[bj] = 1;
        const int nxt = row4col[bj];
        if (nxt < 0) {
          s_done = 1;
          s_sink = bj;
        } else {
          s_i = nxt;
        }
      }
      __syncthreads();
      if (s_done) break;
    }
    if (!s_done) break;  // no free column reached: inf or NaN costs

    // dual updates, in the solver's order: u[cur] first, then the other
    // visited rows by min_val - shortest[their column], then the visited
    // columns
    const float mv = s_min_val;
    for (int r = tid; r < R; r += kThreads) {
      if (r == cur) {
        u[r] = __fadd_rn(u[r], mv);
      } else if (row_visited[r]) {
        const int c = col4row[r] < 0 ? 0 : col4row[r];
        u[r] = __fadd_rn(u[r], __fsub_rn(mv, shortest[c]));
      }
    }
    for (int j = tid; j < C; j += kThreads)
      if (visited[j]) v[j] = __fsub_rn(v[j], __fsub_rn(mv, shortest[j]));
    __syncthreads();

    // augment along the alternating path back from the sink
    if (tid == 0) {
      int j = s_sink;
      for (int link = 0; link <= R; ++link) {
        const int r = pred_row[j];
        row4col[j] = r;
        const int nj = col4row[r];
        col4row[r] = j;
        j = nj;
        if (r == cur) break;
      }
    }
    __syncthreads();
  }
  __syncthreads();
  int* out = col4row_out + static_cast<size_t>(blockIdx.x) * R;
  for (int r = tid; r < R; r += kThreads) out[r] = col4row[r];
}

// numpy's maximum and minimum: a NaN in either operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// pairwise_iou_above's predicate for boxes a (area area_a) and c
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 c, float t) {
  const float iw = nan_max(__fsub_rn(nan_min(a.z, c.z), nan_max(a.x, c.x)), 0.f);
  const float ih = nan_max(__fsub_rn(nan_min(a.w, c.w), nan_max(a.y, c.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, box_area(c)), inter);
  return inter > __fmul_rn(t, uni) && uni > 0.f;
}

size_t propagate_smem_bytes(int P) { return static_cast<size_t>(P) * 20; }

__global__ void __launch_bounds__(kThreads)
    propagate_labels_kernel(const float* __restrict__ boxes, const long long* __restrict__ cls_in,
                            long long* __restrict__ cls_out, int P, int background, float t) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* bx = reinterpret_cast<float4*>(smem);
  int* tc = reinterpret_cast<int*>(bx + P);
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t base = static_cast<size_t>(blockIdx.x) * P;
  const float* gb = boxes + base * 4;
  for (int k = tid; k < P; k += kThreads) {
    bx[k] = make_float4(gb[4 * k], gb[4 * k + 1], gb[4 * k + 2], gb[4 * k + 3]);
    tc[k] = static_cast<int>(cls_in[base + k]);
  }
  __syncthreads();
  int j = 0;
  while (j < P) {
    const int k = j + lane;
    const unsigned fg = __ballot_sync(0xffffffffu, k < P && tc[k] != background);
    if (!fg) {
      j += 32;
      continue;
    }
    const int f = j + __ffs(fg) - 1;  // the next foreground patch, in order
    const int label = tc[f];
    __syncthreads();  // every thread has read the classes up to f
    const float4 a = bx[f];
    const float area_a = box_area(a);
    for (int c = tid; c < P; c += kThreads)
      if (iou_above(a, area_a, bx[c], t)) tc[c] = label;
    __syncthreads();  // the relabels are seen by the next turn
    j = f + 1;
  }
  for (int c = tid; c < P; c += kThreads) cls_out[base + c] = tc[c];
}

// Let `kernel` take smem bytes of dynamic shared memory (an opt-in above
// 48 KB); 0 or a CUDA error.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// cost fp32 [B, R, C], row_mask bool [B, R] (one byte each), col4row int32
// [B, R]; R <= C. One block per image.
extern "C" int owlvit_jv_assign(const void* cost, const void* row_mask, void* col4row, int B,
                                int R, int C, void* stream) {
  if (B < 0 || R < 0 || C < 1 || R > C) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0) return 0;
  const size_t smem = assign_smem_bytes(R, C);
  const int err = allow_smem(jv_assign_kernel, smem);
  if (err) return err;
  jv_assign_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const unsigned char*>(row_mask),
      static_cast<int*>(col4row), R, C);
  return static_cast<int>(cudaGetLastError());
}

// boxes fp32 [B, P, 4] xyxy, classes int64 [B, P] in and out (distinct
// buffers); background is the class that does not propagate. One block per
// image.
extern "C" int owlvit_propagate_labels(const void* boxes, const void* classes_in,
                                       void* classes_out, int B, int P, int background,
                                       float threshold, void* stream) {
  if (B < 0 || P < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || P == 0) return 0;
  const size_t smem = propagate_smem_bytes(P);
  const int err = allow_smem(propagate_labels_kernel, smem);
  if (err) return err;
  propagate_labels_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const long long*>(classes_in),
      static_cast<long long*>(classes_out), P, background, threshold);
  return static_cast<int>(cudaGetLastError());
}
