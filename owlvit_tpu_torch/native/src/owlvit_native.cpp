// owlvit_native: host-side C++ kernels behind a plain C ABI (ctypes).
//
// The reference's host hot spots are third-party native code: SciPy's C
// linear_sum_assignment (matcher.py:136), torchvision's C++ NMS
// (models.py:141) and torchmetrics' evaluation loops. The TPU rebuild keeps
// matching/NMS on device for the hot path, but the host still needs fast
// implementations for (a) eval-time mAP accumulation over hundreds of images
// x 80 classes x 10 IoU thresholds, (b) oracle cross-checks, and (c)
// CPU-only deployments. These are those kernels, dependency-free.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libowlvit_native.so owlvit_native.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Jonker–Volgenant rectangular linear sum assignment (rows <= cols).
// cost: row-major [n_rows, n_cols]. Writes col4row[n_rows]. Returns 0 on OK.
// ---------------------------------------------------------------------------
int lsap_solve(const double* cost, int n_rows, int n_cols, int* col4row_out) {
  if (n_rows > n_cols) return -1;
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(n_rows, 0.0), v(n_cols, 0.0);
  std::vector<int> row4col(n_cols, -1), col4row(n_rows, -1);
  std::vector<double> shortest(n_cols);
  std::vector<int> pred(n_cols);
  std::vector<char> visited_col(n_cols), visited_row(n_rows);

  for (int cur = 0; cur < n_rows; ++cur) {
    std::fill(shortest.begin(), shortest.end(), INF);
    std::fill(pred.begin(), pred.end(), cur);
    std::fill(visited_col.begin(), visited_col.end(), 0);
    std::fill(visited_row.begin(), visited_row.end(), 0);

    double min_val = 0.0;
    int i = cur, sink = -1;
    while (sink == -1) {
      visited_row[i] = 1;
      const double* ci = cost + (size_t)i * n_cols;
      double lowest = INF;
      int j_low = -1;
      for (int j = 0; j < n_cols; ++j) {
        if (visited_col[j]) continue;
        double d = min_val + ci[j] - u[i] - v[j];
        if (d < shortest[j]) { shortest[j] = d; pred[j] = i; }
        if (shortest[j] < lowest) { lowest = shortest[j]; j_low = j; }
      }
      if (j_low < 0) return -2;  // infeasible
      min_val = lowest;
      visited_col[j_low] = 1;
      if (row4col[j_low] == -1) sink = j_low;
      else i = row4col[j_low];
    }

    u[cur] += min_val;
    for (int r = 0; r < n_rows; ++r)
      if (visited_row[r] && r != cur) u[r] += min_val - shortest[col4row[r]];
    for (int j = 0; j < n_cols; ++j)
      if (visited_col[j]) v[j] -= min_val - shortest[j];

    int j = sink;
    while (true) {
      int r = pred[j];
      row4col[j] = r;
      std::swap(col4row[r], j);
      if (r == cur) break;
    }
  }
  std::copy(col4row.begin(), col4row.end(), col4row_out);
  return 0;
}

// ---------------------------------------------------------------------------
// Greedy NMS. boxes: [n, 4] xyxy, scores: [n]. Suppress IoU > thresh
// (torchvision semantics). Writes keep indices (score-descending); returns
// number kept (<= max_out).
// ---------------------------------------------------------------------------
static inline double iou_xyxy(const float* a, const float* b) {
  double lx = std::max(a[0], b[0]), ly = std::max(a[1], b[1]);
  double rx = std::min(a[2], b[2]), ry = std::min(a[3], b[3]);
  double iw = std::max(0.0, rx - lx), ih = std::max(0.0, ry - ly);
  double inter = iw * ih;
  double area_a = (double)(a[2] - a[0]) * (a[3] - a[1]);
  double area_b = (double)(b[2] - b[0]) * (b[3] - b[1]);
  double uni = area_a + area_b - inter;
  return uni > 0 ? inter / uni : 0.0;
}

int nms(const float* boxes, const float* scores, int n, float iou_thresh,
        int max_out, int* keep_out) {
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });
  std::vector<char> dead(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n && kept < max_out; ++oi) {
    int i = order[oi];
    if (dead[i]) continue;
    keep_out[kept++] = i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (!dead[j] && iou_xyxy(boxes + 4 * i, boxes + 4 * j) > iou_thresh)
        dead[j] = 1;
    }
  }
  return kept;
}

// ---------------------------------------------------------------------------
// COCO-eval inner loop: greedy match detections (pre-sorted by score desc)
// to GTs for T IoU thresholds at once.
//   iou:       [n_det, n_gt] row-major (precomputed)
//   gt_ignore: [n_gt] 0/1, gts sorted valid-first
//   thrs:      [T]
// Outputs (size T*n_det, row-major [T, n_det]): matched, ignored (0/1).
// Mirrors ops/map_metric.py::_evaluate_image_class's matching exactly.
// ---------------------------------------------------------------------------
void coco_match(const double* iou, int n_det, int n_gt,
                const uint8_t* gt_ignore, const double* thrs, int T,
                uint8_t* matched_out, uint8_t* ignored_out) {
  std::vector<char> gt_taken(n_gt);
  for (int t = 0; t < T; ++t) {
    std::fill(gt_taken.begin(), gt_taken.end(), 0);
    double thr = thrs[t];
    for (int d = 0; d < n_det; ++d) {
      double best = std::min(thr, 1.0 - 1e-10);
      int best_g = -1;
      for (int g = 0; g < n_gt; ++g) {
        if (gt_taken[g]) continue;
        if (best_g > -1 && !gt_ignore[best_g] && gt_ignore[g]) break;
        double v = iou[(size_t)d * n_gt + g];
        if (v < best) continue;
        best = v;
        best_g = g;
      }
      size_t idx = (size_t)t * n_det + d;
      if (best_g == -1) { matched_out[idx] = 0; ignored_out[idx] = 0; continue; }
      gt_taken[best_g] = 1;
      matched_out[idx] = 1;
      ignored_out[idx] = gt_ignore[best_g];
    }
  }
}

}  // extern "C"
