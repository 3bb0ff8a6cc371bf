"""Host-side COCO-style mean-average-precision (bbox), numpy.

Replaces the reference's torchmetrics `MeanAveragePrecision(iou_type="bbox",
class_metrics=True)` (main.py:31,144; update at
src/train_util.py:37-64). Protocol follows the COCO standard
that torchmetrics/pycocotools implement:

  * IoU thresholds 0.50:0.05:0.95 (10), AP at 101 recall points
  * area buckets: small < 32^2 <= medium < 96^2 <= large (absolute pixels^2)
  * max detections 1 / 10 / 100
  * greedy per-image-per-class matching in descending score order; each
    detection takes the still-unmatched GT with the highest IoU above the
    threshold; out-of-area GTs are ignore-matched, and unmatched detections
    outside the area range are ignored rather than counted as FP

Metric accumulation runs on host (this is an eval-epoch reduction, not a hot
op); boxes arrive in absolute pixel coordinates xyxy.

The port's copy of owlvit_tpu/ops/map_metric.py, its native fast path
pointed at the port's copy of native/; tests/test_torch_map.py holds it
equal.
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)  # 10 thresholds
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / union, 0.0)


def _box_area(b: np.ndarray) -> np.ndarray:
    return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])


class MeanAveragePrecision:
    """Accumulate (preds, targets) per image; compute() -> metric dict.

    update() args per image:
      pred_boxes [D, 4] xyxy abs px, pred_scores [D], pred_labels [D] int
      gt_boxes [G, 4] xyxy abs px, gt_labels [G] int
    """

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self._images = []

    def update(self, pred_boxes, pred_scores, pred_labels, gt_boxes, gt_labels):
        self._images.append(
            (
                np.asarray(pred_boxes, np.float64).reshape(-1, 4),
                np.asarray(pred_scores, np.float64).reshape(-1),
                np.asarray(pred_labels, np.int64).reshape(-1),
                np.asarray(gt_boxes, np.float64).reshape(-1, 4),
                np.asarray(gt_labels, np.int64).reshape(-1),
            )
        )

    # -- core matching ------------------------------------------------------

    def _image_class_data(self, img, cls):
        """Per-(image, class) work shared by every (area, maxDet) cell:
        subset + score-sort detections (capped at max(MAX_DETS) — greedy
        matching is prefix-stable, see _accumulate), subset GT, ONE IoU
        matrix. The r2 version recomputed this 12x per (image, class)."""
        pb, ps, pl, gb, gl = img
        dm = pl == cls
        gm = gl == cls
        det_boxes, det_scores = pb[dm], ps[dm]
        gt = gb[gm]

        order = np.argsort(-det_scores, kind="stable")[: max(MAX_DETS)]
        det_boxes, det_scores = det_boxes[order], det_scores[order]
        return (
            det_scores,
            _iou_matrix(det_boxes, gt),
            _box_area(det_boxes),
            _box_area(gt),
        )

    @staticmethod
    def _py_match(iou, g_ignore):
        """Greedy per-threshold matching (reference protocol), python
        fallback when the native library is unavailable."""
        T = len(IOU_THRS)
        D, G = iou.shape
        matched = np.zeros((T, D), bool)
        ignored = np.zeros((T, D), bool)
        gt_taken = np.zeros((T, G), bool)
        for ti, thr in enumerate(IOU_THRS):
            for d in range(D):
                best, best_g = min(thr, 1 - 1e-10), -1
                for g in range(G):
                    if gt_taken[ti, g]:
                        continue
                    # once we hit ignored GTs, stop unless still unmatched:
                    if best_g > -1 and not g_ignore[best_g] and g_ignore[g]:
                        break
                    if iou[d, g] < best:
                        continue
                    best, best_g = iou[d, g], g
                if best_g == -1:
                    continue
                gt_taken[ti, best_g] = True
                matched[ti, d] = True
                ignored[ti, d] = g_ignore[best_g]
        return matched, ignored

    def _match_class_area(self, data, area_rng):
        """One (image, class, area) match at maxDet = max(MAX_DETS); smaller
        maxDets are derived by truncation in _accumulate. Returns
        (det_scores, matched [T, D], ignored [T, D], n_valid_gt)."""
        det_scores, iou, d_area, g_area = data
        # pycocotools bounds are inclusive on BOTH ends: ignore iff
        # area < lo or area > hi (an exactly-32^2 box counts in small AND
        # medium). Using >= hi here diverged at exact bucket boundaries.
        g_ignore = (g_area < area_rng[0]) | (g_area > area_rng[1])
        # sort GT: valid first (pycocotools processes ignores last)
        g_order = np.argsort(g_ignore, kind="stable")
        g_ignore = g_ignore[g_order]

        T = len(IOU_THRS)
        D, G = iou.shape
        if D and G:
            iou_s = np.ascontiguousarray(iou[:, g_order])
            # C++ fast path (owlvit_tpu_torch/native): same greedy matching.
            from owlvit_tpu_torch import native

            nm = native.coco_match(iou_s, g_ignore, IOU_THRS)
            matched, ignored = (
                nm if nm is not None else self._py_match(iou_s, g_ignore)
            )
        else:
            matched = np.zeros((T, D), bool)
            ignored = np.zeros((T, D), bool)

        # unmatched detections outside the area range are ignored
        d_out = (d_area < area_rng[0]) | (d_area > area_rng[1])
        ignored = ignored | (~matched & d_out[None, :])
        return det_scores, matched, ignored, int((~g_ignore).sum())

    def _evaluate_image_class(self, img, cls, area_rng, max_det):
        """One (image, class, area, maxDet) cell across all IoU thresholds
        (kept for tests/diagnostics; _accumulate shares the per-class work)."""
        s, mt, ig, ng = self._match_class_area(
            self._image_class_data(img, cls), area_rng
        )
        return s[:max_det], mt[:, :max_det], ig[:, :max_det], ng

    def _accumulate(self):
        """-> precision [T, R, K, A, M], recall [T, K, A, M] (-1 = no GT).

        Shapes the work so nothing is recomputed across cells: the IoU
        matrix and detection sort are per (image, class); the greedy match
        is per (image, class, area) at maxDet=100 — maxDets 1/10 fall out
        by truncating its results, exactly as pycocotools slices
        dtm[:, :maxDet] (greedy matching processes detections in descending
        score order, so the first m outcomes never depend on later
        detections). The r2 version re-walked every image 12x per class;
        at the reference recipe shape (80 classes x 100 images x 200 dets)
        that was ~12 s per eval epoch — comparable to a whole cached
        training epoch.
        """
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = self.num_classes, len(AREA_RANGES), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k in range(K):
            datas = [self._image_class_data(img, k) for img in self._images]
            for a, rng in enumerate(AREA_RANGES.values()):
                evals = [self._match_class_area(d, rng) for d in datas]
                n_gt = sum(e[3] for e in evals)
                if n_gt == 0:
                    continue
                for m, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate([e[0][:max_det] for e in evals])
                    matches = np.concatenate(
                        [e[1][:, :max_det] for e in evals], axis=1
                    )  # [T, D_total]
                    ignores = np.concatenate(
                        [e[2][:, :max_det] for e in evals], axis=1
                    )
                    order = np.argsort(-scores, kind="mergesort")
                    matches, ignores = matches[:, order], ignores[:, order]

                    keep = ~ignores
                    for ti in range(T):
                        mt = matches[ti][keep[ti]]
                        tp = np.cumsum(mt)
                        fp = np.cumsum(~mt)
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        recall[ti, k, a, m] = rc[-1] if len(rc) else 0.0
                        # monotone non-increasing precision envelope
                        if len(pr):
                            pr = np.maximum.accumulate(pr[::-1])[::-1]
                        idx = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        ok = idx < len(pr)
                        q[ok] = pr[idx[ok]]
                        precision[ti, :, k, a, m] = q
        return precision, recall

    def compute(self) -> dict:
        precision, recall = self._accumulate()

        def _mean(x):
            x = x[x > -1]
            return float(x.mean()) if x.size else -1.0

        a_all = list(AREA_RANGES).index("all")
        m100 = MAX_DETS.index(100)
        t50 = int(np.argwhere(IOU_THRS == 0.5)[0, 0])
        t75 = int(np.argwhere(IOU_THRS == 0.75)[0, 0])

        out = {
            "map": _mean(precision[:, :, :, a_all, m100]),
            "map_50": _mean(precision[t50, :, :, a_all, m100]),
            "map_75": _mean(precision[t75, :, :, a_all, m100]),
            "mar_1": _mean(recall[:, :, a_all, 0]),
            "mar_10": _mean(recall[:, :, a_all, 1]),
            "mar_100": _mean(recall[:, :, a_all, m100]),
        }
        for name in ("small", "medium", "large"):
            ai = list(AREA_RANGES).index(name)
            out[f"map_{name}"] = _mean(precision[:, :, :, ai, m100])
            out[f"mar_{name}"] = _mean(recall[:, :, ai, m100])

        out["map_per_class"] = np.array(
            [_mean(precision[:, :, k, a_all, m100]) for k in range(self.num_classes)]
        )
        out["mar_100_per_class"] = np.array(
            [_mean(recall[:, k, a_all, m100]) for k in range(self.num_classes)]
        )
        return out
