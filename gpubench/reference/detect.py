"""Detections judged against the plain reference: greedy class-aware NMS of
the reference's own boxes and scores (the control's served rows), and the
comparison of served rows with the reference's boxes and similarities.

A served row is {"boxes": [n, 4] xyxy in the image's pixels, "scores":
[n], "classes": [n]}, in the order served (score descending). Served
detections carry no patch index, so each is matched to the reference patch
nearest to it in box and score together: the box's distance (the largest
of the four coordinates' differences, in units of the image side) plus the
distance of the served score from the reference's similarity of that patch
and the served class. Two patches may predict boxes closer to each other
than a rounding moves them (random weights put the boxes of neighbouring
cells anywhere near each other), and the score tells them apart. The
comparison then reads:

  score_gap        the largest, over served detections, of the served
                   score's distance from the reference's similarity of that
                   patch and class, and of the margin by which the reference
                   ranks another class of that patch above the served one;
  box_gap          the largest distance (in units of the image side) of a
                   served box from its patch's reference box;
  score_rms_ratio  the root mean square, over every served detection, of
                   the served score's distance from the reference's
                   similarity, over that of the reference computed in
                   bfloat16 at the same patches and classes (a per-element
                   number: about 1 where the program rounds as bf16 does,
                   steady from seed to seed);
  rank_gap         the largest margin by which a reference candidate (a
                   patch whose best similarity passes the confidence
                   threshold) that was not served, and that no served box of
                   its class overlaps by more than the IoU threshold less
                   IOU_MARGIN, outscores the last served detection (the
                   threshold itself when fewer than top_k were served): what
                   greedy class-aware NMS should have kept and did not;
  nms_overlap_gap  the largest IoU of two served detections of one class,
                   less the IoU threshold (0 where none passes it): what
                   greedy NMS should have suppressed and did not;
  nms_class_gap    the share of the pairs of detections of different
                   classes overlapping past the IoU threshold in the
                   reference's own NMS rows that the served rows lack (0
                   where the reference has none): class-aware NMS keeps
                   such pairs, NMS across classes never does.

All are 0 for rows that equal the reference's; rounding moves them by the
rounding of a score or a box, a missing, unsuppressed or altered row by its
size.
"""

from __future__ import annotations

import numpy as np

# room under the IoU threshold within which a served box counts as the
# suppressor of a candidate: a box rounded on one side of the threshold
# suppresses a neighbour the other side keeps
IOU_MARGIN = 0.05


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[n, 4] x [m, 4] xyxy -> [n, m]."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def nms_rows(boxes: np.ndarray, sims: np.ndarray, side: float, confidence: float,
             iou: float, top_k: int, rule: str = "class_aware") -> list:
    """Served rows of greedy NMS over each image's patches: boxes [N, P, 4]
    in [0, 1], sims [N, P, C] -> N rows, boxes in pixels of an image of
    `side`. rule "class_aware" is the served protocol; "class_agnostic"
    (a box suppresses every class) and "none" (nothing suppressed) are the
    faults the comparison has to catch."""
    rows = []
    for bx, sm in zip(boxes.astype(np.float64), sims.astype(np.float64)):
        score, cls = sm.max(-1), sm.argmax(-1)
        alive = np.flatnonzero(score > confidence)
        alive = alive[np.argsort(-score[alive], kind="stable")]
        keep = []
        while alive.size and len(keep) < top_k:
            j = alive[0]
            keep.append(j)
            rest = alive[1:]
            over = _iou(bx[j][None], bx[rest])[0] > iou
            if rule == "class_aware":
                over &= cls[rest] == cls[j]
            elif rule == "none":
                over[:] = False
            alive = rest[~over]
        keep = np.asarray(keep, int)
        rows.append({"boxes": (bx[keep] * side).astype(np.float32),
                     "scores": score[keep].astype(np.float32),
                     "classes": cls[keep].astype(np.int32)})
    return rows


def suppressed(rows: list, sims: np.ndarray, confidence: float, top_k: int) -> float:
    """The mean number an image of candidates that NMS left out: of those
    that pass the confidence threshold, or outscore the last served
    detection where top_k were served, those not served (a reading of how
    much the traffic exercises NMS)."""
    n = []
    for row, sm in zip(rows, sims.astype(np.float64)):
        k = len(row["scores"])
        floor = float(row["scores"].min()) if k >= top_k else confidence
        n.append(int((sm.max(-1) > floor).sum()) + (k >= top_k) - k)
    return float(np.mean(n)) if n else 0.0


def _cross_pairs(row: dict, iou: float) -> int:
    """Pairs of a row's detections of different classes whose IoU passes
    the threshold."""
    b, c = np.asarray(row["boxes"], np.float64), np.asarray(row["classes"])
    return int((np.triu(_iou(b, b) > iou, 1) & (c[:, None] != c[None, :])).sum())


def compare(rows: list, boxes: np.ndarray, sims: np.ndarray, sims_bf16: np.ndarray,
            side: float, confidence: float, iou: float, top_k: int) -> dict:
    """rows[i] served for the image whose reference outputs are boxes[i]
    [P, 4] and sims[i] [P, C], and sims_bf16[i] the reference's
    similarities computed in bfloat16 -> the numbers of the module's
    docstring."""
    score_gap = box_gap = rank_gap = overlap_gap = 0.0
    sq, sq_bf16 = [], []
    for row, bx, sm, s16 in zip(rows, boxes.astype(np.float64), sims.astype(np.float64),
                                sims_bf16.astype(np.float64)):
        best, top = sm.max(-1), sm.argmax(-1)
        cand = np.flatnonzero(best > confidence)
        n = len(row["scores"])
        if n:
            sb = np.asarray(row["boxes"], np.float64) / side
            c = np.asarray(row["classes"], int)
            s = np.asarray(row["scores"], np.float64)
            dist = np.abs(sb[:, None, :] - bx[None, :, :]).max(-1)  # [n, P]
            p = (dist + np.abs(s[:, None] - sm[:, c].T)).argmin(1)
            box_gap = max(box_gap, float(dist[np.arange(n), p].max()))
            r = sm[p, c]
            score_gap = max(score_gap, float(np.maximum(np.abs(s - r), best[p] - r).max()))
            sq.append((s - r) ** 2)
            sq_bf16.append((s16[p, c] - r) ** 2)
            floor = r.min() if n >= top_k else confidence
            over = _iou(bx[cand], sb) > iou - IOU_MARGIN  # [cand, n]
            covered = np.isin(cand, p) | (over & (top[cand][:, None] == c[None, :])).any(1)
            pair = np.triu(_iou(sb, sb), 1) * (c[:, None] == c[None, :])
            overlap_gap = max(overlap_gap, float(pair.max()) - iou)
        else:
            floor, covered = confidence, np.zeros(cand.size, bool)
        if (~covered).any():
            rank_gap = max(rank_gap, float((best[cand[~covered]] - floor).max()))
    ref_pairs = sum(_cross_pairs(r, iou)
                    for r in nms_rows(boxes, sims, side, confidence, iou, top_k))
    served_pairs = sum(_cross_pairs(r, iou) for r in rows if len(r["scores"]))
    mean = lambda x: float(np.concatenate(x).mean()) if x else 0.0  # noqa: E731
    return {"score_gap": score_gap, "box_gap": box_gap,
            "score_rms_ratio": float(np.sqrt(mean(sq) / max(mean(sq_bf16), 1e-30))),
            "rank_gap": rank_gap, "nms_overlap_gap": max(overlap_gap, 0.0),
            "nms_class_gap": max(ref_pairs - served_pairs, 0) / max(ref_pairs, 1)}
