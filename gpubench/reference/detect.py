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
  nms_class_gap    the share of the reference's held pairs that the served
                   rows lack (0 where the reference has none), taken over
                   every image the window served (class_gap), not over the
                   sample the other numbers read: held pairs are few where
                   they are (none in most images, none at all in some
                   seeds' whole pool). A held pair is a pair of detections
                   of different classes in the reference's own NMS rows
                   whose boxes overlap past the IoU threshold by more than
                   IOU_MARGIN and whose scores each pass the row's floor by
                   more than SCORE_MARGIN, so that no rounding of a box or
                   a score takes it out (held_pairs); the served rows hold
                   a pair where they hold a detection of each one's patch
                   and class. Class-aware NMS keeps such pairs, NMS across
                   classes never does. Pairs at the top_k floor or at the
                   threshold come and go with a rounding, and where the
                   reference's rows hold no held pair but at least
                   MIN_PAIRS pairs past the threshold by IOU_MARGIN, served
                   rows that hold no pair of different classes overlapping
                   past the threshold at all read 1: a rounding takes some
                   such pairs out, NMS across classes every one.

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
# room over a row's floor within which a detection may leave the row by a
# rounding: the program's scores lie within ~0.0025 of the reference's, and
# the floor moves as much (PERF.md)
SCORE_MARGIN = 0.005
# the fewest reference pairs past the IoU threshold by IOU_MARGIN, at the
# floor or not, that a sound run cannot lose every one of: where it lost
# most, it kept 9 of 15 and 22 of 27 (PERF.md)
MIN_PAIRS = 8


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
                     "classes": cls[keep].astype(np.int32), "patches": keep})
    return rows


def held_pairs(row: dict, boxes: np.ndarray, confidence: float, iou: float, top_k: int) -> list:
    """The pairs of detections of different classes in a reference NMS row
    that no rounding of their own boxes or scores takes out: their boxes
    (boxes [P, 4], the image's reference boxes) overlap past the IoU
    threshold by more than IOU_MARGIN, and each scores above the row's
    floor (its last score where top_k were kept, else the threshold) by
    more than SCORE_MARGIN -> [((patch, class), (patch, class))]."""
    p, c, s = row["patches"], row["classes"], row["scores"].astype(np.float64)
    if len(p) < 2:
        return []
    floor = s.min() if len(p) >= top_k else confidence
    sure = s > floor + SCORE_MARGIN
    over = np.triu(_iou(boxes[p], boxes[p]) > iou + IOU_MARGIN, 1)
    a, b = np.nonzero(over & (c[:, None] != c[None, :]) & sure[:, None] & sure[None, :])
    return [((int(p[i]), int(c[i])), (int(p[j]), int(c[j]))) for i, j in zip(a, b)]


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


def _patches(row: dict, bx: np.ndarray, sm: np.ndarray, side: float) -> tuple:
    """The reference patch of each served detection of `row` (the nearest
    in box and score together; bx [P, 4], sm [P, C] float64) -> (patches,
    the detections' boxes in [0, 1] [n, 4], their distances [n, P])."""
    sb = np.asarray(row["boxes"], np.float64) / side
    c = np.asarray(row["classes"], int)
    s = np.asarray(row["scores"], np.float64)
    dist = np.abs(sb[:, None, :] - bx[None, :, :]).max(-1)  # [n, P]
    return (dist + np.abs(s[:, None] - sm[:, c].T)).argmin(1), sb, dist


def _cross_pairs(boxes: np.ndarray, classes: np.ndarray, iou: float) -> int:
    """Pairs of boxes [n, 4] of different classes whose IoU passes iou."""
    c = np.asarray(classes)
    return int((np.triu(_iou(boxes, boxes) > iou, 1) & (c[:, None] != c[None, :])).sum())


def class_gap(rows: list, boxes: np.ndarray, sims: np.ndarray, side: float,
              confidence: float, iou: float, top_k: int) -> float:
    """nms_class_gap of rows[i] served for the image whose reference outputs
    are boxes[i] [P, 4] and sims[i] [P, C]: the share of the reference's
    held pairs whose two detections the served rows do not both hold; where
    the reference holds none, 1 if it holds MIN_PAIRS pairs past the
    threshold by IOU_MARGIN and the served rows not one past it."""
    ref = nms_rows(boxes, sims, side, confidence, iou, top_k)
    held = lost = near = served = 0
    for row, r, bx, sm in zip(rows, ref, boxes.astype(np.float64), sims.astype(np.float64)):
        near += _cross_pairs(bx[r["patches"]], r["classes"], iou + IOU_MARGIN)
        served += _cross_pairs(np.asarray(row["boxes"], np.float64) / side,
                               np.asarray(row["classes"]), iou)
        pairs = held_pairs(r, bx, confidence, iou, top_k)
        if not pairs:
            continue
        have = set()
        if len(row["scores"]):
            p = _patches(row, bx, sm, side)[0]
            have = set(zip(p.tolist(), np.asarray(row["classes"], int).tolist()))
        held += len(pairs)
        lost += sum(a not in have or b not in have for a, b in pairs)
    if not held:
        return float(near >= MIN_PAIRS and not served)
    return lost / held


def compare(rows: list, boxes: np.ndarray, sims: np.ndarray, sims_bf16: np.ndarray,
            side: float, confidence: float, iou: float, top_k: int) -> dict:
    """rows[i] served for the image whose reference outputs are boxes[i]
    [P, 4] and sims[i] [P, C], and sims_bf16[i] the reference's
    similarities computed in bfloat16 -> the numbers of the module's
    docstring but nms_class_gap (class_gap)."""
    score_gap = box_gap = rank_gap = overlap_gap = 0.0
    sq, sq_bf16 = [], []
    for row, bx, sm, s16 in zip(rows, boxes.astype(np.float64), sims.astype(np.float64),
                                sims_bf16.astype(np.float64)):
        best, top = sm.max(-1), sm.argmax(-1)
        cand = np.flatnonzero(best > confidence)
        n = len(row["scores"])
        if n:
            p, sb, dist = _patches(row, bx, sm, side)
            c = np.asarray(row["classes"], int)
            s = np.asarray(row["scores"], np.float64)
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
    mean = lambda x: float(np.concatenate(x).mean()) if x else 0.0  # noqa: E731
    return {"score_gap": score_gap, "box_gap": box_gap,
            "score_rms_ratio": float(np.sqrt(mean(sq) / max(mean(sq_bf16), 1e-30))),
            "rank_gap": rank_gap, "nms_overlap_gap": max(overlap_gap, 0.0)}
