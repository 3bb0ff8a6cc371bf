"""What the detection drivers (bulk, serve) share: the program's server
from the seed's weights, and the comparison of served rows with the
reference, with the control's and the faults' readings."""

from __future__ import annotations

import numpy as np
import torch

from gpubench import common
from gpubench.drivers import program
from gpubench.reference import detect


def server(spec: dict, seed: int, device, **kw):
    from owlvit_tpu_torch.serve import DetectorServer

    c, t = spec["config"], spec["traffic"]
    cfg = program.config(c)
    W = common.make_weights(c, seed, device)
    model = program.model(c, cfg, W, device)
    del W
    return DetectorServer(model, cfg, buckets=tuple(t["buckets"]),
                          confidence_threshold=t["confidence"], iou_threshold=t["iou"],
                          top_k=t["top_k"], device=device, **kw)


def _reference_outputs(spec, seed, device, images: np.ndarray, precision="fp32"):
    """(boxes, sims) numpy of the reference over uint8 [N, S, S, 3] host images."""
    c = spec["config"]
    W = common.make_weights(c, seed, device)
    ref = common.reference(c).Model(W, c, precision)
    boxes, sims = ref.detect(torch.from_numpy(images).to(device))
    return boxes.cpu().numpy(), sims.cpu().numpy()


def _judge(spec, rows, boxes, sims, sims_bf16, at, every) -> dict:
    """The comparison's numbers of rows (for the images of the reference's
    outputs boxes, sims at positions `at`) and, over every served image
    (`every`: (position, row)), nms_class_gap."""
    t, side = spec["traffic"], spec["config"]["image_size"]
    args = (side, t["confidence"], t["iou"], t["top_k"])
    out = detect.compare(rows, boxes[at], sims[at], sims_bf16, *args)
    pos = [k for k, _ in every]
    out["nms_class_gap"] = detect.class_gap([r for _, r in every], boxes[pos], sims[pos], *args)
    return out


def check(spec: dict, seed: int, device, pool: np.ndarray, served: list, every: list) -> dict:
    """served: the sample [(index into pool, row)] the numbers read; every:
    [(index into pool, row)] of each image the window served, which
    nms_class_gap reads -> the comparison's numbers, the reference run once
    over each image in float32, and over the sample's in bf16."""
    idx = sorted({i for i, _ in served} | {i for i, _ in every})
    at = {i: k for k, i in enumerate(idx)}
    boxes, sims = _reference_outputs(spec, seed, device, pool[idx])
    few = sorted({i for i, _ in served})
    s16 = _reference_outputs(spec, seed, device, pool[few], "bf16")[1]
    s16 = s16[[few.index(i) for i, _ in served]]
    return _judge(spec, [r for _, r in served], boxes, sims, s16, [at[i] for i, _ in served],
                  [(at[i], r) for i, r in every])


def control(spec: dict, seed: int, device, pool: np.ndarray, idx: list) -> dict:
    """Readings against the reference of: the control (the reference in
    fp8 in the program's place), half of every batch of 8 left out (no
    detections), an answer altered where it is produced (the best detection
    of every image given the next class), NMS that suppresses nothing and
    NMS across classes, and the reference's own NMS (reads 0). Each is
    served for the whole pool: the numbers read pool[idx], nms_class_gap
    every image."""
    t = spec["traffic"]
    side = spec["config"]["image_size"]
    boxes, sims = _reference_outputs(spec, seed, device, pool)
    s16 = _reference_outputs(spec, seed, device, pool[idx], "bf16")[1]
    b8, s8 = _reference_outputs(spec, seed, device, pool, "fp8")

    def nms(b, s, rule="class_aware"):
        return detect.nms_rows(b, s, side, t["confidence"], t["iou"], t["top_k"], rule)

    served = nms(boxes, sims)
    empty = {"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
             "classes": np.zeros(0, np.int32)}
    half = [empty if i % 8 >= 4 else r for i, r in enumerate(served)]
    altered = []
    for r in served:
        r = {k: v.copy() for k, v in r.items()}
        r["classes"][:1] = (r["classes"][:1] + 1) % sims.shape[-1]
        altered.append(r)
    rows = {"control_fp8": nms(b8, s8), "fault_half_batch": half,
            "fault_altered_answer": altered, "fault_nms_none": nms(boxes, sims, "none"),
            "fault_nms_class_agnostic": nms(boxes, sims, "class_agnostic"),
            "reference_nms_itself": served}
    out = {k: {"numbers": _judge(spec, [r[i] for i in idx], boxes, sims, s16, idx,
                                 list(enumerate(r)))}
           for k, r in rows.items()}
    out["reference_nms_itself"]["suppressed_per_image"] = detect.suppressed(served, sims,
                                                                        t["confidence"], t["top_k"])
    return out
