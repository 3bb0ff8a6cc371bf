"""Fixed-shape NMS and detection post-processing (counterpart of
owlvit_tpu/ops/nms.py: `nms`, `batched_nms`, `postprocess`,
`pack_detections`).

Greedy suppression over `max_outputs` slots with validity carried as a mask:
each step takes the argmax of the live scores and kills it and everything it
overlaps above the threshold. The batch dimension is written out (the JAX
package vmaps one image), and the loop issues device work only: no value
crosses to the host inside it.
"""

from __future__ import annotations

import torch

from . import boxes as box_ops


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_outputs: int):
    """Greedy NMS per image. boxes [B, N, 4] xyxy, scores [B, N] (-inf = dead).

    Returns (keep_idx [B, max_outputs] int32, keep_valid [B, max_outputs]
    bool) in descending score order; suppression is IoU strictly above the
    threshold (torchvision's rule). Ties go to the lower index."""
    B, N = scores.shape
    above = box_ops.pairwise_iou_above(boxes, boxes, iou_threshold)  # [B, N, N]
    rows = torch.arange(B, device=boxes.device)
    cols = torch.arange(N, device=boxes.device)
    live = scores.float().clone()
    idx, valid = [], []
    for _ in range(max_outputs):
        j = torch.argmax(live, dim=1)  # first maximal index
        ok = live[rows, j] > float("-inf")
        suppress = above[rows, j] | (cols[None, :] == j[:, None])
        live = live.masked_fill(ok[:, None] & suppress, float("-inf"))
        idx.append(torch.where(ok, j, -1))
        valid.append(ok)
    return torch.stack(idx, dim=1).int(), torch.stack(valid, dim=1)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_threshold: float, max_outputs: int):
    """Class-aware NMS (torchvision batched_nms semantics), [B, N] per image.

    Each class is shifted into its own coordinate range; the span is taken
    per image, as the JAX package's per-image vmap does."""
    span = boxes.amax(dim=(1, 2)) - boxes.amin(dim=(1, 2)) + 1.0  # [B]
    offset = classes.float() * span[:, None]
    return nms(boxes + offset[..., None], scores, iou_threshold, max_outputs)


def postprocess(pred_boxes: torch.Tensor, pred_sims: torch.Tensor, *,
                confidence_threshold: float = 0.01, iou_threshold: float = 0.6,
                top_k: int = 200) -> dict:
    """pred_boxes [B, P, 4] xyxy, pred_sims [B, P, C] ->
    dict(boxes [B, K, 4], classes [B, K], scores [B, K], valid [B, K]).

    Per image: per-patch max over classes, confidence filter, class-aware
    NMS; survivors come out score-descending, so the first K are the top K."""
    boxes = pred_boxes.float()
    scores = pred_sims.amax(dim=-1)
    classes = torch.argmax(pred_sims, dim=-1).int()
    scores = torch.where(scores > confidence_threshold, scores,
                         torch.full_like(scores, float("-inf")))
    keep_idx, keep_valid = batched_nms(boxes, scores, classes, iou_threshold,
                                       top_k)
    idx = keep_idx.long().clamp(min=0)
    return {
        "boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        * keep_valid[..., None],
        "classes": torch.where(keep_valid, torch.gather(classes, 1, idx), -1),
        "scores": torch.where(keep_valid, torch.gather(scores, 1, idx), 0.0),
        "valid": keep_valid,
    }


def pack_detections(out: dict) -> torch.Tensor:
    """postprocess() output -> one [B, K, 7] fp32 tensor (xyxy boxes, score,
    class id, 0/1 valid flag): the layout every unpack site reads."""
    return torch.cat([
        out["boxes"],
        out["scores"][..., None],
        out["classes"].float()[..., None],
        out["valid"].float()[..., None],
    ], dim=-1)
