"""Box geometry of the serving and training paths (counterpart of
owlvit_tpu/ops/boxes.py: `area`, `cxcywh_to_xyxy`, `pairwise_iou`,
`pairwise_iou_above`, `pairwise_giou`, `elementwise_iou`,
`elementwise_giou`). Box layout is the last axis of size 4; leading axes are
batch axes."""

from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; [..., 4] -> [...]."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU of xyxy boxes: [..., N, 4] x [..., M, 4] ->
    (iou [..., N, M], union [..., N, M])."""
    area1 = area(boxes1)
    area2 = area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union, union


def pairwise_iou_above(boxes1: torch.Tensor, boxes2: torch.Tensor,
                       threshold: float) -> torch.Tensor:
    """Pairwise predicate IoU > threshold: [..., N, 4] x [..., M, 4] ->
    bool [..., N, M].

    Computed as `inter > threshold * union & union > 0`, literally as the JAX
    package does: divide-then-compare can flip by one ulp for an IoU exactly
    at the threshold, and the union > 0 guard keeps degenerate boxes from
    comparing true."""
    area1 = area(boxes1)
    area2 = area(boxes2)
    iw = (torch.minimum(boxes1[..., :, None, 2], boxes2[..., None, :, 2])
          - torch.maximum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
          ).clamp(min=0.0)
    ih = (torch.minimum(boxes1[..., :, None, 3], boxes2[..., None, :, 3])
          - torch.maximum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
          ).clamp(min=0.0)
    inter = iw * ih
    union = area1[..., :, None] + area2[..., None, :] - inter
    return (inter > threshold * union) & (union > 0)


def pairwise_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise generalized IoU of xyxy boxes: [..., N, M]. Boxes must be
    non-degenerate (x1 >= x0, y1 >= y0), as sigmoid'd cxcywh boxes are."""
    iou, union = pairwise_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull


def _aligned_inter_union(boxes1, boxes2):
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, area(boxes1) + area(boxes2) - inter


def elementwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of aligned box pairs: [..., 4] x [..., 4] -> [...]."""
    inter, union = _aligned_inter_union(boxes1, boxes2)
    return inter / union


def elementwise_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned box pairs: [..., 4] x [..., 4] -> [...] (the diagonal
    of pairwise_giou without the N^2 work)."""
    inter, union = _aligned_inter_union(boxes1, boxes2)
    iou = inter / union
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull
