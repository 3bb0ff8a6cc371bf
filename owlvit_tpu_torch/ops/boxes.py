"""Box geometry used by the serving path (counterpart of
owlvit_tpu/ops/boxes.py: `area`, `cxcywh_to_xyxy`, `pairwise_iou_above`).
Box layout is the last axis of size 4; leading axes are batch axes."""

from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; [..., 4] -> [...]."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


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
