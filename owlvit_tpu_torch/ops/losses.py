"""PushPull detection loss (counterpart of owlvit_tpu/ops/losses.py: `_bce`,
`_focal_mod`, `_propagate_labels`, `push_pull_loss`, `total_loss`).

Batched: every image is matched on the predictions' device (ops/matcher.py;
on the card the assignment kernel) and the four terms reduce over the
batch:

  loss_ce   BCE(|sims|, one-hot) on foreground patches, per-class weights,
            focal modulation (1 - e^-l)^2 * l, summed over classes, mean
            over foreground patches
  loss_bg   the same against zeros on background patches
  loss_bbox L1 over matched pairs / num_boxes
  loss_giou 1 - GIoU over matched pairs / num_boxes

The reference's quirks are kept: BCE on |cosine sims| (#2), the sequential
IoU > 0.85 label propagation after matching (#7), background id = n_classes
(#13), and the JAX package's clamp of |sims| to [0, 1] before the logs. The
propagation runs on the predictions' device as well: `propagate_labels`
launches the kernel of csrc/matcher.cu on a CUDA tensor and runs the host
walk `_propagate_labels`, its plain version, on a CPU one. The step reads
nothing back to the host; the four terms are torch on the predictions'
device and carry the gradient.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from owlvit_tpu_torch.parallel.sharding import all_reduce_sum_

from . import boxes as box_ops
from . import matcher
from ._cuda import launch

_LOG_CLAMP = -100.0  # torch BCELoss clamps log terms at -100


def _bce(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    log_x = torch.log(x).clamp(min=_LOG_CLAMP)
    log_1mx = torch.log1p(-x).clamp(min=_LOG_CLAMP)
    return -(target * log_x + (1.0 - target) * log_1mx)


def _focal_mod(loss: torch.Tensor) -> torch.Tensor:
    """The reference's modulation: (1 - e^{-l})^2 * l."""
    return torch.square(1.0 - torch.exp(-loss)) * loss


def _iou_above_row(box: np.ndarray, boxes: np.ndarray, threshold: float) -> np.ndarray:
    """Row j of pairwise_iou_above(boxes, boxes, t) in fp32 numpy, with the
    same operations: inter > t * union & union > 0."""
    area1 = (box[2] - box[0]) * (box[3] - box[1])
    area2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iw = np.maximum(np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]),
                    np.float32(0))
    ih = np.maximum(np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]),
                    np.float32(0))
    inter = iw * ih
    union = area1 + area2 - inter
    return (inter > np.float32(threshold) * union) & (union > 0)


def _propagate_labels(pred_boxes: np.ndarray, target_classes: np.ndarray,
                      n_classes: int, iou_threshold: float,
                      counts: Optional[list] = None) -> np.ndarray:
    """Sequential IoU > threshold label propagation of one image, on the
    host: pred_boxes [P, 4] float32, target_classes [P] -> [P].

    One sweep over the patches in index order; at its turn a foreground
    patch gives its label to every patch it overlaps by more than the
    threshold, and a patch relabelled earlier in the sweep propagates in
    turn (chaining). A patch that is background at its turn changes
    nothing, so only foreground turns are computed: the result equals the
    full [P, P] sweep. counts, if given, gets the number of foreground turns
    appended (the kernel's sequential depth)."""
    boxes = np.asarray(pred_boxes, np.float32)
    tc = np.array(target_classes, np.int32)
    pending = sorted(np.flatnonzero(tc != n_classes).tolist())
    k = 0
    while k < len(pending):
        j = pending[k]
        k += 1
        take = _iou_above_row(boxes[j], boxes, iou_threshold)
        new = np.flatnonzero(take & (tc == n_classes))
        tc[take] = tc[j]
        later = new[new > j].tolist()
        if later:  # patches that become foreground after j take their turn later
            pending = pending[:k] + sorted(set(pending[k:]) | set(later))
    if counts is not None:
        counts.append(len(pending))
    return tc


def propagate_labels(pred_boxes: torch.Tensor, target_classes: torch.Tensor,
                     n_classes: int, iou_threshold: float) -> torch.Tensor:
    """The sequential IoU > threshold label propagation of every image:
    pred_boxes [B, P, 4] xyxy, target_classes [B, P] -> [B, P] int64 on
    their device. CPU tensors run `_propagate_labels` per image; CUDA
    tensors the kernel (counted in `propagate_labels.launches`; P <=
    matcher.KERNEL_MAX_COLUMNS), the same classes bit for bit, on the
    current stream with no host read."""
    B, P = target_classes.shape
    if pred_boxes.shape != (B, P, 4):
        raise ValueError(f"propagate_labels takes boxes [B, P, 4] and classes [B, P], "
                         f"got {tuple(pred_boxes.shape)} and {tuple(target_classes.shape)}")
    if pred_boxes.device.type == "cpu":
        boxes = pred_boxes.detach().float().numpy()
        tc = target_classes.numpy()
        return torch.from_numpy(np.stack([
            _propagate_labels(boxes[b], tc[b], n_classes, iou_threshold)
            for b in range(B)]).reshape(B, P).astype(np.int64))
    if pred_boxes.device.type != "cuda" or target_classes.device != pred_boxes.device:
        raise ValueError(f"propagate_labels runs on cpu or cuda tensors on one device, "
                         f"got {pred_boxes.device} and {target_classes.device}")
    if P > matcher.KERNEL_MAX_COLUMNS:
        raise ValueError(f"propagate_labels on the card takes at most "
                         f"{matcher.KERNEL_MAX_COLUMNS} patches, got {P}")
    out = torch.empty((B, P), dtype=torch.long, device=pred_boxes.device)
    if B and P:
        bx = pred_boxes.detach().float().contiguous()
        if bx.data_ptr() % 16:  # the kernel loads each box as one float4
            bx = bx.clone()
        tc = target_classes.long().contiguous()
        launch("owlvit_propagate_labels", pred_boxes.device, bx.data_ptr(), tc.data_ptr(),
               out.data_ptr(), B, P, n_classes, float(iou_threshold))
        propagate_labels.launches += 1
    return out


propagate_labels.launches = 0


def push_pull_loss(pred_sims: torch.Tensor, pred_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_mask: torch.Tensor, n_classes: int,
                   class_weights: Optional[torch.Tensor] = None, *,
                   iou_propagation_threshold: float = 0.85,
                   mark: Optional[Callable[[str], None]] = None,
                   data_group=None) -> dict:
    """Batched detection loss.

    pred_sims [B, P, C] raw query-bank similarities; pred_boxes [B, P, 4]
    xyxy in [0, 1]; gt_labels [B, G] int; gt_boxes [B, G, 4] xyxy; gt_mask
    [B, G] bool; class_weights [C] or None. All on one device, which runs
    every part, the matching and the propagation included: nothing is read
    back to the host. Returns dict(loss_ce, loss_bg, loss_bbox, loss_giou)
    of fp32 scalars. mark, if given, is called as the cost matrix
    ("cost"), the assignment and the propagation ("match") and the loss
    terms ("loss") are issued.

    data_group: on a mesh, the "data" process group when this rank holds
    B / dp images of a global batch. The normalisers (num_boxes, n_fg,
    n_bg) are then summed over the group (no gradient), as the JAX package
    counts them over the global batch, and each term is dp times this
    rank's share of the global term: their mean over the group (the
    trainer's gradient average) is the global term and its gradient."""
    B, P, C = pred_sims.shape
    sims = pred_sims.float()
    boxes = pred_boxes.float()
    dev = boxes.device

    cost = matcher.cost_matrix(sims, boxes, gt_labels, gt_boxes, gt_mask)
    if mark:
        mark("cost")
    assigned, target = matcher.assign(cost, gt_labels, gt_mask, n_classes)
    tc = propagate_labels(boxes, target, n_classes, iou_propagation_threshold)
    # an invalid GT row gathers patch P - 1, as JAX's take_along_axis reads
    # index -1; the mask drops it
    idx = torch.where(assigned < 0, P - 1, assigned)
    if mark:
        mark("match")

    mask = gt_mask.bool()
    gt_boxes = gt_boxes.float()
    src = torch.gather(boxes, 1, idx[..., None].expand(B, idx.shape[1], 4))
    fg = tc != n_classes
    counts = torch.stack([mask.sum(), fg.sum(), (~fg).sum()]).float()
    share = 1.0
    if data_group is not None:
        all_reduce_sum_(counts, data_group)
        share = float(dist.get_world_size(data_group))
    num_boxes, n_fg, n_bg = counts.clamp(min=1).unbind()
    l1 = (src - gt_boxes).abs().sum(-1)
    zero = torch.zeros((), device=dev)
    loss_bbox = share * torch.where(mask, l1, zero).sum() / num_boxes
    giou = box_ops.elementwise_giou(src, gt_boxes)
    loss_giou = share * torch.where(mask, 1.0 - giou, zero).sum() / num_boxes

    x = sims.abs()
    onehot = F.one_hot(tc, n_classes + 1)[..., :n_classes].float()  # bg -> 0s
    bce_fg = _bce(x, onehot)
    bce_bg = _bce(x, torch.zeros_like(x))
    if class_weights is not None:
        w = class_weights.float()
        bce_fg = bce_fg * w
        bce_bg = bce_bg * w
    per_patch_fg = _focal_mod(bce_fg).sum(-1)
    per_patch_bg = _focal_mod(bce_bg).sum(-1)
    terms = {
        "loss_ce": share * torch.where(fg, per_patch_fg, zero).sum() / n_fg,
        "loss_bg": share * torch.where(~fg, per_patch_bg, zero).sum() / n_bg,
        "loss_bbox": loss_bbox,
        "loss_giou": loss_giou,
    }
    if mark:
        mark("loss")
    return terms


def total_loss(losses: dict) -> torch.Tensor:
    """Unweighted sum, as the reference's training loop does."""
    return (losses["loss_ce"] + losses["loss_bg"] + losses["loss_bbox"]
            + losses["loss_giou"])
