"""Hungarian matching (counterpart of owlvit_tpu/ops/matcher.py: `hungarian`,
`cost_matrix`, `match`).

The DETR matching cost is computed on the device in torch, batched to
[B, G, P]. The assignment is solved on the host: `hungarian` is a numpy port
of the JAX package's Jonker-Volgenant solver itself (not scipy's
linear_sum_assignment, which breaks ties differently), so the assignment
equals the JAX one, ties included. Like the vmapped JAX solver, it runs the
images of a batch in lockstep: Python loops once per Dijkstra step, not once
per image.

`solve` reads the cost tensor (and the predicted boxes, for the label
propagation that follows it) from the device in one copy. That read is the
train step's one synchronisation before the backward; the reference solves on
the host too. `hungarian_pruned` (off by default in the JAX package) is not
ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import boxes as box_ops


def hungarian(cost: np.ndarray, row_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Min-cost assignment of cost [R, C] or [B, R, C] (R <= C), float32.

    Returns col4row [R] or [B, R] int32: the column of each row, -1 for rows
    that row_mask [R] / [B, R] marks False (they are skipped, which is
    solving the valid-row submatrix). Step for step the JAX solver: rows in
    order, one Dijkstra per row over all columns, the fp32 expression
    `min_val + cost[i] - u[i] - v` evaluated in that order, the strict
    `d < shortest`, argmin's first index, then the dual updates and the
    augmentation along the alternating path."""
    cost = np.asarray(cost, np.float32)
    single = cost.ndim == 2
    if single:
        cost = cost[None]
    nb, R, C = cost.shape
    if R > C:
        raise ValueError(f"hungarian requires rows <= cols, got {cost.shape[-2:]}")
    mask = (np.ones((nb, R), bool) if row_mask is None
            else np.asarray(row_mask, bool).reshape(nb, R))
    u = np.zeros((nb, R), np.float32)
    v = np.zeros((nb, C), np.float32)
    row4col = np.full((nb, C), -1, np.int32)
    col4row = np.full((nb, R), -1, np.int32)
    inf = np.float32(np.inf)
    with np.errstate(invalid="ignore", over="ignore"):
        for cur in range(R):
            act = np.flatnonzero(mask[:, cur])  # images whose row `cur` is real
            n = act.size
            if not n:
                continue
            shortest = np.full((n, C), inf, np.float32)
            pred_row = np.full((n, C), cur, np.int32)
            visited = np.zeros((n, C), bool)
            row_visited = np.zeros((n, R), bool)
            i = np.full(n, cur, np.int64)
            min_val = np.zeros(n, np.float32)
            sink = np.zeros(n, np.int64)
            live = np.ones(n, bool)
            while live.any():  # one Dijkstra step of every live image
                L = np.flatnonzero(live)
                b, iL = act[L], i[L]
                row_visited[L, iL] = True
                d = (min_val[L, None] + cost[b, iL]) - u[b, iL][:, None] - v[b]
                upd = ~visited[L] & (d < shortest[L])
                sh = np.where(upd, d, shortest[L])
                shortest[L] = sh
                pred_row[L] = np.where(upd, iL[:, None].astype(np.int32), pred_row[L])
                masked = np.where(visited[L], inf, sh)
                j = masked.argmin(axis=1)
                min_val[L] = masked[np.arange(L.size), j]
                visited[L, j] = True
                nxt = row4col[b, j]
                done = nxt < 0
                sink[L[done]] = j[done]
                i[L[~done]] = nxt[~done]
                live[L[done]] = False
            # dual updates, as the JAX solver orders them
            u[act, cur] = u[act, cur] + min_val
            ar = np.arange(n)[:, None]
            row_delta = min_val[:, None] - shortest[ar, np.clip(col4row[act], 0, None)]
            other = row_visited & (np.arange(R) != cur)[None, :]
            u[act] = np.where(other, u[act] + row_delta, u[act])
            v[act] = np.where(visited, v[act] - (min_val[:, None] - shortest), v[act])
            # augment along the alternating path back from the sink
            for t, bb in enumerate(act):
                j = int(sink[t])
                while True:
                    r = int(pred_row[t, j])
                    row4col[bb, j] = r
                    j, col4row[bb, r] = int(col4row[bb, r]), j
                    if r == cur:
                        break
    return col4row[0] if single else col4row


def cost_matrix(pred_sims, pred_boxes, gt_labels, gt_boxes, gt_mask, *,
                w_class: float = 1.0, w_bbox: float = 1.0,
                w_giou: float = 1.0) -> torch.Tensor:
    """DETR matching cost, batched: [B, G, P] (rows = GT).

    pred_sims [B, P, C] raw similarities; pred_boxes [B, P, 4] xyxy;
    gt_labels [B, G]; gt_boxes [B, G, 4] xyxy; gt_mask [B, G] bool. Rows of
    invalid GT are zero, whatever their label (a padded slot may hold -1 or
    C). cost = -softmax(sims)[label] + L1 - GIoU."""
    x = pred_sims.float()
    lse = torch.logsumexp(x, dim=-1, keepdim=True)  # [B, P, 1]
    B, P, _ = x.shape
    G = gt_labels.shape[1]
    # an invalid row gathers class 0 (an index in range); its cost is zeroed
    labels = torch.where(gt_mask.bool(), gt_labels.long(), 0)
    idx = labels[:, None, :].expand(B, P, G)
    c_class = -torch.exp(torch.gather(x, 2, idx) - lse).transpose(1, 2)  # [B, G, P]
    pb, gb = pred_boxes.float(), gt_boxes.float()
    c_bbox = (gb[:, :, None, :] - pb[:, None, :, :]).abs().sum(-1)
    c_giou = -box_ops.pairwise_giou(gb, pb)
    cost = w_class * c_class + w_bbox * c_bbox + w_giou * c_giou
    return torch.where(gt_mask[:, :, None].bool(), cost, torch.zeros_like(cost))


def fetch(*tensors: torch.Tensor) -> list:
    """Copy tensors to the host as float32 numpy arrays in ONE device read:
    they are flattened and joined on the device first."""
    flat = torch.cat([t.detach().float().reshape(t.shape[0], -1) for t in tensors], 1)
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = int(np.prod(t.shape[1:]))
        out.append(host[:, at:at + n].reshape(t.shape))
        at += n
    return out


def solve(cost: torch.Tensor, pred_boxes: torch.Tensor, gt_labels: torch.Tensor,
          gt_mask: torch.Tensor, n_classes: int):
    """The assignment on the host from a `cost_matrix` output: one device
    read brings the cost, the predicted boxes, the labels and the mask
    over. Returns numpy (assigned [B, G] int32, -1 for invalid GT;
    target_classes [B, P] int32 with background = n_classes; the predicted
    boxes [B, P, 4] float32)."""
    cost, boxes, labels, mask = fetch(cost, pred_boxes, gt_labels, gt_mask)
    labels, mask = labels.astype(np.int32), mask > 0
    assigned = hungarian(cost, mask)
    B, P = boxes.shape[:2]
    target = np.full((B, P), n_classes, np.int32)
    bi, gi = np.nonzero(mask)
    target[bi, assigned[bi, gi]] = labels[bi, gi]
    return assigned, target, boxes


def match(pred_sims, pred_boxes, gt_labels, gt_boxes, gt_mask,
          n_classes: int, **cost_weights):
    """Batched matching -> (assigned [B, G], target_classes [B, P]) int64
    tensors on the predictions' device: the patch matched to each GT (-1
    where ~gt_mask) and each patch's class, background = n_classes."""
    cost = cost_matrix(pred_sims, pred_boxes, gt_labels, gt_boxes, gt_mask,
                       **cost_weights)
    assigned, target, _ = solve(cost, pred_boxes, gt_labels, gt_mask, n_classes)
    dev = pred_boxes.device
    return (torch.from_numpy(assigned).long().to(dev),
            torch.from_numpy(target).long().to(dev))
