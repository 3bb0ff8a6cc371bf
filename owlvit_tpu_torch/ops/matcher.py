"""Hungarian matching (counterpart of owlvit_tpu/ops/matcher.py: `hungarian`,
`hungarian_pruned`, `cost_matrix`, `match`).

The DETR matching cost is computed on the predictions' device, batched to
[B, G, P], and the assignment is solved there too, as the JAX package
solves it inside its train step with no host round trip: on a CUDA tensor
`jv_assign` launches the Jonker-Volgenant kernel of csrc/matcher.cu (one
block per image), and `assign` scatters the matched labels into each
patch's class on the card. Nothing is read back to the host.

`hungarian` is the plain version: a numpy port of the JAX solver itself
(not scipy's linear_sum_assignment, which breaks ties differently), so the
assignment equals the JAX one, ties included. Like the vmapped JAX solver,
it runs the images of a batch in lockstep (Python loops once per Dijkstra
step, not once per image). CPU tensors take it; on the card only the tests
and chip_smoke.py call it, to hold the kernel to it.

The JAX package's two matcher switches are read at call time by `assign`
(and so by `match`): OWLVIT_MATCH_PRUNE=1 solves each image on the union
of its rows' R cheapest columns (`hungarian_pruned`, the same assignment
on every input the tests and chip_smoke.py try), and OWLVIT_MATCH_SKIP=0
solves the padded rows too instead of skipping them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import boxes as box_ops
from ._cuda import launch

# the most columns (patches) the matcher kernels take: 512 threads an image,
# each holding up to 8 columns in registers (csrc/matcher.cu)
KERNEL_MAX_COLUMNS = 4096


def hungarian(cost: np.ndarray, row_mask: Optional[np.ndarray] = None,
              counts: Optional[list] = None) -> np.ndarray:
    """Min-cost assignment of cost [R, C] or [B, R, C] (R <= C), float32.

    Returns col4row [R] or [B, R] int32: the column of each row, -1 for rows
    that row_mask [R] / [B, R] marks False (they are skipped, which is
    solving the valid-row submatrix). Step for step the JAX solver: rows in
    order, one Dijkstra per row over all columns, the fp32 expression
    `min_val + cost[i] - u[i] - v` evaluated in that order, the strict
    `d < shortest`, argmin's first index, then the dual updates and the
    augmentation along the alternating path. counts, if given, is extended
    by each image's number of Dijkstra steps (the kernel's sequential
    depth)."""
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
    steps = np.zeros(nb, np.int64)
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
                steps[b] += 1
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
    if counts is not None:
        counts.extend(steps.tolist())
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


def jv_assign(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """Min-cost assignment of cost [B, R, C] (R <= C) with rows that
    row_mask [B, R] marks False skipped -> col4row [B, R] int32 on cost's
    device, -1 for skipped rows: `hungarian`'s assignment, ties included.
    CPU tensors run `hungarian`; CUDA tensors the kernel (counted in
    `jv_assign.launches`; C <= KERNEL_MAX_COLUMNS), on the current stream,
    with no host read."""
    if cost.dim() != 3 or row_mask.shape != cost.shape[:2]:
        raise ValueError(f"jv_assign takes cost [B, R, C] and row_mask [B, R], got "
                         f"{tuple(cost.shape)} and {tuple(row_mask.shape)}")
    B, R, C = cost.shape
    if R > C:
        raise ValueError(f"jv_assign requires rows <= cols, got {tuple(cost.shape[-2:])}")
    if cost.device.type == "cpu":
        out = hungarian(cost.detach().float().numpy(), row_mask.bool().numpy())
        return torch.from_numpy(out)
    if cost.device.type != "cuda" or row_mask.device != cost.device:
        raise ValueError(f"jv_assign runs on cpu or cuda tensors on one device, got "
                         f"{cost.device} and {row_mask.device}")
    if C > KERNEL_MAX_COLUMNS:
        raise ValueError(f"jv_assign on the card takes at most {KERNEL_MAX_COLUMNS} columns, "
                         f"got {C}")
    out = torch.empty((B, R), dtype=torch.int32, device=cost.device)
    if B and R:
        c = cost.detach().float().contiguous()
        m = row_mask.bool().contiguous()
        launch("owlvit_jv_assign", cost.device, c.data_ptr(), m.data_ptr(),
               out.data_ptr(), B, R, C)
        jv_assign.launches += 1
    return out


jv_assign.launches = 0


# a duplicate column of the pruned submatrix (the JAX package's _BIG)
_BIG = 1e9


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 x that order as IEEE's total order (-0 before
    +0), the order XLA's top_k compares in."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def hungarian_pruned(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """The JAX `hungarian_pruned`, batched: cost [B, R, C], row_mask [B, R]
    -> col4row [B, R] int32 in the original columns, -1 for masked rows, on
    cost's device with no host read.

    Where R * R >= C, `jv_assign` on the whole matrix. Otherwise each row's
    R cheapest columns, as `lax.top_k(-cost, R)` picks them (IEEE total
    order, so -0 before +0; among equal values the lower index first: a
    stable sort of the total-order keys), their union sorted ascending (R *
    R columns, a repeat of a column set to _BIG so that no column is taken
    twice), the submatrix [B, R, R * R] gathered and solved by `jv_assign`,
    and its columns mapped back. Exact by the exchange argument of the JAX
    docstring: an optimal assignment lies in that union."""
    B, R, C = cost.shape
    if R * R >= C:
        return jv_assign(cost, row_mask)
    cost = cost.detach().float()
    order = torch.sort(_total_order_key(cost), dim=-1, stable=True).indices
    cols = torch.sort(order[..., :R].reshape(B, R * R), dim=-1).values  # [B, R*R]
    dup = torch.zeros_like(cols, dtype=torch.bool)
    dup[:, 1:] = cols[:, 1:] == cols[:, :-1]  # keep the first copy of each column
    sub = torch.gather(cost, 2, cols[:, None, :].expand(B, R, R * R))
    sub = torch.where(dup[:, None, :], torch.full_like(sub, _BIG), sub)
    sub_col = jv_assign(sub, row_mask).long()
    picked = torch.gather(cols, 1, sub_col.clamp(min=0))
    return torch.where(sub_col >= 0, picked, -1).to(torch.int32)


def solve(cost: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """The assignment [B, R] int32 as the JAX `match` routes it, both
    switches read at call time: padded rows skipped (row_mask = gt_mask)
    unless OWLVIT_MATCH_SKIP=0 (every row solved); `hungarian_pruned` under
    OWLVIT_MATCH_PRUNE=1, else `jv_assign` on all columns."""
    mask = gt_mask.bool()
    if os.environ.get("OWLVIT_MATCH_SKIP") == "0":
        mask = torch.ones_like(mask)
    if os.environ.get("OWLVIT_MATCH_PRUNE") == "1":
        return hungarian_pruned(cost, mask)
    return jv_assign(cost, mask)


def assign(cost: torch.Tensor, gt_labels: torch.Tensor, gt_mask: torch.Tensor,
           n_classes: int):
    """The assignment of a `cost_matrix` output on its device -> (assigned
    [B, G] int64, -1 for invalid GT; under OWLVIT_MATCH_SKIP=0 the column
    an invalid row was solved to, as in the JAX package; target_classes [B,
    P] int64, each patch's matched label, background = n_classes), solved
    as `solve` routes it. The labels go to their patches by a scatter on
    the device (an invalid row writes a spare column that is dropped), so
    nothing is read back. A valid row that the kernel's safety stop left at
    -1 (inf or NaN costs) also writes the spare column: its label is
    dropped, not scattered out of range."""
    B, G, P = cost.shape
    mask = gt_mask.bool()
    assigned = solve(cost, mask).long()
    col = torch.where(mask & (assigned >= 0), assigned, P)
    target = torch.full((B, P + 1), n_classes, dtype=torch.long, device=cost.device)
    target.scatter_(1, col, torch.where(mask, gt_labels.long(), n_classes))
    return assigned, target[:, :P]


def match(pred_sims, pred_boxes, gt_labels, gt_boxes, gt_mask,
          n_classes: int, **cost_weights):
    """Batched matching -> (assigned [B, G], target_classes [B, P]) int64
    tensors on the predictions' device: the patch matched to each GT (-1
    where ~gt_mask) and each patch's class, background = n_classes."""
    cost = cost_matrix(pred_sims, pred_boxes, gt_labels, gt_boxes, gt_mask,
                       **cost_weights)
    return assign(cost, gt_labels, gt_mask, n_classes)
