"""The fine-tune step in plain PyTorch and NumPy, float32: the OWL-ViT
forward of reference/owlvit.py with the last k encoder layers, the heads
and the query bank trained; DETR's Hungarian matching; the PushPull loss
of the recipe the program follows; AdamW. It follows a run's first steps
from the weights and inputs the benchmark made, and reads per step the
four loss terms, after the first step each trained leaf's gradient norm,
and after the last each leaf's change.

The loss (the recipe's, with its quirks):
  cost       -softmax(sims)[label] + L1(boxes) - GIoU, on the valid GT rows
  matching   a minimum-cost assignment of each valid GT row to a patch
  labels     the matched patches take their GT's label, then one sweep in
             patch order: a labelled patch gives its label to every patch
             its box overlaps by IoU > 0.85 (chaining forward)
  loss_ce    focal-modulated, class-weighted BCE of |sims| clamped to
             [0, 1] against the one-hot labels, summed over classes,
             averaged over the labelled patches
  loss_bg    the same against zeros, averaged over the unlabelled patches
  loss_bbox  L1 of the matched boxes, over the number of GT boxes
  loss_giou  1 - GIoU of the matched boxes, over the number of GT boxes
"""

from __future__ import annotations

import numpy as np
import torch

from .owlvit import OwlViT

TERMS = ("loss_ce", "loss_bg", "loss_bbox", "loss_giou")
LOG_CLAMP = -100.0
PROPAGATION_IOU = 0.85


def trainable(c: dict, names, k: int) -> list:
    """The names the recipe trains: the last k encoder layers, the
    post-LN, the merged LN, the box head, the class projection and the
    query bank."""
    L = c["num_hidden_layers"]
    heads = [f"vision.layers.{i}." for i in range(L - k, L)] + [
        "vision.post_ln.", "merged_ln.", "box_head.", "class_head.dense0."]
    return [n for n in names if n == "queries" or any(n.startswith(h) for h in heads)]


def hungarian(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost assignment of the rows of cost [R, C] (R <= C) to
    distinct columns, by shortest augmenting paths with potentials
    (Kuhn-Munkres in its O(R^2 C) form) -> the column of each row."""
    R, C = cost.shape
    u, v = np.zeros(R + 1), np.zeros(C + 1)
    owner = np.zeros(C + 1, int)  # owner[j]: the row (1-based) on column j, 0 none
    way = np.zeros(C + 1, int)
    for i in range(1, R + 1):
        owner[0], j0 = i, 0
        minv = np.full(C + 1, np.inf)
        used = np.zeros(C + 1, bool)
        while True:
            used[j0] = True
            i0 = owner[j0]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            free = ~used[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            masked = np.where(free, minv[1:], np.inf)
            j1 = int(masked.argmin()) + 1
            delta = masked[j1 - 1]
            u[owner[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if owner[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            owner[j0] = owner[j1]
            j0 = j1
    col = np.full(R, -1, int)
    for j in range(1, C + 1):
        if owner[j]:
            col[owner[j] - 1] = j - 1
    return col


def _iou_row(b: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    lt = np.maximum(b[:2], boxes[:, :2])
    rb = np.minimum(b[2:], boxes[:, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])  # noqa: E731
    union = area(b) + area(boxes) - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def propagate(boxes: np.ndarray, labels: np.ndarray, background: int) -> np.ndarray:
    """One sweep over the patches in index order: a patch labelled at its
    turn gives its label to every patch its box overlaps by IoU > 0.85."""
    labels = labels.copy()
    j = -1
    while True:
        later = np.flatnonzero(labels[j + 1:] != background)
        if not later.size:
            return labels
        j += 1 + int(later[0])
        labels[_iou_row(boxes[j], boxes) > PROPAGATION_IOU] = labels[j]


def giou_aligned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt, rb = torch.maximum(a[..., :2], b[..., :2]), torch.minimum(a[..., 2:], b[..., 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])  # noqa: E731
    union = area(a) + area(b) - inter
    hull = (torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2])
            ).clamp(min=0).prod(-1)
    return inter / union - (hull - union) / hull


def targets(sims: torch.Tensor, boxes: torch.Tensor, gt: dict, n_classes: int):
    """The matching and the propagated labels of a batch (no gradient) ->
    (matched patch [B, G], -1 for padded rows; labels [B, P])."""
    B, P, _ = sims.shape
    prob = torch.softmax(sims.double(), -1).cpu().numpy()
    bx = boxes.double().cpu().numpy()
    matched = np.full(gt["labels"].shape, -1, int)
    labels = np.full((B, P), n_classes, int)
    for b in range(B):
        rows = np.flatnonzero(gt["gt_mask"][b])
        g, lab = gt["boxes"][b, rows].astype(np.float64), gt["labels"][b, rows]
        l1 = np.abs(g[:, None, :] - bx[b][None]).sum(-1)
        giou = giou_aligned(torch.from_numpy(g)[:, None], torch.from_numpy(bx[b])[None]).numpy()
        cost = -prob[b][:, lab].T + l1 - giou
        matched[b, rows] = hungarian(cost)
        labels[b, matched[b, rows]] = lab
        labels[b] = propagate(bx[b], labels[b], n_classes)
    return matched, labels


def loss_sums(sims, boxes, gt, matched, labels, n_classes, weights):
    """The four terms' numerators over a block of images (torch, with
    gradient), given the block's matching and labels."""
    dev = sims.device
    fg = torch.from_numpy(labels != n_classes).to(dev)
    x = sims.abs().clamp(0.0, 1.0)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(labels).to(dev),
                                         n_classes + 1)[..., :n_classes].float()

    def focal_bce(target):
        bce = -(target * torch.log(x).clamp(min=LOG_CLAMP)
                + (1 - target) * torch.log1p(-x).clamp(min=LOG_CLAMP)) * weights
        return (torch.square(1 - torch.exp(-bce)) * bce).sum(-1)

    ce = focal_bce(onehot)[fg].sum()
    bg = focal_bce(torch.zeros_like(onehot))[~fg].sum()
    valid = matched >= 0
    b_idx, g_idx = np.nonzero(valid)
    src = boxes[torch.from_numpy(b_idx).to(dev), torch.from_numpy(matched[valid]).to(dev)]
    tgt = torch.from_numpy(gt["boxes"][valid]).to(dev).float()
    l1 = (src - tgt).abs().sum()
    giou = (1 - giou_aligned(src, tgt)).sum()
    return torch.stack([ce, bg, l1, giou])


def trajectory(W0: dict, c: dict, t: dict, batches: list, weights: torch.Tensor,
               precision: str = "fp32", half_batch: bool = False, block: int = 4) -> dict:
    """Follow len(batches) AdamW steps from the weights W0. batches[i]:
    {"images": uint8 [B, S, S, 3] on the device, "labels", "boxes",
    "gt_mask"} (numpy). half_batch: the fault that leaves the second half
    of every batch out and takes the mean over the rest.
    -> {"terms": [[4] per step], "grad": {leaf: |g| of step 1},
        "change": {leaf: |p - p0| after the last step},
        "sims": step 1's class similarities (CPU)}"""
    k, C = t["trainable_last_k"], t["n_classes"]
    L = c["num_hidden_layers"]
    names = trainable(c, W0, k)
    W = dict(W0)
    for n in names:
        W[n] = W0[n].clone().requires_grad_(True)
    model = OwlViT(W, c, precision)
    m = {n: torch.zeros_like(W[n]) for n in names}
    v = {n: torch.zeros_like(W[n]) for n in names}
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr, wd = t["learning_rate"], t["weight_decay"]
    out = {"terms": [], "grad": {}, "change": {}}
    for step, batch in enumerate(batches, 1):
        n = batch["images"].shape[0] // 2 if half_batch else None
        images = batch["images"][:n]
        gt = {key: batch[key][:n] for key in ("labels", "boxes", "gt_mask")}
        B = images.shape[0]
        with torch.no_grad():
            x = torch.cat([model.layers(model.embed(images[i:i + block]), 0, L - k)
                           for i in range(0, B, block)])
            pred = [model.heads(model.layers(x[i:i + block], L - k, L))
                    for i in range(0, B, block)]
        boxes = torch.cat([p[0] for p in pred])
        sims = torch.cat([p[1] for p in pred])
        if step == 1:
            out["sims"] = sims.cpu()
        matched, labels = targets(sims, boxes, gt, C)
        fg = labels != C
        norm = torch.tensor([max(int(fg.sum()), 1), max(int((~fg).sum()), 1),
                             max(int(gt["gt_mask"].sum()), 1),
                             max(int(gt["gt_mask"].sum()), 1)], dtype=torch.float32,
                            device=images.device)
        for n in names:
            W[n].grad = None
        total = torch.zeros(4, device=images.device)
        for i in range(0, B, block):
            sl = slice(i, i + block)
            bx, sm = model.heads(model.layers(x[sl], L - k, L))
            part = loss_sums(sm, bx, {key: gt[key][sl] for key in gt},
                             matched[sl], labels[sl], C, weights) / norm
            part.sum().backward()
            total += part.detach()
        out["terms"].append(total.tolist())
        with torch.no_grad():
            if step == 1:
                out["grad"] = {n: W[n].grad.norm().item() for n in names}
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for n in names:
                p, g = W[n], W[n].grad
                p.mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.addcdiv_(m[n], (v[n].sqrt() / bc2 ** 0.5).add_(eps), value=-lr / bc1)
    out["change"] = {n: (W[n].detach() - W0[n]).norm().item() for n in names}
    return out


def path_leaves(names) -> dict:
    """{"box": the box head's leaves, "class": the class path's (the class
    projection and the query bank)}."""
    return {"box": [n for n in names if n.startswith("box_head.")],
            "class": [n for n in names if n.startswith("class_head.dense0.") or n == "queries"]}


def _gaps(prog: dict, ref: dict, key: str, leaves: list) -> dict:
    """Each leaf's distance between the two norms, over the larger of the
    reference leaf's norm and the median leaf's."""
    med = float(np.median([ref[key][n] for n in leaves]))
    return {n: abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med) for n in leaves}


def moved(ref: dict) -> list:
    """The leaves whose step-1 reference gradient is at least a thousandth
    of the median leaf's: the others (nought but for rounding, as the key
    bias under softmax) move by round-off alone."""
    med = float(np.median(list(ref["grad"].values())))
    return [n for n in ref["grad"] if ref["grad"][n] >= 1e-3 * med]


def compare(prog: dict, ref: dict, sims_bf16: torch.Tensor) -> dict:
    """The numbers judged (PERF.md gives the readings that chose them):
      box_loss_gap       loss_bbox and loss_giou of the three steps, the
                         largest relative distance from the reference's
      box_grad_gap       the box head's worst leaf: the distance of its
                         step-1 gradient norm from the reference's
      median_change_gap  the median leaf's distance of its change after the
                         three steps from the reference's
      sims_rms_ratio     step 1's class similarities, element by element:
                         the root mean square of their difference from the
                         reference's, over that of the reference computed
                         in bfloat16 (sims_bf16, the same images): about 1
                         where the program rounds as bf16 does
    loss_ce, loss_bg and the norms of the class path's gradient are not
    judged (detail gives them): the loss's BCE of |cos| has the gradient
    1/x at the smallest foreground similarity x, which a rounding of x
    decides, and the steps after the first follow it."""
    p, r = np.asarray(prog["terms"]), np.asarray(ref["terms"])
    rel = np.abs(p - r) / np.abs(r)
    rs = ref["sims"].double()
    n = min(len(prog["sims"]), len(rs))
    rms = lambda x: float((x[:n].double() - rs[:n]).square().mean().sqrt())  # noqa: E731
    return {"box_loss_gap": float(rel[:, 2:].max()),
            "box_grad_gap": max(_gaps(prog, ref, "grad", path_leaves(ref["grad"])["box"])
                                .values()),
            "median_change_gap": float(np.median(list(_gaps(prog, ref, "change",
                                                            moved(ref)).values()))),
            "sims_rms_ratio": rms(prog["sims"]) / max(rms(sims_bf16), 1e-30)}


def detail(prog: dict, ref: dict) -> dict:
    """What stands beside compare's numbers: each term's gap by step
    (loss_ce's among them), the class path's worst gradient gap, and the
    worst leaves of the gradient and of the change (name, gap, the
    program's norm, the reference's)."""
    p, r = np.asarray(prog["terms"]), np.asarray(ref["terms"])
    out = {"term_gaps": (np.abs(p - r) / np.abs(r)).tolist(),
           "class_grad_gap": max(_gaps(prog, ref, "grad",
                                       path_leaves(ref["grad"])["class"]).values())}
    for key, leaves in (("grad", list(ref["grad"])), ("change", moved(ref))):
        gaps = _gaps(prog, ref, key, leaves)
        worst = sorted(gaps, key=lambda n: -gaps[n])[:3]
        out[f"{key}_worst"] = [[n, gaps[n], prog[key][n], ref[key][n]] for n in worst]
    out["left_out_of_change"] = sorted(set(ref["grad"]) - set(moved(ref)))
    return out
