"""The fine-tune train step (counterpart of owlvit_tpu/train/trainer.py:
`Trainer.train_step`, `grad_update`, `_lr_schedule`).

One step, uncached: uint8 pixels -> `normalize_image` -> `forward_train`
(the frozen prefix of layers under no_grad, the trainable tail with the
attention kernels' autograd Function, the box and query-bank heads) ->
`push_pull_loss` (matching on the host) -> backward -> AdamW on the
trainable set, configured as `optax.adamw` (b1 0.9, b2 0.999, eps 1e-8,
decay on every trainable parameter), its learning rate set before each
update from `lr_schedule` at the number of updates done so far.

Not in this slice, and refused with NotImplementedError when a config asks
for them: grad_accum > 1, EMA, augmentation, the activation cache, a mesh,
checkpoints and remat. The data feed, eval and the epoch loop are not ported
either: the caller hands `train_step` its batches.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.ops import losses as loss_ops
from owlvit_tpu_torch.ops.preprocess import normalize_image
from owlvit_tpu_torch.utils.config import Config, ModelConfig, TrainingConfig

from .state import partition_params

# the four loss terms, in the order train_step returns them
TERM_KEYS = ("loss_ce", "loss_bg", "loss_bbox", "loss_giou")

_NOT_PORTED = (
    ("training.grad_accum > 1", lambda t, m: t.grad_accum > 1),
    ("training.ema_decay", lambda t, m: bool(t.ema_decay)),
    ("training.augment", lambda t, m: t.augment),
    ("training.augment_hflip", lambda t, m: t.augment_hflip),
    ("training.cache_backbone", lambda t, m: t.cache_backbone),
    ("a mesh (training.mesh_data x training.mesh_model > 1)",
     lambda t, m: t.mesh_data * t.mesh_model > 1),
    ("checkpoints (training.checkpoint_dir)", lambda t, m: bool(t.checkpoint_dir)),
    ("model.remat", lambda t, m: m.remat),
)


def _refuse_unported(t: TrainingConfig, m: ModelConfig) -> None:
    if t.grad_accum < 1:
        raise ValueError(f"training.grad_accum must be >= 1, got {t.grad_accum}")
    for what, asked in _NOT_PORTED:
        if asked(t, m):
            raise NotImplementedError(f"{what} is not ported to owlvit_tpu_torch yet")


def lr_schedule(t: TrainingConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate at update `step` (counted from 0): "constant", or
    "cosine" decay to lr_final over n_epochs * steps_per_epoch updates, both
    after an optional linear warmup from 0 over warmup_steps, as optax's
    join_schedules(linear_schedule, constant/cosine) evaluates them."""
    if t.lr_schedule not in ("constant", "cosine"):
        raise ValueError(
            f"training.lr_schedule must be constant|cosine, got {t.lr_schedule!r}")
    peak, warm = t.learning_rate, t.warmup_steps
    if t.lr_schedule == "constant" and not warm:
        return lambda step: peak
    total = max(t.n_epochs * max(1, steps_per_epoch), warm + 1)

    def warmup(step):  # optax.linear_schedule(0, peak, warm), at 0 <= step < warm
        return (0.0 - peak) * (1 - step / warm) + peak

    def cosine(step):  # optax.cosine_decay_schedule(peak, total - warm, alpha)
        decay = total - warm
        alpha = 0.0 if peak == 0.0 else t.lr_final / peak
        c = 0.5 * (1 + math.cos(math.pi * min(step, decay) / decay))
        return peak * ((1 - alpha) * c + alpha)

    after = (lambda step: peak) if t.lr_schedule == "constant" else cosine
    return lambda step: warmup(step) if step < warm else after(step - warm)


def _tensor(x, device, dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=device, dtype=dtype)


class Trainer:
    """Fine-tunes `model` (an owlvit.OwlViT with a query bank) on batches
    the caller gives `train_step`.

    config: the port's Config (utils/config.py); model.name, dtype,
    attention_impl and trainable_last_k pick the model configuration, and
    training.learning_rate, lr_schedule, warmup_steps, lr_final, n_epochs
    and weight_decay the optimizer. steps_per_epoch sizes the cosine
    schedule. class_weights: [n_classes] BCE weights, or None."""

    def __init__(self, config: Config, model: owlvit.OwlViT, n_classes: int, *,
                 steps_per_epoch: int, class_weights=None, device):
        t, m = config.training, config.model
        _refuse_unported(t, m)
        if model.queries is None:
            raise ValueError("the model has no query bank to fine-tune")
        self.device = torch.device(device)
        # static_softmax stays False: the tail takes a gradient
        self.model_cfg = get_config(m.name, dtype=m.dtype,
                                    attention_impl=m.attention_impl,
                                    trainable_last_k=m.trainable_last_k)
        self.model = model.to(self.device)
        self.n_classes = n_classes
        self.params = partition_params(self.model, m.trainable_last_k)
        self.opt = torch.optim.AdamW(self.params, lr=t.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=t.weight_decay)
        self.lr = lr_schedule(t, steps_per_epoch)
        self.class_weights = (None if class_weights is None
                              else _tensor(class_weights, self.device, torch.float32))
        self.step = 0  # updates done

    def train_step(self, batch: dict,
                   mark: Optional[Callable[[str], None]] = None) -> np.ndarray:
        """One optimizer update on batch {"image": uint8 [B, S*S*3] or
        [B, S, S, 3], "labels": [B, G], "boxes": [B, G, 4] xyxy in [0, 1],
        "gt_mask": [B, G]} -> the loss terms [4] in TERM_KEYS order.

        mark, if given, is called with the name of each phase as it is
        issued: "input" (the batch on the device), "forward", "cost",
        "host", "loss", "backward", "optimizer"."""
        dev = self.device
        image = _tensor(batch["image"], dev, torch.uint8)
        if image.dim() == 2:
            S = self.model_cfg.vision.image_size
            image = image.reshape(image.shape[0], S, S, 3)
        labels = _tensor(batch["labels"], dev, torch.int64)
        gt_boxes = _tensor(batch["boxes"], dev, torch.float32)
        gt_mask = _tensor(batch["gt_mask"], dev, torch.bool)
        if mark:
            mark("input")

        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.step)
        self.opt.zero_grad(set_to_none=True)
        boxes, sims = owlvit.forward_train(self.model, self.model_cfg,
                                           normalize_image(image))
        if mark:
            mark("forward")
        terms = loss_ops.push_pull_loss(sims, boxes, labels, gt_boxes, gt_mask,
                                        self.n_classes, self.class_weights,
                                        mark=mark)
        loss_ops.total_loss(terms).backward()
        if mark:
            mark("backward")
        self.opt.step()
        if mark:
            mark("optimizer")
        self.step += 1
        return torch.stack([terms[k].detach() for k in TERM_KEYS]).cpu().numpy()
