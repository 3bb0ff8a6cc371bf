"""The fine-tune train step (counterpart of owlvit_tpu/train/trainer.py:
`Trainer.train_step`, `grad_update`, `_lr_schedule`, and the cached routing
of `_setup_act_cache`, `_init_pool`, `_act_pool_bytes` and
`_train_one_batch_impl` for one device).

One step, uncached: uint8 pixels -> `normalize_image` -> `forward_train`
(the frozen prefix of layers under no_grad, the trainable tail with the
attention kernels' autograd Function, the box and query-bank heads) ->
`push_pull_loss` (matching on the host) -> backward -> AdamW on the
trainable set, configured as `optax.adamw` (b1 0.9, b2 0.999, eps 1e-8,
decay on every trainable parameter), its learning rate set before each
update from `lr_schedule` at the number of updates done so far.

Cached (training.cache_backbone): the frozen prefix is a pure function of
the image, so each image's `embed_prefix` output is computed once and
stored, and every later step trains the tail from it
(`forward_train_from_prefix`). The store is a device pool [N, S, D] in the
activation dtype, or int8 with one fp32 scale per token
(cache_store_dtype: int8), or the disk memmap of data/act_cache.py. A batch
whose rows are not all filled runs the prefix, stores its rows and trains on
the exact prefix output; a filled batch gathers its rows from the store.

Not in this slice, and refused with NotImplementedError when a config asks
for them: grad_accum > 1, EMA, augmentation (hflip's two-row pool
included), a mesh, checkpoints and remat. The data feed, eval and the epoch
loop are not ported either: the caller hands `train_step` its batches.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from owlvit_tpu_torch.data.act_cache import ActivationCache, fingerprint
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.models.layers import fused_ln_enabled
from owlvit_tpu_torch.ops import losses as loss_ops
from owlvit_tpu_torch.ops.flash_attention import resolve_static_max
from owlvit_tpu_torch.ops.preprocess import normalize_image
from owlvit_tpu_torch.ops.quant import dequantize_rows, quantize_rows
from owlvit_tpu_torch.utils.config import Config, ModelConfig, TrainingConfig

from .state import partition_params

# the four loss terms, in the order train_step returns them
TERM_KEYS = ("loss_ce", "loss_bg", "loss_bbox", "loss_giou")

# cache_backbone_store "auto" keeps the pool on the device up to this many
# bytes. The JAX package's constant, sized for a 16 GB TPU v5e (10 GB of
# pool, ~5 GB left for parameters, optimizer and activations); not re-sized
# for the H100's 80 GB yet.
AUTO_DEVICE_POOL_BYTES = 10e9

_NOT_PORTED = (
    ("training.grad_accum > 1", lambda t, m: t.grad_accum > 1),
    ("training.ema_decay", lambda t, m: bool(t.ema_decay)),
    ("training.augment", lambda t, m: t.augment),
    ("training.augment_hflip", lambda t, m: t.augment_hflip),
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
    attention_impl and trainable_last_k pick the model configuration,
    training.learning_rate, lr_schedule, warmup_steps, lr_final, n_epochs
    and weight_decay the optimizer, and training.cache_backbone,
    cache_backbone_store and cache_store_dtype the activation cache.
    steps_per_epoch sizes the cosine schedule. class_weights: [n_classes]
    BCE weights, or None.

    For the cache only: n_images, the number of images in the train set
    (the store's rows, indexed by batch["indices"]); workdir, where the
    disk store lives; dataset_id, a JSON-able identity of the train set
    (image keys with their sizes and times, say) that enters the disk
    store's fingerprint, so that a changed set never reads stale rows."""

    def __init__(self, config: Config, model: owlvit.OwlViT, n_classes: int, *,
                 steps_per_epoch: int, class_weights=None, device,
                 n_images: Optional[int] = None, workdir: Optional[str] = None,
                 dataset_id=None):
        t, m = config.training, config.model
        _refuse_unported(t, m)
        if model.queries is None:
            raise ValueError("the model has no query bank to fine-tune")
        self.cfg = config
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

        self.act_store = None  # "device" | "disk" with cache_backbone
        self.act_cache = None  # the disk store
        self.pool = None  # the device store, allocated at the first filled batch
        if t.cache_backbone:
            if m.trainable_last_k is None:
                raise ValueError(
                    "training.cache_backbone requires model.trainable_last_k "
                    "(full fine-tuning has no frozen prefix to cache)")
            self._setup_act_cache(n_images, workdir, dataset_id)

    # ------------------------------------------------------ activation cache

    def act_pool_bytes(self, rows: int, store_dtype: Optional[str]) -> float:
        """Device pool size: S = num_patches + 1 tokens (never padded) x
        hidden size x element payload (bf16/fp32, or int8 + one fp32 scale
        per token)."""
        vc = self.model_cfg.vision
        elt = 2.0 if self.model_cfg.dtype == "bfloat16" else 4.0
        if store_dtype == "int8":
            elt = 1 + 4.0 / vc.hidden_size
        return rows * (vc.num_patches + 1) * vc.hidden_size * elt

    def _setup_act_cache(self, n_images, workdir, dataset_id) -> None:
        t, m = self.cfg.training, self.cfg.model
        qdt = t.cache_store_dtype
        if qdt not in (None, "int8"):
            raise ValueError("training.cache_store_dtype must be null or 'int8', "
                             f"got {qdt!r}")
        store = t.cache_backbone_store
        if store not in ("auto", "device", "disk"):
            raise ValueError("training.cache_backbone_store must be "
                             f"auto|device|disk, got {store!r}")
        if not n_images or n_images < 1:
            raise ValueError("training.cache_backbone needs n_images, the "
                             "number of images in the train set")
        if store == "auto":
            store = ("device" if self.act_pool_bytes(n_images, qdt)
                     <= AUTO_DEVICE_POOL_BYTES else "disk")
        if qdt and store != "device":
            raise ValueError(
                f"training.cache_store_dtype={qdt!r} only applies to the "
                f"device pool, but the store resolved to {store!r} (the disk "
                "memmap already persists at the activation dtype; if 'auto' "
                "picked disk, the set exceeds the pool budget even quantized)")
        self.act_store, self.store_dtype = store, qdt
        self.n_images = n_images
        self.filled = np.zeros((n_images,), bool)  # device store rows
        if store == "disk":
            if workdir is None:
                raise ValueError("the disk activation store needs a workdir")
            if m.params_npz:
                st = os.stat(m.params_npz)
                src = f"npz:{m.params_npz}:{st.st_size}:{int(st.st_mtime)}"
            else:
                src = f"random:{t.seed}"
            dtype = owlvit.DTYPES[self.model_cfg.dtype]
            fp = fingerprint({
                "params": src, "model": m.name, "dtype": m.dtype,
                "trainable_last_k": m.trainable_last_k,
                # switches that change the prefix's numerics, so that a
                # stale cache does not survive a flip of either
                "static_max": (resolve_static_max(dtype, True)
                               if self.model_cfg.static_softmax else ""),
                "fused_ln": fused_ln_enabled(),
                "attention_impl": self.model_cfg.attention_impl,
                "seed": t.seed, "dataset": dataset_id,
            })
            os.makedirs(workdir, exist_ok=True)
            self.act_cache = ActivationCache(
                os.path.join(workdir, f"backbone_{m.name}"), n_images, fp)

    def _init_pool(self, row_shape, dtype) -> None:
        """Zero-filled device pool of n_images rows, allocated whole:
        [N, S, D] in the activation dtype, or {"q": int8 [N, S, D], "s":
        fp32 [N, S]} with cache_store_dtype int8."""
        shape = (self.n_images, *row_shape)
        if self.store_dtype == "int8":
            self.pool = {"q": torch.zeros(shape, dtype=torch.int8, device=self.device),
                         "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                          device=self.device)}
        else:
            self.pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.pool_dtype = dtype

    def pool_scatter(self, rows: torch.Tensor, acts: torch.Tensor) -> None:
        """Store acts [B, S, D] at pool rows (in place: the pool is written,
        not copied, unlike the JAX package's functional .at[].set)."""
        if self.store_dtype == "int8":
            q, scale = quantize_rows(acts)
            self.pool["q"].index_copy_(0, rows, q)
            self.pool["s"].index_copy_(0, rows, scale)
        else:
            self.pool.index_copy_(0, rows, acts)

    def pool_gather(self, rows: torch.Tensor) -> torch.Tensor:
        """The pool rows [B, S, D] in the activation dtype (dequantized
        from int8 with cache_store_dtype int8)."""
        if self.store_dtype == "int8":
            return dequantize_rows(self.pool["q"].index_select(0, rows),
                                   self.pool["s"].index_select(0, rows),
                                   self.pool_dtype)
        return self.pool.index_select(0, rows)

    def _image(self, batch) -> torch.Tensor:
        image = _tensor(batch["image"], self.device, torch.uint8)
        if image.dim() == 2:
            S = self.model_cfg.vision.image_size
            image = image.reshape(image.shape[0], S, S, 3)
        return image

    def _cached_acts(self, batch, mark) -> torch.Tensor:
        """The batch's prefix activations from the store, or computed,
        stored and returned when any of its rows is not stored yet."""
        idxs = np.asarray(batch["indices"], np.int64)
        disk = self.act_store == "disk"
        hit = self.act_cache.has(idxs) if disk else bool(self.filled[idxs].all())
        if hit:
            if disk:
                mark("input")
                acts = self.act_cache.read_tensor(idxs).to(self.device)
            else:
                rows = torch.from_numpy(idxs).to(self.device)
                mark("input")
                acts = self.pool_gather(rows)
            mark("gather")
            return acts
        image = self._image(batch)
        mark("input")
        acts = owlvit.embed_prefix(self.model, self.model_cfg,
                                   normalize_image(image))
        mark("prefix")
        if disk:
            self.act_cache.write_tensor(idxs, acts)
        else:
            if self.pool is None:
                self._init_pool(acts.shape[1:], acts.dtype)
            self.pool_scatter(torch.from_numpy(idxs).to(self.device), acts)
            self.filled[idxs] = True
        mark("scatter")
        return acts  # the exact prefix output trains this step

    # ------------------------------------------------------------- the step

    def train_step(self, batch: dict,
                   mark: Optional[Callable[[str], None]] = None) -> np.ndarray:
        """One optimizer update on batch {"image": uint8 [B, S*S*3] or
        [B, S, S, 3], "labels": [B, G], "boxes": [B, G, 4] xyxy in [0, 1],
        "gt_mask": [B, G]} -> the loss terms [4] in TERM_KEYS order. With
        cache_backbone the batch also carries "indices" [B], the images'
        rows in the train set, and may leave out "image" when every row is
        stored.

        mark, if given, is called with the name of each phase as it is
        issued: "input" (the batch on the device), then uncached "forward";
        cached, a batch with rows to fill "prefix" and "scatter", a stored
        batch "gather", then "forward" (the tail and the heads); then
        "cost", "host", "loss", "backward", "optimizer"."""
        mark = mark or (lambda name: None)
        dev = self.device
        labels = _tensor(batch["labels"], dev, torch.int64)
        gt_boxes = _tensor(batch["boxes"], dev, torch.float32)
        gt_mask = _tensor(batch["gt_mask"], dev, torch.bool)
        if self.act_store is None:
            image = self._image(batch)
            mark("input")
        else:
            acts = self._cached_acts(batch, mark)

        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.step)
        self.opt.zero_grad(set_to_none=True)
        if self.act_store is None:
            boxes, sims = owlvit.forward_train(self.model, self.model_cfg,
                                               normalize_image(image))
        else:
            boxes, sims = owlvit.forward_train_from_prefix(
                self.model, self.model_cfg, acts)
        mark("forward")
        terms = loss_ops.push_pull_loss(sims, boxes, labels, gt_boxes, gt_mask,
                                        self.n_classes, self.class_weights,
                                        mark=mark)
        loss_ops.total_loss(terms).backward()
        mark("backward")
        self.opt.step()
        mark("optimizer")
        self.step += 1
        return torch.stack([terms[k].detach() for k in TERM_KEYS]).cpu().numpy()
