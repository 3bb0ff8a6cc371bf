"""The fine-tune run (counterpart of owlvit_tpu/train/trainer.py: `setup`
and `_build_query_bank` as `from_config`/`with_data`, `run` on the streamed
path, `evaluate`, `Trainer.train_step`, `grad_update` with optax.MultiSteps
(grad_accum) and the EMA, `_lr_schedule`, `_sample_flips`, and the cached
routing of `_setup_act_cache`, `_init_pool`, `_act_pool_bytes`,
`_train_one_batch_impl`, `_want_image` and `_with_cached_acts` for one
device).

A run, as `python -m owlvit_tpu_torch.cli train` starts it:
`Trainer.from_config` writes the synthetic set when data.synthetic_root is
set, loads the labelmap and both DetectionDatasets, then `with_data` (which
takes ready dataset objects) loads model.params_npz or draws the detector
from training.seed, builds the query bank from the text tower when the
parameters lack one, sets the class weights and the optimizer, restores the
latest checkpoint and prints the mode banner. `run` trains to n_epochs
(resuming where a checkpoint left off), each epoch one shuffled pass
through `batch_iterator` and `prefetch_to_device` into `train_step`, with
eval, the JSONL row, class_maps.json, TensorBoard scalars, periodic and best
checkpoints and early stop. `evaluate` is the eval forward (no split, no
grad) + `postprocess` + `pack_detections`, one device read per batch, and
COCO mAP on the host.

One step, uncached: uint8 pixels -> `normalize_image` -> `forward_train`
(the frozen prefix of layers under no_grad, the trainable tail with the
attention kernels' autograd Function, the box and query-bank heads) ->
`push_pull_loss` (matching on the host) -> backward -> AdamW on the
trainable set, configured as `optax.adamw` (b1 0.9, b2 0.999, eps 1e-8,
decay on every trainable parameter), its learning rate set before each
update from `lr_schedule` at the number of updates done so far.
model.remat recomputes each trained encoder block in the backward
(vit/layers `encoder`) instead of keeping its activations.

The training options, as the JAX package has them:
- grad_accum k > 1: optax.MultiSteps. Each micro-step adds its gradient
  into a running mean (Welford: acc + (g - acc) / (n + 1)); AdamW steps on
  the k-th, and the schedule counts updates. `step` counts micro-steps (a
  checkpoint's step, the JAX package's state.step); `updates` counts
  optimizer updates. A checkpoint carries the mean and the micro-step
  within the accumulation, so a resume continues it.
- ema_decay d: an fp32 EMA of the trainable set, e * d + p * (1 - d), after
  every update; saved beside each checkpoint (checkpoint.save_tree) and
  restored on resume. With ema_eval, evaluate (and so keep_best) runs on the
  EMA weights, swapped in around the eval and out again.
- augment: ops/augment.py's augment_batch on the uncached step, from a
  generator seeded with (training.seed, step).
- augment_hflip: flips sampled on the host by `_sample_flips` (numpy
  Philox keyed by (seed, step): the JAX package's bits). Uncached, the
  pixels and boxes mirror before normalize_image; cached, the device pool
  holds two rows an image (2i: the prefix of the pixels as they are; 2i+1:
  of the x-mirrored pixels), a batch with rows to fill runs the prefix on
  both, every step gathers rows 2i + flip and the tail mirrors the boxes.
- profile_dir: a torch.profiler trace (CPU, and CUDA on the card) of the
  steps after step 0 of epoch 0, for profile_steps steps or to the epoch's
  end, written as a Chrome trace into <workdir>/<profile_dir>.

Cached (training.cache_backbone): the frozen prefix is a pure function of
the image, so each image's `embed_prefix` output is computed once and
stored, and every later step trains the tail from it
(`forward_train_from_prefix`). The store is a device pool [N, S, D] in the
activation dtype, or int8 with one fp32 scale per token
(cache_store_dtype: int8), or the disk memmap of data/act_cache.py. A batch
whose rows are not all filled runs the prefix, stores its rows and trains on
the exact prefix output; a filled batch gathers its rows from the store.

Not in the port yet, and refused with NotImplementedError when a config
asks for them: a mesh, and the device-resident pixel pre-stage
(training.stage_pixels "on"; "auto" resolves to off on a GPU, as it does
off-TPU in the JAX package). Everything runs on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from owlvit_tpu_torch.data import DetectionDataset, batch_iterator, prefetch_to_device
from owlvit_tpu_torch.data.act_cache import ActivationCache, fingerprint
from owlvit_tpu_torch.data.coco import load_labelmap
from owlvit_tpu_torch.data.tokenizer import CLIPTokenizer, HashTokenizer, build_prompts
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.models.convert import from_jax_tree, load_params
from owlvit_tpu_torch.models.layers import fused_ln_enabled, normal
from owlvit_tpu_torch.ops import augment as aug_ops
from owlvit_tpu_torch.ops import losses as loss_ops
from owlvit_tpu_torch.ops import nms as nms_ops
from owlvit_tpu_torch.ops.flash_attention import resolve_static_max
from owlvit_tpu_torch.ops.map_metric import MeanAveragePrecision
from owlvit_tpu_torch.ops.preprocess import normalize_image
from owlvit_tpu_torch.ops.quant import dequantize_rows, quantize_rows
from owlvit_tpu_torch.utils.config import Config, ModelConfig, TrainingConfig
from owlvit_tpu_torch.utils.logging import JSONLLogger, LossAccumulator, ProgressFormatter

from . import checkpoint as ckpt
from .state import partition_params

# the four loss terms, in the order train_step returns them
TERM_KEYS = ("loss_ce", "loss_bg", "loss_bbox", "loss_giou")

# cache_backbone_store "auto" keeps the pool on the device when it fits the
# budget: the card's memory less this margin for the parameters, the
# optimizer, the step's activations and the allocator's slack (the JAX
# package leaves ~5 GB of a 16 GB v5e; the port's cached B/16 batch-32 step
# peaks 5.9 GB above its pool on the H100, PERF.md section 5).
AUTO_POOL_MARGIN_BYTES = 20e9
# On the CPU, the JAX package's v5e figure, so that a set resolves as it does
# in the JAX package's tests.
AUTO_POOL_BYTES_CPU = 10e9

# training.stage_pixels, as the JAX package reads it
_STAGE_OFF, _STAGE_ON = ("off", "false", "0", "none", ""), ("on", "true", "1")

_NOT_PORTED = (
    ("a mesh (training.mesh_data x training.mesh_model > 1)",
     lambda t, m: t.mesh_data * t.mesh_model > 1),
    ("training.stage_pixels: on (the device-resident pixel pre-stage)",
     lambda t, m: _stage_pixels(t) in _STAGE_ON),
)

# image metadata the data feed adds: read on the host only, never by the step
_META_KEYS = ("image_valid", "width", "height")


def _stage_pixels(t: TrainingConfig) -> str:
    v = str(t.stage_pixels).strip().lower()
    if v != "auto" and v not in _STAGE_OFF + _STAGE_ON:
        raise ValueError(
            f"training.stage_pixels must be auto|on|off, got {t.stage_pixels!r}")
    return v


def _validate(t: TrainingConfig, m: ModelConfig) -> None:
    """The JAX package's refusals of a training config, then the settings
    the port does not have yet (NotImplementedError)."""
    if t.grad_accum < 1:
        raise ValueError(f"training.grad_accum must be >= 1, got {t.grad_accum}")
    if t.ema_decay and not 0.0 < t.ema_decay < 1.0:
        raise ValueError(f"training.ema_decay must be in (0, 1), got {t.ema_decay}")
    if t.augment and t.cache_backbone:
        raise ValueError(
            "training.augment and training.cache_backbone are mutually "
            "exclusive: the activation cache stores frozen-prefix outputs "
            "of CONSTANT pixels; augmentation changes pixels every step. "
            "For flip augmentation under the cache use "
            "training.augment_hflip (deterministic two-row pool).")
    if t.augment and t.augment_hflip:
        raise ValueError(
            "training.augment already includes hflip (training.aug_hflip); "
            "training.augment_hflip is the cache-compatible variant — "
            "enable one or the other")
    for what, asked in _NOT_PORTED:
        if asked(t, m):
            raise NotImplementedError(f"{what} is not ported to owlvit_tpu_torch yet")


def _device(device) -> torch.device:
    """The run's device: the card unless the caller asks for the CPU; a
    CUDA device where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to run "
                           "on the CPU")
    return device


def _tokenizer(m: ModelConfig, max_len: int, vocab_size: int):
    """The CLIP BPE from model.clip_vocab/clip_merges, or the HashTokenizer
    fallback, with the JAX package's refusals (`_build_query_bank`)."""
    if bool(m.clip_vocab) != bool(m.clip_merges):
        raise ValueError(
            "model.clip_vocab and model.clip_merges must be set together "
            f"(got clip_vocab={m.clip_vocab!r}, clip_merges={m.clip_merges!r})"
        )
    if m.clip_vocab:
        return CLIPTokenizer(m.clip_vocab, m.clip_merges, max_len=max_len)
    if m.params_npz:
        # a real converted checkpoint with a fake tokenizer would silently
        # produce a meaningless query bank
        raise ValueError(
            "model.params_npz is set (real checkpoint) but "
            "model.clip_vocab/clip_merges are not: the fallback "
            "HashTokenizer would build a meaningless query bank. "
            "Provide the real CLIP BPE assets (see "
            "scripts/fetch_assets.py) or unset params_npz."
        )
    return HashTokenizer(vocab_size, max_len=max_len)


def _dataset_id(train_ds) -> list:
    """The train images' identity for the disk store's fingerprint: each
    key with its file's size and mtime, so that a rewritten or regenerated
    image invalidates the stored rows."""
    ids = []
    for key, _ in train_ds.items:
        path = os.path.join(train_ds.images_dir, os.path.basename(key))
        try:
            st = os.stat(path)
            ids.append((key, st.st_size, int(st.st_mtime)))
        except OSError:
            ids.append((key, -1, -1))
    return ids


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


def auto_pool_budget(device: torch.device) -> float:
    """Bytes the "auto" store may give the device pool: the card's memory
    less AUTO_POOL_MARGIN_BYTES, or AUTO_POOL_BYTES_CPU on the CPU."""
    if device.type != "cuda":
        return AUTO_POOL_BYTES_CPU
    return torch.cuda.mem_get_info(device)[1] - AUTO_POOL_MARGIN_BYTES


def _tensor(x, device, dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=device, dtype=dtype)


class Trainer:
    """Fine-tunes `model` (an owlvit.OwlViT with a query bank): one step at
    a time on batches the caller gives `train_step`, or whole runs (`run`,
    `evaluate`) when built by `from_config` or `with_data`.

    config: the port's Config (utils/config.py); model.name, dtype,
    attention_impl and trainable_last_k pick the model configuration,
    training.learning_rate, lr_schedule, warmup_steps, lr_final, n_epochs
    and weight_decay the optimizer, and training.cache_backbone,
    cache_backbone_store and cache_store_dtype the activation cache.
    steps_per_epoch sizes the cosine schedule: optimizer updates per epoch
    (micro-steps // grad_accum). class_weights: [n_classes] BCE weights, or
    None. The other training options (grad_accum, ema_decay, ema_eval,
    augment, augment_hflip, profile_dir) and model.remat are read from the
    config, as the module docstring describes.

    For the cache only: n_images, the number of images in the train set
    (the store's rows, indexed by batch["indices"]); workdir, where the
    disk store lives; dataset_id, a JSON-able identity of the train set
    (image keys with their sizes and times, say) that enters the disk
    store's fingerprint, so that a changed set never reads stale rows.

    device: the card unless the caller asks for "cpu"; raises where there
    is no card."""

    def __init__(self, config: Config, model: owlvit.OwlViT, n_classes: int, *,
                 steps_per_epoch: int, class_weights=None, device="cuda",
                 n_images: Optional[int] = None, workdir: Optional[str] = None,
                 dataset_id=None):
        t, m = config.training, config.model
        _validate(t, m)
        if model.queries is None:
            raise ValueError("the model has no query bank to fine-tune")
        self.cfg = config
        self.device = _device(device)
        self.workdir = "." if workdir is None else workdir
        # set by with_data: what run() and evaluate() read
        self.train_ds = self.test_ds = self.labelmap = None
        self.query_bank_secs = None  # the text tower's time, when it ran
        # static_softmax stays False: the tail takes a gradient
        self.model_cfg = get_config(m.name, dtype=m.dtype,
                                    attention_impl=m.attention_impl,
                                    trainable_last_k=m.trainable_last_k,
                                    remat=m.remat)
        # eval: every layer in one forward, no gradient (JAX: eval_step)
        self.eval_cfg = self.model_cfg.replace(trainable_last_k=None)
        self.model = model.to(self.device)
        self.n_classes = n_classes
        self.params = partition_params(self.model, m.trainable_last_k)
        self.opt = torch.optim.AdamW(self.params, lr=t.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=t.weight_decay)
        self.lr = lr_schedule(t, steps_per_epoch)
        self.class_weights = (None if class_weights is None
                              else _tensor(class_weights, self.device, torch.float32))
        self.step = 0  # micro-steps done (a checkpoint's step)
        self.updates = 0  # optimizer updates done (the schedule's step)
        # grad_accum: the running mean of this accumulation's gradients and
        # the micro-steps in it so far (optax.MultiSteps' acc_grads, mini_step)
        self.mini_step = 0
        self.grad_acc = ([torch.zeros_like(p) for p in self.params]
                         if t.grad_accum > 1 else None)
        # ema_decay: the fp32 EMA of the trainable set, in self.params' order
        self.ema = ([p.detach().float().clone() for p in self.params]
                    if t.ema_decay else None)
        self.hflip = t.augment_hflip

        self.act_store = None  # "device" | "disk" with cache_backbone
        self.act_cache = None  # the disk store
        self.pool = None  # the device store, allocated at the first filled batch
        if t.cache_backbone:
            if m.trainable_last_k is None:
                raise ValueError(
                    "training.cache_backbone requires model.trainable_last_k "
                    "(full fine-tuning has no frozen prefix to cache)")
            self._setup_act_cache(n_images, workdir, dataset_id)

    # ----------------------------------------------------------------- setup

    @classmethod
    def from_config(cls, config: Config, workdir: str = ".", *,
                    device="cuda") -> "Trainer":
        """The JAX package's `Trainer(config, workdir)`: writes the
        synthetic set when data.synthetic_root is set (pointing data.* at
        it), loads the labelmap and the train and test DetectionDatasets,
        then `with_data` does the rest."""
        t, d = config.training, config.data
        _validate(t, config.model)
        _device(device)
        if d.synthetic_root:
            from owlvit_tpu_torch.data import synthetic  # PIL: only here

            paths = synthetic.generate(
                d.synthetic_root, n_train=d.num_train_images,
                n_test=d.num_test_images, n_classes=d.synthetic_classes,
                seed=t.seed)
            d.images_path = paths["images_dir"]
            d.train_annotations = paths["train"]
            d.test_annotations = paths["test"]
            d.labelmap = paths["labelmap"]
        size = get_config(config.model.name).vision.image_size
        train_ds, test_ds = (
            DetectionDataset(ann, d.images_path, image_size=size, max_gt=d.max_gt,
                             cache_resized=d.cache_resized,
                             native_decode=d.native_decode)
            for ann in (d.train_annotations, d.test_annotations))
        return cls.with_data(config, train_ds, test_ds, load_labelmap(d.labelmap),
                             workdir, device=device)

    @classmethod
    def with_data(cls, config: Config, train_ds, test_ds, labelmap: dict,
                  workdir: str = ".", *, device="cuda") -> "Trainer":
        """A trainer over ready datasets (DetectionDataset's interface:
        __len__, load_batch, class_scales; `items` and `images_dir` for the
        disk store's fingerprint) and labelmap {id: name}: the parameters
        (model.params_npz, else drawn from training.seed), the query bank
        when they lack one (the text tower over 3 prompts per class; a
        random bank when a checkpoint will overwrite it), the class weights
        (use_class_weight), the optimizer, the latest checkpoint and the
        mode banner."""
        t, m = config.training, config.model
        _validate(t, m)
        device = _device(device)
        os.makedirs(workdir, exist_ok=True)
        n_classes = len(labelmap)
        mcfg = get_config(m.name, dtype=m.dtype, attention_impl=m.attention_impl,
                          trainable_last_k=m.trainable_last_k)
        if m.params_npz:
            model, _ = from_jax_tree(load_params(m.params_npz), mcfg)
        else:
            model = owlvit.init(mcfg, torch.Generator().manual_seed(t.seed))
        model = model.to(device)
        bank_secs = None
        if model.queries is None:
            if t.checkpoint_dir and ckpt.latest_step(t.checkpoint_dir) is not None:
                # the checkpoint overwrites the bank: skip the text tower
                bank = normal((3 * n_classes, mcfg.projection_dim), 0.02,
                              torch.Generator().manual_seed(t.seed))
            else:
                tok = _tokenizer(m, mcfg.text.max_len, mcfg.text.vocab_size)
                enc = tok(build_prompts(labelmap))
                t0 = time.perf_counter()
                with torch.no_grad():
                    bank = owlvit.build_query_bank(
                        model, mcfg, torch.from_numpy(enc["input_ids"]).to(device),
                        torch.from_numpy(enc["attention_mask"]).to(device))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                bank_secs = time.perf_counter() - t0
            model.queries = nn.Parameter(bank.to(device))
        cached = t.cache_backbone
        trainer = cls(
            config, model, n_classes,
            # the schedule counts optimizer updates (JAX: _lr_schedule)
            steps_per_epoch=max(1, max(1, len(train_ds) // t.batch_size) // t.grad_accum),
            class_weights=(train_ds.class_scales(n_classes)
                           if t.use_class_weight else None),
            device=device, n_images=len(train_ds) if cached else None,
            workdir=workdir,
            dataset_id=(_dataset_id(train_ds)
                        if cached and t.cache_backbone_store != "device" else None))
        trainer.train_ds, trainer.test_ds, trainer.labelmap = train_ds, test_ds, labelmap
        trainer.query_bank_secs = bank_secs
        if t.checkpoint_dir:
            state = ckpt.restore(t.checkpoint_dir)
            if state is not None:
                trainer.load_state(state)
                print(f"resumed from step {trainer.step}", flush=True)
                ema = (ckpt.restore_tree(t.checkpoint_dir, trainer.step)
                       if trainer.ema is not None else None)
                if ema is not None:
                    for e, r in zip(trainer.ema, ema):
                        e.copy_(r)
                    print("resumed EMA params", flush=True)
        cache_desc = "act-cache off"
        if cached:
            cache_desc = (
                f"act-cache ON (store={trainer.act_store}"
                + (f", {t.cache_store_dtype}" if t.cache_store_dtype else "")
                + f", pool {trainer.pool_bytes / 1e9:.2f} GB"
                + (f" of a {trainer.pool_budget / 1e9:.2f} GB auto budget"
                   if t.cache_backbone_store == "auto" else "") + ")")
        print(f"trainer: model={m.name} dtype={m.dtype} "
              f"trainable_last_k={m.trainable_last_k} | {device} | {cache_desc} | "
              f"batch={t.batch_size}"
              + (f" | grad_accum={t.grad_accum} (eff. batch "
                 f"{t.grad_accum * t.batch_size})" if t.grad_accum > 1 else "")
              + (f" | ema={t.ema_decay}" + (" (eval on EMA)" if t.ema_eval else "")
                 if t.ema_decay else "")
              + (" | augment ON" if t.augment else "")
              + (" | hflip ON (cache-compatible)" if t.augment_hflip else "")
              + (" | remat" if m.remat else ""), flush=True)
        return trainer

    def state(self) -> dict:
        """What a checkpoint holds: every parameter (model), the AdamW state,
        the micro-steps and the updates done, and with grad_accum the
        accumulation in progress (its micro-steps and gradient mean)."""
        return {"model": self.model.state_dict(),
                "optimizer": self.opt.state_dict(), "step": self.step,
                "updates": self.updates, "mini_step": self.mini_step,
                "grad_acc": self.grad_acc}

    def load_state(self, state: dict) -> None:
        """Copy a checkpoint's state in (parameters in place, so the
        optimizer keeps its references)."""
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.updates = int(state.get("updates", self.step))
        self.mini_step = int(state.get("mini_step", 0))
        if self.grad_acc is not None and state.get("grad_acc") is not None:
            for a, g in zip(self.grad_acc, state["grad_acc"]):
                a.copy_(g)

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
        # augment_hflip: rows 2i (as is) and 2i+1 (x-mirrored)
        self.pool_rows = (2 if self.hflip else 1) * n_images
        self.pool_bytes = self.act_pool_bytes(self.pool_rows, qdt)
        self.pool_budget = auto_pool_budget(self.device)
        if store == "auto":
            store = "device" if self.pool_bytes <= self.pool_budget else "disk"
        if qdt and store != "device":
            raise ValueError(
                f"training.cache_store_dtype={qdt!r} only applies to the "
                f"device pool, but the store resolved to {store!r} (the disk "
                "memmap already persists at the activation dtype; if 'auto' "
                "picked disk, the set exceeds the pool budget even quantized)")
        if self.hflip and store == "disk":
            raise ValueError(
                "training.augment_hflip with cache_backbone requires the "
                "device store (two pool rows per image, selected per step); "
                f"the store resolved to 'disk'. Shrink the set, use "
                "cache_store_dtype: int8 (halves the pool), or drop hflip.")
        self.act_store, self.store_dtype = store, qdt
        self.n_images = n_images
        self.filled = np.zeros((self.pool_rows,), bool)  # device store rows
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
        """Zero-filled device pool of pool_rows rows (n_images, twice that
        with augment_hflip), allocated whole: [N, S, D] in the activation
        dtype, or {"q": int8 [N, S, D], "s": fp32 [N, S]} with
        cache_store_dtype int8."""
        shape = (self.pool_rows, *row_shape)
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

    def _cached_acts(self, batch, mark, flip=None) -> torch.Tensor:
        """The batch's prefix activations from the store, or computed,
        stored and returned when any of its rows is not stored yet. flip
        (augment_hflip): the host-sampled [B] bool flips, which pick pool
        row 2i + flip; a batch with rows to fill runs the prefix on its
        pixels and on their mirror, stores both rows of each image, then
        gathers."""
        idxs = np.asarray(batch["indices"], np.int64)
        disk = self.act_store == "disk"
        if "acts" in batch:  # stored rows the data feed read (_with_cached_acts)
            acts = batch["acts"].to(self.device)
            mark("input")
            mark("gather")
            return acts
        rows = idxs if flip is None else 2 * idxs + flip
        hit = self.act_cache.has(idxs) if disk else bool(self.filled[rows].all())
        if hit:
            if disk:
                mark("input")
                acts = self.act_cache.read_tensor(idxs).to(self.device)
            else:
                rows = torch.from_numpy(rows).to(self.device)
                mark("input")
                acts = self.pool_gather(rows)
            mark("gather")
            return acts
        image = self._image(batch)
        mark("input")
        acts = owlvit.embed_prefix(self.model, self.model_cfg,
                                   normalize_image(image))
        if flip is not None:  # the odd rows: the prefix of the mirrored pixels
            acts_f = owlvit.embed_prefix(self.model, self.model_cfg,
                                         normalize_image(image.flip(2)))
        mark("prefix")
        if disk:
            self.act_cache.write_tensor(idxs, acts)
            mark("scatter")
            return acts
        if self.pool is None:
            self._init_pool(acts.shape[1:], acts.dtype)
        if flip is None:
            self.pool_scatter(torch.from_numpy(idxs).to(self.device), acts)
            self.filled[idxs] = True
            mark("scatter")
            return acts  # the exact prefix output trains this step
        self.pool_scatter(torch.from_numpy(2 * idxs).to(self.device), acts)
        self.pool_scatter(torch.from_numpy(2 * idxs + 1).to(self.device), acts_f)
        self.filled[2 * idxs] = self.filled[2 * idxs + 1] = True
        mark("scatter")
        acts = self.pool_gather(torch.from_numpy(rows).to(self.device))
        mark("gather")
        return acts

    # ------------------------------------------------------------- the step

    def _sample_flips(self, n: int) -> np.ndarray:
        """augment_hflip's flips for this micro-step: numpy Philox keyed by
        (training.seed, micro-steps done), the JAX package's bits (its
        batch counter is the micro-step count in a run)."""
        rng = np.random.Generator(
            np.random.Philox(key=[self.cfg.training.seed, self.step]))
        return rng.random(n) < 0.5

    def _aug_generator(self) -> torch.Generator:
        """training.augment's generator for this micro-step, seeded from
        (training.seed, micro-steps done), as the JAX package folds its key
        with state.step."""
        seed = np.random.SeedSequence([self.cfg.training.seed, self.step])
        return torch.Generator().manual_seed(int(seed.generate_state(1, np.uint64)[0]))

    def train_step(self, batch: dict,
                   mark: Optional[Callable[[str], None]] = None) -> np.ndarray:
        """One micro-step on batch {"image": uint8 [B, S*S*3] or [B, S, S,
        3], "labels": [B, G], "boxes": [B, G, 4] xyxy in [0, 1], "gt_mask":
        [B, G]} -> the loss terms [4] in TERM_KEYS order: an optimizer
        update, or with grad_accum k one micro-step of k (the update on the
        k-th). With cache_backbone the batch also carries "indices" [B], the
        images' rows in the train set, and may leave out "image" when every
        row is stored.

        mark, if given, is called with the name of each phase as it is
        issued: "input" (the batch on the device), then uncached "forward";
        cached, a batch with rows to fill "prefix" and "scatter", a stored
        batch "gather", then "forward" (the tail and the heads); then
        "cost", "host", "loss", "backward", "optimizer"."""
        mark = mark or (lambda name: None)
        t = self.cfg.training
        dev = self.device
        labels = _tensor(batch["labels"], dev, torch.int64)
        gt_boxes = _tensor(batch["boxes"], dev, torch.float32)
        gt_mask = _tensor(batch["gt_mask"], dev, torch.bool)
        flip = self._sample_flips(labels.shape[0]) if self.hflip else None
        if flip is not None:
            flip_dev = torch.from_numpy(flip).to(dev)
        if self.act_store is None:
            image = self._image(batch)
            mark("input")
            if flip is not None:
                image, gt_boxes = aug_ops.apply_hflip(image, gt_boxes, flip_dev)
            if t.augment:
                image, gt_boxes, gt_mask = aug_ops.augment_batch(
                    self._aug_generator(), image, gt_boxes, gt_mask,
                    hflip_prob=t.aug_hflip, color_strength=t.aug_color,
                    scale_min=t.aug_scale_min, scale_max=t.aug_scale_max)
        else:
            acts = self._cached_acts(batch, mark, flip)
            if flip is not None:  # the gathered rows are mirrored already
                gt_boxes = aug_ops.mirror_boxes(gt_boxes, flip_dev)

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
        self._update()
        mark("optimizer")
        self.step += 1
        return torch.stack([terms[k].detach() for k in TERM_KEYS]).cpu().numpy()

    def _update(self) -> None:
        """The optimizer update from the gradients of this micro-step: AdamW
        at once, or with grad_accum k optax.MultiSteps' cadence (the grads
        join the accumulation's running mean; on its k-th micro-step AdamW
        steps on the mean and the mean is reset). The EMA follows each
        update."""
        accum = self.cfg.training.grad_accum
        if accum > 1:
            n = torch.full((), self.mini_step + 1.0, device=self.device)
            for a, p in zip(self.grad_acc, self.params):
                a.add_((p.grad - a) / n)
            self.mini_step = (self.mini_step + 1) % accum
            if self.mini_step:
                return
            for a, p in zip(self.grad_acc, self.params):
                p.grad.copy_(a)
                a.zero_()
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.updates)
        self.opt.step()
        self.updates += 1
        if self.ema is not None:
            d = self.cfg.training.ema_decay
            with torch.no_grad():
                for e, p in zip(self.ema, self.params):
                    e.mul_(d).add_(p.float() * (1.0 - d))

    # ------------------------------------------------------------ data feed

    def _want_image(self):
        """batch_iterator callback: skip the decode of a batch whose rows
        are all stored (its pixels would go unread), None uncached."""
        if self.act_store is None:
            return None
        if self.act_store == "device":
            if self.hflip:  # pixels until both rows of every image are stored
                return lambda idxs: not (self.filled[2 * np.asarray(idxs)].all()
                                         and self.filled[2 * np.asarray(idxs) + 1].all())
            return lambda idxs: not self.filled[np.asarray(idxs)].all()
        return lambda idxs: not self.act_cache.has(idxs)

    def _with_cached_acts(self, it):
        """Disk store: attach the stored rows on the host side (in the
        data feed's thread), dropping the pixels."""
        for batch in it:
            if self.act_cache.has(batch["indices"]):
                batch["acts"] = self.act_cache.read_tensor(batch["indices"])
                batch.pop("image", None)
            yield batch

    def _need_data(self) -> None:
        if self.train_ds is None:
            raise ValueError("run() and evaluate() need the datasets: build the "
                             "trainer with Trainer.from_config or Trainer.with_data")

    # ------------------------------------------------------------------ run

    def run(self) -> dict:
        """Train to training.n_epochs in all, resuming after the epochs a
        restored checkpoint holds; eval every eval_every_epochs and at the
        last epoch. Returns the last eval's metrics."""
        self._need_data()
        t = self.cfg.training
        logger = (JSONLLogger(os.path.join(self.workdir, t.log_file))
                  if t.log_file else None)
        acc = LossAccumulator()
        progress = ProgressFormatter()
        class_maps = {name: [] for name in self.labelmap.values()}
        last_val = {}
        tb = None
        if t.tensorboard_dir:
            from owlvit_tpu_torch.utils.tb_writer import TBWriter

            tb = TBWriter(os.path.join(self.workdir, t.tensorboard_dir))
        if t.keep_best and not t.checkpoint_dir:
            raise ValueError("training.keep_best requires training.checkpoint_dir")
        best_map = -1.0
        evals_since_best = 0

        if len(self.train_ds) < t.batch_size:
            raise ValueError(
                f"training.batch_size={t.batch_size} exceeds the train set "
                f"({len(self.train_ds)} images) — every epoch would drop the "
                f"ragged remainder and train on nothing"
            )

        # a restored checkpoint at step k*spe means k epochs are done:
        # continue to n_epochs in all (steps and spe count micro-steps)
        spe = max(1, len(self.train_ds) // t.batch_size)
        start_epoch = min(self.step // spe, t.n_epochs)
        if start_epoch:
            print(
                f"resume: {start_epoch}/{t.n_epochs} epoch(s) already "
                f"complete at step {self.step} — "
                + ("nothing left to train; running eval"
                   if start_epoch >= t.n_epochs else
                   f"continuing from epoch {start_epoch}"),
                flush=True,
            )
        if start_epoch >= t.n_epochs:
            last_val = self.evaluate(epoch=t.n_epochs - 1)

        profiler = None
        for epoch in range(start_epoch, t.n_epochs):
            acc.reset()
            ep_t0 = time.perf_counter()
            it = batch_iterator(self.train_ds, t.batch_size, shuffle=True,
                                seed=t.seed + epoch, pad_final=False,
                                want_image=self._want_image())
            if self.act_cache is not None:  # disk store: rows read host-side
                it = self._with_cached_acts(it)
            for step_i, batch in enumerate(prefetch_to_device(
                    it, device=self.device, host_keys=_META_KEYS)):
                for k in ("paths",) + _META_KEYS:
                    batch.pop(k, None)
                if t.profile_dir and epoch == 0 and step_i == 1:
                    # step 0 warms up (the kernels' first launches, the pool)
                    profiler = self._start_profile()
                terms = self.train_step(batch)  # ends in a device read
                acc.update(dict(zip(TERM_KEYS, terms.tolist())))
                if profiler and step_i >= t.profile_steps:
                    self._stop_profile(profiler)
                    profiler = None
            if profiler:  # an epoch shorter than profile_steps
                self._stop_profile(profiler)
                profiler = None

            # the epoch's training wall, before eval
            epoch_train_secs = time.perf_counter() - ep_t0
            epoch_imgs = (len(self.train_ds) // t.batch_size) * t.batch_size

            train_metrics = acc.means()
            run_eval = ((epoch + 1) % max(1, t.eval_every_epochs) == 0
                        or epoch == t.n_epochs - 1)
            val_metrics = self.evaluate(epoch=epoch) if run_eval else {}
            if run_eval:
                last_val = val_metrics
                for i, name in sorted(self.labelmap.items()):
                    class_maps[name].append(float(val_metrics["map_per_class"][i]))
                with open(os.path.join(self.workdir, "class_maps.json"), "w") as f:
                    json.dump(class_maps, f)

            improved = False
            if run_eval:
                m = float(val_metrics.get("map", 0.0))
                if m > best_map:
                    best_map, evals_since_best, improved = m, 0, True
                else:
                    evals_since_best += 1

            progress.update(epoch, train_metrics, val_metrics)
            progress.print()
            if logger:
                logger.log(
                    dict(epoch=epoch, step=self.step,
                         # not train_-prefixed: tests compare the train_*
                         # keys across runs, and wall-clock fields must
                         # stay out of that set
                         epoch_train_secs=round(epoch_train_secs, 4),
                         epoch_imgs_per_sec=round(
                             epoch_imgs / max(epoch_train_secs, 1e-9), 2),
                         **{f"train_{k}": v for k, v in train_metrics.items()},
                         **{f"val_{k}": v for k, v in val_metrics.items()
                            if not k.endswith("per_class")})
                )
            if tb:
                tb.scalars(train_metrics, epoch, prefix="train/")
                if run_eval:
                    tb.scalars(val_metrics, epoch, prefix="val/")
                tb.flush()
            if (t.checkpoint_dir and t.checkpoint_every_epochs > 0  # 0: off
                    and (epoch + 1) % t.checkpoint_every_epochs == 0):
                path = ckpt.save(t.checkpoint_dir, self.state())
                if self.ema is not None:
                    ckpt.save_tree(t.checkpoint_dir, self.step, self.ema)
                print(f"checkpoint: {path}", flush=True)
            if improved and t.keep_best:
                bdir = os.path.join(t.checkpoint_dir, "best")
                path = ckpt.save(bdir, self.state())
                if self.ema is not None:
                    ckpt.save_tree(bdir, self.step, self.ema)
                ckpt.prune_steps(bdir, self.step)
                print(f"best checkpoint (map={best_map:.4f}): {path}", flush=True)
            if t.early_stop_patience and evals_since_best >= t.early_stop_patience:
                print(
                    f"early stop at epoch {epoch}: no mAP improvement in "
                    f"{evals_since_best} eval(s) (best {best_map:.4f})",
                    flush=True,
                )
                break

        if tb:
            tb.close()
        if logger:
            logger.close()
        return last_val

    def _start_profile(self) -> torch.profiler.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
        profiler.first_step = self.step
        return profiler

    def _stop_profile(self, profiler: torch.profiler.profile) -> str:
        """Stop the trace and write it as <workdir>/<profile_dir>/
        steps_<first>-<last>.trace.json (Chrome trace format)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out = os.path.join(self.workdir, self.cfg.training.profile_dir)
        os.makedirs(out, exist_ok=True)
        path = os.path.join(
            out, f"steps_{profiler.first_step:08d}-{self.step - 1:08d}.trace.json")
        profiler.export_chrome_trace(path)
        print(f"profiler trace: {path}", flush=True)
        return path

    # ----------------------------------------------------------------- eval

    @contextlib.contextmanager
    def _eval_weights(self):
        """With an EMA and training.ema_eval, the EMA in the trainable
        parameters for the block, the trained values copied back after it
        (bit for bit); otherwise nothing changes."""
        if self.ema is None or not self.cfg.training.ema_eval:
            yield
            return
        trained = [p.detach().clone() for p in self.params]
        with torch.no_grad():
            for p, e in zip(self.params, self.ema):
                p.copy_(e)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, v in zip(self.params, trained):
                    p.copy_(v)

    def eval_batch(self, image) -> np.ndarray:
        """uint8 [B, S*S*3] or [B, S, S, 3] -> packed detections [B, K, 7]
        (xyxy in [0, 1], score, class, valid), in one device read: the eval
        forward (every layer, no gradient, per-row softmax max) +
        postprocess + pack_detections."""
        with torch.no_grad():
            px = normalize_image(self._image({"image": image}))
            return self._pack(*owlvit.forward_train(self.model, self.eval_cfg, px))

    def _pack(self, boxes, sims) -> np.ndarray:
        """postprocess + pack_detections of a forward's (boxes, sims) ->
        packed detections [B, K, 7] on the host."""
        t = self.cfg.training
        with torch.no_grad():
            out = nms_ops.postprocess(
                boxes, sims, confidence_threshold=t.confidence_threshold,
                iou_threshold=t.iou_threshold, top_k=t.top_k)
            return nms_ops.pack_detections(out).cpu().numpy()

    def evaluate(self, epoch: Optional[int] = None, infer_fn=None,
                 save_detections: Optional[str] = None) -> dict:
        """Eval epoch over the test set -> the COCO mAP dict, on the EMA
        weights with ema_eval (see _eval_weights).

        infer_fn: a callable uint8 images [B, S, S, 3] (on the trainer's
        device) -> (boxes, sims), e.g. a loaded export artifact
        (train/export.py). The same postprocess, packing and metric run on
        its outputs, so `cli eval --from-export` shows that the served
        artifact reproduces the eval; the EMA swap applies only without it.

        save_detections: a path; writes every kept detection in
        COCO-results style ({image_id, image_path, category_id,
        category_name, bbox [x, y, w, h] in pixels, score}); category_id
        is the dense 0..C-1 training id. With training.save_eval_images and
        an epoch, each test image is drawn with its detections under
        <workdir>/debug/<epoch>/ (PIL, on the host)."""
        self._need_data()
        t = self.cfg.training
        metric = MeanAveragePrecision(self.n_classes)
        debug_dir = None
        if t.save_eval_images and epoch is not None:
            debug_dir = os.path.join(self.workdir, "debug", str(epoch))
            os.makedirs(debug_dir, exist_ok=True)
        detections = [] if save_detections else None
        img_idx = 0
        it = batch_iterator(self.test_ds, t.batch_size, shuffle=False)
        # ground truth and image metadata are read on the host only
        batches = prefetch_to_device(
            it, device=self.device,
            host_keys=_META_KEYS + ("boxes", "labels", "gt_mask"))
        if infer_fn is None:
            weights, packed_fn = self._eval_weights(), self.eval_batch
        else:
            weights = contextlib.nullcontext()

            def packed_fn(image):
                return self._pack(*infer_fn(self._image({"image": image})))

        with weights:
            for bi, batch in enumerate(batches):
                paths = batch.pop("paths", None)
                packed = packed_fn(batch["image"])
                widths, heights = batch["width"], batch["height"]
                gt_boxes, gt_labels, gt_mask = batch["boxes"], batch["labels"], batch["gt_mask"]
                for i, valid in enumerate(batch["image_valid"]):
                    if not valid:
                        continue
                    w, h = float(widths[i]), float(heights[i])
                    keep = packed[i, :, 6] > 0.5
                    det_boxes = packed[i, keep, :4]
                    det_scores = packed[i, keep, 4]
                    det_classes = packed[i, keep, 5].astype(np.int32)
                    scale = np.array([w, h, w, h])
                    metric.update(det_boxes * scale, det_scores, det_classes,
                                  gt_boxes[i][gt_mask[i]] * scale,
                                  gt_labels[i][gt_mask[i]])
                    if detections is not None:
                        for b, s, c in zip(det_boxes * scale, det_scores, det_classes):
                            x0, y0, x1, y1 = (float(v) for v in b)
                            detections.append({
                                "image_id": img_idx,
                                "image_path": paths[i] if paths else None,
                                "category_id": int(c),
                                "category_name": self.labelmap.get(int(c), "?"),
                                "bbox": [x0, y0, x1 - x0, y1 - y0],
                                "score": float(s),
                            })
                    img_idx += 1
                    if debug_dir and paths:
                        self._save_debug_image(paths[i], det_boxes * scale, det_classes,
                                               os.path.join(debug_dir, f"{bi}_{i}.png"))
        if save_detections:
            with open(save_detections, "w") as f:
                json.dump(detections, f)
            print(f"wrote {len(detections)} detections: {save_detections}", flush=True)
        return metric.compute()

    def _save_debug_image(self, src, boxes_abs, classes, out_path):
        from PIL import Image, ImageDraw

        img = Image.open(src).convert("RGB")
        draw = ImageDraw.Draw(img)
        for b, c in zip(boxes_abs, classes):
            draw.rectangle(list(map(float, b)), outline=(0, 255, 0), width=2)
            draw.text((float(b[0]), float(b[1])), self.labelmap.get(int(c), "?"),
                      fill=(0, 255, 0))
        img.save(out_path)
