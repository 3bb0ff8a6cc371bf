"""The activation-cache steady-state measurement (counterpart of
owlvit_tpu/utils/bench_cached.py).

One implementation of the cached step's timing, so that every caller
measures the same steps in the same order: build the model and AdamW, run
the frozen prefix once, time the RESIDENT tail step (the prefix output
passed directly), then the GATHER step (the batch's rows gathered from a
device pool, as the trainer's gathered step does), then the SPLIT gather
(the gather issued on its own before each step). In eager PyTorch the
gather and split steps make the same calls (the JAX package compiles the
gather into the step or into a program of its own); the split phase is
kept so that the sequence, its step count and so the parameters'
trajectory are the JAX function's. Every timed window ends in a device
synchronisation.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.ops import losses as loss_ops
from owlvit_tpu_torch.ops.preprocess import normalize_image
from owlvit_tpu_torch.train.state import partition_params


def build_batch(cfg, batch, n_classes, seed=0, device="cuda"):
    """The benchmark's batch on `device`: random uint8 images, 16 GT slots
    (8 valid) with one fixed box and random labels; the same numpy draws as
    the JAX function, so the arrays are equal."""
    G = min(16, cfg.vision.num_patches)
    S = cfg.vision.image_size
    rng = np.random.default_rng(seed)
    arrays = {
        "image": rng.integers(0, 255, size=(batch, S, S, 3), dtype=np.uint8),
        "boxes": np.tile(np.asarray([[0.2, 0.2, 0.6, 0.7]], np.float32), (batch, G, 1)),
        "labels": rng.integers(0, n_classes, size=(batch, G), dtype=np.int32),
        "gt_mask": np.tile(np.arange(G) < min(8, G), (batch, 1)),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def measure_cached_steady_state(
    model: str,
    batch: int,
    steps: int,
    *,
    dtype: str = "bfloat16",
    trainable_last_k: int = 1,
    n_classes: int = 80,
    seed: int = 0,
    pool_bytes: float = 2e9,
    max_pool_rows: int = 2500,
    pool_gather: bool = True,
    split_gather: bool = True,
    device: torch.device | str = "cuda",
) -> dict:
    """Returns dict(tail_imgs_per_sec, gather_imgs_per_sec,
    split_gather_imgs_per_sec, loss, acts_mb, pool_imgs). On the card
    unless `device` says otherwise; raises where there is no CUDA."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("measure_cached_steady_state: no CUDA device; pass "
                           "device='cpu' to measure on the CPU")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = get_config(model, dtype=dtype, trainable_last_k=trainable_last_k)
    params = owlvit.init(cfg, torch.Generator().manual_seed(seed),
                         num_queries=3 * n_classes, device=device)
    trainable = partition_params(params, trainable_last_k)
    opt = torch.optim.AdamW(trainable, lr=3e-6, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.1)
    data = build_batch(cfg, batch, n_classes, seed, device)
    la, bo, gm = data["labels"], data["boxes"], data["gt_mask"]
    rng = np.random.default_rng(seed)

    def tail_step(acts):
        boxes, sims = owlvit.forward_train_from_prefix(params, cfg, acts)
        terms = loss_ops.push_pull_loss(sims, boxes, la, bo, gm, n_classes)
        loss = loss_ops.total_loss(terms)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    def timed(make_acts):
        """One warm-up step, then `steps` timed ones -> (img/s, last loss)."""
        loss = tail_step(make_acts())
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = tail_step(make_acts())
        sync()
        return steps * batch / (time.perf_counter() - t0), float(loss)

    acts = owlvit.embed_prefix(params, cfg, normalize_image(data["image"]))
    sync()
    acts_mb = acts.numel() * acts.element_size() / 1e6
    tail_ips, loss_val = timed(lambda: acts)

    # The device-store steady state: a pool of prefix rows on the device,
    # zeros but for the batch's own rows, which each step gathers (the
    # gather's cost depends on shapes, not on the index values).
    row_bytes = acts[0].numel() * acts.element_size()
    pool = max(batch, min(max_pool_rows, int(pool_bytes // row_bytes)))
    acts_all = torch.zeros((pool, *acts.shape[1:]), dtype=acts.dtype, device=device)
    acts_all[:batch] = acts
    idxs = torch.from_numpy(rng.integers(0, batch, (batch,), dtype=np.int64)).to(device)

    gather_ips = None
    if pool_gather:
        gather_ips, loss_val = timed(lambda: acts_all[idxs])

    split_ips = None
    if split_gather:
        split_ips, loss_val = timed(lambda: acts_all[idxs])

    def rate(ips):
        return None if ips is None else round(ips, 2)

    return {
        "tail_imgs_per_sec": rate(tail_ips),
        "gather_imgs_per_sec": rate(gather_ips),
        "split_gather_imgs_per_sec": rate(split_ips),
        "loss": loss_val,
        "acts_mb": round(acts_mb, 1),
        "pool_imgs": int(pool),
    }
