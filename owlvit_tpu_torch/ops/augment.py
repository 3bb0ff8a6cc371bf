"""Data augmentation on the device, box-aware (counterpart of
owlvit_tpu/ops/augment.py): horizontal flip with the boxes' x-mirror,
colour jitter (brightness, contrast, saturation), and scale jitter (zoom in
is a random crop, zoom out shrinks the image onto a zero canvas) as a
fixed-shape resample, so every sampled window keeps the model's input size.

Randomness: each sampler draws its per-image parameters from an explicit
`torch.Generator` on the host (the trainer seeds one from (training.seed,
micro-step), as the JAX package folds its key with the step), then moves
them to the images' device; the same generator state gives the same
parameters on the CPU and on the card. jax.random's bits cannot be
reproduced here, so the deterministic cores (`apply_hflip`, `apply_color`,
`apply_scale_window`) are the functions held to the JAX ones.

Coordinates: boxes are normalized xyxy. Boxes pushed outside a crop are
clipped; a box whose visible area falls below `min_visibility` of its
transformed area has its gt_mask slot cleared (slots are never compacted).

The activation cache stores the frozen prefix of constant pixels, so the
trainer refuses `training.augment` with `training.cache_backbone`; the flip
alone composes with the cache through the two-row pool
(training.augment_hflip), whose flips are sampled by the trainer.
"""

from __future__ import annotations

import numpy as np
import torch

from .preprocess import triangle, weight_mat_at

# ITU-R BT.601 luma weights (torchvision's rgb_to_grayscale convention)
_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


def _rows(n: int, share) -> tuple:
    """(draws to make, the images' rows among them): n and all n, or for a
    share (start, total) of a larger batch, total and [start, start + n)."""
    if share is None:
        return n, slice(0, n)
    start, total = share
    return total, slice(start, start + n)


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float,
             device, share=None) -> torch.Tensor:
    """n fp32 draws from [lo, hi) on the host generator, on `device` (the
    rows of `share` among its draws, see augment_batch)."""
    total, rows = _rows(n, share)
    u = torch.rand(total, generator=generator, dtype=torch.float32)[rows]
    return (lo + (hi - lo) * u).to(device)


def mirror_boxes(boxes: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """x-mirror normalized-xyxy boxes [B, G, 4] where flip [B] is True."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    mirrored = torch.stack([1.0 - x2, y1, 1.0 - x1, y2], dim=-1)
    return torch.where(flip[:, None, None], mirrored, boxes)


def apply_hflip(images: torch.Tensor, boxes: torch.Tensor, flip: torch.Tensor):
    """Deterministic hflip core: flip [B] bool selects which images [B, H,
    W, C] and boxes mirror. Shared by `hflip` and the trainer's
    training.augment_hflip, whose flips are sampled on the host."""
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    return images, mirror_boxes(boxes, flip)


def hflip(generator: torch.Generator, images: torch.Tensor, boxes: torch.Tensor,
          prob: float = 0.5, share=None):
    """Per-image random horizontal flip with probability prob. images [B,
    H, W, 3], boxes [B, G, 4] normalized xyxy -> (images, boxes)."""
    total, rows = _rows(images.shape[0], share)
    flip = torch.rand(total, generator=generator)[rows] < prob
    return apply_hflip(images, boxes, flip.to(images.device))


def apply_color(images: torch.Tensor, fb, fc, fs) -> torch.Tensor:
    """Brightness, then contrast, then saturation, with per-image [B] (or
    scalar) factors, torchvision's semantics: each blends on the current
    image, so the saturation's gray is recomputed after the contrast.
    images float [B, H, W, 3] in [0, 255]."""
    def per_image(f):
        return torch.as_tensor(f, dtype=torch.float32,
                               device=images.device).reshape(-1, 1, 1, 1)

    luma = torch.from_numpy(_LUMA).to(images.device)
    x = images * per_image(fb)
    # contrast: pull toward the per-image mean of the gray
    mean = (x @ luma).mean(dim=(1, 2))[:, None, None, None]
    x = mean + per_image(fc) * (x - mean)
    # saturation: pull toward the current per-pixel gray
    gray = (x @ luma)[..., None]
    x = gray + per_image(fs) * (x - gray)
    return torch.clamp(x, 0.0, 255.0)


def color_jitter(generator: torch.Generator, images: torch.Tensor,
                 strength: float, share=None) -> torch.Tensor:
    """Brightness, contrast and saturation, each scaled by a per-image
    factor drawn from [1 - strength, 1 + strength]. images float [B, H, W,
    3] in [0, 255]."""
    if strength <= 0.0:
        return images
    B = images.shape[0]
    fb, fc, fs = (_uniform(generator, B, 1.0 - strength, 1.0 + strength,
                           images.device, share) for _ in range(3))
    return apply_color(images, fb, fc, fs)


def apply_scale_window(images: torch.Tensor, boxes: torch.Tensor,
                       gt_mask: torch.Tensor, x0, y0, s,
                       min_visibility: float = 0.1):
    """Resample each image so that the window [x0, x0 + s] x [y0, y0 + s]
    (normalized input coordinates, per-image [B]; past [0, 1] when s > 1)
    fills the fixed output: `jax.image.scale_and_translate` with the linear
    kernel and antialiasing, built as one weight matrix per axis and image
    and applied axis by axis; samples outside the image are zero.

    Boxes map by (box - origin) / s, then clip; slots whose visible area
    falls below min_visibility of the transformed area are masked out."""
    B, H, W, _ = images.shape
    dev = images.device
    x0, y0, s = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for v in (x0, y0, s))
    # output pixel u samples input s * u + origin_px: scale 1 / s,
    # translation -origin_px / s, as the JAX function passes them
    scale = 1.0 / s
    inv_scale = 1.0 / scale
    wy = weight_mat_at(H, H, inv_scale, -(y0 * H) / s, triangle, True)
    wx = weight_mat_at(W, W, inv_scale, -(x0 * W) / s, triangle, True)
    out = torch.einsum("bhwc,bhH->bHwc", images.float(), wy)
    out = torch.einsum("bhwc,bwW->bhWc", out, wx)

    origin = torch.stack([x0, y0, x0, y0], dim=-1)[:, None, :]  # [B, 1, 4]
    moved = (boxes - origin) / s[:, None, None]
    clipped = torch.clamp(moved, 0.0, 1.0)

    def area(b):
        return (torch.clamp(b[..., 2] - b[..., 0], min=0.0)
                * torch.clamp(b[..., 3] - b[..., 1], min=0.0))

    vis = area(clipped) / torch.clamp(area(moved), min=1e-12)
    keep = (area(clipped) > 1e-6) & (vis >= min_visibility)
    return out, clipped, gt_mask & keep


def scale_jitter(generator: torch.Generator, images: torch.Tensor,
                 boxes: torch.Tensor, gt_mask: torch.Tensor, scale_min: float,
                 scale_max: float, min_visibility: float = 0.1, share=None):
    """Random zoom: s < 1 crops a random s-window (zoom in), s > 1 shrinks
    the image onto a zero canvas (zoom out)."""
    if scale_min == 1.0 and scale_max == 1.0:
        return images, boxes, gt_mask
    B, dev = images.shape[0], images.device
    s = _uniform(generator, B, scale_min, scale_max, dev, share)
    # the window's origin: in [0, 1 - s] when cropping, [1 - s, 0] zoomed out
    x0 = torch.clamp(1.0 - s, max=0.0) + (1.0 - s).abs() * _uniform(generator, B, 0, 1, dev, share)
    y0 = torch.clamp(1.0 - s, max=0.0) + (1.0 - s).abs() * _uniform(generator, B, 0, 1, dev, share)
    return apply_scale_window(images, boxes, gt_mask, x0, y0, s, min_visibility)


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  boxes: torch.Tensor, gt_mask: torch.Tensor, *,
                  hflip_prob: float = 0.5, color_strength: float = 0.0,
                  scale_min: float = 1.0, scale_max: float = 1.0, share=None):
    """The whole pipeline: images uint8/float [B, H, W, 3] in [0, 255] ->
    (float32 images in [0, 255], boxes, gt_mask); hflip, then colour, then
    scale. Feed the images to ops.preprocess.normalize_image.

    share (start, total): the images are rows [start, start + B) of a batch
    of total (a rank's rows of a global batch on a mesh). Every parameter
    is drawn for the whole batch and these rows keep theirs, so the images
    get the bits they would get in one batch on one device."""
    images = images.float()
    if hflip_prob > 0.0:
        images, boxes = hflip(generator, images, boxes, hflip_prob, share)
    images = color_jitter(generator, images, color_strength, share)
    return scale_jitter(generator, images, boxes, gt_mask, scale_min, scale_max,
                        share=share)
