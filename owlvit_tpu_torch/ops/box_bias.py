"""Per-patch box-bias prior, matching OWL-ViT's grid logit bias.

A numpy copy of owlvit_tpu/ops/box_bias.py, kept here because importing that
module pulls in jax (through owlvit_tpu/ops/__init__.py).
tests/test_torch_convert.py holds the two equal.

The box head predicts residuals in logit space around a prior that centers
each box on its patch with size = one patch (HF
`OwlViTForObjectDetection.compute_box_bias`).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def compute_box_bias(num_patches_h: int, num_patches_w: int) -> np.ndarray:
    """[h*w, 4] fp32 bias for (cx, cy, w, h) in logit space."""
    # Patch centers at (c+1)/W, (r+1)/H — matches HF's arange(1, n+1)/n grid.
    xs = np.arange(1, num_patches_w + 1, dtype=np.float32) / num_patches_w
    ys = np.arange(1, num_patches_h + 1, dtype=np.float32) / num_patches_h
    xx, yy = np.meshgrid(xs, ys)  # [h, w] each, row-major over the patch grid
    centers = np.stack([xx, yy], axis=-1).reshape(-1, 2)
    centers = np.clip(centers, 0.0, 1.0)

    def _logit(p):
        return np.log(p + 1e-4) - np.log1p(-p + 1e-4)

    coord_bias = _logit(centers)
    size = np.empty_like(centers)
    size[:, 0] = 1.0 / num_patches_w
    size[:, 1] = 1.0 / num_patches_h
    size_bias = _logit(size)
    return np.concatenate([coord_bias, size_bias], axis=-1).astype(np.float32)
