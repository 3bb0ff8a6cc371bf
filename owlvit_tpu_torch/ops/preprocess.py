"""Image normalization (counterpart of owlvit_tpu/ops/preprocess.py).

Only `normalize_image` is ported: serving resizes on the host
(serve._size_to_model) and normalizes on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# OpenAI CLIP normalization constants (HF transformers utils/constants.py:5-6).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _clip_consts(device: torch.device):
    # made once per device: a fresh host->device copy per call would block
    return (torch.from_numpy(CLIP_MEAN).to(device),
            torch.from_numpy(CLIP_STD).to(device))


def normalize_image(image: torch.Tensor) -> torch.Tensor:
    """uint8/float [..., H, W, 3] in [0, 255] -> CLIP-normalized float32."""
    mean, std = _clip_consts(image.device)
    x = image.float() * (1.0 / 255.0)
    return (x - mean) / std
