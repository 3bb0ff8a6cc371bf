"""Image preprocessing (counterpart of owlvit_tpu/ops/preprocess.py):
`normalize_image`, `resize_image`, `preprocess_image`.

Serving and the data feed resize on the host (PIL bicubic, as the HF
processor does) and normalize on the device with `normalize_image`.
`resize_image` is the JAX package's on-device resize: `jax.image.resize`
with the cubic method and antialiasing, which is Keys' cubic kernel (a =
-0.5) applied as one weight matrix per axis, its support widened by the
downsampling factor and each output's weights normalised to sum to 1.
`F.interpolate(mode="bicubic")` is another function (a = -0.75, clamped
edges, no antialias), so the matrices are built here as JAX builds them
(`jax/_src/image/scale.py::compute_weight_mat`) and applied as two products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# OpenAI CLIP normalization constants (HF transformers utils/constants.py:5-6).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

DEFAULT_SIZE = 768


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


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5, at |offsets| x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def triangle(x: torch.Tensor) -> torch.Tensor:
    """The linear kernel (JAX's "linear" method): max(0, 1 - |x|)."""
    return torch.clamp(1.0 - x.abs(), min=0.0)


def weight_mat_at(n_in: int, n_out: int, inv_scale: torch.Tensor,
                  translation: torch.Tensor, kernel, antialias: bool) -> torch.Tensor:
    """[..., n_in, n_out] fp32 resampling weights of one axis for each of
    the fp32 inv_scale [...] (input pixels per output pixel) and translation
    [...] (output pixels), as `jax.image.scale_and_translate` computes them
    (`compute_weight_mat`): output pixel u samples input position (u + 0.5 -
    translation) * inv_scale - 0.5; each column normalised to sum to 1; a
    column whose position lies outside the input is zero (zero fill)."""
    dev = inv_scale.device
    inv_scale, translation = inv_scale[..., None], translation[..., None]
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.ones_like(inv_scale))
    sample_f = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * inv_scale
                - translation * inv_scale - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=dev)[:, None]
    w = kernel((sample_f[..., None, :] - src).abs() / kernel_scale[..., None])
    total = w.sum(dim=-2, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[..., None, :], w, torch.zeros_like(w))


def _weight_mat(n_in: int, n_out: int, antialias: bool,
                device: torch.device) -> torch.Tensor:
    """[n_in, n_out] cubic weights of one axis (scale n_out/n_in, no
    translation; the inverse scale rounded from float64, as
    `jax.image.resize` passes a Python scale)."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    return weight_mat_at(n_in, n_out, inv_scale, torch.zeros(()), _keys_cubic,
                         antialias).to(device)


def resize_image(image: torch.Tensor, size: int = DEFAULT_SIZE,
                 antialias: bool = True) -> torch.Tensor:
    """Bicubic resize [..., H, W, 3] -> [..., size, size, 3] float32: the
    function of `jax.image.resize(method="cubic", antialias=antialias)`. An
    axis already of the target size is left as it is, as JAX skips it."""
    x = image.float()
    H, W = x.shape[-3], x.shape[-2]
    if H != size:
        x = torch.einsum("...hwc,hH->...Hwc", x,
                         _weight_mat(H, size, antialias, x.device))
    if W != size:
        x = torch.einsum("...hwc,wW->...hWc", x,
                         _weight_mat(W, size, antialias, x.device))
    return x


def preprocess_image(image: torch.Tensor, size: int = DEFAULT_SIZE) -> torch.Tensor:
    """Resize + rescale + normalize: [..., H, W, 3] uint8 -> float32."""
    x = resize_image(image, size=size) * (1.0 / 255.0)
    mean, std = _clip_consts(x.device)
    return (x - mean) / std
