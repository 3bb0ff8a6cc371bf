"""Per-token int8 quantization (counterpart of owlvit_tpu/ops/quant.py:
`quantize_rows`, `dequantize_rows`, `linear_q`).

`quantize_rows` quantizes one tensor once for storage, the activation pool
of the cached train step, and `dequantize_rows` brings it back to the
compute dtype before any math. Each row [..., D] gets its own symmetric
scale max(amax, 1e-12) / 127; values are rounded half to even (torch.round,
as jnp.round), clipped to +-127 and stored as int8, so the worst-case error
of an element is half a step, rowmax / 254.

`linear_q` is the int8 linear of the frozen prefix under
OWLVIT_QUANT_BACKBONE=1 or OwlViTConfig.quant_backbone (models/layers.py):
per-token activation scales, per-output-channel weight scales, an int32
product (`int8_mm`: cuBLAS's on the card, as the JAX package leaves its
int8 dot to XLA), the rescale in fp32. The JAX package marks it
experimental: its detections drift from the bf16 model's (its quant.py
caveat). Under tensor parallelism a row-parallel layer holds a slice of
D_in, so the caller passes the "model" group and both scales are the
maximum over it, the int32 partial products their sum: the single
device's numbers, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from owlvit_tpu_torch.parallel.sharding import all_reduce_max_, all_reduce_sum_


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127, divided as IEEE divides: by a tensor on
    amax's device (a Python number on the card would multiply by its
    reciprocal, which can round the other way)."""
    return torch.clamp_min(amax, 1e-12) / amax.new_full((), 127.0)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (q int8 [..., D], scale fp32 [...])."""
    scale = _scale(x.float().abs().amax(dim=-1, keepdim=True))
    return _quantize(x, scale), scale[..., 0]


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Inverse of quantize_rows: (int8 [..., D], fp32 [...]) -> dtype
    [..., D], the product taken in fp32."""
    return (q.float() * scale[..., None]).to(dtype)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, k] int8 @ b [k, n] int8 -> int32 [m, n], exact. On the card
    `torch._int_mm` (cuBLAS's int8 product: m > 16, k and n multiples of
    8). On the CPU, where an int8 product may sum pairs in saturating int16
    (CPUs without VNNI), the plain version: a float64 product, exact while
    every sum stays under 2^53 (k * 127^2 does for any k below 5e11)."""
    if a.is_cuda:
        return torch._int_mm(a, b)
    return (a.double() @ b.double()).to(torch.int32)


def linear_q(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
             group=None) -> torch.Tensor:
    """int8 x int8 -> int32 linear with dynamic scales, y in x.dtype: the
    JAX `linear_q` step for step. weight [d_out, d_in] (the port's layout:
    the per-channel amax runs over its last axis, where the JAX package's
    [d_in, d_out] kernel takes axis 0), x [..., d_in]; y = acc * (x_scale *
    w_scale) + bias, the product and the bias in fp32. group: the "model"
    group of a row-parallel layer (x and weight hold a slice of d_in): both
    scales are maxima over it and the int32 product is summed over it; the
    bias is then added once, after the sum."""
    x_amax = x.float().abs().amax(dim=-1, keepdim=True)  # [..., 1]
    w_amax = weight.float().abs().amax(dim=-1)  # [d_out]
    if group is not None:
        all_reduce_max_(x_amax, group)
        all_reduce_max_(w_amax, group)
    x_scale, w_scale = _scale(x_amax), _scale(w_amax)
    xq = _quantize(x, x_scale).reshape(-1, x.shape[-1])
    wq = _quantize(weight, w_scale[:, None])
    acc = int8_mm(xq, wq.t())
    if group is not None:
        all_reduce_sum_(acc, group)
    y = acc.reshape(*x.shape[:-1], -1).float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
