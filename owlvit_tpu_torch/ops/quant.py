"""Per-token int8 storage quantization (counterpart of
owlvit_tpu/ops/quant.py: `quantize_rows`, `dequantize_rows`).

Quantizes one tensor once for storage, the activation pool of the cached
train step, and dequantizes it back to the compute dtype before any math.
Each row [..., D] gets its own symmetric scale max(amax, 1e-12) / 127;
values are rounded half to even (torch.round, as jnp.round), clipped to
+-127 and stored as int8, so the worst-case error of an element is half a
step, rowmax / 254. The int8 linear (`linear_q`) is left out on purpose:
the port does not carry the quantized backbone.
"""

from __future__ import annotations

import torch


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (q int8 [..., D], scale fp32 [...])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Inverse of quantize_rows: (int8 [..., D], fp32 [...]) -> dtype
    [..., D], the product taken in fp32."""
    return (q.float() * scale[..., None]).to(dtype)
