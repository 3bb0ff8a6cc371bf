"""NN building blocks (counterpart of owlvit_tpu/models/layers.py).

Numerics follow the CLIP/OWL-ViT encoder stack: pre-LN transformer blocks,
quick_gelu MLPs, LN eps 1e-5, attention scale applied to q. Parameters are
fp32 masters; `Linear` casts them to the activation dtype, as the JAX
package's `linear` does, so bf16 compute keeps fp32 weights.

Parameter names follow the JAX parameter tree (`q`, `k`, `v`, `out`, `ln1`,
`mlp.fc1`, ...) so that models/convert.py maps one onto the other by name.
Attention takes a differentiable kernel path when autograd records the call
(packed, else hybrid, else transposed, as the JAX package's `attention`
routes them) and the forward-only kernel wrapper (`pk_fwd`) otherwise.
`encoder` takes the fused add+LayerNorm branch under OWLVIT_FUSED_LN=1, as
the JAX package's does. Left out for now: the quantized and fast-softmax
variants.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from owlvit_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_hybrid, flash_attention_packed,
    hybrid_supported, packed_supported, pk_fwd, pk_fwd_plain)
from owlvit_tpu_torch.ops.fused_ln import add_ln


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, used by the box head."""
    return F.gelu(x, approximate="none")


def normal(shape, std: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, std^2) fp32 drawn from `generator`, or uninitialized storage when
    generator is None (for modules that are filled from a checkpoint)."""
    if generator is None:
        return torch.empty(shape)
    return torch.randn(shape, generator=generator) * std


class Linear(nn.Module):
    """y = x @ weight.T + bias, fp32 master weight [d_out, d_in] cast to x's
    dtype. Init: N(0, 1/d_in) weight (or N(0, std^2)), zero bias."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True,
                 std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        std = d_in**-0.5 if std is None else std
        self.weight = nn.Parameter(normal((d_out, d_in), std, generator))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention over packed [B, S, D] activations."""

    def __init__(self, dim: int, num_heads: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(dim, dim, generator=generator)
        self.k = Linear(dim, dim, generator=generator)
        self.v = Linear(dim, dim, generator=generator)
        self.out = Linear(dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, *, impl: str = "auto",
                static_max: Optional[float] = None) -> torch.Tensor:
        """impl "xla": the plain version on any device, under PyTorch's own
        autograd; otherwise the kernels (CUDA kernels on CUDA tensors, plain
        versions on CPU). A call that autograd records takes
        `flash_attention_packed` when `packed_supported` (off under
        OWLVIT_PACKED_FLASH=0), else `flash_attention_hybrid` when
        `hybrid_supported`, else the transposed `flash_attention`; a call it
        does not record takes `pk_fwd`. The fixed shift (static_max) is for
        forward-only calls and raises on a recorded one, as the JAX package
        keeps it out of every grad graph. All S tokens are real: the token
        axis is never padded."""
        B, S, D = x.shape
        H = self.num_heads
        scale = (D // H) ** -0.5
        q, k, v = self.q(x), self.k(x), self.v(x)
        recorded = torch.is_grad_enabled() and q.requires_grad
        if recorded and static_max is not None:
            raise ValueError("static_max (the fixed-shift softmax) is for "
                             "forward-only calls; this call records a gradient")
        if impl == "xla":
            o, _ = pk_fwd_plain(q, k, v, scale=scale, num_heads=self.num_heads,
                                static_max=static_max)
        elif recorded and packed_supported(H, D // H, D):
            o = flash_attention_packed(q, k, v, scale=scale, num_heads=H)
        elif recorded and hybrid_supported(H, D // H, D):
            o = flash_attention_hybrid(q, k, v, scale=scale, num_heads=H)
        elif recorded:
            heads = (B, S, H, D // H)
            o = flash_attention(q.view(heads), k.view(heads), v.view(heads),
                                scale=scale).reshape(B, S, D)
        else:
            o, _ = pk_fwd(q, k, v, scale=scale, num_heads=self.num_heads,
                          static_max=static_max)
        return self.out(o)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, generator=generator)
        self.fc2 = Linear(hidden, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class EncoderBlock(nn.Module):
    """CLIP pre-LN block: x + attn(ln1(x)), then + mlp(ln2(.))."""

    def __init__(self, dim: int, hidden: int, num_heads: int, eps: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = LayerNorm(dim, eps)
        self.attn = Attention(dim, num_heads, generator=generator)
        self.ln2 = LayerNorm(dim, eps)
        self.mlp = MLP(dim, hidden, generator=generator)

    def forward(self, x: torch.Tensor, *, impl: str = "auto",
                static_max: Optional[float] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), impl=impl, static_max=static_max)
        return x + self.mlp(self.ln2(x))


def fused_ln_enabled() -> bool:
    """The JAX package's switch, read at call time: OWLVIT_FUSED_LN=1 (the
    default is off)."""
    return os.environ.get("OWLVIT_FUSED_LN", "0") == "1"


def encoder(blocks, x: torch.Tensor, *, impl: str = "auto",
            static_max: Optional[float] = None) -> torch.Tensor:
    """Run a sequence of EncoderBlocks in order.

    With a kernel impl (not "xla") and OWLVIT_FUSED_LN=1, the residual
    stream is carried as a pending (res, branch) pair from (x, 0), so that
    every layer boundary is one fused add+LayerNorm (`add_ln`) instead of
    an add and a LayerNorm: the JAX package's fused branch, the same
    function up to summation order."""
    if impl != "xla" and fused_ln_enabled():
        res, br = x, torch.zeros_like(x)
        for block in blocks:
            xi, y1 = add_ln(res, br, block.ln1)
            a = block.attn(y1, impl=impl, static_max=static_max)
            res, y2 = add_ln(xi, a, block.ln2)
            br = block.mlp(y2)
        return res + br
    for block in blocks:
        x = block(x, impl=impl, static_max=static_max)
    return x
