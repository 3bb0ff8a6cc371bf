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
the JAX package's does, and with remat recomputes each block in the
backward (the JAX package's jax.checkpoint around the block). The frozen
prefix's two switches reach every block through `encoder`, as the JAX
package threads them: `quantized` runs every projection (q, k, v, out, fc1,
fc2) through the int8 `linear_q`, and `fast_softmax` the forward-only
attention kernel's fast mode.

Tensor parallelism (parallel/sharding.py::shard_params, the JAX package's
Megatron specs under GSPMD): `Attention` and `MLP` given the "model"
process group keep their local heads (H / tp) and hidden units (F / tp).
The column-parallel input (q/k/v, fc1) passes `copy_to_model` (identity
forward, all_reduce backward), the row-parallel output (out, fc2)
`reduce_from_model` (all_reduce forward, identity backward), with the
replicated bias added once after the reduce. LayerNorms and the fused
add+LayerNorm stay replicated.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from owlvit_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_hybrid, flash_attention_packed,
    hybrid_supported, packed_supported, pk_fwd, pk_fwd_plain)
from owlvit_tpu_torch.ops.fused_ln import add_ln
from owlvit_tpu_torch.ops.quant import linear_q
from owlvit_tpu_torch.parallel.sharding import all_reduce_sum_


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

    def forward(self, x: torch.Tensor, quantized: bool = False) -> torch.Tensor:
        """quantized: the int8 `linear_q` (forward only: the frozen prefix)."""
        if quantized:
            return linear_q(x, self.weight, self.bias)
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


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group, as a new tensor (gloo's on the host)."""
    return all_reduce_sum_(x.clone(memory_format=torch.contiguous_format), group)


class _CopyToModel(torch.autograd.Function):
    """A column-parallel layer's input: identity forward; the backward sums
    the input's gradient over the "model" group (each rank's heads add
    their part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """A row-parallel layer's output: the partial products summed over the
    "model" group; identity backward (the output is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def _row_parallel(linear: "Linear", x: torch.Tensor, group, tp: int,
                  quantized: bool = False) -> torch.Tensor:
    """The row-parallel product: x [.., d_in / tp] @ this rank's weight
    slice, summed over the group, plus the replicated bias once. With one
    rank the sum is the identity and the bias joins the product, as the
    single-device layer adds it. quantized: `linear_q` over the group (its
    scales over the whole d_in, as GSPMD reduces the JAX package's amax
    across shards; forward only)."""
    if quantized:
        return linear_q(x, linear.weight, linear.bias, group=group)
    if tp == 1:
        return reduce_from_model(linear(x), group)
    y = reduce_from_model(F.linear(x, linear.weight.to(x.dtype)), group)
    return y + linear.bias.to(y.dtype)


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
        self.tp_group, self.tp = None, 1  # the "model" group, its size

    def tensor_parallel(self, group, tp: int) -> None:
        """Run on this rank's H / tp heads (its q/k/v and out slices, which
        parallel/sharding.py::shard_params keeps) over the "model" group."""
        if self.tp_group is not None:
            raise ValueError("this attention is tensor-parallel already")
        if self.num_heads % tp:
            raise ValueError(f"{self.num_heads} heads do not divide by model={tp}")
        self.num_heads //= tp
        self.tp_group, self.tp = group, tp

    def forward(self, x: torch.Tensor, *, impl: str = "auto",
                static_max: Optional[float] = None, fast_softmax: bool = False,
                quantized: bool = False,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """impl "xla": the plain version on any device, under PyTorch's own
        autograd; otherwise the kernels (CUDA kernels on CUDA tensors, plain
        versions on CPU). bias: an additive fp32 [B, 1|H, S, S] on the
        scores (the text tower's causal and padding masks), which takes
        `_biased_attention` whatever impl says, as the JAX package routes a
        biased call to its XLA path. A call that autograd records takes
        `flash_attention_packed` when `packed_supported` (off under
        OWLVIT_PACKED_FLASH=0), else `flash_attention_hybrid` when
        `hybrid_supported`, else the transposed `flash_attention`; a call it
        does not record takes `pk_fwd`. The fixed shift (static_max) is for
        forward-only calls and raises on a recorded one, as the JAX package
        keeps it out of every grad graph. fast_softmax: the kernels' fast
        mode where the JAX package's packed and hybrid kernels take it
        (`hybrid_supported`; the transposed and plain paths ignore it, as
        its transposed and XLA paths do), NotImplementedError on a recorded
        call. quantized: every projection through `linear_q`, on every
        path. The packed backward's mode is `pk_bwd_mode`'s. All S tokens
        are real: the token axis is never padded."""
        if self.tp_group is not None:
            x = copy_to_model(x, self.tp_group)
        q, k, v = self.q(x, quantized), self.k(x, quantized), self.v(x, quantized)
        # the local heads' width: D, or D / tp under tensor parallelism
        B, S, D = q.shape
        H = self.num_heads
        scale = (D // H) ** -0.5
        if bias is not None:
            return self._out(_biased_attention(q, k, v, H, scale, bias), quantized)
        recorded = torch.is_grad_enabled() and q.requires_grad
        if recorded and static_max is not None:
            raise ValueError("static_max (the fixed-shift softmax) is for "
                             "forward-only calls; this call records a gradient")
        fast = fast_softmax and hybrid_supported(H, D // H, D)
        if impl == "xla":
            o, _ = pk_fwd_plain(q, k, v, scale=scale, num_heads=self.num_heads,
                                static_max=static_max)
        elif recorded and packed_supported(H, D // H, D):
            o = flash_attention_packed(q, k, v, scale=scale, num_heads=H, fast_softmax=fast)
        elif recorded and hybrid_supported(H, D // H, D):
            o = flash_attention_hybrid(q, k, v, scale=scale, num_heads=H, fast_softmax=fast)
        elif recorded:
            heads = (B, S, H, D // H)
            o = flash_attention(q.view(heads), k.view(heads), v.view(heads),
                                scale=scale).reshape(B, S, D)
        else:
            o, _ = pk_fwd(q, k, v, scale=scale, num_heads=self.num_heads,
                          static_max=static_max, fast_softmax=fast)
        return self._out(o, quantized)

    def _out(self, o: torch.Tensor, quantized: bool = False) -> torch.Tensor:
        if self.tp_group is None:
            return self.out(o, quantized)
        return _row_parallel(self.out, o, self.tp_group, self.tp, quantized)


def _biased_attention(q, k, v, num_heads: int, scale: float,
                      bias: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA attention with an additive bias: q scaled in
    its dtype, fp32 scores plus bias, fp32 softmax cast back, then p.v."""
    B, S, D = q.shape
    hd = D // num_heads
    qh, kh, vh = (t.reshape(B, S, num_heads, hd) for t in (q * scale, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) + bias
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vh).reshape(B, S, D)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, generator=generator)
        self.fc2 = Linear(hidden, dim, generator=generator)
        self.tp_group, self.tp = None, 1  # the "model" group, its size

    def tensor_parallel(self, group, tp: int) -> None:
        """Run on this rank's F / tp hidden units (its fc1 and fc2 slices)
        over the "model" group."""
        if self.tp_group is not None:
            raise ValueError("this MLP is tensor-parallel already")
        self.tp_group, self.tp = group, tp

    def forward(self, x: torch.Tensor, quantized: bool = False) -> torch.Tensor:
        if self.tp_group is None:
            return self.fc2(quick_gelu(self.fc1(x, quantized)), quantized)
        h = quick_gelu(self.fc1(copy_to_model(x, self.tp_group), quantized))
        return _row_parallel(self.fc2, h, self.tp_group, self.tp, quantized)


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
                static_max: Optional[float] = None, fast_softmax: bool = False,
                quantized: bool = False,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), impl=impl, static_max=static_max,
                          fast_softmax=fast_softmax, quantized=quantized, bias=bias)
        return x + self.mlp(self.ln2(x), quantized)


def fused_ln_enabled() -> bool:
    """The JAX package's switch, read at call time: OWLVIT_FUSED_LN=1 (the
    default is off)."""
    return os.environ.get("OWLVIT_FUSED_LN", "0") == "1"


def _fused_block(block: EncoderBlock, res: torch.Tensor, br: torch.Tensor, *,
                 impl: str, static_max: Optional[float], fast_softmax: bool,
                 quantized: bool):
    """One block on the pending (res, branch) pair -> the next pair."""
    xi, y1 = add_ln(res, br, block.ln1)
    a = block.attn(y1, impl=impl, static_max=static_max, fast_softmax=fast_softmax,
                   quantized=quantized)
    res, y2 = add_ln(xi, a, block.ln2)
    return res, block.mlp(y2, quantized)


def encoder(blocks, x: torch.Tensor, *, impl: str = "auto",
            static_max: Optional[float] = None, remat: bool = False,
            fast_softmax: bool = False, quantized: bool = False) -> torch.Tensor:
    """Run a sequence of EncoderBlocks in order.

    With a kernel impl (not "xla") and OWLVIT_FUSED_LN=1, the residual
    stream is carried as a pending (res, branch) pair from (x, 0), so that
    every layer boundary is one fused add+LayerNorm (`add_ln`) instead of
    an add and a LayerNorm: the JAX package's fused branch, the same
    function up to summation order.

    Every recorded layer's attention takes the backward `pk_bwd_mode`
    resolves, the split pair unless OWLVIT_PACKED_BWD says otherwise, at any
    depth and on either branch: the JAX package's depth hint decided between
    two TPU kernels that both run in a fixed order, while here only the pair
    gives the same gradients on every run.

    remat, when autograd records the stack: each block runs under
    torch.utils.checkpoint (non-reentrant), which keeps only its input and
    runs it again in the backward, the kernels' autograd Functions
    included (`pk_fwd`, and `add_ln_fwd` in the fused branch, launch twice;
    the backward reads the recomputed o and lse). The same function, bit
    for bit: the forward kernels are deterministic.

    fast_softmax and quantized: the frozen prefix's switches
    (vit.forward_prefix), passed to every block's `Attention` and `MLP`."""
    remat = remat and torch.is_grad_enabled()

    def run(fn, *args):
        if remat:
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    opts = dict(impl=impl, static_max=static_max, fast_softmax=fast_softmax,
                quantized=quantized)
    if impl != "xla" and fused_ln_enabled():
        res, br = x, torch.zeros_like(x)
        for block in blocks:
            res, br = run(functools.partial(_fused_block, block, **opts), res, br)
        return res + br
    for block in blocks:
        x = run(functools.partial(block, **opts), x)
    return x
