"""Fused residual add + LayerNorm: the Hopper kernels, their plain versions,
the launch counters and the autograd Function.

Counterpart of owlvit_tpu/ops/fused_ln.py (`_fwd_kernel`, `_bwd_kernel`,
`_add_ln`, `add_ln`). Over rows of [..., D]:

    r = x + h                       (the residual stream, in the input dtype)
    y = LN(r) * scale + bias        (fp32 statistics of the rounded r)

in one pass over memory; the backward recomputes the statistics from r, so
only r and scale are saved, and returns the same g for x and h.

`add_ln_fwd` and `add_ln_bwd` are the wrappers: a CPU tensor goes to the
plain version, a CUDA tensor to the kernels in ../csrc/fused_ln.cu (built
and bound by ops/_cuda.py at first use), or the wrapper raises.
`add_ln_fwd` is the custom op `owlvit::add_ln_fwd` with a fake
implementation, so that torch.export traces it (train/export.py). Unlike the
JAX wrapper, nothing pads N to a block multiple: the kernels take ragged N.
"""

from __future__ import annotations

import functools

import torch

from ._cuda import DTYPE_CODE, launch, query

_MAX_D = 1024
_ROWS_PER_BLOCK = 8  # kWarps of csrc/fused_ln.cu: one row per warp


def _stats(rf: torch.Tensor, eps: float):
    """(mean, rstd) of fp32 rows, the variance two-pass as in the TPU
    kernel: the mean of the squared deviations."""
    mean = rf.mean(dim=-1, keepdim=True)
    var = (rf - mean).square().mean(dim=-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def add_ln_fwd_plain(x, h, scale, bias, eps: float):
    """Plain PyTorch version of the forward kernel, in its expression order:
    r = x + h in the input dtype; y = (r - mean) * rstd * scale + bias in
    fp32 from the rounded r, cast to the input dtype. Returns (r, y)."""
    r = x + h
    rf = r.float()
    mean, rstd = _stats(rf, eps)
    y = (rf - mean) * rstd * scale.float() + bias.float()
    return r, y.to(x.dtype)


def add_ln_bwd_plain(r, dy, dr, scale, eps: float):
    """Plain PyTorch version of the backward kernel: the statistics and
    xhat recomputed from r; dyh = dy * scale; g = dr + rstd * (dyh -
    mean(dyh) - xhat * mean(dyh * xhat)) in the input dtype; dscale =
    sum(dy * xhat) and dbias = sum(dy) over all rows, fp32 [D]. Returns
    (g, dscale, dbias)."""
    D = r.shape[-1]
    rf, dyf = r.float(), dy.float()
    mean, rstd = _stats(rf, eps)
    xhat = (rf - mean) * rstd
    dyh = dyf * scale.float()
    m1 = dyh.mean(dim=-1, keepdim=True)
    m2 = (dyh * xhat).mean(dim=-1, keepdim=True)
    g = dr.float() + rstd * (dyh - m1 - xhat * m2)
    return (g.to(r.dtype), (dyf * xhat).reshape(-1, D).sum(0),
            dyf.reshape(-1, D).sum(0))


def vectors_per_lane(name: str, D: int, dtype: torch.dtype) -> int:
    """The 16-byte vectors that each of a warp's 32 lanes loads from a row
    of D values: the backward kernel's template parameter (bf16 1-4, fp32
    1-8). Raises unless the dtype is float32 or bfloat16 and D a multiple of
    256 (bf16) or 128 (fp32) up to 1024."""
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: operands must be float32 or bfloat16, got {dtype}")
    per_warp = 32 * 16 // dtype.itemsize
    if D % per_warp or not per_warp <= D <= _MAX_D:
        raise ValueError(f"{name}: the kernel takes D a multiple of {per_warp} "
                         f"up to {_MAX_D} in {dtype}, got D={D}")
    return D // per_warp


def bwd_blocks(N: int, resident: int) -> int:
    """The backward's fixed grid: the blocks the card holds at once, but no
    more than the ceil(N / 8) that have a row for each warp."""
    return min(resident, -(-N // _ROWS_PER_BLOCK))


def _rows(name: str, like: torch.Tensor, **tensors) -> tuple:
    """What the kernels take: CUDA tensors of `like`'s [..., D] shape and
    dtype (float32 or bfloat16), D as `vectors_per_lane` takes it,
    contiguous and 16-byte aligned. Returns (N, D)."""
    D = like.shape[-1]
    vectors_per_lane(name, D, like.dtype)
    for key, t in tensors.items():
        if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
            raise ValueError(f"{name}: {key} must be {like.dtype} {tuple(like.shape)} "
                             f"on {like.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte aligned")
    N = like.numel() // D
    if N < 1:
        raise ValueError(f"{name}: no rows")
    return N, D


def _param(p: torch.Tensor, D: int, device) -> torch.Tensor:
    """A [D] parameter as the fp32 contiguous vector the kernels read."""
    if p.shape != (D,):
        raise ValueError(f"LayerNorm parameter must be [{D}], got {tuple(p.shape)}")
    return p.to(device=device, dtype=torch.float32).contiguous()


@functools.lru_cache(maxsize=None)
def _bwd_resident_blocks(device_index: int, dtype_code: int, D: int) -> int:
    """The backward kernel's blocks that the card holds at once (SMs x
    occupancy; its template, and so its shared memory, depends on D),
    asked once per device, dtype and D."""
    return query("owlvit_add_ln_bwd_resident_blocks", torch.device("cuda", device_index),
                 D, dtype_code, device_index)


def bwd_smem_bytes(D: int, dtype: torch.dtype, device) -> int:
    """The backward kernel's dynamic shared memory at width D (its rows'
    rings and their mbarriers), as the kernel's source sets it."""
    vectors_per_lane("add_ln_bwd", D, dtype)
    return query("owlvit_add_ln_bwd_smem_bytes", torch.device(device), D, DTYPE_CODE[dtype])


def add_ln_fwd(x, h, scale, bias, eps: float):
    """(r, y) = (x + h, LN(x + h) * scale + bias) over [..., D]. It calls the
    custom op `owlvit::add_ln_fwd`, which torch.export traces as one node:
    CPU tensors run `add_ln_fwd_plain`; CUDA tensors run the kernel, and
    `add_ln_fwd.launches` counts each launch."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"add_ln_fwd runs on cpu or cuda tensors, got {x.device}")
    return torch.ops.owlvit.add_ln_fwd(x, h, scale, bias, float(eps))


@torch.library.custom_op("owlvit::add_ln_fwd", mutates_args=())
def _add_ln_fwd_op(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """`add_ln_fwd`'s implementation: the plain version on the CPU, the
    kernel (counted) on the card."""
    if x.device.type == "cpu":
        return add_ln_fwd_plain(x, h, scale, bias, eps)
    N, D = _rows("add_ln_fwd", x, x=x, h=h)
    sc, bi = _param(scale, D, x.device), _param(bias, D, x.device)
    r, y = torch.empty_like(x), torch.empty_like(x)
    launch("owlvit_add_ln_fwd", x.device, x.data_ptr(), h.data_ptr(),
           sc.data_ptr(), bi.data_ptr(), r.data_ptr(), y.data_ptr(), N, D,
           float(eps), DTYPE_CODE[x.dtype])
    add_ln_fwd.launches += 1
    return r, y


@_add_ln_fwd_op.register_fake
def _add_ln_fwd_fake(x, h, scale, bias, eps):
    return torch.empty_like(x), torch.empty_like(x)


add_ln_fwd.launches = 0


def add_ln_bwd(r, dy, dr, scale, eps: float):
    """(g, dscale, dbias) of add_ln from the saved r and the cotangents dy
    (of y) and dr (of r); dscale and dbias fp32 [D]. CPU tensors run
    `add_ln_bwd_plain`; CUDA tensors run the kernel (per-block partials
    summed by a second kernel in a fixed order, so the sums are the same
    from run to run), and `add_ln_bwd.launches` counts each launch."""
    if r.device.type == "cpu":
        return add_ln_bwd_plain(r, dy, dr, scale, eps)
    if r.device.type != "cuda":
        raise ValueError(f"add_ln_bwd runs on cpu or cuda tensors, got {r.device}")
    N, D = _rows("add_ln_bwd", r, r=r, dy=dy, dr=dr)
    sc = _param(scale, D, r.device)
    g = torch.empty_like(r)
    # a fixed grid, one fp32 partial row of dscale and dbias per block
    blocks = bwd_blocks(N, _bwd_resident_blocks(r.device.index, DTYPE_CODE[r.dtype], D))
    part = torch.empty((2, blocks, D), dtype=torch.float32, device=r.device)
    dscale = torch.empty(D, dtype=torch.float32, device=r.device)
    dbias = torch.empty(D, dtype=torch.float32, device=r.device)
    launch("owlvit_add_ln_bwd", r.device, r.data_ptr(), dy.data_ptr(),
           dr.data_ptr(), sc.data_ptr(), g.data_ptr(), part[0].data_ptr(),
           part[1].data_ptr(), dscale.data_ptr(), dbias.data_ptr(), N, D,
           blocks, float(eps), DTYPE_CODE[r.dtype])
    add_ln_bwd.launches += 1
    return g, dscale, dbias


add_ln_bwd.launches = 0


class _AddLN(torch.autograd.Function):
    """The counterpart of the JAX package's `_add_ln` custom_vjp: saves r
    and scale only; the backward gives x and h the same g, and scale and
    bias their sums in the parameters' dtype."""

    @staticmethod
    def forward(ctx, x, h, scale, bias, eps):
        r, y = add_ln_fwd(x, h, scale, bias, eps)
        ctx.save_for_backward(r, scale)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return r, y

    @staticmethod
    def backward(ctx, dr, dy):
        r, scale = ctx.saved_tensors
        g, dscale, dbias = add_ln_bwd(r, dy.contiguous(), dr.contiguous(),
                                      scale, ctx.eps)
        return g, g, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None


def add_ln(x, h, ln, eps=None):
    """(x + h, ln(x + h)) over [..., D] through the fused kernels on CUDA
    tensors (the plain versions on CPU tensors). ln: a LayerNorm module
    (its weight is the scale); eps defaults to ln.eps."""
    eps = ln.eps if eps is None else eps
    return _AddLN.apply(x.contiguous(), h.contiguous(), ln.weight, ln.bias,
                        float(eps))
