"""Packed flash attention: the Hopper kernels, their plain versions, the
launch counters and the autograd Functions.

Counterpart of owlvit_tpu/ops/flash_attention.py (`_pk_fwd`,
`_pk_fwd_kernel` with its fast_softmax branch, `_pk_bwd` with
`_pk_fused_bwd_kernel`, `_pk_dq_kernel` and `_pk_dkv_kernel`, `_pk_bwd_mode`,
`_flash_packed`, `flash_attention_packed`, `_check_differentiable`,
`_static_max_env`). q/k/v stay in the packed
[B, S, D] layout (head h = columns h*hd:(h+1)*hd); the forward returns
o [B, S, D] in the input dtype and lse [B, H, S] in fp32, the backward
dq, dk, dv [B, S, D] in the input dtype.

`pk_fwd`, `pk_bwd` (mode "fused"), and `pk_dq` and `pk_dkv` (mode "both",
run one after the other by `pk_bwd_split`) are the wrappers: a CPU tensor
goes to the plain version, a CUDA tensor to the CUDA kernel in
../csrc/flash_attention_fwd.cu or ../csrc/flash_attention_bwd.cu, or the
wrapper raises. `pk_fwd` is the custom op `owlvit::pk_fwd` with a fake
implementation, so that torch.export traces it (train/export.py). The
kernels are built and bound by ops/_cuda.py at first use, so importing this
module needs neither nvcc nor a card. The pair is the default backward: its
dq, dk and dv are the same on every run. The fused backward
(OWLVIT_PACKED_BWD=fused) may give a dq that differs by one bf16 ulp from
run to run (its key tiles add dq partials in L2 in no fixed order).

The transposed functions (`flash_attention` over [B, S, H, hd], the
counterpart of `_flash3` with `_fwd_kernel`, `_dq_kernel` and `_dkv_kernel`,
and `flash_attention_hybrid`, packed forward and transposed backward) need
no kernel of their own: the transposed layout [B*H, S, hd] is the packed
layout with one head of 64 lanes, so `pk_fwd`, `pk_dq` and `pk_dkv` at
num_heads=1 compute those TPU kernels' functions. Each wrapper counts a
launch once, where it makes it: a one-head launch (the transposed layout; no
shipped model has a one-head packed layer) in `.transposed_launches`, any
other in `.launches`, and a launch in the fast softmax mode (bf16, for
the frozen prefix under OWLVIT_FAST_SOFTMAX=1) in `pk_fwd.fast_launches`
instead. `packed_supported` and `hybrid_supported` keep the
JAX package's routing predicates, the OWLVIT_PACKED_FLASH=0 switch
included, and `pk_bwd_mode` its backward mode (OWLVIT_PACKED_BWD).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ._cuda import DTYPE_CODE, launch

HEAD_DIM = 64  # the only head dim of B/32, B/16 and L/14; the kernel takes no other

# Fixed softmax shift for non-fp32 serving (the JAX package's
# _STATIC_MAX_DEFAULT): exp(s - C) needs no row max, and C = 20 keeps
# headroom for logits up to ~C + 88 before exp overflows in fp32.
STATIC_MAX_DEFAULT = 20.0


def resolve_static_max(dtype: torch.dtype, static_softmax: bool) -> Optional[float]:
    """C for the fixed-shift softmax, or None for the per-row max, resolved
    as the JAX package's `_static_max_env(dtype) if static_softmax else
    None`: OWLVIT_STATIC_MAX (read at call time) set to `off` or `dynamic`
    (in any case) gives the per-row max, set to a number gives that C (fp32
    included); unset, C = 20 for non-fp32 compute. Nothing of this applies
    without static_softmax."""
    if not static_softmax:
        return None
    env = os.environ.get("OWLVIT_STATIC_MAX", "")
    if env.lower() in ("off", "dynamic"):
        return None
    if env:
        return float(env)
    return STATIC_MAX_DEFAULT if dtype != torch.float32 else None


# the forward kernel's softmax modes (its C entry point's `softmax` argument)
ROW_MAX, STATIC_SHIFT, FAST = 0, 1, 2


def softmax_mode(dtype: torch.dtype, static_max: Optional[float],
                 fast_softmax: bool) -> int:
    """The forward's softmax, as the TPU kernel picks it: the fixed shift
    when static_max is set (its branch comes first), else the fast mode for
    a non-fp32 dtype under fast_softmax (fp32 ignores it), else the per-row
    max."""
    if static_max is not None:
        return STATIC_SHIFT
    return FAST if fast_softmax and dtype != torch.float32 else ROW_MAX


def pk_fwd_plain(q, k, v, *, scale: float, num_heads: int,
                 valid_len: Optional[int] = None,
                 static_max: Optional[float] = None,
                 fast_softmax: bool = False):
    """Plain PyTorch version of the kernel, with the same rounding points:
    q scaled in the input dtype, fp32 scores and sums, p rounded to the
    input dtype before p.v, the division by l in fp32. Keys at index >=
    valid_len get zero weight. In the fast mode (`softmax_mode`), as the
    TPU kernel's fast_softmax branch: p = exp(s - m) with s - m rounded to
    the input dtype and the exp taken (and rounded) in it, l the fp32 sum of
    that p. Returns (o [B, S, D], lse [B, H, S])."""
    B, S, D = q.shape
    hd = D // num_heads
    valid = S if valid_len is None else int(valid_len)

    def heads(x):  # [B, S, D] -> [B, H, S, hd] fp32 (exact for bf16 values)
        return x.reshape(B, S, num_heads, hd).transpose(1, 2).float()

    qs = (q * scale).to(q.dtype)
    s = heads(qs) @ heads(k).transpose(-1, -2)  # [B, H, S, S] fp32
    s[..., valid:] = float("-inf")
    shift = (s.amax(dim=-1, keepdim=True) if static_max is None
             else torch.full_like(s[..., :1], static_max))
    if softmax_mode(q.dtype, static_max, fast_softmax) == FAST:
        p = torch.exp((s - shift).to(q.dtype)).float()
        l = p.sum(dim=-1, keepdim=True)
        o = (p @ heads(v)) / l
    else:
        p = torch.exp(s - shift)
        l = p.sum(dim=-1, keepdim=True)
        o = (p.to(q.dtype).float() @ heads(v)) / l
    o = o.transpose(1, 2).reshape(B, S, D).to(q.dtype)
    return o, (shift + torch.log(l))[..., 0]


def _heads(x, num_heads: int):
    """[B, S, D] -> [B, H, S, hd] fp32 (exact for bf16 values)."""
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads).transpose(1, 2).float()


def _packed(x, dtype):
    """[B, H, S, hd] fp32 -> [B, S, D] in `dtype`."""
    B, H, S, hd = x.shape
    return x.transpose(1, 2).reshape(B, S, H * hd).to(dtype)


def _delta_plain(o, do, num_heads: int):
    """delta = rowsum(do * o) per head in fp32, [B, H, S]."""
    B, S, D = o.shape
    delta = (do.float() * o.float()).reshape(B, S, num_heads, D // num_heads).sum(-1)
    return delta.transpose(1, 2)


def _bwd_plain_terms(q, k, v, lse, do, delta, scale: float, num_heads: int,
                     valid_len: Optional[int]):
    """p and ds [B, H, S, S] fp32 (ds rounded to the input dtype), with
    k * scale [B, H, S, hd] (rounded to the input dtype): what the three
    products of the backward take. Keys at index >= valid_len and query rows
    >= valid_len get p = 0."""
    valid = q.shape[1] if valid_len is None else int(valid_len)
    dt = q.dtype
    ks = _heads((k * scale).to(dt), num_heads)
    s = _heads(q, num_heads) @ ks.transpose(-1, -2)  # [B, H, S, S] fp32
    p = torch.exp(s - lse.float()[..., None])
    p[..., valid:] = 0.0
    p[..., valid:, :] = 0.0
    dp = _heads(do, num_heads) @ _heads(v, num_heads).transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    return p, ds, ks


def pk_bwd_plain(q, k, v, o, lse, do, *, scale: float, num_heads: int,
                 valid_len: Optional[int] = None):
    """Plain PyTorch version of the backward kernels, with their rounding
    points: k and q scaled in the input dtype, p = exp(s - lse) from the
    forward's fp32 lse, delta = rowsum(do * o) in fp32, ds rounded to the
    input dtype before the dq and dk products, p before the dv product, fp32
    products. Keys at index >= valid_len get p = 0 (dk, dv rows 0); query
    rows >= valid_len contribute nothing (dq rows 0). Returns (dq, dk, dv)
    [B, S, D] in the input dtype."""
    delta = _delta_plain(o, do, num_heads)
    p, ds, ks = _bwd_plain_terms(q, k, v, lse, do, delta, scale, num_heads, valid_len)
    return (_packed(ds @ ks, q.dtype), *_dkv_plain(q, do, p, ds, scale, num_heads))


def _dkv_plain(q, do, p, ds, scale: float, num_heads: int):
    """dk = ds^T . (q*scale) and dv = p^T . do, [B, S, D] in the input
    dtype, q scaled and p rounded in the input dtype."""
    dt = q.dtype
    qs = _heads((q * scale).to(dt), num_heads)
    dk = ds.transpose(-1, -2) @ qs
    dv = p.to(dt).float().transpose(-1, -2) @ _heads(do, num_heads)
    return _packed(dk, dt), _packed(dv, dt)


def pk_dq_plain(q, k, v, o, lse, do, *, scale: float, num_heads: int,
                valid_len: Optional[int] = None):
    """Plain version of the dq kernel (the first of the split pair), as
    `pk_bwd_plain` computes dq. Returns (dq [B, S, D] in the input dtype,
    delta [B, H, S] fp32)."""
    delta = _delta_plain(o, do, num_heads)
    _, ds, ks = _bwd_plain_terms(q, k, v, lse, do, delta, scale, num_heads, valid_len)
    return _packed(ds @ ks, q.dtype), delta.contiguous()


def pk_dkv_plain(q, k, v, lse, do, delta, *, scale: float, num_heads: int,
                 valid_len: Optional[int] = None):
    """Plain version of the dk/dv kernel (the second of the split pair), as
    `pk_bwd_plain` computes dk and dv, from `pk_dq_plain`'s delta. Returns
    (dk, dv) [B, S, D] in the input dtype."""
    p, ds, _ = _bwd_plain_terms(q, k, v, lse, do, delta, scale, num_heads, valid_len)
    return _dkv_plain(q, do, p, ds, scale, num_heads)


def _check_cuda_operands(name: str, num_heads: int, **tensors) -> tuple:
    """What both kernels take: CUDA tensors of one [B, S, D] shape and one
    dtype (float32 or bfloat16), head dim 64, contiguous, 16-byte aligned.
    Returns (B, S, D)."""
    q = next(iter(tensors.values()))
    if q.dim() != 3 or any(x.shape != q.shape for x in tensors.values()):
        raise ValueError(f"{name}: {', '.join(tensors)} must share one [B, S, D] "
                         f"shape: {[tuple(x.shape) for x in tensors.values()]}")
    B, S, D = q.shape
    if B > 65535:  # the kernels' grid z dimension
        raise ValueError(f"{name}: at most 65535 sequences per launch, got {B}")
    if D % num_heads or D // num_heads != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim {HEAD_DIM}; got "
                         f"D={D}, num_heads={num_heads}")
    if q.dtype not in DTYPE_CODE or any(x.dtype != q.dtype for x in tensors.values()):
        raise ValueError(f"{name}: operands must all be float32 or bfloat16: "
                         f"{[x.dtype for x in tensors.values()]}")
    for key, x in tensors.items():
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous, 16-byte aligned "
                             f"and on {q.device}")
    return B, S, D


def _count(wrapper, num_heads: int) -> None:
    """One launch of `wrapper`'s kernel: a one-head launch is the transposed
    layout [B*H, S, 64] (the TPU package's `_fwd_kernel` or `_dq_kernel` and
    `_dkv_kernel`), any other the packed layout."""
    if num_heads == 1:
        wrapper.transposed_launches += 1
    else:
        wrapper.launches += 1


def _valid(valid_len: Optional[int], S: int) -> int:
    valid = S if valid_len is None else int(valid_len)
    if not 1 <= valid <= S:
        raise ValueError(f"valid_len must be in [1, {S}], got {valid}")
    return valid


def pk_fwd(q, k, v, *, scale: float, num_heads: int,
           valid_len: Optional[int] = None,
           static_max: Optional[float] = None,
           fast_softmax: bool = False):
    """Packed attention forward -> (o [B, S, D], lse [B, H, S] fp32).

    static_max: None for the per-row max, or C for exp(s - C) with
    lse = C + log l (see `resolve_static_max`). fast_softmax: the exp in
    the input dtype (`softmax_mode`: the fixed shift wins, fp32 ignores
    it), for layers that take no gradient. valid_len: keys at index >=
    valid_len are masked (default S). It calls the custom op
    `owlvit::pk_fwd`, which torch.export traces as one node: CPU tensors run
    `pk_fwd_plain`; CUDA tensors run the kernel, and `pk_fwd.launches`
    counts each launch (`pk_fwd.transposed_launches` at num_heads=1,
    `pk_fwd.fast_launches` in the fast mode)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pk_fwd runs on cpu or cuda tensors, got {q.device}")
    return torch.ops.owlvit.pk_fwd(
        q, k, v, float(scale), int(num_heads), None if valid_len is None else int(valid_len),
        None if static_max is None else float(static_max), bool(fast_softmax))


pk_fwd.launches = pk_fwd.transposed_launches = pk_fwd.fast_launches = 0


@torch.library.custom_op("owlvit::pk_fwd", mutates_args=())
def _pk_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
               num_heads: int, valid_len: Optional[int],
               static_max: Optional[float],
               fast_softmax: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """`pk_fwd`'s implementation: the plain version on the CPU, the kernel
    (counted) on the card."""
    if q.device.type == "cpu":
        o, lse = pk_fwd_plain(q, k, v, scale=scale, num_heads=num_heads,
                              valid_len=valid_len, static_max=static_max,
                              fast_softmax=fast_softmax)
        return o, lse.contiguous()
    B, S, D = _check_cuda_operands("pk_fwd", num_heads, q=q, k=k, v=v)
    valid = _valid(valid_len, S)
    mode = softmax_mode(q.dtype, static_max, fast_softmax)
    o = torch.empty_like(q)
    lse = torch.empty((B, num_heads, S), dtype=torch.float32, device=q.device)
    launch("owlvit_pk_fwd", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr(), B, S, num_heads, HEAD_DIM, valid, float(scale), mode,
           0.0 if static_max is None else float(static_max),
           DTYPE_CODE[q.dtype])
    if mode == FAST:
        pk_fwd.fast_launches += 1
    else:
        _count(pk_fwd, num_heads)
    return o, lse


@_pk_fwd_op.register_fake
def _pk_fwd_fake(q, k, v, scale, num_heads, valid_len, static_max, fast_softmax=False):
    B, S, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, num_heads, S), dtype=torch.float32)


def _check_rows(name: str, x, B: int, H: int, S: int, device) -> None:
    """lse or delta: contiguous float32 [B, H, S] on `device`."""
    if (x.shape != (B, H, S) or x.dtype != torch.float32 or x.device != device
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 [{B}, {H}, {S}] on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def pk_bwd(q, k, v, o, lse, do, *, scale: float, num_heads: int,
           valid_len: Optional[int] = None):
    """Packed attention backward, mode "fused" -> (dq, dk, dv) [B, S, D] in
    the input dtype.

    o and lse [B, H, S] fp32 are the forward's outputs (per-row max); do is
    the cotangent of o. valid_len: keys at index >= valid_len are masked
    and query rows >= valid_len contribute nothing (default S). CPU tensors
    run `pk_bwd_plain`; CUDA tensors run the kernel, and `pk_bwd.launches`
    counts each launch (`pk_bwd.transposed_launches` at num_heads=1). In
    bf16 each 128-key block of the kernel adds its dq partials into a zeroed
    fp32 buffer with four-wide vector reductions (`red.global.add.v4.f32`;
    no scalar atomics), in an order that changes from run to run: dq may
    differ in its last fp32 bits before the cast, so by one bf16 ulp after
    it; dk and dv are the same from run to run. Mode "both"
    (`pk_bwd_split`, the default) gives the same dq on every run."""
    if q.device.type == "cpu":
        return pk_bwd_plain(q, k, v, o, lse, do, scale=scale,
                            num_heads=num_heads, valid_len=valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"pk_bwd runs on cpu or cuda tensors, got {q.device}")
    B, S, D = _check_cuda_operands("pk_bwd", num_heads, q=q, k=k, v=v, o=o, do=do)
    _check_rows("pk_bwd: lse", lse, B, num_heads, S, q.device)
    valid = _valid(valid_len, S)
    bf16 = q.dtype == torch.bfloat16
    delta = torch.empty((B, num_heads, S), dtype=torch.float32, device=q.device)
    # bf16: the kernel adds dq partials into a zeroed fp32 buffer; fp32: it writes dq
    dq = (torch.zeros((B, S, D), dtype=torch.float32, device=q.device) if bf16
          else torch.empty_like(q))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch("owlvit_pk_bwd", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), B, S, num_heads, HEAD_DIM, valid,
           float(scale), DTYPE_CODE[q.dtype])
    _count(pk_bwd, num_heads)
    return (dq.to(q.dtype) if bf16 else dq), dk, dv


pk_bwd.launches = pk_bwd.transposed_launches = 0


def scale_is_exact_in_bf16(scale: float) -> bool:
    """Whether k * scale rounds to itself in bf16 for every bf16 k short of
    underflow: a power of two in (0, 1] (hd**-0.5 = 1/8 at head dim 64)."""
    return 0.0 < scale <= 1.0 and math.frexp(scale)[0] == 0.5


def _scaled_scratch(x, scale: float):
    """A bf16 kernel's scratch for x * scale (k for the dq kernel, q for the
    dkv kernel), rounded once by a launch before it (the TPU kernel's
    rounding point), or None where that rounding is exact: the kernel then
    reads x and scales its fp32 scores and its output instead, which gives
    the same bits."""
    return None if scale_is_exact_in_bf16(scale) else torch.empty_like(x)


def pk_dq(q, k, v, o, lse, do, *, scale: float, num_heads: int,
          valid_len: Optional[int] = None):
    """The split pair's first half, dq by query tile -> (dq [B, S, D] in the
    input dtype, delta [B, H, S] fp32 for `pk_dkv`); arguments as `pk_bwd`'s.
    Each query tile's dq is summed in registers over every key in a fixed
    order and written once: the same inputs give the same dq. CPU tensors
    run `pk_dq_plain`; CUDA tensors run the kernel, and `pk_dq.launches`
    counts each launch (`pk_dq.transposed_launches` at num_heads=1)."""
    if q.device.type == "cpu":
        return pk_dq_plain(q, k, v, o, lse, do, scale=scale, num_heads=num_heads,
                           valid_len=valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"pk_dq runs on cpu or cuda tensors, got {q.device}")
    B, S, _ = _check_cuda_operands("pk_dq", num_heads, q=q, k=k, v=v, o=o, do=do)
    _check_rows("pk_dq: lse", lse, B, num_heads, S, q.device)
    valid = _valid(valid_len, S)
    delta = torch.empty((B, num_heads, S), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    ks = _scaled_scratch(k, scale) if q.dtype == torch.bfloat16 else None
    launch("owlvit_pk_dq", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
           do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
           None if ks is None else ks.data_ptr(), B, S, num_heads, HEAD_DIM,
           valid, float(scale), DTYPE_CODE[q.dtype])
    _count(pk_dq, num_heads)
    return dq, delta


pk_dq.launches = pk_dq.transposed_launches = 0


def pk_dkv(q, k, v, lse, do, delta, *, scale: float, num_heads: int,
           valid_len: Optional[int] = None):
    """The split pair's second half, dk and dv by key tile -> (dk, dv) [B,
    S, D] in the input dtype, from `pk_dq`'s delta. Each key tile's dk and
    dv are summed in registers over every query in a fixed order: the same
    inputs give the same dk and dv. CPU tensors run `pk_dkv_plain`; CUDA
    tensors run the kernel, and `pk_dkv.launches` counts each launch
    (`pk_dkv.transposed_launches` at num_heads=1)."""
    if q.device.type == "cpu":
        return pk_dkv_plain(q, k, v, lse, do, delta, scale=scale, num_heads=num_heads,
                            valid_len=valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"pk_dkv runs on cpu or cuda tensors, got {q.device}")
    B, S, _ = _check_cuda_operands("pk_dkv", num_heads, q=q, k=k, v=v, do=do)
    _check_rows("pk_dkv: lse", lse, B, num_heads, S, q.device)
    _check_rows("pk_dkv: delta", delta, B, num_heads, S, q.device)
    valid = _valid(valid_len, S)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    qs = _scaled_scratch(q, scale) if q.dtype == torch.bfloat16 else None
    launch("owlvit_pk_dkv", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
           delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           None if qs is None else qs.data_ptr(), B, S, num_heads, HEAD_DIM,
           valid, float(scale), DTYPE_CODE[q.dtype])
    _count(pk_dkv, num_heads)
    return dk, dv


pk_dkv.launches = pk_dkv.transposed_launches = 0


def pk_bwd_split(q, k, v, o, lse, do, *, scale: float, num_heads: int,
                 valid_len: Optional[int] = None):
    """Packed attention backward, mode "both" (the JAX package's split
    pair; the default): `pk_dq` then `pk_dkv` -> (dq, dk, dv), the function
    `pk_bwd` computes, the same from run to run."""
    args = dict(scale=scale, num_heads=num_heads, valid_len=valid_len)
    dq, delta = pk_dq(q, k, v, o, lse, do, **args)
    return (dq, *pk_dkv(q, k, v, lse, do, delta, **args))


# the packed backward's modes: "fused" (pk_bwd) and "both" (pk_bwd_split)
BWD_MODES = ("fused", "both")


def pk_bwd_mode() -> str:
    """Which packed backward runs: OWLVIT_PACKED_BWD (read at call time)
    when set, as the JAX package's `_pk_bwd_mode` lets it win, else "both",
    the split pair, whose dq, dk and dv are the same on every run (the JAX
    package's grid runs in order, so its dq is too; the fused kernel's dq
    reduction is what would break that here). "fused" stays the A/B
    yardstick. The JAX package's diagnostic halves "dq" and "dkv" isolate a
    TPU fault and are not ported: they raise, as any other value does."""
    mode = os.environ.get("OWLVIT_PACKED_BWD") or "both"
    if mode not in BWD_MODES:
        raise ValueError(f"packed backward mode {mode!r} (OWLVIT_PACKED_BWD): the port "
                         f"runs {BWD_MODES}")
    return mode


class _FlashAttentionPacked(torch.autograd.Function):
    """o = attention(q, k, v) with the per-row-max forward (`pk_fwd`) and
    the backward from the saved (q, k, v, o, lse), `pk_bwd_split` or
    `pk_bwd` as `pk_bwd_mode()` resolves at backward time: the counterpart
    of the JAX package's `_flash_packed` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads):
        o, lse = pk_fwd(q, k, v, scale=scale, num_heads=num_heads)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.num_heads = scale, num_heads
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = pk_bwd if pk_bwd_mode() == "fused" else pk_bwd_split
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), scale=ctx.scale,
                         num_heads=ctx.num_heads)
        return dq, dk, dv, None, None


def _check_differentiable(fast_softmax: bool) -> None:
    """The JAX package's `_check_differentiable`: the fast softmax has no
    backward that recomputes its p, so the autograd paths refuse it (a
    forward-only call takes `pk_fwd`'s fast mode)."""
    if fast_softmax:
        raise NotImplementedError(
            "fast_softmax=True has no consistent backward (the forward takes the "
            "softmax weights in the input dtype; the backward recomputes them in "
            "fp32). It is only for layers that take no gradient (the frozen "
            "prefix, through pk_fwd); pass fast_softmax=False on differentiated calls.")


def flash_attention_packed(q, k, v, *, scale: float, num_heads: int,
                           fast_softmax: bool = False):
    """Differentiable packed attention over all S tokens ([B, S, D] in and
    out): the kernels on CUDA tensors, the plain versions on CPU tensors;
    the backward as `pk_bwd_mode` resolves it. The fixed-shift softmax has
    no place here: it is for forward-only calls. fast_softmax=True raises
    NotImplementedError (`_check_differentiable`)."""
    _check_differentiable(fast_softmax)
    return _FlashAttentionPacked.apply(q, k, v, float(scale), int(num_heads))


# heads per group in the JAX package's packed kernels: GROUP_LANES // hd
GROUP_LANES = 128


def _group_heads(num_heads: int, head_dim: int) -> int:
    return max(1, min(num_heads, GROUP_LANES // head_dim))


def packed_supported(num_heads: int, head_dim: int, D: int) -> bool:
    """The JAX package's predicate for the packed forward and backward;
    OWLVIT_PACKED_FLASH=0 (read at call time) turns it off, and a recorded
    attention call then takes the hybrid path."""
    if os.environ.get("OWLVIT_PACKED_FLASH", "1") == "0":
        return False
    return hybrid_supported(num_heads, head_dim, D)


def hybrid_supported(num_heads: int, head_dim: int, D: int) -> bool:
    """The JAX package's predicate for the hybrid path: the heads split into
    whole groups. When it fails (an odd head count at hd 64), a recorded
    call takes the transposed `flash_attention`."""
    hg = _group_heads(num_heads, head_dim)
    return num_heads % hg == 0 and hg * head_dim <= D


def _to3(x):
    """[B, S, H, hd] -> [B*H, S, hd], contiguous."""
    B, S, H, hd = x.shape
    return x.transpose(1, 2).reshape(B * H, S, hd).contiguous()


def _from3(x, B: int, H: int):
    """[B*H, S, hd] -> [B, S, H, hd]."""
    _, S, hd = x.shape
    return x.reshape(B, H, S, hd).transpose(1, 2)


class _FlashAttention3(torch.autograd.Function):
    """Attention over [B, S, H, hd] through the transposed layout: the
    counterpart of the JAX package's `_flash3` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        B, _, H, _ = q.shape
        q3, k3, v3 = _to3(q), _to3(k), _to3(v)
        o3, lse = pk_fwd(q3, k3, v3, scale=scale, num_heads=1)
        ctx.save_for_backward(q3, k3, v3, o3, lse)
        ctx.scale, ctx.B, ctx.H = scale, B, H
        return _from3(o3, B, H)

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o3, lse = ctx.saved_tensors
        grads = pk_bwd_split(q3, k3, v3, o3, lse, _to3(do), scale=ctx.scale, num_heads=1)
        return (*(_from3(g, ctx.B, ctx.H) for g in grads), None)


def flash_attention(q, k, v, *, scale: float):
    """Differentiable attention over all S tokens, q, k, v and the output
    [B, S, H, hd] (the JAX package's `flash_attention` without padding,
    bias or mask): relayout to [B*H, S, hd] and `pk_fwd` at one head (the
    per-row max; lse [B*H, 1, S]), in the backward the split pair
    (`pk_bwd_split`) at one head, as the JAX package's `_bwd` always runs
    `_dq_kernel` and `_dkv_kernel`, then back. All S keys are real: the port
    does not pad."""
    return _FlashAttention3.apply(q, k, v, float(scale))


class _FlashAttentionHybrid(torch.autograd.Function):
    """Packed forward, transposed backward: the counterpart of the JAX
    package's `_flash_hybrid` custom_vjp and `_transposed_bwd_from_packed`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads):
        o, lse = pk_fwd(q, k, v, scale=scale, num_heads=num_heads)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.num_heads = scale, num_heads
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        B, S, D = q.shape
        H = ctx.num_heads

        def to3(x):  # [B, S, D] -> [B*H, S, hd]
            return _to3(x.reshape(B, S, H, D // H))

        def from3(x):  # [B*H, S, hd] -> [B, S, D]
            return _from3(x, B, H).reshape(B, S, D)

        grads = pk_bwd_split(to3(q), to3(k), to3(v), to3(o), lse.reshape(B * H, 1, S),
                             to3(do), scale=ctx.scale, num_heads=1)
        return (*(from3(g) for g in grads), None, None)


def flash_attention_hybrid(q, k, v, *, scale: float, num_heads: int,
                           fast_softmax: bool = False):
    """Differentiable packed attention ([B, S, D] in and out) whose forward
    is `pk_fwd` and whose backward relayouts q, k, v, o, do and lse to the
    transposed layout and runs the split pair (`pk_bwd_split`) at one head:
    the path a recorded call takes under OWLVIT_PACKED_FLASH=0.
    fast_softmax as in `flash_attention_packed`."""
    _check_differentiable(fast_softmax)
    return _FlashAttentionHybrid.apply(q, k, v, float(scale), int(num_heads))
