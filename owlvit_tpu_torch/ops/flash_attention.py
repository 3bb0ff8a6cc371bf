"""Packed flash-attention forward: the Hopper kernel, its plain version and
the launch counter.

Counterpart of owlvit_tpu/ops/flash_attention.py (`_pk_fwd`,
`_pk_fwd_kernel`, `flash_attention_packed`, `_static_max_env`). q/k/v stay
in the packed [B, S, D] layout (head h = columns h*hd:(h+1)*hd); outputs are
o [B, S, D] in the input dtype and lse [B, H, S] in fp32.

`pk_fwd` is the wrapper: a CPU tensor goes to `pk_fwd_plain`, a CUDA tensor
to the CUDA kernel in ../csrc/flash_attention_fwd.cu, or the wrapper raises.
The kernel is built with nvcc at first use into ../_build/ (keyed by a hash
of the sources and flags) and bound with ctypes, so importing this module
needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIM = 64  # the only head dim of B/32, B/16 and L/14; the kernel takes no other

# Fixed softmax shift for non-fp32 serving (the JAX package's
# _STATIC_MAX_DEFAULT): exp(s - C) needs no row max, and C = 20 keeps
# headroom for logits up to ~C + 88 before exp overflows in fp32.
STATIC_MAX_DEFAULT = 20.0


def resolve_static_max(dtype: torch.dtype, static_softmax: bool) -> Optional[float]:
    """C for the fixed-shift softmax, or None for the per-row max: C = 20 for
    non-fp32 compute when static_softmax is set, as `_static_max_env`
    resolves it by default (an argument here, not an environment variable)."""
    if static_softmax and dtype != torch.float32:
        return STATIC_MAX_DEFAULT
    return None


def pk_fwd_plain(q, k, v, *, scale: float, num_heads: int,
                 valid_len: Optional[int] = None,
                 static_max: Optional[float] = None):
    """Plain PyTorch version of the kernel, with the same rounding points:
    q scaled in the input dtype, fp32 scores and sums, p rounded to the
    input dtype before p.v, the division by l in fp32. Keys at index >=
    valid_len get zero weight. Returns (o [B, S, D], lse [B, H, S])."""
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
    p = torch.exp(s - shift)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(q.dtype).float() @ heads(v)) / l
    o = o.transpose(1, 2).reshape(B, S, D).to(q.dtype)
    return o, (shift + torch.log(l))[..., 0]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile csrc/*.cu with nvcc for sm_90a into a shared library under
    _build/, named by a hash of the sources and flags; reuse it if present.
    nvcc's report (registers, shared memory, spills) goes beside it as .log."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libowlvit_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.owlvit_pk_fwd.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    )
    lib.owlvit_pk_fwd.restype = ctypes.c_int
    return lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def pk_fwd(q, k, v, *, scale: float, num_heads: int,
           valid_len: Optional[int] = None,
           static_max: Optional[float] = None):
    """Packed attention forward -> (o [B, S, D], lse [B, H, S] fp32).

    static_max: None for the per-row max, or C for exp(s - C) with
    lse = C + log l (see `resolve_static_max`). valid_len: keys at index >=
    valid_len are masked (default S). CPU tensors run `pk_fwd_plain`; CUDA
    tensors run the kernel, and `pk_fwd.launches` counts each launch."""
    if q.device.type == "cpu":
        return pk_fwd_plain(q, k, v, scale=scale, num_heads=num_heads,
                            valid_len=valid_len, static_max=static_max)
    if q.device.type != "cuda":
        raise ValueError(f"pk_fwd runs on cpu or cuda tensors, got {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, S, D] shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, S, D = q.shape
    if D % num_heads or D // num_heads != HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}; got D={D}, "
                         f"num_heads={num_heads}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16: "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {q.device}")
    valid = S if valid_len is None else int(valid_len)
    if not 1 <= valid <= S:
        raise ValueError(f"valid_len must be in [1, {S}], got {valid}")
    o = torch.empty_like(q)
    lse = torch.empty((B, num_heads, S), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.owlvit_pk_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, num_heads, HEAD_DIM, valid, float(scale),
            int(static_max is not None),
            0.0 if static_max is None else float(static_max),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"pk_fwd kernel launch failed: CUDA error {err}")
    pk_fwd.launches += 1
    return o, lse


pk_fwd.launches = 0
