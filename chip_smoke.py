#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each printing its numbers on a line of its own:
  1. device: refuse to run without CUDA; TF32 off; the card's name and power
     limit from nvidia-smi.
  2. build: the kernels from owlvit_tpu_torch/csrc (attention forward and
     backward, fused add+LayerNorm), one nvcc per source, started together;
     nvcc's registers, stack and spills per kernel, the bf16 attention
     backward's under a key of their own.
  3. kernel: pk_fwd against its plain PyTorch version on the card at the
     B/32, B/16 and L/14 attention shapes (batch 4, valid_len < padded S),
     bf16 and fp32, fixed-shift (C=20) and per-row-max softmax.
  4. kernel_bwd: pk_bwd against its plain version at the same shapes and at
     [8, 2305, 768] unpadded, bf16 and fp32 (the fp32 instantiation is the
     one the JAX package's split backward serves).
  5. kernel_ln: add_ln forward and backward against their plain versions at
     [32*2305, 768] (the trained shape), [8*2305, 768], [4*3601, 1024]
     (L/14) and [2305, 768], bf16 and fp32: r exact, the backward's sums the
     same from launch to launch; at the trained shape in bf16 the times
     beside the bound, the plain versions' and the yardstick x + h then
     F.layer_norm (forward, backward alone, and forward + backward).
  6. kernel_transposed: the transposed Function flash_attention ([B, S, H,
     64], the packed kernels at one head per sequence) driven once forward
     and backward at [32, 2305, 12, 64] bf16 and [4, 2305, 12, 64] fp32 (the
     only launches of the transposed forward: no model reaches it), then
     its kernels against the plain versions, with times at the bf16 shape.
  7. slice: B/16 bf16 with random weights behind DetectorServer(buckets=(1,
     8)); 9 model-sized images; results checked; the forward kernel's launch
     count, a batch bit-equal to a direct forward + NMS, and the kernel path
     against the plain-attention path.
  8. main_path_kernel: pk_fwd against its plain version at the shapes the
     served forward gives it ([8, 2305, 768] and [1, 2305, 768], C = 20, no
     padding) and at the train step's [32, 2305, 768] (per-row max), with
     scaled_dot_product_attention's forward time beside it; then pk_bwd at
     [32, 2305, 768] bf16 beside its plain version (on batch slices of 4)
     and scaled_dot_product_attention's forward + backward, and launched
     twice: dk and dv bit-equal, dq within its reductions' fp32 order.
  9. train: 4 uncached steps of Trainer.train_step, B/16 bf16, random
     weights (seed 0), a 240-query bank, batch 32, max_gt 64, ~7 random
     boxes per image, lr 3e-6, weight decay 0.1: finite terms, launch counts
     (12 pk_fwd and 1 pk_bwd per step), frozen parameters bit-unchanged,
     every trainable one moved; host wall of steps 2-4, CUDA-event times of
     each phase of the step, peak memory. Then the trained layer on the
     prefix output of 8 images: kernel path against the plain path, forward
     and backward.
 10. train_cached: the same recipe with training.cache_backbone, the device
     pool sized for config.yaml's 2500 images, 64 of them trained on: epoch
     1 (2 steps) fills the pool, epoch 2 (2 steps, no pixels) gathers.
     Default run (bf16 pool): launch counts (11 pk_fwd per filled batch, 1
     pk_fwd and 1 pk_bwd per step), stored rows bit-equal to a fresh
     embed_prefix, finite terms, frozen and trainable parameters; then one
     tail step under OWLVIT_PACKED_FLASH=0 (the transposed backward) against
     the packed step from the same state (terms equal, gradients and update
     within 1e-4 in L2); then OWLVIT_FUSED_LN=1 with the int8 pool (22
     add_ln_fwd per filled batch, 2 add_ln_fwd and 2 add_ln_bwd per step;
     rows within rowmax/254; epoch-1 terms against the unfused run). Host wall, CUDA events per phase and peak memory of each.
The kernels JSON (second-to-last line) gives each kernel's launches summed
over the paths driven (serving, the uncached and cached train runs, and for
the transposed entries alone the drives of phase 6; each counted from 0 just
before it and read just after, each launch once, where the wrapper makes it),
its error, time, plain time, bound and library time at its main-path shape;
the last line is the device JSON. Any failure raises, so the exit code is
non-zero.
"""

import contextlib
import copy
import json
import os
import subprocess
import time

# bitwise-reproducible cuBLAS across the server's thread and the main thread,
# for the bit-equality check of phase 5; a production server does not set it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from owlvit_tpu_torch.models import get_config, owlvit, vit  # noqa: E402
from owlvit_tpu_torch.ops import _cuda, fused_ln  # noqa: E402
from owlvit_tpu_torch.ops import flash_attention as fa  # noqa: E402
from owlvit_tpu_torch.ops import nms as nms_ops  # noqa: E402
from owlvit_tpu_torch.ops.quant import dequantize_rows  # noqa: E402
from owlvit_tpu_torch.ops.preprocess import normalize_image  # noqa: E402
from owlvit_tpu_torch.serve import DetectorServer, _flatten_bucket  # noqa: E402
from owlvit_tpu_torch.train import Trainer  # noqa: E402
from owlvit_tpu_torch.utils.config import (  # noqa: E402
    Config, DataConfig, ModelConfig, TrainingConfig)

KERNELS = {
    "pk_fwd": ("owlvit_tpu_torch/csrc/flash_attention_fwd.cu",
               "owlvit_tpu/ops/flash_attention.py:368"),
    "pk_bwd": ("owlvit_tpu_torch/csrc/flash_attention_bwd.cu",
               "owlvit_tpu/ops/flash_attention.py:654"),
    "add_ln_fwd": ("owlvit_tpu_torch/csrc/fused_ln.cu",
                   "owlvit_tpu/ops/fused_ln.py:50"),
    "add_ln_bwd": ("owlvit_tpu_torch/csrc/fused_ln.cu",
                   "owlvit_tpu/ops/fused_ln.py:63"),
    # the transposed functions run the packed kernels at num_heads=1
    "transposed_fwd": ("owlvit_tpu_torch/csrc/flash_attention_fwd.cu",
                       "owlvit_tpu/ops/flash_attention.py:73"),
    "transposed_bwd": ("owlvit_tpu_torch/csrc/flash_attention_bwd.cu",
                       "owlvit_tpu/ops/flash_attention.py:136/:159"),
}
# each kernel's launch counter: (wrapper, attribute), added to where the
# wrapper launches; pk_fwd and pk_bwd count a one-head launch (the transposed
# layout) under transposed_launches and no other
COUNTERS = {"pk_fwd": (fa.pk_fwd, "launches"), "pk_bwd": (fa.pk_bwd, "launches"),
            "add_ln_fwd": (fused_ln.add_ln_fwd, "launches"),
            "add_ln_bwd": (fused_ln.add_ln_bwd, "launches"),
            "transposed_fwd": (fa.pk_fwd, "transposed_launches"),
            "transposed_bwd": (fa.pk_bwd, "transposed_launches")}
SWITCHES = ("OWLVIT_FUSED_LN", "OWLVIT_PACKED_FLASH")
BATCH = 4
C = fa.STATIC_MAX_DEFAULT
# Tolerances. Forward, bf16: both sides round p to bf16 and differ in
# summation order, so o is held to 2e-2 of its largest magnitude; lse is fp32
# on both. fp32: summation order and exp rounding only.
TOL_BF16_O_REL, TOL_BF16_LSE = 2e-2, 1e-3
TOL_F32 = 1e-4
# Backward, bf16: both sides round ds and p to bf16 at the same points, but a
# value at a rounding boundary can fall either way (exp and sums differ in
# their last fp32 bits, and the kernel adds dq up with fp32 reductions in an
# order that changes from run to run), so dq, dk and dv are held to 2e-2 of
# their largest magnitude, as the forward's o. fp32 (no atomics): 1e-4 of
# the largest magnitude, summation order over up to 3712 keys.
TOL_BWD_BF16_REL, TOL_BWD_F32_REL = 2e-2, 1e-4
# Two launches of the bf16 backward on the same inputs: dk and dv bit-equal;
# dq adds its key tiles' partials with reductions in an order that changes
# from run to run, so its fp32 sums differ in their last bits and the cast to
# bf16 may round an element one ulp the other way: at most 2^-7 of that
# element, so of the largest magnitude.
TOL_DQ_REPEAT_REL = 2.0**-7
TOL_SLICE = 3e-2  # kernel vs plain attention, pre-NMS sims and boxes, 12 bf16 layers
# The trained layer, kernel path vs plain path under autograd, bf16, max-rel.
# y, dx and the v and out weight grads: 3e-2, as the served slice (the two
# backward graphs round at different points: the plain path's autograd
# rounds dp to bf16, the kernel ds). The q and k weight grads: 0.15. The
# kernel rounds ds to bf16 before the dq and dk products, as the TPU kernel
# does; the rounded rows of ds no longer sum to zero, and the keys' shared
# mean turns that into a few % of error on these two grads (4-6% against an
# fp32 reference at B/16 with the plain versions of the same rounding, on the
# CPU, where the plain path errs by 0.6%). An fp32 run of the layer is the
# reference both bf16 paths are reported against.
TOL_LAYER = {"y": 3e-2, "dx": 3e-2, "dq_w": 0.15, "dk_w": 0.15, "dv_w": 3e-2,
             "dout_w": 3e-2}
# add_ln, kernel vs plain on the same inputs. r: exact (one add, rounded
# once on both sides). y and g: bf16 1e-2 of the largest magnitude (the
# fp32 statistics differ in their last bits, so a value at a bf16 rounding
# boundary can fall either way: one ulp, 0.4-0.8%); fp32 1e-5 of it
# (summation order and rsqrt over D <= 1024). dscale and dbias: sums over N
# rows in another order, held to 1e-5 of the column's sum of magnitudes.
TOL_LN = {"bf16": 1e-2, "f32": 1e-5}
TOL_LN_SUM = 1e-5
# The cached train step. Under OWLVIT_FUSED_LN=1 an LN output may differ by
# one bf16 ulp where the rounding falls either way; that propagates through
# the 11 frozen bf16 layers at bf16 noise, and a Hungarian assignment may
# flip on a near-tie: epoch-1 loss terms rtol 2e-2 against the unfused run.
# OWLVIT_PACKED_FLASH=0 changes only the backward (the same kernel at one
# head per sequence; dq reductions add in another order), so the terms are
# bit-equal, and the gradients of every trained parameter are within 1e-4 of
# the packed step's in L2 norm (2.8e-6 read on the update on an H100 80GB).
# The update is held to the same 1e-4, without the key bias: its gradient is
# 0 in exact arithmetic (a per-query shift of all scores leaves the softmax
# unchanged), so it is rounding noise that AdamW scales to a full step. Its
# gradient is in the gradient check.
TOL_FUSED_TERMS = 2e-2
TOL_HYBRID_GRAD = TOL_HYBRID_UPDATE = 1e-4
# H100 SXM datasheet peaks (dense): the bound of a launch is the larger of
# its bytes over the memory rate and its flops over the tensor-core rate
# (fp32 outside the tensor cores for elementwise work).
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
PEAK_F32_FLOPS = 67e12


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


def max_rel(a, b):
    return max_abs(a, b) / b.float().abs().max().item()


def reset_counts():
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)


def read_counts():
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in COUNTERS.items()}


@contextlib.contextmanager
def switches(**values):
    """Set the JAX package's switches (None: unset) for one run, then
    restore the environment."""
    def apply(settings):
        for k, v in settings.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    old = {k: os.environ.get(k) for k in values}
    try:
        apply(values)
        yield
    finally:
        apply(old)


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the least time for the work on an H100 SXM."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fwd_bound(B, S, D, H, elt=2):
    """q, k, v read, o written, lse written; two products of 2*S*S*hd."""
    return bound(4 * B * H * S * S * (D // H), 4 * B * S * D * elt + B * H * S * 4)


def bwd_bound(B, S, D, H, elt=2):
    """q, k, v, o, do and lse read, dq, dk, dv written; five products."""
    return bound(10 * B * H * S * S * (D // H), 8 * B * S * D * elt + B * H * S * 4)


def heads4(x, H):
    B, S, D = x.shape
    return x.view(B, S, H, D // H).transpose(1, 2)


def sdpa_ms(q, k, v, H, scale, do=None):
    """scaled_dot_product_attention at the same shape, forward alone (no
    grad), or forward + backward with cotangent do: a yardstick only, the
    port never calls it."""
    qh, kh, vh = (heads4(x, H) for x in (q, k, v))
    if do is None:
        with torch.no_grad():
            return cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 10)
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]

    def fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, scale=scale)
        torch.autograd.grad(o, leaves, heads4(do, H))

    return cuda_ms(fwd_bwd, 10)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)


def phase_build():
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    build_s = time.perf_counter() - t0
    report = _cuda.ptxas_report(lib_path)
    # the bf16 attention backward (main and delta kernels) on its own key
    bwd = {name: lines for name, lines in report.items() if "pk_bwd" in name and "bf16" in name}
    check(len(bwd) == 2, f"ptxas report of the bf16 attention backward: {bwd}")
    emit("build", seconds=build_s, library=lib_path.name, ptxas=report,
         ptxas_pk_bwd_bf16=bwd)


def attention_shapes():
    """(name, S padded to a 128 multiple, valid_len, H, D, scale) per model."""
    for name in ("b32", "b16", "l14"):
        vc = get_config(name).vision
        valid = vc.num_patches + 1
        yield (name, -(-valid // 128) * 128, valid, vc.num_heads, vc.hidden_size,
               vc.head_dim**-0.5)


def phase_kernel():
    """Forward kernel vs plain at the three attention shapes; raises on a
    disagreement."""
    for name, S, valid, H, D, scale in attention_shapes():
        g = torch.Generator(device="cuda").manual_seed(len(name) + S)
        q, k, v = (torch.randn(BATCH, S, D, generator=g, device="cuda")
                   for _ in range(3))
        row = {"shape": [BATCH, S, D], "heads": H, "valid_len": valid}
        for dtype, static, ref_static in ((torch.bfloat16, C, C),
                                          (torch.bfloat16, None, None),
                                          (torch.float32, None, None),
                                          (torch.float32, C, None)):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            args = dict(scale=scale, num_heads=H, valid_len=valid)
            o_k, l_k = fa.pk_fwd(qd, kd, vd, static_max=static, **args)
            o_p, l_p = fa.pk_fwd_plain(qd, kd, vd, static_max=ref_static, **args)
            torch.cuda.synchronize()
            o_k, o_p = o_k[:, :valid], o_p[:, :valid]
            l_k, l_p = l_k[..., :valid], l_p[..., :valid]
            check(torch.isfinite(o_k).all().item() and torch.isfinite(l_k).all().item(),
                  f"{name} {dtype} static={static}: non-finite kernel output")
            key = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_" \
                  f"{'static' if static is not None else 'dynamic'}"
            err = {"o_max_abs": max_abs(o_k, o_p), "o_max_rel": max_rel(o_k, o_p),
                   "lse_max_abs": max_abs(l_k, l_p)}
            if dtype == torch.bfloat16:
                check(err["o_max_rel"] <= TOL_BF16_O_REL and err["lse_max_abs"] <= TOL_BF16_LSE,
                      f"{name} {key}: {err}")
            else:
                check(err["o_max_abs"] <= TOL_F32 and err["lse_max_abs"] <= TOL_F32,
                      f"{name} {key}: {err}")
            if key in ("bf16_static", "f32_dynamic"):
                err["ms"] = cuda_ms(lambda: fa.pk_fwd(qd, kd, vd, static_max=static, **args), 10)
                err["plain_ms"] = cuda_ms(
                    lambda: fa.pk_fwd_plain(qd, kd, vd, static_max=static, **args), 3)
            row[key] = err
            del o_k, o_p, l_k, l_p
        emit("kernel", model=name, **row)
        del q, k, v
        torch.cuda.empty_cache()


def bwd_errors(got, want, valid):
    """Max abs / rel of dq, dk, dv over real rows, and whether the rows at
    and past valid_len are exactly zero in the kernel's output."""
    err = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(torch.isfinite(g).all().item(), f"non-finite kernel {name}")
        err[f"{name}_max_abs"] = max_abs(g[:, :valid], w[:, :valid])
        err[f"{name}_max_rel"] = max_rel(g[:, :valid], w[:, :valid])
        check(not g[:, valid:].any().item(), f"kernel {name} rows >= valid_len not 0")
    return err


def check_bwd(err, dtype, what):
    tol = TOL_BWD_BF16_REL if dtype == torch.bfloat16 else TOL_BWD_F32_REL
    worst = max(err[f"{n}_max_rel"] for n in ("dq", "dk", "dv"))
    check(worst <= tol, f"{what}: {err}")


def phase_kernel_bwd():
    """Backward kernel vs plain at the padded model shapes and at the
    unpadded [8, 2305, 768], bf16 and fp32."""
    b16 = get_config("b16").vision
    shapes = [*attention_shapes(),
              ("b16_unpadded_b8", b16.num_patches + 1, b16.num_patches + 1,
               b16.num_heads, b16.hidden_size, b16.head_dim**-0.5)]
    for name, S, valid, H, D, scale in shapes:
        batch = 8 if name.endswith("_b8") else BATCH
        g = torch.Generator(device="cuda").manual_seed(101 + S)
        q, k, v, do = (torch.randn(batch, S, D, generator=g, device="cuda")
                       for _ in range(4))
        row = {"shape": [batch, S, D], "heads": H, "valid_len": valid}
        for dtype in (torch.bfloat16, torch.float32):
            qd, kd, vd, dod = (x.to(dtype) for x in (q, k, v, do))
            args = dict(scale=scale, num_heads=H, valid_len=valid)
            o, lse = fa.pk_fwd(qd, kd, vd, **args)
            got = fa.pk_bwd(qd, kd, vd, o, lse, dod, **args)
            want = fa.pk_bwd_plain(qd, kd, vd, o, lse, dod, **args)
            torch.cuda.synchronize()
            key = "bf16" if dtype == torch.bfloat16 else "f32"
            err = bwd_errors(got, want, valid)
            check_bwd(err, dtype, f"{name} {key}")
            del got, want
            err["ms"] = cuda_ms(lambda: fa.pk_bwd(qd, kd, vd, o, lse, dod, **args), 5)
            err["plain_ms"] = cuda_ms(
                lambda: fa.pk_bwd_plain(qd, kd, vd, o, lse, dod, **args), 2)
            row[key] = err
            del qd, kd, vd, dod, o, lse
            torch.cuda.empty_cache()
        emit("kernel_bwd", model=name, **row)
        del q, k, v, do
        torch.cuda.empty_cache()


def trained_shape_bwd(cfg, batch=32, slice_=4):
    """pk_bwd at the train step's shape, bf16, per-row max, all 2305 tokens
    real. The plain version (one [B, H, S, S] fp32 tensor is 8.2 GB at batch
    32) runs on batch slices of 4, for the comparison and its time."""
    vc = cfg.vision
    S, D, H, scale = vc.num_patches + 1, vc.hidden_size, vc.num_heads, vc.head_dim**-0.5
    g = torch.Generator(device="cuda").manual_seed(32)
    q, k, v, do = (torch.randn(batch, S, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    args = dict(scale=scale, num_heads=H)
    o, lse = fa.pk_fwd(q, k, v, **args)
    got = fa.pk_bwd(q, k, v, o, lse, do, **args)
    diff = [0.0, 0.0, 0.0]
    peak = [0.0, 0.0, 0.0]
    plain_ms = 0.0
    for i in range(0, batch, slice_):
        part = [x[i:i + slice_] for x in (q, k, v, o, lse, do)]
        want = fa.pk_bwd_plain(*part, **args)
        for j in range(3):
            diff[j] = max(diff[j], max_abs(got[j][i:i + slice_], want[j]))
            peak[j] = max(peak[j], want[j].float().abs().max().item())
        del want
        plain_ms += cuda_ms(lambda: fa.pk_bwd_plain(*part, **args), 1)
    err = {}
    for j, name in enumerate(("dq", "dk", "dv")):
        check(torch.isfinite(got[j]).all().item(), f"non-finite kernel {name}")
        err[f"{name}_max_abs"] = diff[j]
        err[f"{name}_max_rel"] = diff[j] / peak[j]
    check_bwd(err, torch.bfloat16, f"trained shape [{batch}, {S}, {D}]")
    # dq again: the reductions add in another order, dk and dv do not change
    again = fa.pk_bwd(q, k, v, o, lse, do, **args)
    check(torch.equal(again[1], got[1]) and torch.equal(again[2], got[2]),
          "dk, dv differ between two launches")
    dq_diff = max_abs(again[0], got[0])
    err["dq_repeat_max_abs"] = dq_diff
    err["dq_repeat_max_rel"] = dq_diff / got[0].float().abs().max().item()
    err["dq_repeat_elements_differing"] = int((again[0] != got[0]).sum().item())
    check(err["dq_repeat_max_rel"] <= TOL_DQ_REPEAT_REL,
          f"dq differs between two launches beyond the fp32 order: {err}")
    del got, again
    ms = cuda_ms(lambda: fa.pk_bwd(q, k, v, o, lse, do, **args), 10)
    lib_fwd = sdpa_ms(q, k, v, H, scale)
    lib = sdpa_ms(q, k, v, H, scale, do=do)
    bound_ms, bound_by = bwd_bound(batch, S, D, H)
    row = {"shape": [batch, S, D], **err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib, "library_fwd_ms": lib_fwd,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernel_bwd_trained_shape", **row)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return row


def fwd_row(vc, batch, static, slice_=8):
    """pk_fwd at [batch, 2305, D] (no padding, so the last query tile is
    ragged) against its plain version on batch slices of 8, with times and
    scaled_dot_product_attention's forward beside it."""
    S, D, H, scale = vc.num_patches + 1, vc.hidden_size, vc.num_heads, vc.head_dim**-0.5
    args = dict(scale=scale, num_heads=H, static_max=static)
    g = torch.Generator(device="cuda").manual_seed(7 + batch)
    q, k, v = (torch.randn(batch, S, D, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o_k, l_k = fa.pk_fwd(q, k, v, **args)
    check(torch.isfinite(o_k).all().item() and torch.isfinite(l_k).all().item(),
          f"shape [{batch}, {S}, {D}]: non-finite kernel output")
    o_abs = o_peak = l_abs = plain_ms = 0.0
    for i in range(0, batch, slice_):
        part = [x[i:i + slice_] for x in (q, k, v)]
        o_p, l_p = fa.pk_fwd_plain(*part, **args)
        o_abs = max(o_abs, max_abs(o_k[i:i + slice_], o_p))
        o_peak = max(o_peak, o_p.float().abs().max().item())
        l_abs = max(l_abs, max_abs(l_k[i:i + slice_], l_p))
        del o_p, l_p
        plain_ms += cuda_ms(lambda: fa.pk_fwd_plain(*part, **args), 3)
    err = {"o_max_abs": o_abs, "o_max_rel": o_abs / o_peak, "lse_max_abs": l_abs}
    check(err["o_max_rel"] <= TOL_BF16_O_REL and err["lse_max_abs"] <= TOL_BF16_LSE,
          f"shape [{batch}, {S}, {D}]: {err}")
    bound_ms, bound_by = fwd_bound(batch, S, D, H)
    row = {"shape": [batch, S, D], "softmax": "dynamic" if static is None else f"C={static}",
           **err, "ms": cuda_ms(lambda: fa.pk_fwd(q, k, v, **args), 20),
           "plain_ms": plain_ms,
           "library_ms": sdpa_ms(q, k, v, H, scale),
           "bound_ms": bound_ms, "bound_by": bound_by}
    del q, k, v, o_k, l_k
    torch.cuda.empty_cache()
    return row


def phase_slice():
    cfg = get_config("b16", dtype="bfloat16")
    params = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=240).to("cuda")
    S = cfg.vision.image_size
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (9, S, S, 3), dtype=np.uint8)

    reset_counts()
    t_start = time.perf_counter()
    srv = DetectorServer(params, cfg, buckets=(1, 8), device="cuda",
                         autostart=False)  # warms up both buckets
    warmup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    futs = [srv.submit(im) for im in images]
    srv.start()  # all 9 are queued: one batch of 8, one of 1
    results = [f.result() for f in futs]
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    stats = srv.stats()
    srv.close()

    forward_batches = stats["batches"] + len(srv.buckets)  # + warmup
    check(stats["bucket_counts"] == {1: 1, 8: 1}, f"buckets {stats['bucket_counts']}")
    check(launches["pk_fwd"] == cfg.vision.num_layers * forward_batches,
          f"{launches} launches for {forward_batches} forward batches")
    check(all(n == 0 for k, n in launches.items() if k != "pk_fwd"),
          f"serving launched another kernel: {launches}")
    for res in results:
        b, s = res["boxes"], res["scores"]
        check(np.isfinite(b).all() and np.isfinite(s).all(), "non-finite result")
        check(((s >= 0) & (s <= 1)).all(), "score outside [0, 1]")
        check(((b[:, 2] >= b[:, 0]) & (b[:, 3] >= b[:, 1])).all(), "unordered box")
        # the box head puts centres in [0, 1] (sigmoid); edges may pass it
        cx, cy = (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2
        check(((cx >= 0) & (cx <= S) & (cy >= 0) & (cy <= S)).all(),
              "box centre outside the image")

    # the 8-image batch again, directly: forward + postprocess + pack
    flat = torch.from_numpy(_flatten_bucket(list(images[:8]), 8, S)).cuda()
    with torch.inference_mode():
        px = normalize_image(flat.reshape(8, S, S, 3))
        boxes, sims = owlvit.forward_train(params, srv.cfg, px)
        packed = nms_ops.pack_detections(
            nms_ops.postprocess(boxes, sims, confidence_threshold=0.01,
                                iou_threshold=0.6, top_k=200)).cpu().numpy()
        boxes_p, sims_p = owlvit.forward_train(
            params, srv.cfg.replace(attention_impl="xla"), px)
    for i in range(8):
        direct = srv._unpack_row(packed[i], (S, S))
        for key in ("boxes", "scores", "classes"):
            check(np.array_equal(direct[key], results[i][key]),
                  f"served image {i} {key} differs from the direct call")
    err_sims, err_boxes = max_abs(sims, sims_p), max_abs(boxes, boxes_p)
    check(err_sims <= TOL_SLICE and err_boxes <= TOL_SLICE,
          f"kernel vs plain attention: sims {err_sims} boxes {err_boxes}")
    emit("slice", model="b16", dtype="bfloat16", requests=len(images),
         img_per_s=len(images) / serve_s, serve_s=serve_s, warmup_s=warmup_s,
         stats=stats, launches=launches, forward_batches=forward_batches,
         detections=[len(r["scores"]) for r in results],
         kernel_vs_plain={"sims_max_abs": err_sims, "boxes_max_abs": err_boxes})
    del params, srv
    torch.cuda.empty_cache()
    return cfg, launches


def train_batch(rng, B, G, S, n_classes):
    """uint8 images (flat, as the loader sends them) and 4-10 random boxes
    per image, padded to G."""
    labels = np.zeros((B, G), np.int32)
    boxes = np.zeros((B, G, 4), np.float32)
    mask = np.zeros((B, G), bool)
    for b in range(B):
        n = int(rng.integers(4, 11))
        c, wh = rng.uniform(0.1, 0.9, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))
        boxes[b, :n] = np.clip(np.concatenate([c - wh / 2, c + wh / 2], 1), 0, 1)
        labels[b, :n] = rng.integers(0, n_classes, n)
        mask[b, :n] = True
    return {"image": rng.integers(0, 256, (B, S * S * 3), dtype=np.uint8),
            "labels": labels, "boxes": boxes, "gt_mask": mask}


class PhaseTimer:
    """CUDA events (and host clock) at the train step's phase marks; the
    first mark after "input" is "prefix", set by a pre-hook on the first
    trained layer."""

    def __init__(self):
        self.marks = []
        self("start")

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev, time.perf_counter()))

    def durations(self):
        torch.cuda.synchronize()
        return {b: {"device_ms": ea.elapsed_time(eb), "host_ms": (hb - ha) * 1e3}
                for (_, ea, ha), (b, eb, hb) in zip(self.marks, self.marks[1:])}


def phase_train(steps=4, batch=32, max_gt=64, n_classes=80):
    name = "b16"
    mcfg = get_config(name)
    L = mcfg.vision.num_layers
    config = Config(DataConfig(max_gt=max_gt),
                    TrainingConfig(learning_rate=3e-6, weight_decay=0.1,
                                   batch_size=batch, checkpoint_dir=None),
                    ModelConfig(name=name, dtype="bfloat16", trainable_last_k=1))
    model = owlvit.init(mcfg, torch.Generator().manual_seed(0),
                        num_queries=3 * n_classes, device="cuda")
    rng = np.random.default_rng(0)
    S = mcfg.vision.image_size
    batches = [train_batch(rng, batch, max_gt, S, n_classes) for _ in range(steps)]
    class_weights = np.linspace(0.5, 1.5, n_classes, dtype=np.float32)
    trainer = Trainer(config, model, n_classes, steps_per_epoch=steps,
                      class_weights=class_weights, device="cuda")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    timer = [None]
    hook = model.vision.layers[L - 1].register_forward_pre_hook(
        lambda mod, args: timer[0] and timer[0]("prefix"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, terms, phases = [], [], []
    for i, b in enumerate(batches):
        timer[0] = PhaseTimer() if i else None
        t0 = time.perf_counter()
        terms.append(trainer.train_step(b, mark=timer[0]).tolist())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if timer[0]:
            phases.append(timer[0].durations())
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hook.remove()

    check(np.isfinite(terms).all(), f"non-finite loss terms {terms}")
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * steps, "pk_bwd": steps},
          f"{launches} launches in {steps} steps")
    trainable = {id(p) for p in trainer.params}
    for n, p in model.named_parameters():
        same = torch.equal(p, before[n])
        check(not same if id(p) in trainable else same,
              f"{'trainable' if id(p) in trainable else 'frozen'} {n}: "
              f"{'unchanged' if same else 'changed'}")
    emit("train", model=name, dtype="bfloat16", batch=batch, steps=steps,
         max_gt=max_gt, gt_per_image=float(np.mean([b["gt_mask"].sum(1) for b in batches])),
         terms=terms, launches=launches, step_wall_ms=walls,
         img_per_s=batch * (steps - 1) / (sum(walls[1:]) / 1e3),
         phases_ms=phases, max_memory_allocated_gb=peak_gb,
         trainable_params=len(trainer.params))

    # the trained layer: kernel path vs plain path, forward and backward
    n = min(8, batch)
    with torch.no_grad():
        img = torch.from_numpy(batches[0]["image"][:n]).cuda().reshape(n, S, S, 3)
        acts = vit.forward_prefix(model.vision, mcfg.vision, normalize_image(img),
                                  dtype=torch.bfloat16, trainable_last_k=1)
    layer = model.vision.layers[L - 1]
    cot = torch.randn(acts.shape, generator=torch.Generator(device="cuda").manual_seed(11),
                      device="cuda").to(torch.bfloat16)
    out = {}
    for path, impl, dtype in (("kernel", "auto", torch.bfloat16),
                              ("plain", "xla", torch.bfloat16),
                              ("f32", "xla", torch.float32)):
        x = acts.to(dtype, copy=True).requires_grad_(True)
        layer.zero_grad(set_to_none=True)
        y = layer(x, impl=impl)
        y.backward(cot.to(dtype))
        out[path] = dict(zip(TOL_LAYER, [y.detach(), x.grad] + [
            getattr(layer.attn, n).weight.grad for n in ("q", "k", "v", "out")]))
        del x, y
    err = {name: max_rel(out["kernel"][name], out["plain"][name]) for name in TOL_LAYER}
    check(all(np.isfinite(e) and e <= TOL_LAYER[n] for n, e in err.items()),
          f"trained layer, kernel vs plain path: {err}")
    vs_f32 = {path: {name: max_rel(out[path][name], out["f32"][name]) for name in TOL_LAYER}
              for path in ("kernel", "plain")}
    emit("train_layer", shape=list(acts.shape), kernel_vs_plain_max_rel=err,
         vs_f32_max_rel=vs_f32)
    del model, trainer, before, acts, out
    torch.cuda.empty_cache()
    return launches


LN_EPS = 1e-5


def ln_inputs(N, D, dtype, seed):
    """x with a row offset (so that the mean is not ~0), h, dy, dr; fp32
    scale and bias around 1 and 0, as trained LayerNorms are."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(N, D, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    h, dy, dr = (torch.randn(N, D, generator=g, device="cuda").to(dtype) for _ in range(3))
    scale = 1 + 0.2 * torch.randn(D, generator=g, device="cuda")
    bias = 0.1 * torch.randn(D, generator=g, device="cuda")
    return x, h, scale, bias, dy, dr


def ln_errors(x, h, scale, bias, dy, dr, key):
    """add_ln forward and backward, kernel vs plain on the same inputs;
    raises outside the tolerances or if the backward's sums change from one
    launch to the next."""
    r_k, y_k = fused_ln.add_ln_fwd(x, h, scale, bias, LN_EPS)
    r_p, y_p = fused_ln.add_ln_fwd_plain(x, h, scale, bias, LN_EPS)
    g_k, ds_k, db_k = fused_ln.add_ln_bwd(r_k, dy, dr, scale, LN_EPS)
    again = fused_ln.add_ln_bwd(r_k, dy, dr, scale, LN_EPS)
    g_p, ds_p, db_p = fused_ln.add_ln_bwd_plain(r_k, dy, dr, scale, LN_EPS)
    torch.cuda.synchronize()
    for name, t in (("y", y_k), ("g", g_k), ("dscale", ds_k), ("dbias", db_k)):
        check(torch.isfinite(t).all().item(), f"add_ln {key}: non-finite kernel {name}")
    check(torch.equal(r_k, r_p), f"add_ln {key}: r differs from x + h")
    check(all(torch.equal(a, b) for a, b in zip((g_k, ds_k, db_k), again)),
          f"add_ln {key}: the backward is not deterministic")
    mean, rstd = fused_ln._stats(r_k.float(), LN_EPS)
    xhat = (r_k.float() - mean) * rstd
    mag_s = (dy.float() * xhat).abs().sum(0)
    mag_b = dy.float().abs().sum(0)
    err = {"y_max_abs": max_abs(y_k, y_p), "y_max_rel": max_rel(y_k, y_p),
           "g_max_abs": max_abs(g_k, g_p), "g_max_rel": max_rel(g_k, g_p),
           "dscale_max_abs": max_abs(ds_k, ds_p), "dbias_max_abs": max_abs(db_k, db_p),
           "dscale_rel_to_sum": ((ds_k - ds_p).abs() / mag_s).max().item(),
           "dbias_rel_to_sum": ((db_k - db_p).abs() / mag_b).max().item()}
    check(err["y_max_rel"] <= TOL_LN[key] and err["g_max_rel"] <= TOL_LN[key]
          and err["dscale_rel_to_sum"] <= TOL_LN_SUM
          and err["dbias_rel_to_sum"] <= TOL_LN_SUM, f"add_ln {key}: {err}")
    return err, r_k


def phase_kernel_ln():
    """add_ln forward and backward vs plain at the trained shape
    [32*2305, 768], [8*2305, 768], L/14's [4*3601, 1024] and one B/16 image
    (2305 rows, not a multiple of the kernel's 8-row block; 4*3601 is not
    either), bf16 and fp32; at the trained shape in bf16 the times of the
    kernels, their plain versions and the yardstick x + h then
    F.layer_norm: forward, backward alone (on a retained graph, the
    kernels line's library time) and forward + backward."""
    S16 = get_config("b16").vision.num_patches + 1
    S14 = get_config("l14").vision.num_patches + 1
    trained = None
    for name, N, D in (("trained", 32 * S16, 768), ("b16_b8", 8 * S16, 768),
                       ("l14_b4", 4 * S14, 1024), ("b16_one_image", S16, 768)):
        row = {"shape": [N, D]}
        for dtype in (torch.bfloat16, torch.float32):
            key = "bf16" if dtype == torch.bfloat16 else "f32"
            x, h, scale, bias, dy, dr = ln_inputs(N, D, dtype, seed=N + D)
            err, r = ln_errors(x, h, scale, bias, dy, dr, key)
            if name == "trained" and key == "bf16":
                elt = x.element_size()
                w16, b16 = scale.to(dtype), bias.to(dtype)
                leaves = [t.detach().clone().requires_grad_(True) for t in (x, h, w16, b16)]

                def lib_fwd():
                    rl = leaves[0] + leaves[1]
                    return rl, F.layer_norm(rl, (D,), leaves[2], leaves[3], LN_EPS)

                def lib_fwd_bwd():
                    torch.autograd.grad(lib_fwd(), leaves, (dr, dy))

                graph = lib_fwd()  # the backward alone, on a retained graph

                fwd_b = bound(8 * N * D, 4 * N * D * elt + 2 * D * 4, PEAK_F32_FLOPS)
                bwd_b = bound(14 * N * D, 4 * N * D * elt + 3 * D * 4, PEAK_F32_FLOPS)
                trained = {
                    "fwd": {"max_abs_err": err["y_max_abs"],
                            "ms": cuda_ms(lambda: fused_ln.add_ln_fwd(x, h, scale, bias, LN_EPS), 20),
                            "plain_ms": cuda_ms(lambda: fused_ln.add_ln_fwd_plain(
                                x, h, scale, bias, LN_EPS), 5),
                            "library_ms": cuda_ms(lambda: F.layer_norm(x + h, (D,), w16, b16, LN_EPS), 20),
                            "bound_ms": fwd_b[0], "bound_by": fwd_b[1]},
                    "bwd": {"max_abs_err": err["g_max_abs"],
                            "ms": cuda_ms(lambda: fused_ln.add_ln_bwd(r, dy, dr, scale, LN_EPS), 20),
                            "plain_ms": cuda_ms(lambda: fused_ln.add_ln_bwd_plain(
                                r, dy, dr, scale, LN_EPS), 5),
                            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                                graph, leaves, (dr, dy), retain_graph=True), 20),
                            "library_fwd_bwd_ms": cuda_ms(lib_fwd_bwd, 10),
                            "bound_ms": bwd_b[0], "bound_by": bwd_b[1]},
                }
                err.update({f"{d}_{k}": v for d in ("fwd", "bwd") for k, v in trained[d].items()
                            if k != "max_abs_err"})
                del leaves, graph
            row[key] = err
            del x, h, scale, bias, dy, dr, r
            torch.cuda.empty_cache()
        emit("kernel_ln", case=name, **row)
    return trained


def transposed_vs_plain(q3, k3, v3, do3, scale, key, slice_=48):
    """pk_fwd and pk_bwd at num_heads=1 on [B*H, S, 64] (the transposed
    kernels) against the plain versions, on slices of `slice_` sequences."""
    args = dict(scale=scale, num_heads=1)
    o3, lse = fa.pk_fwd(q3, k3, v3, **args)
    grads = fa.pk_bwd(q3, k3, v3, o3, lse, do3, **args)
    torch.cuda.synchronize()
    stats = dict.fromkeys(("o", "lse", "dq", "dk", "dv"), 0.0)
    peak = dict.fromkeys(stats, 0.0)
    plain_fwd_ms = plain_bwd_ms = 0.0
    for i in range(0, q3.shape[0], slice_):
        part = [t[i:i + slice_] for t in (q3, k3, v3)]
        o_p, l_p = fa.pk_fwd_plain(*part, **args)
        want = fa.pk_bwd_plain(*part, o3[i:i + slice_], lse[i:i + slice_],
                               do3[i:i + slice_], **args)
        for name, got, ref in (("o", o3, o_p), ("lse", lse, l_p), *zip(
                ("dq", "dk", "dv"), grads, want)):
            stats[name] = max(stats[name], max_abs(got[i:i + slice_], ref))
            peak[name] = max(peak[name], ref.float().abs().max().item())
        del o_p, l_p, want
        plain_fwd_ms += cuda_ms(lambda: fa.pk_fwd_plain(*part, **args), 1)
        plain_bwd_ms += cuda_ms(lambda: fa.pk_bwd_plain(
            *part, o3[i:i + slice_], lse[i:i + slice_], do3[i:i + slice_], **args), 1)
    err = {f"{n}_max_abs": stats[n] for n in stats}
    err.update({f"{n}_max_rel": stats[n] / peak[n] for n in ("o", "dq", "dk", "dv")})
    for t in (o3, *grads):
        check(torch.isfinite(t).all().item(), f"transposed {key}: non-finite kernel output")
    if key == "bf16":
        ok = (err["o_max_rel"] <= TOL_BF16_O_REL and err["lse_max_abs"] <= TOL_BF16_LSE
              and max(err[f"{n}_max_rel"] for n in ("dq", "dk", "dv")) <= TOL_BWD_BF16_REL)
    else:
        ok = (err["o_max_abs"] <= TOL_F32 and err["lse_max_abs"] <= TOL_F32
              and max(err[f"{n}_max_rel"] for n in ("dq", "dk", "dv")) <= TOL_BWD_F32_REL)
    check(ok, f"transposed {key}: {err}")
    return err, o3, lse, plain_fwd_ms, plain_bwd_ms


def phase_kernel_transposed():
    """flash_attention (the transposed Function) forward and backward at
    [32, 2305, 12, 64] bf16 and [4, 2305, 12, 64] fp32: one drive through
    the entry point (the only launches of the transposed forward: no model
    reaches it), counted from 0; then the kernels on the transposed layout
    against their plain versions; at the bf16 shape the times beside the
    bound and scaled_dot_product_attention's."""
    vc = get_config("b16").vision
    S, H, hd = vc.num_patches + 1, vc.num_heads, vc.head_dim
    scale = hd**-0.5
    launches, out = dict.fromkeys(KERNELS, 0), {}
    for batch, dtype in ((32, torch.bfloat16), (4, torch.float32)):
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        g = torch.Generator(device="cuda").manual_seed(300 + batch)
        q, k, v, do = (torch.randn(batch, S, H, hd, generator=g, device="cuda").to(dtype)
                       for _ in range(4))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        reset_counts()
        o = fa.flash_attention(*leaves, scale=scale)
        o.backward(do)
        torch.cuda.synchronize()
        drive = read_counts()
        check(drive == {**dict.fromkeys(KERNELS, 0), "transposed_fwd": 1, "transposed_bwd": 1},
              f"transposed {key}: {drive} launches in one forward + backward")
        launches = {n: launches[n] + drive[n] for n in KERNELS}
        q3, k3, v3, do3 = (fa._to3(t) for t in (q, k, v, do))
        err, o3, lse, plain_fwd_ms, plain_bwd_ms = transposed_vs_plain(q3, k3, v3, do3, scale, key)
        check(torch.equal(fa._from3(o3, batch, H), o.detach()),
              f"transposed {key}: the Function's output is not the kernel's")
        tol = TOL_BWD_BF16_REL if key == "bf16" else TOL_BWD_F32_REL
        grads = fa.pk_bwd(q3, k3, v3, o3, lse, do3, scale=scale, num_heads=1)
        for name, leaf, want in zip(("dq", "dk", "dv"), leaves, grads):
            check(max_rel(fa._to3(leaf.grad), want) <= tol,
                  f"transposed {key}: the Function's {name} is not the kernel's")
        row = {"shape": [batch, S, H, hd], "layout": list(q3.shape), **err}
        if key == "bf16":
            BH = batch * H
            fb, bb = fwd_bound(BH, S, hd, 1), bwd_bound(BH, S, hd, 1)
            with torch.no_grad():
                fn_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, scale=scale), 10)
            out = {
                "fwd": {"max_abs_err": err["o_max_abs"],
                        "ms": cuda_ms(lambda: fa.pk_fwd(q3, k3, v3, scale=scale,
                                                        num_heads=1), 20),
                        "plain_ms": plain_fwd_ms, "library_ms": sdpa_ms(q3, k3, v3, 1, scale),
                        "bound_ms": fb[0], "bound_by": fb[1], "function_ms": fn_ms},
                "bwd": {"max_abs_err": max(err[f"{n}_max_abs"] for n in ("dq", "dk", "dv")),
                        "ms": cuda_ms(lambda: fa.pk_bwd(q3, k3, v3, o3, lse, do3,
                                                        scale=scale, num_heads=1), 10),
                        "plain_ms": plain_bwd_ms,
                        "library_ms": sdpa_ms(q3, k3, v3, 1, scale, do=do3),
                        "bound_ms": bb[0], "bound_by": bb[1]},
            }
            row.update({f"{d}_{k}": v for d in ("fwd", "bwd") for k, v in out[d].items()
                        if k != "max_abs_err"})
        emit("kernel_transposed", dtype=key, launches=drive, **row)
        del q, k, v, do, leaves, o, q3, k3, v3, do3, o3, lse
        torch.cuda.empty_cache()
    return out, launches


N_IMAGES = 2500  # config.yaml's train set: the device pool is sized for it


def cached_data(rng, n, max_gt, S, n_classes):
    """n images with their GT (flat uint8, as the loader sends them) and
    their rows in the train set, distinct and spread over the pool."""
    data = train_batch(rng, n, max_gt, S, n_classes)
    data["indices"] = rng.choice(N_IMAGES, n, replace=False)
    return data


def epoch_batches(data, batch, order, with_image):
    for start in range(0, len(order), batch):
        sel = order[start:start + batch]
        b = {k: data[k][sel] for k in ("labels", "boxes", "gt_mask", "indices")}
        if with_image:
            b["image"] = data["image"][sel]
        yield b


def cached_run(data, orders, batch, max_gt, n_classes, store_dtype=None):
    """Trainer.train_step with cache_backbone over the epochs in `orders`
    (epoch 1 with images, later epochs without): B/16 bf16, random weights
    (seed 0), the pool sized for N_IMAGES rows. Checks the terms, the frozen
    and trainable parameters; returns the trainer and the run's record."""
    mcfg = get_config("b16")
    config = Config(DataConfig(max_gt=max_gt),
                    TrainingConfig(learning_rate=3e-6, weight_decay=0.1, batch_size=batch,
                                   checkpoint_dir=None, cache_backbone=True,
                                   cache_store_dtype=store_dtype),
                    ModelConfig(name="b16", dtype="bfloat16", trainable_last_k=1))
    model = owlvit.init(mcfg, torch.Generator().manual_seed(0),
                        num_queries=3 * n_classes, device="cuda")
    trainer = Trainer(config, model, n_classes, steps_per_epoch=len(orders[0]) // batch,
                      class_weights=np.linspace(0.5, 1.5, n_classes, dtype=np.float32),
                      device="cuda", n_images=N_IMAGES)
    check(trainer.act_store == "device",
          f"auto store for {N_IMAGES} B/16 rows: {trainer.act_store}")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, terms, phases = [], [], []
    for epoch, order in enumerate(orders):
        for b in epoch_batches(data, batch, order, with_image=epoch == 0):
            timer = PhaseTimer()
            t0 = time.perf_counter()
            terms.append(trainer.train_step(b, mark=timer).tolist())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            phases.append(timer.durations())
    launches = read_counts()
    record = {"terms": terms, "step_wall_ms": walls, "phases_ms": phases,
              "launches": launches,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(np.isfinite(terms).all(), f"non-finite loss terms {terms}")
    trainable = {id(p) for p in trainer.params}
    for n, p in model.named_parameters():
        same = torch.equal(p, before[n])
        check(not same if id(p) in trainable else same,
              f"cached: {'trainable' if id(p) in trainable else 'frozen'} {n}: "
              f"{'unchanged' if same else 'changed'}")
    return trainer, record


def fresh_prefix(trainer, data, sel):
    """embed_prefix of the images at `sel`, recomputed from the pixels."""
    S = trainer.model_cfg.vision.image_size
    img = torch.from_numpy(data["image"][sel]).cuda().reshape(len(sel), S, S, 3)
    return owlvit.embed_prefix(trainer.model, trainer.model_cfg, normalize_image(img))


def l2_rel(got, want, keep):
    """||got - want|| / ||want|| over the tensors at `keep`, in fp32."""
    diff = sum(((got[i].float() - want[i].float()) ** 2).sum() for i in keep)
    return (diff / sum((want[i].float() ** 2).sum() for i in keep)).sqrt().item()


def hybrid_step(trainer, batch):
    """One tail step on stored rows, packed, then the same step from the
    same state under OWLVIT_PACKED_FLASH=0 (hybrid: the transposed
    backward); the trainer is left after the hybrid step. Holds the terms,
    the gradients and the update to the packed step's."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    params = trainer.params
    start = [p.detach().clone() for p in params]
    opt_state, step = copy.deepcopy(trainer.opt.state_dict()), trainer.step
    terms_p = trainer.train_step(dict(batch))
    grad_p = [p.grad.clone() for p in params]
    upd_p = [p.detach() - s for p, s in zip(params, start)]
    with torch.no_grad():
        for p, s in zip(params, start):
            p.copy_(s)
    trainer.opt.load_state_dict(opt_state)
    trainer.step = step
    with switches(OWLVIT_PACKED_FLASH="0"):
        reset_counts()
        terms_h = trainer.train_step(dict(batch))
        torch.cuda.synchronize()
        launches = read_counts()
    grad_h = [p.grad for p in params]
    upd_h = [p.detach() - s for p, s in zip(params, start)]
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": 1, "transposed_bwd": 1},
          f"hybrid step: {launches} launches")
    every = range(len(params))
    key_bias = [i for i in every if names[id(params[i])].endswith("attn.k.bias")]
    check(len(key_bias) == 1, f"the trained tail has {len(key_bias)} key biases")
    keep = [i for i in every if i not in key_bias]
    record = {"terms_packed": terms_p.tolist(), "terms_hybrid": terms_h.tolist(),
              "terms_equal": bool(np.array_equal(terms_h, terms_p)),
              "grad_l2_rel": l2_rel(grad_h, grad_p, every),
              "update_l2_rel": l2_rel(upd_h, upd_p, keep),
              "update_max_abs_diff": max((upd_h[i] - upd_p[i]).abs().max().item() for i in keep),
              "update_max_abs": max(upd_p[i].abs().max().item() for i in keep),
              "key_bias_grad_max_abs": grad_p[key_bias[0]].abs().max().item(),
              "grad_max_abs": max(g.abs().max().item() for g in grad_p),
              "launches": launches}
    check(record["terms_equal"] and record["grad_l2_rel"] <= TOL_HYBRID_GRAD
          and record["update_l2_rel"] <= TOL_HYBRID_UPDATE,
          f"hybrid step vs packed step: {record}")
    return record


def phase_train_cached(n_rows=64, batch=32, max_gt=64, n_classes=80):
    """The cached train step, B/16 bf16 batch 32, 64 images of a 2500-row
    pool: epoch 1 (2 steps) fills the pool, epoch 2 (2 steps) gathers.
    Three runs: default (bf16 pool), then one tail step under
    OWLVIT_PACKED_FLASH=0 against the packed step on the same rows, then
    OWLVIT_FUSED_LN=1 with the int8 pool. Returns the launches summed over
    the runs."""
    L = get_config("b16").vision.num_layers
    S = get_config("b16").vision.image_size
    rng = np.random.default_rng(5)
    data = cached_data(rng, n_rows, max_gt, S, n_classes)
    orders = [np.arange(n_rows), rng.permutation(n_rows)]
    fills, steps = n_rows // batch, 2 * n_rows // batch
    total = dict.fromkeys(KERNELS, 0)

    with switches(OWLVIT_FUSED_LN=None, OWLVIT_PACKED_FLASH=None):
        trainer, rec = cached_run(data, orders, batch, max_gt, n_classes)
    check(rec["launches"] == {**dict.fromkeys(KERNELS, 0),
                              "pk_fwd": (L - 1) * fills + steps, "pk_bwd": steps},
          f"cached default: {rec['launches']} launches")
    sel = orders[0][:batch]
    with torch.no_grad():
        fresh = fresh_prefix(trainer, data, sel)
        stored = trainer.pool_gather(torch.from_numpy(data["indices"][sel]).cuda())
    check(torch.equal(stored, fresh), "the pool's rows differ from a fresh embed_prefix")
    pool_gb = trainer.pool.numel() * trainer.pool.element_size() / 1e9
    emit("train_cached", run="default", model="b16", dtype="bfloat16", store="bfloat16",
         pool_rows=N_IMAGES, pool_gb=pool_gb, batch=batch, images=n_rows,
         epoch2_img_per_s=batch * (steps - fills) / (sum(rec["step_wall_ms"][fills:]) / 1e3),
         gathered_bit_equal=True, **rec)
    total = {n: total[n] + rec["launches"][n] for n in KERNELS}
    unfused_terms = rec["terms"]

    hyb = hybrid_step(trainer, next(epoch_batches(data, batch, orders[1], with_image=False)))
    emit("train_cached_hybrid_step", **hyb)
    total = {n: total[n] + hyb["launches"][n] for n in KERNELS}
    del trainer, fresh, stored
    torch.cuda.empty_cache()

    with switches(OWLVIT_FUSED_LN="1", OWLVIT_PACKED_FLASH=None):
        trainer, rec = cached_run(data, orders, batch, max_gt, n_classes, store_dtype="int8")
        check(rec["launches"] == {**dict.fromkeys(KERNELS, 0),
                                  "pk_fwd": (L - 1) * fills + steps, "pk_bwd": steps,
                                  "add_ln_fwd": 2 * (L - 1) * fills + 2 * steps,
                                  "add_ln_bwd": 2 * steps},
              f"cached fused: {rec['launches']} launches")
        with torch.no_grad():
            fresh = fresh_prefix(trainer, data, sel).float()
            rows = torch.from_numpy(data["indices"][sel]).cuda()
            deq = dequantize_rows(trainer.pool["q"].index_select(0, rows),
                                  trainer.pool["s"].index_select(0, rows), torch.float32)
        # half a step, plus the fp32 rounding of x / s and q * s
        step_bound = fresh.abs().amax(-1, keepdim=True) / 254 * (1 + 1e-4)
        int8_err = ((deq - fresh).abs() / step_bound).max().item()
        check(int8_err <= 1.0, f"int8 pool rows beyond rowmax/254: {int8_err}")
    rel = (np.abs(np.subtract(rec["terms"][:fills], unfused_terms[:fills]))
           / np.abs(unfused_terms[:fills]))
    check(rel.max() <= TOL_FUSED_TERMS, f"fused vs unfused epoch-1 terms: {rel.tolist()}")
    pool_gb = sum(t.numel() * t.element_size() for t in trainer.pool.values()) / 1e9
    emit("train_cached", run="fused_ln_int8", model="b16", dtype="bfloat16", store="int8",
         pool_rows=N_IMAGES, pool_gb=pool_gb, batch=batch, images=n_rows,
         epoch2_img_per_s=batch * (steps - fills) / (sum(rec["step_wall_ms"][fills:]) / 1e3),
         epoch1_terms_max_rel_vs_unfused=rel.max().item(),
         int8_err_over_rowmax_254=int8_err, **rec)
    total = {n: total[n] + rec["launches"][n] for n in KERNELS}
    del trainer, fresh, deq
    torch.cuda.empty_cache()
    return total


def main():
    for name in SWITCHES:  # the default paths run with the switches off
        os.environ.pop(name, None)
    phase_device()
    phase_build()
    phase_kernel()
    phase_kernel_bwd()
    ln = phase_kernel_ln()
    transposed, transposed_launches = phase_kernel_transposed()
    cfg, serve_launches = phase_slice()
    b16 = cfg.vision
    served = [fwd_row(b16, bucket, C) for bucket in (8, 1)]
    served.append(fwd_row(b16, 32, None))  # the train step's shape and softmax
    for row in served:
        emit("main_path_kernel", **row)
    bwd = trained_shape_bwd(cfg)
    train_launches = phase_train()
    cached_launches = phase_train_cached()
    launches = {k: sum(run[k] for run in (serve_launches, train_launches, cached_launches))
                for k in KERNELS}
    for k in ("transposed_fwd", "transposed_bwd"):  # the drives of the transposed Function
        launches[k] += transposed_launches[k]
    check(all(launches[k] > 0 for k in KERNELS), f"a kernel was never launched: {launches}")
    fwd = served[0]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = {
        "pk_fwd": {"max_abs_err": max(r["o_max_abs"] for r in served), **{
            k: fwd[k] for k in keys}},
        "pk_bwd": {"max_abs_err": max(bwd[f"{n}_max_abs"] for n in ("dq", "dk", "dv")), **{
            k: bwd[k] for k in keys}},
        "add_ln_fwd": {k: ln["fwd"][k] for k in ("max_abs_err", *keys)},
        "add_ln_bwd": {k: ln["bwd"][k] for k in ("max_abs_err", *keys)},
        "transposed_fwd": {k: transposed["fwd"][k] for k in ("max_abs_err", *keys)},
        "transposed_bwd": {k: transposed["bwd"][k] for k in ("max_abs_err", *keys)},
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **rows[name]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
