#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each printing its numbers on a line of its own:
  1. device: refuse to run without CUDA; TF32 off; the card's name and power
     limit from nvidia-smi.
  2. build: the attention kernels from owlvit_tpu_torch/csrc, one nvcc per
     source, started together.
  3. kernel: pk_fwd against its plain PyTorch version on the card at the
     B/32, B/16 and L/14 attention shapes (batch 4, valid_len < padded S),
     bf16 and fp32, fixed-shift (C=20) and per-row-max softmax.
  4. kernel_bwd: pk_bwd against its plain version at the same shapes and at
     [8, 2305, 768] unpadded, bf16 and fp32 (the fp32 instantiation is the
     one the JAX package's split backward serves); at the trained shape
     [32, 2305, 768] bf16 the kernel's time beside the plain version's (on
     batch slices of 4) and beside scaled_dot_product_attention's forward +
     backward.
  5. slice: B/16 bf16 with random weights behind DetectorServer(buckets=(1,
     8)); 9 model-sized images; results checked; the forward kernel's launch
     count, a batch bit-equal to a direct forward + NMS, and the kernel path
     against the plain-attention path.
  6. main_path_kernel: pk_fwd against its plain version at the shapes the
     served forward gives it ([8, 2305, 768] and [1, 2305, 768], C = 20, no
     padding) and at the train step's [32, 2305, 768] (per-row max), with
     scaled_dot_product_attention's forward time beside it.
  7. train: 4 steps of Trainer.train_step, B/16 bf16, random weights (seed
     0), a 240-query bank, batch 32, max_gt 64, ~7 random boxes per image,
     lr 3e-6, weight decay 0.1: finite terms, launch counts (12 pk_fwd and 1
     pk_bwd per step), frozen parameters bit-unchanged, every trainable one
     moved; host wall of steps 2-4, CUDA-event times of each phase of the
     step, peak memory. Then the trained layer on the prefix output of 8
     images: kernel path against the plain path, forward and backward.
The kernels JSON (second-to-last line) gives each kernel's launches summed
over the two paths driven (serving, training; each counted from 0 just before
it), its error, time, plain time, bound and library time at its main-path
shape; the last line is the device JSON. Any failure raises, so the exit code
is non-zero.
"""

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
from owlvit_tpu_torch.ops import flash_attention as fa  # noqa: E402
from owlvit_tpu_torch.ops import nms as nms_ops  # noqa: E402
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
}
BATCH = 4
C = fa.STATIC_MAX_DEFAULT
# Tolerances. Forward, bf16: both sides round p to bf16 and differ in
# summation order, so o is held to 2e-2 of its largest magnitude; lse is fp32
# on both. fp32: summation order and exp rounding only.
TOL_BF16_O_REL, TOL_BF16_LSE = 2e-2, 1e-3
TOL_F32 = 1e-4
# Backward, bf16: both sides round ds and p to bf16 at the same points, but a
# value at a rounding boundary can fall either way (exp and sums differ in
# their last fp32 bits, and the kernel adds dq up with fp32 atomics in an
# order that changes from run to run), so dq, dk and dv are held to 2e-2 of
# their largest magnitude, as the forward's o. fp32 (no atomics): 1e-4 of
# the largest magnitude, summation order over up to 3712 keys.
TOL_BWD_BF16_REL, TOL_BWD_F32_REL = 2e-2, 1e-4
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
# H100 SXM datasheet peaks (dense): the bound of a launch is the larger of
# its bytes over the memory rate and its flops over the tensor-core rate.
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12


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


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time for the work on an H100 SXM."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
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
    lib_path = fa.build()
    fa._library()
    build_s = time.perf_counter() - t0
    log = lib_path.with_suffix(".log")
    report = ([ln.strip() for ln in log.read_text().splitlines()
               if ln.startswith("==") or "registers" in ln or "spill" in ln]
              if log.exists() else [])
    emit("build", seconds=build_s, library=lib_path.name, ptxas=report)


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
    del got
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

    fa.pk_fwd.launches = fa.pk_bwd.launches = 0
    t_start = time.perf_counter()
    srv = DetectorServer(params, cfg, buckets=(1, 8), device="cuda",
                         autostart=False)  # warms up both buckets
    warmup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    futs = [srv.submit(im) for im in images]
    srv.start()  # all 9 are queued: one batch of 8, one of 1
    results = [f.result() for f in futs]
    serve_s = time.perf_counter() - t0
    launches = {"pk_fwd": fa.pk_fwd.launches, "pk_bwd": fa.pk_bwd.launches}
    stats = srv.stats()
    srv.close()

    forward_batches = stats["batches"] + len(srv.buckets)  # + warmup
    check(stats["bucket_counts"] == {1: 1, 8: 1}, f"buckets {stats['bucket_counts']}")
    check(launches["pk_fwd"] == cfg.vision.num_layers * forward_batches,
          f"{launches} launches for {forward_batches} forward batches")
    check(launches["pk_bwd"] == 0, "serving launched the backward kernel")
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
    fa.pk_fwd.launches = fa.pk_bwd.launches = 0
    walls, terms, phases = [], [], []
    for i, b in enumerate(batches):
        timer[0] = PhaseTimer() if i else None
        t0 = time.perf_counter()
        terms.append(trainer.train_step(b, mark=timer[0]).tolist())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if timer[0]:
            phases.append(timer[0].durations())
    launches = {"pk_fwd": fa.pk_fwd.launches, "pk_bwd": fa.pk_bwd.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hook.remove()

    check(np.isfinite(terms).all(), f"non-finite loss terms {terms}")
    check(launches == {"pk_fwd": L * steps, "pk_bwd": steps},
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


def main():
    phase_device()
    phase_build()
    phase_kernel()
    phase_kernel_bwd()
    cfg, serve_launches = phase_slice()
    b16 = cfg.vision
    served = [fwd_row(b16, bucket, C) for bucket in (8, 1)]
    served.append(fwd_row(b16, 32, None))  # the train step's shape and softmax
    for row in served:
        emit("main_path_kernel", **row)
    bwd = trained_shape_bwd(cfg)
    train_launches = phase_train()
    launches = {k: serve_launches[k] + train_launches[k] for k in KERNELS}
    fwd = served[0]
    rows = {
        "pk_fwd": {"max_abs_err": max(r["o_max_abs"] for r in served), **{
            k: fwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        "pk_bwd": {"max_abs_err": max(bwd[f"{n}_max_abs"] for n in ("dq", "dk", "dv")), **{
            k: bwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
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
