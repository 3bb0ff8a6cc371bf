#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each printing its numbers on a line of its own:
  1. device: refuse to run without CUDA; TF32 off; the card's name and power
     limit from nvidia-smi.
  2. build: the attention kernel from owlvit_tpu_torch/csrc with nvcc.
  3. kernel: pk_fwd against its plain PyTorch version on the card at the
     B/32, B/16 and L/14 attention shapes (batch 4, valid_len < padded S),
     bf16 and fp32, fixed-shift (C=20) and per-row-max softmax.
  4. slice: B/16 bf16 with random weights behind DetectorServer(buckets=(1,
     8)); 9 model-sized images; results checked; the kernel's launch count,
     a batch bit-equal to a direct forward + NMS, and the kernel path against
     the plain-attention path.
  5. main_path_kernel: the kernel against its plain version at the shapes
     the served forward gives it ([8, 2305, 768] and [1, 2305, 768], no
     padding), same tolerances as phase 3; the kernels JSON reports bucket 8.
The second-to-last line is the kernels JSON, the last line the device JSON.
Any failure raises, so the exit code is non-zero.
"""

import json
import os
import subprocess
import time

# bitwise-reproducible cuBLAS across the server's thread and the main thread,
# for the bit-equality check of phase 4; a production server does not set it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from owlvit_tpu_torch.models import get_config, owlvit  # noqa: E402
from owlvit_tpu_torch.ops import flash_attention as fa  # noqa: E402
from owlvit_tpu_torch.ops import nms as nms_ops  # noqa: E402
from owlvit_tpu_torch.ops.preprocess import normalize_image  # noqa: E402
from owlvit_tpu_torch.serve import DetectorServer, _flatten_bucket  # noqa: E402

KERNEL_SOURCE = "owlvit_tpu_torch/csrc/flash_attention_fwd.cu"
KERNEL_REPLACES = "owlvit_tpu/ops/flash_attention.py:368"
BATCH = 4
C = fa.STATIC_MAX_DEFAULT
# Tolerances. bf16: both sides round p to bf16 and differ in summation
# order, so o is held to 2e-2 of its largest magnitude; lse is fp32 on both.
# fp32: summation order and exp rounding only.
TOL_BF16_O_REL, TOL_BF16_LSE = 2e-2, 1e-3
TOL_F32 = 1e-4
TOL_SLICE = 3e-2  # kernel vs plain attention, pre-NMS sims and boxes, 12 bf16 layers


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
               if "registers" in ln or "spill" in ln] if log.exists() else [])
    emit("build", seconds=build_s, library=lib_path.name, ptxas=report)


def phase_kernel():
    """Kernel vs plain at the three attention shapes; returns nothing, raises
    on a disagreement."""
    for name in ("b32", "b16", "l14"):
        vc = get_config(name).vision
        valid = vc.num_patches + 1
        S = -(-valid // 128) * 128  # padded, so valid_len < S
        H, D = vc.num_heads, vc.hidden_size
        scale = vc.head_dim**-0.5
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


def main_path_kernel_numbers(cfg, buckets):
    """The kernel at the shapes the served forward gives it (each bucket of
    B/16 bf16, fixed shift, no padding, so the last query tile is ragged),
    checked against the plain version, with times."""
    vc = cfg.vision
    S, D, H = vc.num_patches + 1, vc.hidden_size, vc.num_heads
    args = dict(scale=vc.head_dim**-0.5, num_heads=H, static_max=C)
    rows = []
    for bucket in buckets:
        g = torch.Generator(device="cuda").manual_seed(7 + bucket)
        q, k, v = (torch.randn(bucket, S, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        o_k, l_k = fa.pk_fwd(q, k, v, **args)
        o_p, l_p = fa.pk_fwd_plain(q, k, v, **args)
        err = {"o_max_abs": max_abs(o_k, o_p), "o_max_rel": max_rel(o_k, o_p),
               "lse_max_abs": max_abs(l_k, l_p)}
        check(torch.isfinite(o_k).all().item() and torch.isfinite(l_k).all().item(),
              f"served shape {bucket}: non-finite kernel output")
        check(err["o_max_rel"] <= TOL_BF16_O_REL and err["lse_max_abs"] <= TOL_BF16_LSE,
              f"served shape [{bucket}, {S}, {D}]: {err}")
        rows.append({"shape": [bucket, S, D], **err,
                     "ms": cuda_ms(lambda: fa.pk_fwd(q, k, v, **args), 20),
                     "plain_ms": cuda_ms(lambda: fa.pk_fwd_plain(q, k, v, **args), 5)})
        del q, k, v, o_k, o_p, l_k, l_p
    return rows


def phase_slice():
    cfg = get_config("b16", dtype="bfloat16")
    params = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=240).to("cuda")
    S = cfg.vision.image_size
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (9, S, S, 3), dtype=np.uint8)

    fa.pk_fwd.launches = 0
    t_start = time.perf_counter()
    srv = DetectorServer(params, cfg, buckets=(1, 8), device="cuda",
                         autostart=False)  # warms up both buckets
    warmup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    futs = [srv.submit(im) for im in images]
    srv.start()  # all 9 are queued: one batch of 8, one of 1
    results = [f.result() for f in futs]
    serve_s = time.perf_counter() - t0
    launches = fa.pk_fwd.launches
    stats = srv.stats()
    srv.close()

    forward_batches = stats["batches"] + len(srv.buckets)  # + warmup
    check(stats["bucket_counts"] == {1: 1, 8: 1}, f"buckets {stats['bucket_counts']}")
    check(launches == cfg.vision.num_layers * forward_batches,
          f"{launches} launches for {forward_batches} forward batches")
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
    return cfg, launches


def main():
    phase_device()
    phase_build()
    phase_kernel()
    cfg, launches = phase_slice()
    served = main_path_kernel_numbers(cfg, buckets=(8, 1))
    for row in served:
        emit("main_path_kernel", **row)
    print(json.dumps({"kernels": [{
        "name": "pk_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(r["o_max_abs"] for r in served),
        "ms": served[0]["ms"], "plain_ms": served[0]["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
