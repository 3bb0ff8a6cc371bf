#!/usr/bin/env python3
"""Where the time of one served batch goes: the PyTorch port, B/16 bf16, one
NVIDIA GPU.

Usage: python3 tools/torch_serve_profile.py [--out DIR]

Random weights (seed 0), 240-query bank, model-sized random uint8 images.
Prints one JSON line per phase:
  serve_batch  host wall per `DetectorServer.serve_batch` (normalize, forward,
               NMS, pack; ends with the fetch to the host), 5 runs at each
               of buckets 1, 8 and 32.
  stages       CUDA events around embedding + ViT, the heads and NMS + pack,
               and the forward with the plain attention in place of the
               kernel, at bucket 8.
  profile      torch.profiler over 3 batches at bucket 8. Only
               device-side events (kernels, memcpy, memset) are summed, never
               the aten ops that launch them. busy = the union of their
               intervals; idle share = 1 - busy / the span from the first
               profiled event to the last, host events included.
  served       the same batch through the server's threads against a direct
               serve_batch, bit-equal or not (no cuBLAS determinism setting).
With --out, the profiler's table of device kernels goes to DIR/prof_b<N>.txt.
cuBLAS runs with its default workspace: this script sets no determinism knob.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from owlvit_tpu_torch.models import get_config, owlvit  # noqa: E402
from owlvit_tpu_torch.ops import flash_attention as fa  # noqa: E402
from owlvit_tpu_torch.ops import nms as nms_ops  # noqa: E402
from owlvit_tpu_torch.ops.preprocess import normalize_image  # noqa: E402
from owlvit_tpu_torch.serve import DetectorServer  # noqa: E402

BUCKETS = (1, 8, 32)  # the server's default ladder
RUNS = 5
PROFILE_BUCKET = 8


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def category(name: str) -> str:
    n = name.lower()
    if "pk_fwd" in n:
        return "attention kernel"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "gemm"
    if "layer_norm" in n:
        return "layernorm"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copy / cast"
    if "reduce_kernel" in n or "index" in n:
        return "reduce / index"
    return "elementwise / other"


def device_events(prof):
    """(name, start_us, end_us) of every device-side event of the trace."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def union_us(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the device-kernel table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))

    pb = PROFILE_BUCKET
    cfg = get_config("b16", dtype="bfloat16")
    params = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=240)
    S = cfg.vision.image_size
    srv = DetectorServer(params, cfg, buckets=BUCKETS, device="cuda",
                         autostart=False)
    rng = np.random.default_rng(0)
    flats = {b: torch.from_numpy(rng.integers(0, 256, (b, S * S * 3), dtype=np.uint8)
                                 ).cuda() for b in srv.buckets}

    # --- host wall per serve_batch, the fetch included
    for b in BUCKETS:
        srv.serve_batch(flats[b]).cpu()
        walls = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            srv.serve_batch(flats[b]).cpu()
            walls.append((time.perf_counter() - t0) * 1e3)
        emit("serve_batch", bucket=b, wall_ms=walls,
             img_per_s=b * len(walls) / (sum(walls) / 1e3))

    # --- CUDA events around the stages at the profiled bucket
    scfg = srv.cfg
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        px = normalize_image(flats[pb].reshape(pb, S, S, 3))
        for _ in range(2):  # second pass is the one kept
            ev[0].record()
            feats = owlvit.image_embedder(srv._params, scfg, px)
            ev[1].record()
            boxes = owlvit.box_predictor(srv._params, scfg, feats)
            sims = owlvit.class_predictor_querybank(srv._params, scfg, feats)
            ev[2].record()
            nms_ops.pack_detections(nms_ops.postprocess(boxes, sims, **srv._thresholds))
            ev[3].record()
            ev[3].synchronize()
        fwd = {}
        for impl in ("auto", "xla"):
            c = scfg.replace(attention_impl=impl)
            owlvit.forward_train(srv._params, c, px)
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            owlvit.forward_train(srv._params, c, px)
            z.record()
            z.synchronize()
            fwd["kernel" if impl == "auto" else "plain_attention"] = a.elapsed_time(z)
    emit("stages", bucket=pb, embed_vit_ms=ev[0].elapsed_time(ev[1]),
         heads_ms=ev[1].elapsed_time(ev[2]), nms_pack_ms=ev[2].elapsed_time(ev[3]),
         forward_ms=fwd)

    # --- profiler: device-side events only
    n_prof = 3
    srv.serve_batch(flats[pb]).cpu()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            srv.serve_batch(flats[pb]).cpu()
    dev = device_events(prof)
    all_ev = [(e.time_range.start, e.time_range.end) for e in prof.events()]
    span_us = max(e for _, e in all_ev) - min(s for s, _ in all_ev)
    busy_us = union_us([(s, e) for _, s, e in dev])
    by_cat, by_name = {}, {}
    for name, s, e in dev:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + (e - s)
        cnt, tot = by_name.get(name, (0, 0.0))
        by_name[name] = (cnt + 1, tot + (e - s))
    sum_us = sum(by_cat.values())
    attn = [e - s for name, s, e in dev if "pk_fwd" in name]
    vc = cfg.vision
    attn_flop = 4 * pb * vc.num_heads * (vc.num_patches + 1) ** 2 * vc.head_dim
    emit("profile", bucket=pb, batches=n_prof, device_events=len(dev),
         device_event_ms_per_batch=sum_us / 1e3 / n_prof,
         device_busy_ms_per_batch=busy_us / 1e3 / n_prof,
         span_ms_per_batch=span_us / 1e3 / n_prof,
         idle_share=1 - busy_us / span_us,
         by_category_ms_per_batch={k: v / 1e3 / n_prof for k, v in
                                   sorted(by_cat.items(), key=lambda kv: -kv[1])},
         attention_launches_per_batch=len(attn) / n_prof,
         attention_ms_per_launch=sum(attn) / 1e3 / max(1, len(attn)),
         attention_tflop_per_s=attn_flop / (sum(attn) / max(1, len(attn)) * 1e-6) / 1e12)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
        with open(os.path.join(args.out, f"prof_b{pb}.txt"), "w") as f:
            f.write(f"{smi}\ndevice-side events, {n_prof} batches of {pb}\n")
            f.write(f"{'total_us':>12} {'calls':>7} {'avg_us':>10}  name\n")
            for name, (cnt, tot) in rows:
                f.write(f"{tot:12.3f} {cnt:7d} {tot / cnt:10.3f}  {name}\n")

    # --- the server's threads against a direct call, default cuBLAS settings
    direct = srv.serve_batch(flats[pb]).cpu().numpy()
    images = list(flats[pb].cpu().numpy().reshape(pb, S, S, 3))
    futs = [srv.submit(im) for im in images]
    srv.start()
    results = [f.result() for f in futs]
    srv.close()
    equal = all(
        np.array_equal(srv._unpack_row(direct[i].reshape(srv._top_k, 7), (S, S))[key],
                       results[i][key])
        for i in range(pb) for key in ("boxes", "scores", "classes"))
    emit("served", bucket=pb, bit_equal_to_direct=equal,
         launches=fa.pk_fwd.launches)


if __name__ == "__main__":
    main()
