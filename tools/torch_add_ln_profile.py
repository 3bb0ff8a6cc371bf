#!/usr/bin/env python3
"""Where the time of the fused add+LayerNorm kernels goes: bf16, one NVIDIA
GPU, at [73760, 768] (B/16's trained layer at batch 32: 32 x 2305 rows),
[18440, 768] (batch 8) and [14404, 1024] (L/14 at batch 4: 4 x 3601 rows).

Usage: python3 tools/torch_add_ln_profile.py [--out DIR] [--baseline CSRC ...]

Prints one JSON line per phase:
  device   the card's name and power limit (nvidia-smi).
  build    nvcc's registers, stack and spills for every add_ln entry
           function (each width the backward is built for), and per bf16
           width the backward's dynamic shared memory and resident blocks
           per SM.
  baseline_build  per --baseline CSRC, the same report for its build.
  shape    per shape: add_ln_bwd and add_ln_fwd by CUDA events (20 calls of
           the C entry point on buffers allocated once, so no host work of
           the wrapper is timed), each beside its bound (bytes over 3.35
           TB/s or fp32 flops over 67 TFLOP/s, the larger) and the
           yardstick, one PyTorch call of the same function (x + h then
           F.layer_norm; for the backward, that graph's backward alone on a
           retained graph): a yardstick only, the port never calls it; g,
           dscale and dbias against the plain version; and torch.profiler's
           device time per call of each kernel launched (the backward's main
           kernel and the reduction of its partials).
  baseline per shape and --baseline CSRC (a directory of kernel sources,
           e.g. an earlier commit's owlvit_tpu_torch/csrc unpacked by git
           archive, with the same C entry points for the kernels; may be
           given more than once): the backward and the forward with that
           build and with this tree's, in turns (baseline, tree, tree,
           baseline; 20 calls each).
With --out, the lines also go to DIR/add_ln_profile.jsonl.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from owlvit_tpu_torch.ops import _cuda, fused_ln  # noqa: E402

SHAPES = (("b16_b32", 32 * 2305, 768), ("b16_b8", 8 * 2305, 768), ("l14_b4", 4 * 3601, 1024))
WIDTHS = (256, 512, 768, 1024)  # every D the bf16 kernels take
EPS = 1e-5
BF16 = fused_ln.DTYPE_CODE[torch.bfloat16]
PEAK_BYTES, PEAK_F32_FLOPS = 3.35e12, 67e12


def cuda_ms(fn, iters=20):
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


def kernel_times(fn, calls=5):
    """Device microseconds per call of each kernel `fn` launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / calls
    return out or "not measured: the profiler saw no device events"


def bound_ms(flops, nbytes):
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3


def build_from(csrc):
    """The path of the kernel library built from the sources in `csrc`
    instead of the tree's."""
    saved = _cuda.CSRC
    _cuda.CSRC = Path(csrc).resolve()
    try:
        return _cuda.build()
    finally:
        _cuda.CSRC = saved


def resident_blocks(lib, D):
    """The backward's resident blocks at width D in bf16. A build without
    owlvit_add_ln_bwd_smem_bytes is of older sources, whose query takes
    (dtype, device) and has one kernel for every D."""
    dev = torch.cuda.current_device()
    if hasattr(lib, "owlvit_add_ln_bwd_smem_bytes"):
        return lib.owlvit_add_ln_bwd_resident_blocks(D, BF16, dev)
    fn = lib.owlvit_add_ln_bwd_resident_blocks
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn(BF16, dev)


def build_report(lib_path):
    """nvcc's lines for the add_ln kernels; per bf16 width the backward's
    dynamic shared memory (bytes; null for older sources, which had none)
    and resident blocks per SM."""
    lib = _cuda.bind(lib_path)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    widths = {}
    for D in WIDTHS:
        smem = (lib.owlvit_add_ln_bwd_smem_bytes(D, BF16)
                if hasattr(lib, "owlvit_add_ln_bwd_smem_bytes") else None)
        widths[D] = {"dynamic_smem_bytes": smem, "blocks_per_sm": resident_blocks(lib, D) / sms}
    return lib, {"ptxas": {name: lines for name, lines in _cuda.ptxas_report(lib_path).items()
                           if "add_ln" in name},
                 "bwd_bf16_by_width": widths}


def calls(lib, t, N, D):
    """(bwd, fwd): one launch each of the C entry points in `lib` on the
    tensors `t`, on the current stream."""
    stream = torch.cuda.current_stream().cuda_stream
    blocks = fused_ln.bwd_blocks(N, resident_blocks(lib, D))
    part = torch.empty((2, blocks, D), dtype=torch.float32, device="cuda")
    bwd_args = (t["r"].data_ptr(), t["dy"].data_ptr(), t["dr"].data_ptr(), t["scale"].data_ptr(),
                t["g"].data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                t["dscale"].data_ptr(), t["dbias"].data_ptr(), N, D, blocks, EPS, BF16, stream)
    fwd_args = (t["x"].data_ptr(), t["h"].data_ptr(), t["scale"].data_ptr(),
                t["bias"].data_ptr(), t["r"].data_ptr(), t["y"].data_ptr(), N, D, EPS, BF16,
                stream)

    def bwd():
        if lib.owlvit_add_ln_bwd(*bwd_args):
            raise RuntimeError("owlvit_add_ln_bwd: launch failed")

    def fwd():
        if lib.owlvit_add_ln_fwd(*fwd_args):
            raise RuntimeError("owlvit_add_ln_fwd: launch failed")

    bwd.part = part  # kept alive with the closure
    return bwd, fwd


def inputs(N, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = {"x": (torch.randn(N, D, generator=g, device="cuda") * 2 + 0.5).to(torch.bfloat16)}
    for name in ("h", "dy", "dr"):
        t[name] = torch.randn(N, D, generator=g, device="cuda").to(torch.bfloat16)
    t["scale"] = 1 + 0.2 * torch.randn(D, generator=g, device="cuda")
    t["bias"] = 0.1 * torch.randn(D, generator=g, device="cuda")
    for name in ("r", "y", "g"):
        t[name] = torch.empty(N, D, dtype=torch.bfloat16, device="cuda")
    t["dscale"], t["dbias"] = (torch.empty(D, device="cuda") for _ in range(2))
    return t


def yardstick_ms(t, D):
    """(forward, backward alone) of x + h then F.layer_norm, bf16."""
    w16, b16 = t["scale"].to(torch.bfloat16), t["bias"].to(torch.bfloat16)
    leaves = [a.detach().clone().requires_grad_(True) for a in (t["x"], t["h"], w16, b16)]
    rl = leaves[0] + leaves[1]
    graph = (rl, F.layer_norm(rl, (D,), leaves[2], leaves[3], EPS))
    fwd = cuda_ms(lambda: F.layer_norm(t["x"] + t["h"], (D,), w16, b16, EPS))
    bwd = cuda_ms(lambda: torch.autograd.grad(graph, leaves, (t["dr"], t["dy"]),
                                              retain_graph=True))
    return fwd, bwd


def errors(t):
    """g, dscale and dbias of the last backward launch against the plain
    version on the same r (max-rel; the sums relative to their column's
    sum of magnitudes), and whether r equals x + h."""
    g, ds, db = fused_ln.add_ln_bwd_plain(t["r"], t["dy"], t["dr"], t["scale"], EPS)
    mean, rstd = fused_ln._stats(t["r"].float(), EPS)
    xhat = (t["r"].float() - mean) * rstd
    return {"r_exact": bool(torch.equal(t["r"], t["x"] + t["h"])),
            "g_max_rel": ((t["g"].float() - g.float()).abs().max() / g.float().abs().max()).item(),
            "dscale_rel_to_sum": ((t["dscale"] - ds).abs()
                                  / (t["dy"].float() * xhat).abs().sum(0)).max().item(),
            "dbias_rel_to_sum": ((t["dbias"] - db).abs()
                                 / t["dy"].float().abs().sum(0)).max().item()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--baseline", action="append", default=[],
                    help="directory of kernel sources to time this tree's against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on the GPU")
    lines = []

    def emit(phase, **fields):
        line = json.dumps({"phase": phase, **fields})
        lines.append(line)
        print(line, flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi)
    lib, report = build_report(_cuda.build())
    emit("build", **report)
    baselines = []
    for csrc in args.baseline:
        base_lib, report = build_report(build_from(csrc))
        emit("baseline_build", csrc=csrc, **report)
        baselines.append((csrc, base_lib))

    for name, N, D in SHAPES:
        t = inputs(N, D, seed=N + D)
        bwd, fwd = calls(lib, t, N, D)
        fwd()
        bwd()
        torch.cuda.synchronize()
        err = errors(t)
        lib_fwd, lib_bwd = yardstick_ms(t, D)
        emit("shape", name=name, shape=[N, D], **err,
             bwd_ms=cuda_ms(bwd), bwd_library_ms=lib_bwd,
             bwd_bound_ms=bound_ms(14 * N * D, 4 * N * D * 2 + 3 * D * 4),
             fwd_ms=cuda_ms(fwd), fwd_library_ms=lib_fwd,
             fwd_bound_ms=bound_ms(8 * N * D, 4 * N * D * 2 + 2 * D * 4),
             bwd_kernel_us_per_call=kernel_times(bwd), fwd_kernel_us_per_call=kernel_times(fwd))
        for csrc, base_lib in baselines:
            base_bwd, base_fwd = calls(base_lib, t, N, D)
            row = {}
            for kind, tree_fn, base_fn in (("bwd", bwd, base_bwd), ("fwd", fwd, base_fwd)):
                turns = [cuda_ms(base_fn), cuda_ms(tree_fn), cuda_ms(tree_fn), cuda_ms(base_fn)]
                row[kind] = {"baseline_ms": (turns[0] + turns[3]) / 2,
                             "tree_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}
            emit("baseline", name=name, shape=[N, D], csrc=csrc, **row)
        del t, bwd, fwd
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "add_ln_profile.jsonl"), "w") as f:
            f.write(f"{smi}\n" + "\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
