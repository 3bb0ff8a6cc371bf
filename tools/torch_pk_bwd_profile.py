#!/usr/bin/env python3
"""Where the time of the attention backward goes: bf16, one NVIDIA GPU, at
the train step's packed shape [32, 2305, 768] (12 heads) and the transposed
[384, 2305, 64] (one head), in the two modes: "fused" (`pk_bwd`, one
kernel) and "both" (the split pair `pk_dq` then `pk_dkv`).

Usage: python3 tools/torch_pk_bwd_profile.py [--out DIR] [--mode fused|both]
                                             [--baseline CSRC]

Prints one JSON line per phase:
  device   the card's name and power limit (nvidia-smi).
  build    nvcc's registers and spills for the bf16 backward kernels (the
           key-tile kernel as the fused kernel and as the pair's dkv
           kernel, the delta kernel, the pair's dq kernel).
  shape    per shape: the fused backward and the pair in turns (fused,
           pair, pair, fused; CUDA events over 10 calls each), each half of
           the pair alone, the share of the fused kernel's time that its dq
           product and reductions take, read as 1 - dkv / fused (the dkv
           kernel is the fused kernel with them compiled out; the delta
           kernel, the zero fill and the cast count on the fused side), and
           torch.profiler's device time per call of each kernel that
           --mode's backward launches.
  baseline with --baseline CSRC (a directory of kernel sources, e.g. an
           earlier commit's owlvit_tpu_torch/csrc unpacked by git archive):
           per shape, --mode's backward with that build and with this
           tree's, in turns (baseline, tree, tree, baseline; 10 calls each).
           Mode "both" needs sources with the pair's entry points.
With --out, the lines also go to DIR/pk_bwd_profile.jsonl.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from owlvit_tpu_torch.ops import _cuda  # noqa: E402
from owlvit_tpu_torch.ops import flash_attention as fa  # noqa: E402

MODES = {"fused": fa.pk_bwd, "both": fa.pk_bwd_split}
SHAPES = (("packed", 32, 12), ("transposed", 384, 1))  # (name, sequences, heads)
S, HD = 2305, 64


def cuda_ms(fn, iters=10):
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


def bwd_ptxas(lib_path):
    """nvcc's lines (stack and spills, registers, any wgmma serialisation
    note) for the bf16 backward's entry functions."""
    return {name: lines for name, lines in _cuda.ptxas_report(lib_path).items()
            if ("pk_bwd" in name or "pk_dq" in name) and "bf16" in name}


def build_from(csrc):
    """The kernel library built from the sources in `csrc` instead of the
    tree's."""
    saved = _cuda.CSRC
    _cuda.CSRC = Path(csrc).resolve()
    try:
        return _cuda.bind(_cuda.build())
    finally:
        _cuda.CSRC = saved


def with_library(lib, fn):
    """fn() with every launch going to `lib` instead of the default build."""
    saved = _cuda.library
    _cuda.library = lambda: lib
    try:
        return fn()
    finally:
        _cuda.library = saved


def kernel_times(fn, calls=3):
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--mode", choices=sorted(MODES), default="fused",
                    help="the backward profiled and timed against --baseline")
    ap.add_argument("--baseline", default=None,
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
    emit("build", mode=args.mode, kernels=bwd_ptxas(_cuda.build()))
    baseline = build_from(args.baseline) if args.baseline else None

    for name, B, H in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B)
        q, k, v, do = (torch.randn(B, S, H * HD, generator=g, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        kw = dict(scale=HD**-0.5, num_heads=H)
        o, lse = fa.pk_fwd(q, k, v, **kw)
        dq, delta = fa.pk_dq(q, k, v, o, lse, do, **kw)

        def run(mode):
            return lambda: MODES[mode](q, k, v, o, lse, do, **kw)

        turns = [cuda_ms(run("fused")), cuda_ms(run("both")), cuda_ms(run("both")),
                 cuda_ms(run("fused"))]
        fused_ms, pair_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        dq_ms = cuda_ms(lambda: fa.pk_dq(q, k, v, o, lse, do, **kw))
        dkv_ms = cuda_ms(lambda: fa.pk_dkv(q, k, v, lse, do, delta, **kw))
        emit("shape", shape=[B, S, H * HD], heads=H, fused_ms=fused_ms, pair_ms=pair_ms,
             turns_ms=turns, dq_ms=dq_ms, dkv_ms=dkv_ms,
             fused_dq_share=1 - dkv_ms / fused_ms, mode=args.mode,
             kernel_us_per_call=kernel_times(run(args.mode)))
        if baseline is not None:
            def base():
                return with_library(baseline, run(args.mode))

            tree = run(args.mode)
            turns = [cuda_ms(base), cuda_ms(tree), cuda_ms(tree), cuda_ms(base)]
            emit("baseline", shape=[B, S, H * HD], heads=H, csrc=args.baseline,
                 mode=args.mode, baseline_ms=(turns[0] + turns[3]) / 2,
                 tree_ms=(turns[1] + turns[2]) / 2, turns_ms=turns)
        del q, k, v, do, o, lse, dq, delta
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "pk_bwd_profile.jsonl"), "w") as f:
            f.write(f"{smi}\n" + "\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
