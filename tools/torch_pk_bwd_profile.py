#!/usr/bin/env python3
"""Where the time of the attention backward goes: bf16, one NVIDIA GPU, at
the train step's packed shape [32, 2305, 768] (12 heads) and the transposed
[384, 2305, 64] (one head), in the two modes: "fused" (`pk_bwd`, one
kernel) and "both" (the split pair `pk_dq` then `pk_dkv`).

Usage: python3 tools/torch_pk_bwd_profile.py [--out DIR] [--mode fused|both]
                                             [--baseline CSRC ...]

Prints one JSON line per phase:
  device   the card's name and power limit (nvidia-smi).
  build    nvcc's registers and spills for the bf16 backward kernels (the
           key-tile kernel as the fused kernel and as the pair's dkv
           kernel, the delta kernel, the pair's dq kernel), of this tree's
           build and then of each --baseline's.
  shape    per shape: the fused backward and the pair in turns (fused,
           pair, pair, fused; CUDA events over 10 calls each), each half of
           the pair alone, the share of the fused kernel's time that its dq
           product and reductions take, read as 1 - dkv / fused (the dkv
           kernel is the fused kernel with them compiled out; the delta
           kernel, the zero fill and the cast count on the fused side), the
           library's attention backward alone (`chip_smoke.sdpa_bwd_ms`: the
           flash backward fed with its own forward's outputs; a yardstick
           the port never calls), torch.profiler's device time per call
           of each kernel that --mode's backward launches, and the SM clock
           and power draw while `pk_dq` runs back to back (nvidia-smi).
  baseline with --baseline CSRC (a directory of kernel sources, e.g. an
           earlier commit's owlvit_tpu_torch/csrc unpacked by git archive;
           repeatable): per shape and per build, --mode's backward with
           that build and with this tree's in turns (baseline, tree, tree,
           baseline; 10 calls each), `pk_dq` alone in three such rounds
           (100 calls each; medians and spreads) and the profiler's device
           time per call of each kernel it launches with either build, and
           the largest |dq_tree - dq_baseline| over the shape. Mode "both"
           needs sources with the pair's entry points.
With --out, the lines also go to DIR/pk_bwd_profile.jsonl.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from owlvit_tpu_torch.ops import _cuda  # noqa: E402
from owlvit_tpu_torch.ops import flash_attention as fa  # noqa: E402

MODES = {"fused": fa.pk_bwd, "both": fa.pk_bwd_split}
SHAPES = (("packed", 32, 12), ("transposed", 384, 1))  # (name, sequences, heads)
S, HD = 2305, 64


def in_turns(measure, names, rounds=1):
    """measure(name) for each name, then again in the reverse order (a, b,
    b, a), `rounds` times over: a drift of the card over the run weighs on
    every name alike. Returns {name: [its 2 * rounds readings]}."""
    out = {name: [] for name in names}
    for name in [*names, *reversed(names)] * rounds:
        out[name].append(measure(name))
    return out


def summary(readings):
    """The median of `readings` and their spread, (max - min) / median."""
    med = statistics.median(readings)
    return {"median": med, "spread": (max(readings) - min(readings)) / med}


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


def sm_clocks(fn, seconds=1.0):
    """fn() called back to back for about `seconds` while nvidia-smi samples
    the card every 100 ms: the median SM clock (MHz) and power draw (W)."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines()
            if line.count(",") == 1]
    if not rows:
        return "not measured: nvidia-smi gave no samples"
    return {"sm_mhz": statistics.median(r[0] for r in rows),
            "power_w": statistics.median(r[1] for r in rows), "samples": len(rows)}


def bwd_ptxas(lib_path):
    """nvcc's lines (stack and spills, registers, any wgmma serialisation
    note) for the bf16 backward's entry functions."""
    return {name: lines for name, lines in _cuda.ptxas_report(lib_path).items()
            if ("pk_bwd" in name or "pk_dq" in name) and "bf16" in name}


class WithoutWorkspace:
    """A build of sources from before the dq kernel's k*scale workspace (it
    lacks owlvit_pk_dq_smem_bytes), called as this tree's wrappers call it:
    its owlvit_pk_dq takes no ks, the ninth argument."""

    def __init__(self, lib):
        self._lib = lib
        sig = _cuda._SIGNATURES["owlvit_pk_dq"]
        lib.owlvit_pk_dq.argtypes = sig[:8] + sig[9:]

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def owlvit_pk_dq(self, *args):
        return self._lib.owlvit_pk_dq(*args[:8], *args[9:])


def build_from(csrc):
    """(path, library) of the kernels built from the sources in `csrc`
    instead of the tree's, called as this tree's wrappers call them."""
    saved = _cuda.CSRC
    _cuda.CSRC = Path(csrc).resolve()
    try:
        path = _cuda.build()
        lib = _cuda.bind(path)
        return path, lib if hasattr(lib, "owlvit_pk_dq_smem_bytes") else WithoutWorkspace(lib)
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
    ap.add_argument("--baseline", action="append", default=[],
                    help="directory of kernel sources to time this tree's against "
                         "(repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on the GPU")
    from chip_smoke import sdpa_bwd_ms  # the smoke's yardstick, imported on the card only
    lines = []

    def emit(phase, **fields):
        line = json.dumps({"phase": phase, **fields})
        lines.append(line)
        print(line, flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("build", mode=args.mode, kernels=bwd_ptxas(_cuda.build()))
    baselines = {}
    for csrc in args.baseline:
        path, baselines[csrc] = build_from(csrc)
        emit("build", mode=args.mode, csrc=csrc, kernels=bwd_ptxas(path))

    for name, B, H in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B)
        q, k, v, do = (torch.randn(B, S, H * HD, generator=g, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        kw = dict(scale=HD**-0.5, num_heads=H)
        o, lse = fa.pk_fwd(q, k, v, **kw)
        dq, delta = fa.pk_dq(q, k, v, o, lse, do, **kw)

        def run(mode):
            return lambda: MODES[mode](q, k, v, o, lse, do, **kw)

        def dq_alone():
            return fa.pk_dq(q, k, v, o, lse, do, **kw)

        turns = [cuda_ms(run("fused")), cuda_ms(run("both")), cuda_ms(run("both")),
                 cuda_ms(run("fused"))]
        fused_ms, pair_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        dq_ms = cuda_ms(dq_alone)
        dkv_ms = cuda_ms(lambda: fa.pk_dkv(q, k, v, lse, do, delta, **kw))
        lib_ms, lib_op = sdpa_bwd_ms(q, k, v, H, HD**-0.5, do)
        emit("shape", shape=[B, S, H * HD], heads=H, fused_ms=fused_ms, pair_ms=pair_ms,
             turns_ms=turns, dq_ms=dq_ms, dkv_ms=dkv_ms,
             fused_dq_share=1 - dkv_ms / fused_ms, library_bwd_ms=lib_ms, library_bwd_op=lib_op,
             mode=args.mode, kernel_us_per_call=kernel_times(run(args.mode)),
             dq_clocks=sm_clocks(dq_alone))
        for csrc, lib in baselines.items():
            def timed(fn, iters):  # build name -> ms per call of fn with that build
                return lambda build: cuda_ms(
                    (lambda: with_library(lib, fn)) if build == "baseline" else fn, iters)

            bwd = in_turns(timed(run(args.mode), 10), ("baseline", "tree"))
            dq_turns = in_turns(timed(dq_alone, 100), ("baseline", "tree"), rounds=3)
            dq_base = with_library(lib, dq_alone)[0]
            emit("baseline", shape=[B, S, H * HD], heads=H, csrc=csrc, mode=args.mode,
                 baseline_ms=summary(bwd["baseline"])["median"],
                 tree_ms=summary(bwd["tree"])["median"], turns_ms=bwd,
                 dq_baseline_ms=summary(dq_turns["baseline"]),
                 dq_tree_ms=summary(dq_turns["tree"]), dq_turns_ms=dq_turns,
                 dq_kernel_us_per_call={
                     "baseline": with_library(lib, lambda: kernel_times(dq_alone, 10)),
                     "tree": kernel_times(dq_alone, 10)},
                 dq_max_abs_diff=(dq_alone()[0].float() - dq_base.float()).abs().max().item())
            del dq_base
        del q, k, v, do, o, lse, dq, delta
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "pk_bwd_profile.jsonl"), "w") as f:
            f.write(f"{smi}\n" + "\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
