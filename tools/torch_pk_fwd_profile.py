#!/usr/bin/env python3
"""Where the time of the attention forward `pk_fwd` goes: bf16, one NVIDIA
GPU, at the train step's packed shape [32, 2305, 768] (12 heads, per-row
max), the served [8, 2305, 768] (fixed shift C = 20) and the transposed
[384, 2305, 64] (one head, per-row max); then the train shape with
valid_len 2304 (the one-key tile's cost, from the difference).

Usage: python3 tools/torch_pk_fwd_profile.py [--out DIR] [--fast] [--baseline CSRC ...]

--fast: the softmax's fast mode (OWLVIT_FAST_SOFTMAX=1 in the frozen
prefix) instead, at the train and served shapes (per-row max, exp in bf16),
beside the default mode at the train shape, each checked against its own
plain version.

Prints one JSON line per phase:
  device   the card's name and power limit (nvidia-smi).
  build    nvcc's registers, stack and spills for the bf16 forward's
           entry functions (both softmax modes) and the bf16 backward's,
           and any line of nvcc's report that names wgmma (ptxas says so
           where it serialises the asynchronous products).
  shape    per shape: o and lse against the plain version on the first 4
           sequences (max-rel of o, max-abs of lse); the wrapper's time by
           CUDA events (20 calls), scaled_dot_product_attention's forward at
           the same shape beside it (a yardstick: the port never calls it),
           the bound (flops over 989 TFLOP/s or bytes over 3.35 TB/s), and
           torch.profiler's device time per call of each kernel the wrapper
           launches.
  baseline_build  per --baseline CSRC, the same report for its build.
  baseline with --baseline CSRC (a directory of kernel sources, e.g. an
           earlier commit's owlvit_tpu_torch/csrc unpacked by git archive,
           with the same C entry points; may be given more than once): per
           shape, the wrapper's time with that build and with this tree's,
           in turns (baseline, tree, tree, baseline; 20 calls each), and
           that build's o and lse against the plain version.
With --out, the lines also go to DIR/pk_fwd_profile.jsonl.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from owlvit_tpu_torch.ops import _cuda  # noqa: E402
from owlvit_tpu_torch.ops import flash_attention as fa  # noqa: E402

S, HD = 2305, 64
# (name, sequences, heads, static_max, valid_len, fast_softmax): the train
# step's forward, a served batch of 8, the transposed layout at one head per
# sequence; then the train shape with the last key masked, which drops the
# key tile that holds one key (S = 2305 = 36*64 + 1): the difference is that
# tile's cost
SHAPES = (("train", 32, 12, None, S, False), ("serve", 8, 12, fa.STATIC_MAX_DEFAULT, S, False),
          ("transposed", 384, 1, None, S, False),
          ("train_valid_2304", 32, 12, None, S - 1, False))
# --fast: the fast mode at the frozen prefix's train shape and at a served
# batch under OWLVIT_STATIC_MAX=off, the default mode at the train shape
FAST_SHAPES = (("train", 32, 12, None, S, False), ("train_fast", 32, 12, None, S, True),
               ("serve_fast", 8, 12, None, S, True))
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12


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


def attention_ptxas(lib_path):
    """nvcc's lines (stack and spills, registers) for the bf16 attention
    kernels' entry functions, forward and backward."""
    return {name: lines for name, lines in _cuda.ptxas_report(lib_path).items()
            if ("pk_fwd" in name or "pk_bwd" in name) and "bf16" in name}


def build_from(csrc):
    """The path of the kernel library built from the sources in `csrc`
    instead of the tree's."""
    saved = _cuda.CSRC
    _cuda.CSRC = Path(csrc).resolve()
    try:
        return _cuda.build()
    finally:
        _cuda.CSRC = saved


def build_report(lib_path):
    """The build's registers and spills for the attention kernels, and
    nvcc's lines that name wgmma."""
    return {"ptxas": attention_ptxas(lib_path),
            "wgmma_warnings": [line for line in
                               lib_path.with_suffix(".log").read_text().splitlines()
                               if "wgmma" in line]}


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


def fwd_bound_ms(B, H):
    """The least time for the launch: two products of 2*S*S*hd per (batch,
    head) at the bf16 peak, or q, k, v read and o, lse written at the
    memory rate, whichever is larger."""
    t_ops = 4 * B * H * S * S * HD / PEAK_BF16_FLOPS * 1e3
    t_bytes = (4 * B * S * H * HD * 2 + B * H * S * 4) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes)


def sdpa_fwd_ms(q, k, v, H, scale):
    def heads(x):
        B = x.shape[0]
        return x.view(B, S, H, HD).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    with torch.no_grad():
        return cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--baseline", action="append", default=[],
                    help="directory of kernel sources to time this tree's against")
    ap.add_argument("--fast", action="store_true",
                    help="time the fast softmax mode (FAST_SHAPES) instead")
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
    emit("build", **build_report(_cuda.build()))
    baselines = []
    for csrc in args.baseline:
        lib_path = build_from(csrc)
        emit("baseline_build", csrc=csrc, **build_report(lib_path))
        baselines.append((csrc, _cuda.bind(lib_path)))

    for name, B, H, static, valid, fast in FAST_SHAPES if args.fast else SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B)
        q, k, v = (torch.randn(B, S, H * HD, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        kw = dict(scale=HD**-0.5, num_heads=H, static_max=static, valid_len=valid,
                  fast_softmax=fast)

        def tree():
            return fa.pk_fwd(q, k, v, **kw)

        o_p, lse_p = fa.pk_fwd_plain(q[:4], k[:4], v[:4], **kw)

        def errors(run):
            o, lse = run()
            return {"o_max_rel": ((o[:4].float() - o_p.float()).abs().max()
                                  / o_p.float().abs().max()).item(),
                    "lse_max_abs": (lse[:4] - lse_p).abs().max().item(),
                    "finite": bool(torch.isfinite(o).all().item()
                                   and torch.isfinite(lse).all().item())}

        err = errors(tree)
        softmax = "fast" if fast else "dynamic" if static is None else f"C={static}"
        emit("shape", name=name, shape=[B, S, H * HD], heads=H, valid_len=valid,
             softmax=softmax, **err,
             ms=cuda_ms(tree), sdpa_fwd_ms=sdpa_fwd_ms(q, k, v, H, HD**-0.5),
             bound_ms=fwd_bound_ms(B, H), kernel_us_per_call=kernel_times(tree))
        for csrc, lib in baselines:
            def base():
                return with_library(lib, tree)

            turns = [cuda_ms(base), cuda_ms(tree), cuda_ms(tree), cuda_ms(base)]
            emit("baseline", name=name, shape=[B, S, H * HD], heads=H, csrc=csrc,
                 softmax=softmax, baseline_ms=(turns[0] + turns[3]) / 2,
                 tree_ms=(turns[1] + turns[2]) / 2, turns_ms=turns,
                 baseline_errors=errors(base))
        del q, k, v, o_p, lse_p
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "pk_fwd_profile.jsonl"), "w") as f:
            f.write(f"{smi}\n" + "\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
