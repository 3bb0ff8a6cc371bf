#!/usr/bin/env python3
"""Where the time of the matcher's two kernels goes (csrc/matcher.cu:
`jv_assign` and `propagate_labels`), on one NVIDIA GPU, against older
builds of the same entry points.

Usage: python3 tools/torch_matcher_profile.py [--out DIR] [--baseline CSRC ...]

--baseline CSRC (repeatable) is a directory of kernel sources holding a
matcher.cu with the same C entry points, e.g. an earlier commit's unpacked
by `git archive <commit> owlvit_tpu_torch/csrc/matcher.cu | tar -x -C DIR`
(then pass DIR/owlvit_tpu_torch/csrc). Each is built beside this tree's.

Prints one JSON line per phase:
  device   the card's name and power limit (nvidia-smi).
  build    nvcc's registers, stack and spills of every instantiation of the
           two kernels, for this tree's build and each --baseline's.
  input    per input and kernel: its shape, the valid rows or foreground
           patches, the slowest image's Dijkstra steps (jv_assign) or
           foreground turns (propagate_labels) as the plain version counts
           them, whether every build gives the host's output exactly, and
           each build timed in turns (b1, .., tree, tree, .., b1; two
           rounds): torch.profiler's device ms a launch of the kernel, the
           calls queued behind a device sleep (`chip_smoke.queued_ms`, 20
           calls a reading; median and spread) and CUDA events through the
           wrapper (20 calls), then the tree's microseconds a step or turn
           of the slowest image (device ms / its count).
The inputs: the train step's at random weights (`chip_smoke.train_like_
inputs`: the port's cost_matrix of random sims against the box-bias
prior's boxes, 4-10 valid of 64 GT) and a crowded scene (`crowd_inputs`:
64 valid GT in a 0.25 x 0.25 window against the prior's boxes jittered) at
[32, 64, 2304], each for both kernels (the propagation on the predicted
boxes and the host's assignment); `tie_costs` at MATCH_SHAPES and
`signed_zero_costs` at [32, 16, 2304] for jv_assign; `propagation_cases`
at [32, 2304] and [4, 3600] for propagate_labels.
With --out, the lines also go to DIR/matcher_profile.jsonl.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(_TOOLS, ".."), _TOOLS]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_pk_bwd_profile import in_turns, summary, with_library  # noqa: E402

from owlvit_tpu_torch.ops import _cuda, losses, matcher  # noqa: E402

N_CLASSES = 80
THRESHOLD = 0.85  # the loss's IoU propagation threshold
KERNELS = ("jv_assign_kernel", "propagate_labels_kernel")


def slowest(counts):
    """(index, count) of the image with the most steps or turns."""
    i = int(np.argmax(counts))
    return i, int(counts[i])


def summaries(turns):
    """{build: summary of its readings}, or the readings themselves where
    one is not a number (the profiler saw no device events)."""
    return {b: summary(r) if all(isinstance(x, float) for x in r) else r
            for b, r in turns.items()}


def matcher_ptxas(lib_path):
    """nvcc's lines (stack and spills, registers) for every instantiation of
    the matcher's two kernels."""
    return {name: lines for name, lines in _cuda.ptxas_report(lib_path).items()
            if any(k in name for k in KERNELS)}


def build_from(csrc):
    """(path, library) of the kernels built from the sources in `csrc`
    instead of the tree's."""
    saved = _cuda.CSRC
    _cuda.CSRC = Path(csrc).resolve()
    try:
        path = _cuda.build()
        return path, _cuda.bind(path)
    finally:
        _cuda.CSRC = saved


def inputs(rng):
    """name -> (cost [B, R, C], row_mask) for jv_assign, and the
    propagation inputs of the same draws: name -> (boxes, classes)."""
    import chip_smoke as cs  # the smoke's input families, on the card only
    assign, prop = {}, {}
    for name, make in (("train", cs.train_like_inputs), ("crowd", cs.crowd_inputs)):
        cost, mask, boxes, target = make(rng, 32, 64, 2304, N_CLASSES)
        assign[name], prop[name] = (cost, mask), (boxes, target)
    for shape in cs.MATCH_SHAPES:
        assign["ties_" + "x".join(map(str, shape))] = cs.tie_costs(rng, *shape)
    assign["signed_zeros"] = cs.signed_zero_costs(rng, 32, 16, 2304)
    for B, P in ((32, 2304), (4, 3600)):
        prop[f"chains_{B}x{P}"] = cs.propagation_cases(rng, B, P, N_CLASSES)
    return assign, prop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--baseline", action="append", default=[],
                    help="directory of kernel sources to time this tree's against "
                         "(repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on the GPU")
    from chip_smoke import cuda_ms, queued_ms  # the smoke's timers, on the card only
    lines = []

    def emit(phase, **fields):
        line = json.dumps({"phase": phase, **fields})
        lines.append(line)
        print(line, flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit("build", kernels=matcher_ptxas(_cuda.build()))
    libs = {}
    for csrc in args.baseline:
        path, libs[csrc] = build_from(csrc)
        emit("build", csrc=csrc, kernels=matcher_ptxas(path))
    libs["tree"] = _cuda.library()
    order = list(libs)

    assign, prop = inputs(np.random.default_rng(17))
    cases = []
    for name, (cost, mask) in assign.items():
        steps = []
        want = matcher.hungarian(cost, mask, steps)
        c, m = torch.from_numpy(cost).cuda(), torch.from_numpy(mask).cuda()
        cases.append(("jv_assign", name, list(cost.shape), int(mask.sum()), steps, want,
                      lambda c=c, m=m: matcher.jv_assign(c, m)))
    for name, (boxes, classes) in prop.items():
        turns = []
        want = np.stack([losses._propagate_labels(boxes[b], classes[b], N_CLASSES, THRESHOLD,
                                                  turns) for b in range(len(boxes))])
        bx, tc = torch.from_numpy(boxes).cuda(), torch.from_numpy(classes).cuda()
        cases.append(("propagate_labels", name, list(classes.shape),
                      int((classes != N_CLASSES).sum()), turns, want,
                      lambda bx=bx, tc=tc: losses.propagate_labels(bx, tc, N_CLASSES, THRESHOLD)))

    for kernel, name, shape, real, counts, want, fn in cases:
        exact = {build: bool(np.array_equal(with_library(lib, fn).cpu().numpy(), want))
                 for build, lib in libs.items()}
        dev = in_turns(lambda b: queued_ms(lambda: with_library(libs[b], fn), (kernel,)),
                       order, rounds=2)
        events = in_turns(lambda b: cuda_ms(lambda: with_library(libs[b], fn), 20), order,
                          rounds=2)
        image, count = slowest(counts)
        dev_ms = summaries(dev)
        tree = dev_ms["tree"]
        emit("input", kernel=kernel, input=name, shape=shape,
             **{"valid_rows" if kernel == "jv_assign" else "foreground": real},
             slowest_image=image, **{"steps" if kernel == "jv_assign" else "turns": count},
             mean_count=float(np.mean(counts)), exact=exact,
             device_ms=dev_ms, device_turns_ms=dev, events_ms=summaries(events),
             us_per_count=tree["median"] * 1e3 / count
             if count and isinstance(tree, dict) else "not measured")
        del fn
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "matcher_profile.jsonl"), "w") as f:
            f.write(f"{smi}\n" + "\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
