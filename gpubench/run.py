"""Run one cell of the benchmark on the card it is started on.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as setup_s, from this file's first line to the window's
start) makes the weights and inputs from the seed, builds the program's
trainer or server, runs the cell's checked work and warms up until the
allocator's reserved bytes stop growing. The window then measures for
--seconds. With --trace 1 the window also records the trainer's phase
marks, and a traced span of the same work follows it (the profiler on),
from which the per-layer metrics are read. Then the program is freed and
the plain reference judges what the window produced.

Earlier lines of standard output are JSON records of the run; the last is
the result. The last lines of standard error give each number compared
beside its limit.

--control makes no measurement: it prints the readings the cell's limits
are set from, at the cell's sizes, each judged by those limits. For each
seed of --seeds the program's checked work (set-up and a window of
--seconds, without the warm-up); for each seed of --control-seeds also
the program's own int8 path (OWLVIT_QUANT_BACKBONE=1, the control where
the program has one) and, with no program, the reference in fp8 in the
program's place, the faults and the looks.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import common  # noqa: E402

common.cache_dirs()

import torch  # noqa: E402

from gpubench import yardstick  # noqa: E402
from gpubench.trace import Trace  # noqa: E402

# seconds of the second traced span, which explains the idle gaps
ATTRIBUTION_S = 1.0
# the program's own path in the precision below bf16
PROGRAM_INT8 = {"OWLVIT_QUANT_BACKBONE": "1"}


def emit(kind: str, **fields) -> None:
    print(json.dumps({"gpubench": kind, **fields}), flush=True)


def reader(name: str):
    path = common.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def nvidia_smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def segments() -> int:
    """cudaMalloc calls so far (the allocator's segments allocated)."""
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def warm_up(cell, most: int) -> int:
    """Warm-up units of the cell's own work until a unit grows neither the
    reserved bytes nor the segments; at least two, at most `most` (the
    mix's warm_max)."""
    for i in range(most):
        before = (torch.cuda.memory_reserved(), segments())
        cell.warm()
        torch.cuda.synchronize()
        if i >= 1 and (torch.cuda.memory_reserved(), segments()) == before:
            return i + 1
    return most


def judge(numbers: dict, limits: dict) -> tuple:
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks


def run(args, spec: dict, device: str = "cuda") -> int:
    """One run of the cell `spec`; device is the card but for the tests,
    which drive a run on the CPU with the card's calls stubbed."""
    driver = importlib.import_module(f"gpubench.drivers.{spec['traffic']['driver']}")
    torch.cuda.reset_peak_memory_stats()
    t_cell = time.perf_counter()
    cell = driver.Cell(spec, args.seed, device)
    t_warm = time.perf_counter()
    units = warm_up(cell, spec["traffic"]["warm_max"])
    t_window = time.perf_counter()
    setup_s = t_window - T_START
    emit("setup", imports_s=t_cell - T_START, cell_s=t_warm - t_cell,
         warm_s=t_window - t_warm, **getattr(cell, "phases", {}))
    seg0 = segments()
    win = cell.window(args.seconds, marks=bool(args.trace))
    emit("window", workload=spec["name"], seed=args.seed, warm_units=units,
         cuda_malloc_in_window=segments() - seg0, wall_s=win["wall_s"],
         attempted=win["attempted"], failed=win["failed"], **win.get("info", {}))
    metrics, breakdown, device = {}, None, None
    e2e = {**win["e2e"], "setup_s": setup_s}
    if args.trace:
        tr = Trace(cpu=False)
        traced = cell.traced(spec["traffic"]["trace_seconds"], tr)
        att = Trace(cpu=True)
        cell.traced(ATTRIBUTION_S, att)
        emit("traced", window_s=tr.window_s, busy_s=tr.busy_s, **traced,
             img_per_s=traced["images"] / tr.window_s)
        device = common.device_info(spec["chips"])
        ctx = {"config": spec["config"], "traffic": spec["traffic"], "window": win,
               "e2e": e2e, "traced": traced,
               "trace": {"device": tr.device, "window_s": tr.window_s, "busy_s": tr.busy_s},
               "peak_flops": yardstick.peak(device["kind"])[0]}
        for m in spec["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": yardstick.device_ops(tr.device),
                     "idle_gaps": yardstick.idle_gaps(att.device, att.host, att.window_s)}
        del tr, att
    else:
        device = common.device_info(spec["chips"])
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    cell.free()
    t_ref = time.perf_counter()
    with tf32_off():
        numbers = cell.check()
    ok, checks = judge(numbers, spec["limits"])
    emit("device", nvidia_smi=nvidia_smi(), torch=torch.__version__,
         reference_s=time.perf_counter() - t_ref)
    if getattr(cell, "detail", None):
        emit("check_detail", **cell.detail)
    for k, v in checks.items():
        common.say(f"check {k} {v['value']!r} limit {v['limit']!r}")
    result = {"correct": ok, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    banned = common.banned_modules()
    if banned:
        common.say(f"gpubench: the run loaded {banned}; a run may not hold them")
        return 4
    print(json.dumps(result), flush=True)
    return 0


@contextlib.contextmanager
def tf32_off():
    """The reference's matmuls in full float32; the program's setting after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


@contextlib.contextmanager
def switched(env: dict):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def program_reading(driver, spec: dict, seed: int, seconds: float, device: str) -> dict:
    """The program's checked work of one seed: its set-up and a window of
    `seconds`, then the comparison, as a run makes them."""
    cell = driver.Cell(spec, seed, device)
    cell.window(seconds, marks=False)
    cell.free()
    with tf32_off():
        numbers = cell.check()
    out = {"numbers": numbers}
    if getattr(cell, "detail", None):
        out["detail"] = cell.detail
    del cell
    return out


def control(args, spec: dict, device: str = "cuda") -> int:
    """The readings the limits are set from, each judged (no result line);
    device as run's."""
    driver = importlib.import_module(f"gpubench.drivers.{spec['traffic']['driver']}")
    limits = spec["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = {"program": program_reading(driver, spec, seed, args.seconds, device)}
        if seed in args.control_seeds:
            with switched(PROGRAM_INT8):
                rec["program_int8"] = program_reading(driver, spec, seed, args.seconds,
                                                      device)
            with tf32_off():
                rec.update(driver.Cell(spec, seed, device, run_program=False).control())
        for v in rec.values():
            v["correct"] = judge(v["numbers"], limits)[0]
        emit("readings", workload=spec["name"], seed=seed,
             seconds=time.perf_counter() - t0, limits=limits, **rec)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    seeds = lambda s: [int(x) for x in s.split(",")]  # noqa: E731
    ap.add_argument("--seeds", type=seeds, default=None)
    ap.add_argument("--control-seeds", type=seeds, default=())
    args = ap.parse_args(argv)
    spec = common.cell(args.workload)
    common.require_devices(spec["chips"])
    if args.control:
        args.seeds = args.seeds or [args.seed]
        return control(args, spec)
    return run(args, spec)


if __name__ == "__main__":
    sys.exit(main())
