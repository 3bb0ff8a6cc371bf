"""The program's spans in a cell's window, and the per-layer numbers read
from them.

    python3 gpubench/spans.py --workload <name> --seed <n> --seconds <s> \
        [--turns off,on,on,off] [--traced <s>]

Set-up as run.py's: the cell's program from the seed, then its warm-up.
Then one window of --seconds per turn of --turns, each as a `--trace 0`
window: "on" inside `owlvit_tpu_torch.utils.profiling.record()`, "off"
without, so that turns in alternation give the recorder's cost. With
--traced, a last turn records the spans inside the traced span of a
`--trace 1` run (torch.profiler on the card's activity), whose busy and
window seconds account for the job edges. Each turn prints one JSON line:
the window's end-to-end metric and, with the recorder on, the readings
below, each span name's median host and device ms, and the reading of each
job or step under its number. Nothing is judged; the program's outputs
are not compared here (run.py does that).

The readings, each the median over the window's jobs, batches or steps:

  job_edge_ms.bulk  per bulk job, from `serve.bulk`'s start to its first
                    `serve.bulk.copy`'s start plus from its last
                    `serve.bulk.wait`'s end to its own end: host time in
                    which no work of the job is queued on the card
  forward_ms.bulk   `device_ms` of `serve.forward` (normalize, the ViT,
                    the heads) a batch
  nms_ms.bulk       `device_ms` of `serve.nms` (postprocess and pack) a
                    batch, on the stream's timeline, so the card's waits
                    for NMS's host launches count
  input_ms.train    host ms of `train.input` (the step's copies of its
                    pixels and ground truth to the card) a step
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import common  # noqa: E402


def host_ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def job_edges(spans: list) -> dict:
    """{job: its edge in ms} of every `serve.bulk` job with a copy and a
    wait among its children."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    out = {}
    for job in (s for s in spans if s["name"] == "serve.bulk"):
        copies = [k for k in kids.get(job["id"], ()) if k["name"] == "serve.bulk.copy"]
        waits = [k for k in kids.get(job["id"], ()) if k["name"] == "serve.bulk.wait"]
        if copies and waits:
            first = min(k["start_ns"] for k in copies)
            last = max(k["end_ns"] for k in waits)
            out[job["job"]] = ((first - job["start_ns"]) + (job["end_ns"] - last)) / 1e6
    return out


def _median(values):
    values = list(values)
    return statistics.median(values) if values else None


def device_median(spans: list, name: str):
    return _median(s["device_ms"] for s in spans
                   if s["name"] == name and s["device_ms"] is not None)


def host_median(spans: list, name: str):
    return _median(host_ms(s) for s in spans if s["name"] == name)


READINGS = {
    "job_edge_ms.bulk": lambda spans: _median(job_edges(spans).values()),
    "forward_ms.bulk": lambda spans: device_median(spans, "serve.forward"),
    "nms_ms.bulk": lambda spans: device_median(spans, "serve.nms"),
    "input_ms.train": lambda spans: host_median(spans, "train.input"),
}


def readings(spans: list) -> dict:
    """Each reading of READINGS that the spans hold; one they do not hold
    is left out."""
    out = {k: f(spans) for k, f in READINGS.items()}
    return {k: v for k, v in out.items() if v is not None}


def summary(spans: list) -> dict:
    """Each span name's count and median host ms (and device ms where it
    has events), and each job's or step's reading under its number."""
    by_name = {}
    for name in dict.fromkeys(s["name"] for s in spans):
        by_name[name] = {"n": sum(s["name"] == name for s in spans),
                         "host_ms": host_median(spans, name),
                         "device_ms": device_median(spans, name)}
    per_job = {"serve.bulk.edge_ms": job_edges(spans),
               "train.input_ms": {}}
    steps = {s["id"]: s["job"] for s in spans if s["name"] == "train.step"}
    for s in spans:
        if s["name"] == "train.input" and s["parent"] in steps:
            per_job["train.input_ms"][steps[s["parent"]]] = host_ms(s)
    return {"readings": readings(spans), "spans": by_name,
            "per_job": {k: v for k, v in per_job.items() if v}}


def turn(cell, seconds: float, recorder: bool) -> dict:
    """One `--trace 0` window of the cell, inside `record()` or not: its
    end-to-end metric and, recorded, the summary of its spans."""
    from gpubench.drivers import program
    from owlvit_tpu_torch.utils import profiling

    with profiling.record() if recorder else contextlib.nullcontext() as spans:
        win = cell.window(seconds, marks=False)
        program.sync(cell.device)
    return {"recorder": "on" if recorder else "off", "e2e": win["e2e"],
            "attempted": win["attempted"], **(summary(spans) if recorder else {})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--turns", default="off,on,on,off")
    ap.add_argument("--traced", type=float, default=0)
    args = ap.parse_args(argv)
    turns = args.turns.split(",")
    if set(turns) - {"on", "off"}:
        ap.error("--turns takes on and off, comma-separated")
    spec = common.cell(args.workload)
    common.require_devices(spec["chips"])
    common.cache_dirs()

    import torch

    from gpubench import run
    from gpubench.trace import Trace
    from owlvit_tpu_torch.utils import profiling

    driver = importlib.import_module(f"gpubench.drivers.{spec['traffic']['driver']}")
    cell = driver.Cell(spec, args.seed, "cuda")
    units = run.warm_up(cell, spec["traffic"]["warm_max"])
    run.emit("spans_setup", workload=spec["name"], seed=args.seed, warm_units=units,
             nvidia_smi=run.nvidia_smi(), torch=torch.__version__)
    for i, t in enumerate(turns):
        run.emit("spans_turn", turn=i, **turn(cell, args.seconds, t == "on"))
    if args.traced:
        tr = Trace(cpu=False)
        with profiling.record() as spans:
            cell.traced(args.traced, tr)
        run.emit("spans_traced", window_s=tr.window_s, busy_s=tr.busy_s,
                 idle_s=tr.window_s - tr.busy_s,
                 job_edges_s=sum(job_edges(spans).values()) / 1e3, **summary(spans))
    cell.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
