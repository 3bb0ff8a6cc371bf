"""The harness's own tests: python3 -m pytest gpubench/tests (CPU, a few
minutes). Tests marked `chip` need an NVIDIA card and skip without one; on
the card: python3 -m pytest gpubench/tests -m chip.

Runs on the CPU use each cell's CPU-size counterparts, files found by name
under gpubench/tests/tiny/:
  configs/<configuration>.json  the configuration file whole, at a size
                                the CPU runs in seconds through the
                                program's plain paths (float32);
  traffic/<mix>.json            the keys of the mix that the tiny size
                                cuts; its other keys stay as the mix's
                                own file has them (bulk_jobs' IoU is
                                lowered so that NMS suppresses at 9
                                patches).
A configuration or a mix that enters BENCHMARK.json brings its
counterparts (test_gpubench_manifest.py fails without them); a driver
other than bulk and train brings its own tests,
gpubench/tests/test_driver_<driver>.py."""

import argparse
import json
import time
from pathlib import Path

import pytest
import torch

from gpubench import common

TINY = Path(__file__).resolve().parent / "tiny"
SEED = 2 ** 31 + 12345  # more than 32 signed bits hold, as the driver's seeds
# the drivers the shared tests know; another brings test_driver_<driver>.py
SHARED_DRIVERS = ("bulk", "train")


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skips without one)")


def tiny_file(kind: str, name: str, tiny: Path = TINY) -> Path:
    """The CPU-size counterpart `tiny/<kind>/<name>.json`; a missing one
    fails with the file to add."""
    path = tiny / kind / f"{name}.json"
    if not path.is_file():
        pytest.fail(f"no CPU-size counterpart of {name!r}: add {path}", pytrace=False)
    return path


def tiny_spec(workload: str, dtype: str = "float32", root: Path = common.ROOT,
              tiny: Path = TINY, **traffic) -> dict:
    """The cell `workload` of the checkout at `root`, its limits included,
    at its tiny size (the counterparts under `tiny`) on the CPU; traffic
    overrides the mix's parameters."""
    spec = common.cell(workload, root)
    spec["config"] = {**common.load_json(tiny_file("configs", spec["config_name"], tiny)),
                      "dtype": dtype}
    spec["traffic"].update(common.load_json(tiny_file("traffic", spec["traffic_name"], tiny)),
                           **traffic)
    return spec


def shared_driver(workload: str) -> str:
    """The cell's driver where the shared tests know it; else the test
    skips, naming the file the driver brings its tests in."""
    d = common.cell(workload)["traffic"]["driver"]
    if d not in SHARED_DRIVERS:
        pytest.skip(f"driver {d!r}: its tests are in gpubench/tests/test_driver_{d}.py")
    return d


class _Event:
    def __init__(self, **kw):
        self.t = None

    def record(self, *a):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def cpu_run(monkeypatch, capsys):
    """Drive gpubench.run.run on the CPU (the card's calls stubbed) and
    return the result line's object, or None where the run printed none."""
    from gpubench import run as run_mod

    c = torch.cuda
    for name, fn in (("reset_peak_memory_stats", lambda *a: None),
                     ("memory_reserved", lambda *a: 0), ("memory_stats", lambda *a: {}),
                     ("synchronize", lambda *a: None)):
        monkeypatch.setattr(c, name, fn)
    monkeypatch.setattr(c, "Event", _Event)
    monkeypatch.setattr(run_mod.common, "device_info", lambda n: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": n,
        "memory_peak_bytes": 1})

    def go(spec: dict, seconds: float = 0.5, trace: int = 0):
        args = argparse.Namespace(seed=SEED, seconds=seconds, trace=trace)
        capsys.readouterr()
        rc = run_mod.run(args, spec, device="cpu")
        out = capsys.readouterr().out.strip().splitlines()
        return json.loads(out[-1]) if rc == 0 and out else None

    return go
