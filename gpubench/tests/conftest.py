"""The harness's own tests: python3 -m pytest gpubench/tests (CPU, a few
minutes). Tests marked `chip` need an NVIDIA card and skip without one; on
the card: python3 -m pytest gpubench/tests -m chip.

Runs on the CPU use the `tiny` configuration with the cells' traffic cut to
a few images, through the program's plain paths."""

import argparse
import json
import time

import pytest
import torch

from gpubench import common

TINY = {"program_config": "tiny", "image_size": 96, "patch_size": 32, "hidden_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
        "layer_norm_eps": 1e-05, "projection_dim": 32, "num_queries": 12,
        "prompts_per_class": 3, "dtype": "float32"}
# each mix cut to a few images of the tiny model (9 patches, 4 classes);
# the bulk mix's IoU threshold lowered so that NMS suppresses at this size
TINY_TRAFFIC = {
    "train_uncached": dict(host_images=32, batch=8, n_classes=4, max_gt=8, boxes_min=2,
                           boxes_max=4),
    "bulk_jobs": dict(buckets=[1, 8], job_images=16, pool_images=16, check_images=8,
                      iou=0.1),
}
# the training driver's activation pool, which no cell of the manifest runs
# yet: the cached fine-tune is a mix of its own once its cell holds
CACHED = dict(cached=True, pool_rows=40)
SEED = 2 ** 31 + 12345  # more than 32 signed bits hold, as the driver's seeds


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skips without one)")


def tiny_spec(workload: str, dtype: str = "float32", **traffic) -> dict:
    """The cell `workload`, its limits included, at the tiny size on the
    CPU; traffic overrides the mix's parameters."""
    spec = common.cell(workload)
    spec["config"] = {**TINY, "dtype": dtype}
    spec["traffic"].update(TINY_TRAFFIC[spec["traffic_name"]], **traffic)
    return spec


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
