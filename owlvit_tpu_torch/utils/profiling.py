"""Per-step timing utilities (counterpart of owlvit_tpu/utils/profiling.py).

Device tracing does not live here: the trainer's `training.profile_dir`
wraps `torch.profiler` for that."""

from __future__ import annotations

import time

import numpy as np
import torch


def _devices(result, out: set) -> set:
    """The CUDA devices of the tensors in a nested dict/list/tuple."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            out.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _devices(v, out)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _devices(v, out)
    return out


class StepTimer:
    """Cheap per-step wall-time tracker with percentile summary (waits on
    the device result it is handed, so timings are real)."""

    def __init__(self):
        self.durations: list = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """Wait for every card that holds a tensor of `result` (a tensor or
        a nested structure of them; CPU tensors need no wait), then record
        the elapsed time."""
        if result is not None:
            for device in _devices(result, set()):
                torch.cuda.synchronize(device)
        self.durations.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.durations:
            return {}
        d = np.asarray(self.durations)
        return {
            "steps": len(d),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "total_s": float(d.sum()),
        }
