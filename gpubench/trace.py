"""The traced span of a `--trace 1` run: torch.profiler over CPU and CUDA
activity, reduced to (name, start_s, end_s) events on the device and on the
host, in seconds from the span's start."""

from __future__ import annotations

import torch

# the harness's own spans (torch.profiler.record_function names)
SPAN_PREFIX = "gpubench."


class Trace:
    """with Trace(cpu) as tr: <work ending in a synchronize>; then tr.device,
    tr.host (event lists) and tr.window_s (the span's length).

    cpu=False traces the card's activity alone (kernels, copies, the CUDA
    runtime's calls), which costs the host little, for the device's
    numbers; cpu=True adds every operator the host runs, which costs it
    several microseconds an operator and so widens the gaps it explains."""

    def __init__(self, cpu: bool = False):
        self.cpu = cpu

    def __enter__(self):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.cpu:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self):
        dev, host = [], []
        for name, is_dev, s_ns, d_ns in _raw_events(self._prof):
            (dev if is_dev else host).append((name, s_ns, s_ns + d_ns))
        t0 = min((s for _, s, _ in dev + host), default=0)
        to_s = lambda evs: [(n, (s - t0) * 1e-9, (e - t0) * 1e-9) for n, s, e in evs]  # noqa: E731
        self.device, self.host = to_s(dev), to_s(host)
        # the traced window: from its first event to its last, host included
        self.window_s = max((e for _, _, e in self.device + self.host), default=0.0)

    @property
    def busy_s(self) -> float:
        from .yardstick import union_s

        return union_s([(s, e) for _, s, e in self.device])


def _raw_events(prof):
    """(name, on_device, start_ns, duration_ns) of every event but the
    spans' mirrors, from the profiler's raw results (much faster than
    building its FunctionEvents)."""
    return [(e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
             e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events() if not _annotation(e)]


def _annotation(e) -> bool:
    """A span the harness or the program named (record_function) as the
    profiler mirrors it on the device's timeline, where it is no work."""
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    is_ann = getattr(e, "is_user_annotation", None)
    return bool(is_ann and is_ann()) or e.name().startswith(SPAN_PREFIX)
