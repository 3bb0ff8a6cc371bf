"""Per-step timing utilities (counterpart of owlvit_tpu/utils/profiling.py)
and the program's spans.

Spans mark the program's layer boundaries: the server's bulk job, its
batches' pack, copy, forward, NMS, wait and unpack, the online lane's
dispatch, and the trainer's step and its phases. `record()` collects the
spans that run inside it, on every thread. While a torch.profiler runs
(the trainer's `training.profile_dir`, a benchmark's traced span) each span
is also a `record_function` range of its name, so the profiler's trace
shows it. With neither, a span costs one check. Spans sit at layer
boundaries only, never inside a per-turn or per-layer loop.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

# the active recorders' span lists; spans started while one is active
# join it
_recorders: list = []


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # the spans open on this thread, innermost last


_local = _Local()
_ids = itertools.count(1)
# what span() returns with tracing off: one shared no-op
_OFF = contextlib.nullcontext()


def _tracing() -> bool:
    return bool(_recorders) or _torch_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "job", "device", "id", "parent", "start_ns", "end_ns",
                 "events", "_into", "_range")

    def __init__(self, name: str, job, device):
        self.name, self.job, self.device = name, job, device
        self.end_ns = self.events = self._range = None

    def __enter__(self):
        self._into = list(_recorders)
        if self._into:
            stack = _local.stack
            self.id, self.parent = next(_ids), (stack[-1].id if stack else None)
            stack.append(self)
            for spans in self._into:
                spans.append(self)
            self.start_ns = time.time_ns()
        if _torch_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self._into and self.device is not None and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._into:
            self.end_ns = time.time_ns()
            _local.stack.pop()
        return False

    def to_dict(self) -> dict:
        """The finished span as its recorder hands it out."""
        ms = None
        if self.events is not None:
            self.events[1].synchronize()
            ms = self.events[0].elapsed_time(self.events[1])
        return {"name": self.name, "id": self.id, "parent": self.parent, "job": self.job,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "device_ms": ms}


def span(name: str, *, job=None, device=None):
    """A context manager marking one layer boundary's work.

    With tracing off (no recorder active, no torch.profiler running) it is
    one shared no-op: no clock is read, no event recorded. Under a recorder
    the span keeps `name`, an `id`, its `parent` (the id of the span open
    on the same thread, or None), `job` (the caller's number of the job,
    batch or step it belongs to) and `start_ns` / `end_ns` from
    time.time_ns(), the clock of torch.profiler's events, taken outside
    the profiler's range. `device`: the device the span's work runs on;
    on a CUDA device a pair of timing events is also recorded on its
    current stream, which the recorder reads as `device_ms` when it closes.
    A span never synchronises."""
    if not _tracing():
        return _OFF
    return _Span(name, job, device)


@contextlib.contextmanager
def record():
    """Record the spans of every thread while the block runs: yields a list
    that holds, once the block has exited, each span that started and
    finished inside it, as dicts (span()'s fields and `device_ms`, None for
    a span without events), in the order they started. The caller
    synchronises the devices before the block exits; the recorder then
    waits for each span's last event (already done) and reads its time."""
    spans, out = [], []
    _recorders.append(spans)
    try:
        yield out
    finally:
        _recorders[:] = [r for r in _recorders if r is not spans]
        out.extend(s.to_dict() for s in spans if s.end_ns is not None)


def _no_mark(name: str) -> None:
    pass


@contextlib.contextmanager
def phases(mark, edges: dict, first: str):
    """Spans that follow a run's phase marks. Yields the mark callback to
    call at each phase boundary: it calls `mark` (when given) with the
    phase's name, then moves the spans as edges[name] = (closes, opens)
    says: `closes` ends the innermost span this opened, `opens` names the
    span it starts (or None). The span `first` opens at once; spans still
    open when the block exits close then. With tracing off it yields
    `mark` itself."""
    mark = mark or _no_mark
    if not _tracing():
        yield mark
        return
    opened = []

    def start(name: str) -> None:
        s = span(name)
        s.__enter__()
        opened.append(s)

    def boundary(name: str) -> None:
        mark(name)
        closes, opens = edges.get(name, (False, None))
        if closes:
            opened.pop().__exit__(None, None, None)
        if opens:
            start(opens)

    start(first)
    try:
        yield boundary
    finally:
        while opened:
            opened.pop().__exit__(None, None, None)


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
