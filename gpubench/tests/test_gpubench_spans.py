"""The program's spans (owlvit_tpu_torch.utils.profiling) in the work each
driver's window runs, and gpubench/spans.py's readings of them: the
readings on hand-built spans; on the CPU at the tiny size, a window inside
`profiling.record()` holds, for every bulk job, its copies, waits and each
batch's forward and NMS, and for every training step its input phase, and
the readings find them. On the card (`-m chip`) a span on the card reads
its device time."""

import importlib
import statistics

import pytest
import torch

from gpubench import common, spans as span_reads
from gpubench.tests.conftest import SEED, _Event, shared_driver, tiny_spec
from owlvit_tpu_torch.utils import profiling

CELLS = [w["name"] for w in common.manifest()["workloads"]]
MS = 1_000_000  # ns


def _span(id_, name, start_ms, end_ms, parent=None, job=None, device_ms=None):
    return {"name": name, "id": id_, "parent": parent, "job": job,
            "start_ns": start_ms * MS, "end_ns": end_ms * MS, "device_ms": device_ms}


def _bulk_job(first_id, job, t0):
    """A job of two batches from t0 (ms): 3 ms of sizing and alloc before
    its first copy, 1.5 ms after its last wait (its edge: 4.5 ms)."""
    i = first_id
    return [_span(i, "serve.bulk", t0, t0 + 99.5, job=job),
            _span(i + 1, "serve.bulk.size", t0, t0 + 2, parent=i),
            _span(i + 2, "serve.bulk.alloc", t0 + 2, t0 + 2.5, parent=i),
            _span(i + 3, "serve.bulk.pack", t0 + 2.5, t0 + 3, parent=i),
            _span(i + 4, "serve.bulk.copy", t0 + 3, t0 + 4, parent=i),
            _span(i + 5, "serve.forward", t0 + 4, t0 + 5, parent=i, device_ms=40.0),
            _span(i + 6, "serve.nms", t0 + 5, t0 + 9, parent=i, device_ms=8.0 + job),
            _span(i + 7, "serve.bulk.pack", t0 + 9, t0 + 10, parent=i),
            _span(i + 8, "serve.bulk.copy", t0 + 10, t0 + 11, parent=i),
            _span(i + 9, "serve.forward", t0 + 11, t0 + 12, parent=i, device_ms=42.0),
            _span(i + 10, "serve.nms", t0 + 12, t0 + 16, parent=i, device_ms=10.0 + job),
            _span(i + 11, "serve.bulk.wait", t0 + 16, t0 + 50, parent=i),
            _span(i + 12, "serve.bulk.unpack", t0 + 50, t0 + 51, parent=i),
            _span(i + 13, "serve.bulk.wait", t0 + 51, t0 + 98, parent=i),
            _span(i + 14, "serve.bulk.unpack", t0 + 98, t0 + 99, parent=i)]


def test_bulk_readings_on_hand_built_spans():
    recs = _bulk_job(1, 0, 0.0) + _bulk_job(16, 1, 200.0) + _bulk_job(31, 2, 400.0)
    # the last job's first copy 1 ms later: its edge 5.5 ms
    recs[30 + 3]["start_ns"] += MS
    recs[30 + 4]["start_ns"] += MS
    assert span_reads.job_edges(recs) == pytest.approx({0: 4.5, 1: 4.5, 2: 5.5})
    got = span_reads.readings(recs)
    assert got == pytest.approx({"job_edge_ms.bulk": 4.5, "forward_ms.bulk": 41.0,
                                 # the six batches' 8, 10, 9, 11, 10, 12
                                 "nms_ms.bulk": 10.0})
    out = span_reads.summary(recs)
    assert out["spans"]["serve.bulk.pack"]["n"] == 6
    assert out["spans"]["serve.bulk"]["host_ms"] == pytest.approx(99.5)
    assert out["spans"]["serve.bulk.size"]["device_ms"] is None
    assert out["per_job"] == {"serve.bulk.edge_ms": pytest.approx({0: 4.5, 1: 4.5, 2: 5.5})}


def test_a_job_without_a_copy_has_no_edge():
    recs = [_span(1, "serve.bulk", 0.0, 1.0, job=0),
            _span(2, "serve.bulk.size", 0.0, 0.5, parent=1)]
    assert span_reads.job_edges(recs) == {}
    assert span_reads.readings(recs) == {}


def test_train_readings_on_hand_built_spans():
    recs = []
    for step, input_ms in ((5, 8.0), (6, 14.0), (7, 9.0)):
        t0, i = 500.0 * step, 10 * step
        recs += [_span(i, "train.step", t0, t0 + 400, job=step),
                 _span(i + 1, "train.input", t0, t0 + input_ms, parent=i),
                 _span(i + 2, "train.forward", t0 + input_ms, t0 + 340, parent=i)]
    assert span_reads.readings(recs) == pytest.approx({"input_ms.train": 9.0})
    out = span_reads.summary(recs)
    assert out["per_job"] == {"train.input_ms": pytest.approx({5: 8.0, 6: 14.0, 7: 9.0})}
    assert out["spans"]["train.forward"]["host_ms"] == pytest.approx(340 - 9.0)


def _cell(workload: str):
    spec = tiny_spec(workload)
    driver = importlib.import_module(f"gpubench.drivers.{spec['traffic']['driver']}")
    cell = driver.Cell(spec, SEED, "cpu")
    cell.warm()
    return spec, cell


@pytest.mark.parametrize("workload", CELLS)
def test_window_work_holds_the_programs_spans(monkeypatch, workload):
    driver = shared_driver(workload)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    spec, cell = _cell(workload)
    with profiling.record() as spans:
        win = cell.window(0.3, marks=True)
    cell.free()
    got = span_reads.readings(spans)
    assert win["attempted"] > 0
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s["name"])
    if driver == "bulk":
        t = spec["traffic"]
        batches = -(-t["job_images"] // t["buckets"][-1])
        jobs = [s for s in spans if s["name"] == "serve.bulk"]
        assert len(jobs) == len(cell.done) == win["attempted"] // t["job_images"]
        for j in jobs:
            names = kids[j["id"]]
            assert names[:2] == ["serve.bulk.size", "serve.bulk.alloc"]
            for name in ("serve.bulk.copy", "serve.bulk.wait", "serve.forward", "serve.nms"):
                assert names.count(name) == batches, (name, names)
            assert j["start_ns"] <= j["end_ns"]
        # no device events off the card: the forward and NMS read there
        assert set(got) == {"job_edge_ms.bulk"} and got["job_edge_ms.bulk"] > 0
        assert set(span_reads.job_edges(spans)) == {j["job"] for j in jobs}
    if driver == "train":
        steps = [s for s in spans if s["name"] == "train.step"]
        assert len(steps) == win["attempted"] == len(win["phase_ms"]["forward"])
        assert [s["job"] for s in steps] == sorted(s["job"] for s in steps)
        inputs = [s for s in spans if s["name"] == "train.input"]
        assert [s["parent"] for s in inputs] == [s["id"] for s in steps]
        assert statistics.median((s["end_ns"] - s["start_ns"]) / 1e6 for s in inputs) > 0
        assert set(got) == {"input_ms.train"} and got["input_ms.train"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_turns_with_the_recorder_off_and_on(workload):
    driver = shared_driver(workload)
    spec, cell = _cell(workload)
    off = span_reads.turn(cell, 0.2, recorder=False)
    on = span_reads.turn(cell, 0.2, recorder=True)
    cell.free()
    assert set(off) == {"recorder", "e2e", "attempted"} and off["recorder"] == "off"
    assert on["e2e"].keys() == off["e2e"].keys() and on["attempted"] > 0
    key = {"bulk": "job_edge_ms.bulk", "train": "input_ms.train"}[driver]
    assert list(on["readings"]) == [key] and on["readings"][key] > 0
    top = "serve.bulk" if key == "job_edge_ms.bulk" else "train.step"
    assert on["spans"][top]["n"] == len(next(iter(on["per_job"].values())))


@pytest.mark.chip
def test_device_span_reads_the_cards_time():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    with profiling.record() as spans:
        with profiling.span("t.matmul", device=x.device):
            for _ in range(8):
                x = torch.tanh(x @ x)
        torch.cuda.synchronize()
    (s,) = spans
    # 8 products of 2 * 4096^3 FLOPs: well over 0.1 ms on any card, and
    # the host returns before the card is done
    assert s["device_ms"] > 0.1 and s["device_ms"] == s["device_ms"]
    assert span_reads.device_median(spans, "t.matmul") == s["device_ms"]


# the span readings the CPU has: host clocks (the device ones need CUDA events)
HOST_READINGS = {"job_edge_ms.bulk", "input_ms.train"}


class _NoProfiler:
    """The traced span without torch.profiler (which traces a card): no
    device events, half of a 1 s window busy."""

    def __init__(self, cpu: bool = False):
        self.device, self.host, self.window_s, self.busy_s = [], [], 1.0, 0.5

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_the_span_metrics(cpu_run, monkeypatch, workload):
    """A --trace 1 run records the program's spans over its window, and the
    span metrics of the cell's per_layer read them into its result line."""
    from gpubench import run as run_mod

    shared_driver(workload)
    monkeypatch.setattr(run_mod, "Trace", _NoProfiler)
    spec = tiny_spec(workload)
    res = cpu_run(spec, trace=1)
    assert res["correct"]
    listed = {m["name"] for m in spec["per_layer"]}
    for name in listed & HOST_READINGS:
        assert res["metrics"][name]["value"] > 0 and res["metrics"][name]["unit"] == "ms"
    assert not set(res["metrics"]) & (set(span_reads.READINGS) - HOST_READINGS)
    assert set(res["metrics"]) <= listed
