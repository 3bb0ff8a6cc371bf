"""Port: the program's spans (utils/profiling.py `span`, `record`, `phases`)
and where the server and the trainer open them, on the CPU at `tiny`.

Held: with tracing off a span is one shared no-op that reads no clock and
enters no profiler range; under a recorder each span keeps its name, id,
parent on its own thread and job; under torch.profiler each span contains
the profiler's range of its name; `bulk_detect`, the online lane's
dispatch and `train_step` open their spans in order under the right
parents, the step's marks are unchanged, and results are bit-equal with
the recorder on and off."""

import contextlib
import threading

import numpy as np
import pytest
import torch

from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.serve import DetectorServer
from owlvit_tpu_torch.train.trainer import Trainer
from owlvit_tpu_torch.utils import profiling
from owlvit_tpu_torch.utils.config import Config, DataConfig, ModelConfig, TrainingConfig

N_CLASSES = 4


def _raise(*a, **kw):
    raise AssertionError("called with tracing off")


def _model():
    return owlvit.init(get_config("tiny"), torch.Generator().manual_seed(0),
                       num_queries=3 * N_CLASSES)


def _images(n, seed=0):
    return list(np.random.default_rng(seed).integers(0, 255, (n, 96, 96, 3), dtype=np.uint8))


def _tree(spans) -> list:
    """(name, name of the parent or None, job) of each span, in start order."""
    by_id = {s["id"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent"]), s["job"]) for s in spans]


def test_span_off_is_one_shared_noop(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(profiling.time, "time_ns", _raise)
    a = profiling.span("x")
    b = profiling.span("y", job=3, device="cpu")
    assert a is b is profiling._OFF
    with a, b:
        pass
    with profiling.phases(None, {"p": (True, "q")}, "first") as mark:
        assert mark is profiling._no_mark
    monkeypatch.undo()
    with profiling.record() as spans:
        pass
    assert spans == []


def test_record_keeps_names_parents_jobs_and_threads():
    inner_open, outer_may_close = threading.Event(), threading.Event()

    def other():
        with profiling.span("t.thread", job=7):
            with profiling.span("t.thread.child"):
                inner_open.set()
                assert outer_may_close.wait(30)

    with profiling.record() as spans:
        with profiling.span("t.outer", job=1):
            t = threading.Thread(target=other)
            t.start()
            assert inner_open.wait(30)
            with profiling.span("t.inner", job=2):
                pass
            outer_may_close.set()
            t.join(30)
            assert not t.is_alive()
        with profiling.span("t.after"):
            pass
    assert sorted(_tree(spans), key=str) == sorted([
        ("t.outer", None, 1), ("t.thread", None, 7), ("t.thread.child", "t.thread", None),
        ("t.inner", "t.outer", 2), ("t.after", None, None)], key=str)
    assert [s["start_ns"] for s in spans] == sorted(s["start_ns"] for s in spans)
    assert len({s["id"] for s in spans}) == len(spans)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None


def test_record_nests_and_leaves_out_unfinished_spans():
    with profiling.record() as outer:
        with profiling.span("t.a"):
            with profiling.record() as inner:
                with profiling.span("t.b"):
                    pass
    assert [s["name"] for s in outer] == ["t.a", "t.b"]
    assert [s["name"] for s in inner] == ["t.b"]
    assert profiling._recorders == [] and profiling._local.stack == []


@pytest.mark.parametrize("recorded", [True, False], ids=["recorder", "profiler_alone"])
def test_spans_contain_the_profilers_ranges(recorded):
    x = torch.randn(32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.record() if recorded else contextlib.nullcontext() as spans:
            for job in range(3):
                with profiling.span("t.outer", job=job), profiling.span("t.inner"):
                    x = torch.tanh(x @ x)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in ("t.outer", "t.inner")]
    assert sorted(n for n, _, _ in ranges) == ["t.inner"] * 3 + ["t.outer"] * 3
    if not recorded:
        return
    assert len(spans) == 6
    for s in spans:
        inside = [(a, b) for n, a, b in ranges
                  if n == s["name"] and s["start_ns"] <= a and b <= s["end_ns"]]
        assert len(inside) == 1, s
        a, b = inside[0]
        assert a - s["start_ns"] < 1e6 and s["end_ns"] - b < 1e6


def test_phases_close_every_span_when_the_block_raises():
    edges = {"a": (True, "t.b"), "c": (False, "t.c")}
    marks = []
    with profiling.record() as spans:
        with pytest.raises(RuntimeError):
            with profiling.span("t.step"), profiling.phases(marks.append, edges, "t.a") as mark:
                mark("a")
                mark("c")
                raise RuntimeError("mid-step")
    assert marks == ["a", "c"]
    assert _tree(spans) == [("t.step", None, None), ("t.a", "t.step", None),
                            ("t.b", "t.step", None), ("t.c", "t.b", None)]
    assert profiling._local.stack == []


BULK_BATCH = ["serve.bulk.pack", "serve.bulk.copy", "serve.forward", "serve.nms"]
BULK_READ = ["serve.bulk.wait", "serve.bulk.unpack"]


@pytest.mark.parametrize("queries", [None, ("a cat", "a dog")], ids=["bank", "zero_shot"])
def test_bulk_detect_spans(queries):
    """Two batches: size and alloc, each batch's pack, copy, forward and
    NMS, then batch 0's read while batch 1 runs and batch 1's read, all
    under the job's span; the results equal those with the recorder off."""
    from owlvit_tpu_torch.data.tokenizer import HashTokenizer

    cfg, images = get_config("tiny"), _images(7)
    with DetectorServer(_model(), cfg, buckets=(2, 4), top_k=8, device="cpu",
                        warmup=False, autostart=False,
                        tokenizer=HashTokenizer(cfg.text.vocab_size, max_len=cfg.text.max_len)
                        ) as srv:
        off = srv.bulk_detect(images, queries=queries)
        with profiling.record() as spans:
            on = srv.bulk_detect(images, queries=queries)
    names = ["serve.bulk", "serve.bulk.size", "serve.bulk.alloc", *BULK_BATCH, *BULK_BATCH,
             *BULK_READ, *BULK_READ]
    assert _tree(spans) == [(n, None if n == "serve.bulk" else "serve.bulk",
                             1 if n == "serve.bulk" else None) for n in names]
    for a, b in zip(off, on):
        for k in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(a[k], b[k])
    assert len(off) == len(on) == 7


def test_dispatch_spans():
    """The online lane: one span a batch, holding the forward and NMS."""
    with DetectorServer(_model(), get_config("tiny"), buckets=(2,), top_k=8, device="cpu",
                        warmup=False, max_delay_ms=1) as srv:
        off = srv.detect(_images(1)[0], timeout=60)
        with profiling.record() as spans:
            on = srv.detect(_images(1)[0], timeout=60)
    assert _tree(spans) == [("serve.dispatch", None, None),
                            ("serve.forward", "serve.dispatch", None),
                            ("serve.nms", "serve.dispatch", None)]
    np.testing.assert_array_equal(off["scores"], on["scores"])


def _trainer(cached: bool) -> Trainer:
    config = Config(DataConfig(max_gt=4),
                    TrainingConfig(learning_rate=1e-3, batch_size=2, checkpoint_dir=None,
                                   cache_backbone=cached, cache_backbone_store="device"),
                    ModelConfig(name="tiny", trainable_last_k=1))
    return Trainer(config, _model(), N_CLASSES, steps_per_epoch=4, device="cpu",
                   n_images=8 if cached else None)


def _batch():
    g = np.random.default_rng(1)
    return {"image": g.integers(0, 255, (2, 96, 96, 3), dtype=np.uint8),
            "labels": np.array([[0, 1, 0, 0], [2, 3, 0, 0]]),
            "boxes": np.tile(np.array([0.1, 0.2, 0.5, 0.6], np.float32), (2, 4, 1)),
            "gt_mask": np.array([[1, 1, 0, 0], [1, 0, 0, 0]], bool),
            "indices": np.array([3, 5])}


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_train_step_spans(cached):
    """The step's spans open and close at its marks; the marks a caller
    sees and the loss terms are those of a step with the recorder off."""
    off_marks, on_marks = [], []
    a, b = _trainer(cached), _trainer(cached)
    off = a.train_step(_batch(), mark=off_marks.append)
    with profiling.record() as spans:
        on = b.train_step(_batch(), mark=on_marks.append)
    fill = ["prefix", "scatter"] if cached else []
    assert off_marks == on_marks == ["input", *fill, "forward", "cost", "match", "loss",
                                     "backward", "optimizer"]
    np.testing.assert_array_equal(off, on)
    assert _tree(spans) == [("train.step", None, 0), ("train.input", "train.step", None),
                            ("train.forward", "train.step", None),
                            ("train.loss", "train.step", None),
                            ("train.match", "train.loss", None),
                            ("train.backward", "train.step", None),
                            ("train.optimizer", "train.step", None)]
    # the phases follow one another inside the step, the match inside the loss
    step, phase, loss, match = spans[0], [spans[i] for i in (1, 2, 3, 5, 6)], spans[3], spans[4]
    for prev, nxt in zip(phase, phase[1:]):
        assert prev["end_ns"] <= nxt["start_ns"]
    assert step["start_ns"] <= phase[0]["start_ns"] and phase[-1]["end_ns"] <= step["end_ns"]
    assert loss["start_ns"] <= match["start_ns"] and match["end_ns"] <= loss["end_ns"]
