"""The comparison fails what it must: a run with the timed path broken
underneath comes out not correct, once for each fault a cell can have (the
detections' among them NMS that suppresses nothing and NMS across
classes), and so does the control (the reference in fp8 in the program's
place). The
runs skip the harness's look for a card and drive the rest of a run on the
CPU at the tiny size, the program in float32 (its sound run compares at
rounding alone), against each cell's own limits."""

import numpy as np
import pytest
import torch

from gpubench import common
from gpubench.tests.conftest import SEED, tiny_spec

CELLS = [w["name"] for w in common.manifest()["workloads"]]
TRAIN = [w for w in CELLS if common.cell(w)["traffic"]["driver"] == "train"]
DETECT = [w for w in CELLS if common.cell(w)["traffic"]["driver"] == "bulk"]


def _state_unchanged(monkeypatch):
    from owlvit_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "_update", lambda self: None)


def _half_batch_loss(monkeypatch):
    from owlvit_tpu_torch.ops import losses

    full = losses.push_pull_loss

    def half(sims, boxes, labels, gt_boxes, gt_mask, *a, **kw):
        h = sims.shape[0] // 2
        return full(sims[:h], boxes[:h], labels[:h], gt_boxes[:h], gt_mask[:h], *a, **kw)

    monkeypatch.setattr(losses, "push_pull_loss", half)


def _half_batch_served(monkeypatch):
    from owlvit_tpu_torch.serve import DetectorServer

    full = DetectorServer.serve_batch

    def half(self, images):
        out = full(self, images).clone()
        out[out.shape[0] // 2:] = 0  # no detections for the second half
        return out

    monkeypatch.setattr(DetectorServer, "serve_batch", half)


def _answer_altered(monkeypatch):
    from owlvit_tpu_torch.ops import nms

    full = nms.pack_detections

    def altered(out):
        out = dict(out)
        out["scores"] = out["scores"].clone()
        out["scores"][:, 0] += 0.05  # each image's best detection
        return full(out)

    monkeypatch.setattr(nms, "pack_detections", altered)


def _nms_suppresses_nothing(monkeypatch):
    from owlvit_tpu_torch.ops import nms

    monkeypatch.setattr(nms, "batched_nms",
                        lambda boxes, scores, classes, iou, k: nms.nms(boxes, scores, 2.0, k))


def _nms_across_classes(monkeypatch):
    from owlvit_tpu_torch.ops import nms

    monkeypatch.setattr(nms, "batched_nms",
                        lambda boxes, scores, classes, iou, k: nms.nms(boxes, scores, iou, k))


@pytest.mark.parametrize("workload", TRAIN + DETECT)
def test_sound_run_is_correct(cpu_run, workload):
    assert cpu_run(tiny_spec(workload))["correct"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_loss], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", TRAIN)
def test_training_faults_fail(cpu_run, monkeypatch, workload, fault):
    fault(monkeypatch)
    assert cpu_run(tiny_spec(workload))["correct"] is False


@pytest.mark.parametrize("fault", [_half_batch_served, _answer_altered,
                                   _nms_suppresses_nothing, _nms_across_classes],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", DETECT)
def test_detection_faults_fail(cpu_run, monkeypatch, workload, fault):
    fault(monkeypatch)
    assert cpu_run(tiny_spec(workload))["correct"] is False


@pytest.mark.parametrize("workload", TRAIN + DETECT)
def test_control_fails(workload):
    import importlib

    spec = tiny_spec(workload)
    driver = importlib.import_module(f"gpubench.drivers.{spec['traffic']['driver']}")
    with torch.no_grad() if spec["traffic"]["driver"] != "train" else torch.enable_grad():
        readings = driver.Cell(spec, SEED, "cpu", run_program=False).control()
    numbers = readings["control_fp8"]["numbers"]
    assert any(numbers[k] > v for k, v in spec["limits"].items()), numbers
    if "reference_nms_itself" in readings:  # the reference's own rows read 0
        assert all(v < 1e-6 for v in readings["reference_nms_itself"]["numbers"].values())


@pytest.mark.parametrize("workload", TRAIN + DETECT)
def test_readings_are_judged(monkeypatch, capsys, workload):
    """--control judges each reading by the cell's limits: the program's
    sound run is correct, the control and every planted fault are not."""
    import argparse
    import json

    from gpubench import run as run_mod

    monkeypatch.setattr(run_mod, "PROGRAM_INT8", {})  # the int8 path is the chip's
    args = argparse.Namespace(seeds=[SEED], control_seeds=[SEED], seconds=0.2)
    capsys.readouterr()
    assert run_mod.control(args, tiny_spec(workload), device="cpu") == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["program"]["correct"] and rec["program_int8"]["correct"]
    assert not rec["control_fp8"]["correct"]
    assert not any(v["correct"] for k, v in rec.items() if k.startswith("fault_"))


@pytest.mark.parametrize("workload", DETECT)
def test_bulk_sample_does_not_depend_on_the_job_count(workload):
    """The images a bulk run compares are drawn from the seed alone: one
    job or three in the window, the same images (each row from one of the
    jobs that served it), so a fault shows alike however many jobs fit."""
    from gpubench.drivers import bulk

    cell = bulk.Cell(tiny_spec(workload), SEED, "cpu")
    cell.done = [cell._job() for _ in range(3)]
    n = cell.t["check_images"]
    three = cell._sample(n)
    cell.done = cell.done[:1]
    one = cell._sample(n)
    cell.free()
    assert [i for i, _ in one] == [i for i, _ in three]
    assert len({i for i, _ in one}) == n
    # nms_class_gap reads every image served, each once
    assert [i for i, _ in cell._every()] == sorted({int(i) for o, _ in cell.done for i in o})


def test_nms_class_gap_counts_held_pairs_alone():
    """Of the cross-class pairs in the reference's NMS rows, nms_class_gap
    counts those that a rounding cannot take out: a pair overlapping just
    past the IoU threshold, or with a member just over the row's floor, is
    left out; NMS across classes loses the held pair."""
    from gpubench.reference import detect

    boxes = np.array([[[0.1, 0.1, 0.5, 0.5], [0.15, 0.1, 0.55, 0.5],  # IoU 0.78
                       [0.1, 0.3015, 0.5, 0.7015],  # IoU 0.33 with the first
                       [0.6, 0.6, 0.9, 0.9], [0.62, 0.6, 0.92, 0.9]]])  # the first just over 0.01
    sims = np.zeros((1, 5, 3))
    for patch, cls, score in ((0, 0, 0.5), (1, 1, 0.4), (2, 2, 0.3), (3, 0, 0.012), (4, 1, 0.3)):
        sims[0, patch, cls] = score
    args = (100.0, 0.01, 0.3, 200)
    ref = detect.nms_rows(boxes, sims, *args)
    assert detect.held_pairs(ref[0], boxes[0], 0.01, 0.3, 200) == [((0, 0), (1, 1))]
    assert detect.class_gap(ref, boxes, sims, *args) == 0
    assert "nms_class_gap" not in detect.compare(ref, boxes, sims, sims, *args)
    across = detect.nms_rows(boxes, sims, *args, rule="class_agnostic")
    assert detect.class_gap(across, boxes, sims, *args) == 1.0


def test_nms_across_classes_changes_nothing_without_cross_class_pairs():
    """Where the reference's class-aware rows hold no two detections of
    different classes overlapping past the IoU threshold, NMS across classes
    serves the same rows: no comparison can tell that fault apart there."""
    from gpubench.reference import detect

    g = np.random.default_rng(SEED)
    quiet = 0
    for _ in range(200):
        lo = g.uniform(0, 0.8, (1, 12, 2))
        boxes = np.concatenate([lo, lo + g.uniform(0.02, 0.2, (1, 12, 2))], -1)
        sims = g.uniform(0, 0.5, (1, 12, 3))
        args = (100.0, 0.01, 0.3, 200)
        aware = detect.nms_rows(boxes, sims, *args)[0]
        b, c = aware["boxes"].astype(np.float64) / 100.0, aware["classes"]
        if (np.triu(detect._iou(b, b) > 0.3, 1) & (c[:, None] != c[None, :])).any():
            continue
        quiet += 1
        across = detect.nms_rows(boxes, sims, *args, rule="class_agnostic")[0]
        assert all(np.array_equal(aware[k], across[k]) for k in aware)
    assert quiet >= 20


@pytest.mark.parametrize("images", [8, 7])
def test_nms_class_gap_where_every_pair_lies_at_the_floor(images):
    """Where the reference holds no held pair, served rows that hold no
    overlapping pair of different classes read 1 once the reference holds
    MIN_PAIRS pairs past the threshold by IOU_MARGIN (NMS across classes
    loses every one), and class-aware rows read 0."""
    from gpubench.reference import detect

    # one pair an image, IoU 0.78, both scores within SCORE_MARGIN of the
    # confidence threshold (the rows' floor, as they hold fewer than top_k)
    boxes = np.tile(np.array([[[0.1, 0.1, 0.5, 0.5], [0.15, 0.1, 0.55, 0.5]]]), (images, 1, 1))
    sims = np.zeros((images, 2, 3))
    sims[:, 0, 0], sims[:, 1, 1] = 0.013, 0.012
    args = (100.0, 0.01, 0.3, 200)
    aware = detect.nms_rows(boxes, sims, *args)
    assert not any(detect.held_pairs(r, b, 0.01, 0.3, 200) for r, b in zip(aware, boxes))
    assert detect.class_gap(aware, boxes, sims, *args) == 0
    across = detect.nms_rows(boxes, sims, *args, rule="class_agnostic")
    assert detect.class_gap(across, boxes, sims, *args) == float(images >= detect.MIN_PAIRS)
