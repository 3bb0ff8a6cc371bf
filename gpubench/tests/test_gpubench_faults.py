"""The comparison fails what it must: a run with the timed path broken
underneath comes out not correct, once for each fault a cell can have (the
detections' among them NMS that suppresses nothing and NMS across
classes), and so does the control (the reference in fp8 in the program's
place). The
runs skip the harness's look for a card and drive the rest of a run on the
CPU at the tiny size, the program in float32 (its sound run compares at
rounding alone), against each cell's own limits."""

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
