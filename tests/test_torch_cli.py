"""Port: `python -m owlvit_tpu_torch.cli` (train, eval, make-synthetic,
make-coco-subset), mirroring tests/test_cli.py with --device cpu; the
default device is the card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from owlvit_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cliwork"))
    cfg = f"""
data:
  synthetic_root: {root}/synth
  num_train_images: 8
  num_test_images: 2
  max_gt: 8
  synthetic_classes: 3
training:
  n_epochs: 1
  learning_rate: 1.0e-4
  batch_size: 4
  checkpoint_dir: {root}/ckpt
  top_k: 8
model:
  name: tiny
  trainable_last_k: 1
"""
    cfg_path = os.path.join(root, "config.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg)
    return root, cfg_path


def test_make_synthetic(workdir, capsys):
    root, _ = workdir
    cli.main(["make-synthetic", "--root", f"{root}/standalone", "--n-train", "3",
              "--n-test", "1", "--n-classes", "2"])
    out = json.loads(capsys.readouterr().out)
    assert os.path.exists(out["train"])


def test_train_and_eval(workdir, capsys):
    root, cfg_path = workdir
    cli.main(["train", "--config", cfg_path, "--workdir", root, "--device", "cpu"])
    captured = capsys.readouterr().out
    assert "map" in captured
    assert os.path.isdir(f"{root}/ckpt")

    dets = os.path.join(root, "dets.json")
    cli.main(["eval", "--config", cfg_path, "--workdir", root, "--device", "cpu",
              "--save-detections", dets])
    text = capsys.readouterr().out
    assert "resumed from step 2" in text
    out = json.loads(text[text.index("{\n"):])  # after the set-up lines
    assert "map_50" in out and len(out["map_per_class"]) == 3
    with open(dets) as f:
        assert isinstance(json.load(f), list)


def test_make_coco_subset(tmp_path, capsys):
    imgs = [{"id": i, "coco_url": f"http://x/{i}.jpg"} for i in range(20)]
    anns = [{"image_id": i, "category_id": [1, 2, 3, 16][i % 4], "bbox": [1, 2, 3, 4]}
            for i in range(20)]
    inst = tmp_path / "instances.json"
    inst.write_text(json.dumps({"images": imgs, "annotations": anns}))
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"data:\n  annotations_file: {inst}\n  num_train_images: 10\n"
                   "  num_test_images: 5\n")
    cli.main(["make-coco-subset", "--config", str(cfg), "--out-dir", str(tmp_path / "out")])
    out = json.loads(capsys.readouterr().out)
    assert out["n_train"] == 10 and out["n_test"] == 5
    assert os.path.exists(tmp_path / "out" / "labelmap.json")


def test_train_runs_on_the_card_by_default(workdir):
    """Without --device the CLI asks for the card, and refuses where there
    is none (before it writes any data)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    root, cfg_path = workdir
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--config", cfg_path, "--workdir", os.path.join(root, "w2")])
    assert not os.path.exists(os.path.join(root, "w2"))


def test_module_entry_point(workdir):
    _, cfg_path = workdir
    out = subprocess.run([sys.executable, "-m", "owlvit_tpu_torch.cli", "--help"],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0
    for cmd in ("train", "eval", "make-synthetic", "make-coco-subset"):
        assert cmd in out.stdout
