"""Port: `python -m owlvit_tpu_torch.cli` (train, eval, make-synthetic,
make-coco-subset, infer, bulk-infer, serve, convert), mirroring
tests/test_cli.py with --device cpu, and the inference commands and convert
against the JAX package's CLI on the same weights and files; the default
device is the card."""

import json
import os
import subprocess
import sys

import numpy as np
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
    for cmd in ("train", "eval", "make-synthetic", "make-coco-subset", "infer",
                "bulk-infer", "serve", "convert"):
        assert cmd in out.stdout


# ------------------------------------------- inference, serving, conversion


@pytest.fixture(scope="module")
def npz_workdir(tmp_path_factory):
    """A config both CLIs load the same weights from: a JAX init with a
    query bank, written by the JAX package's save_params, and the synthetic
    set (3 classes) as the labelmap and the images to detect on."""
    import jax

    from owlvit_tpu.models import get_config as jax_get_config
    from owlvit_tpu.models import convert as jconvert
    from owlvit_tpu.models import owlvit as jowlvit

    root = str(tmp_path_factory.mktemp("inferwork"))
    params = jowlvit.init(jax.random.PRNGKey(2), jax_get_config("tiny"), num_queries=9)
    jconvert.save_params(f"{root}/params.npz", jax.tree.map(np.asarray, params))
    cfg_path = os.path.join(root, "config.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"""
data:
  synthetic_root: {root}/synth
  num_train_images: 6
  num_test_images: 2
  max_gt: 8
  synthetic_classes: 3
training:
  batch_size: 4
  top_k: 8
  confidence_threshold: 0.0
model:
  name: tiny
  params_npz: {root}/params.npz
""")
    cli.main(["make-synthetic", "--root", f"{root}/synth", "--n-train", "6",
              "--n-test", "2", "--n-classes", "3"])
    images = sorted(os.listdir(f"{root}/synth/images"))
    return root, cfg_path, [os.path.join(root, "synth", "images", f) for f in images]


def _detections(text):
    """Parse infer's lines: name, score, [x0, y0, x1, y1]."""
    rows = []
    for line in text.splitlines():
        if "[" not in line:
            continue
        head, box = line.rsplit("[", 1)
        name, score = head.rstrip().rsplit(" ", 1)
        rows.append((name.strip(), float(score),
                     [float(v) for v in box.rstrip("]").split(",")]))
    return rows


@pytest.mark.parametrize("mode", ["bank", "queries", "query-image"])
def test_infer_matches_jax_cli(npz_workdir, capsys, mode):
    """infer in its three modes prints the JAX CLI's detections for the same
    weights and image: names equal, scores within 2e-3 and box corners
    within 0.15 px (both printed rounded, to 3 and 1 decimals)."""
    from owlvit_tpu import cli as jcli

    root, cfg_path, images = npz_workdir
    extra = {"bank": [], "queries": ["--queries", "a red rectangle", "a green ellipse"],
             "query-image": ["--query-image", images[1]]}[mode]
    argv = ["infer", "--config", cfg_path, "--workdir", root, "--image", images[0],
            "--top", "5", *extra]
    jcli.main(argv)
    ref = _detections(capsys.readouterr().out)
    cli.main([*argv, "--device", "cpu"])
    got = _detections(capsys.readouterr().out)
    assert len(got) == len(ref) == 5
    for (gn, gs, gb), (rn, rs, rb) in zip(got, ref):
        assert gn == rn
        assert abs(gs - rs) <= 2e-3
        assert max(abs(a - b) for a, b in zip(gb, rb)) <= 0.15
    names = {n for n, _, _ in got}
    if mode == "queries":
        assert names <= {"a red rectangle", "a green ellipse"}
    elif mode == "query-image":
        assert names == {"query-object"}


@pytest.mark.parametrize("queries", [[], ["a red rectangle", "a blue box"]])
def test_bulk_infer_matches_jax_cli(npz_workdir, tmp_path, capsys, queries):
    """bulk-infer over the image directory (one unreadable file among
    them) writes the JAX CLI's JSON: every file, the same labels and
    classes, scores and boxes within their printed rounding plus 2e-5."""
    from owlvit_tpu import cli as jcli

    root, cfg_path, images = npz_workdir
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for p in images:
        os.symlink(p, in_dir / os.path.basename(p))
    (in_dir / "broken.png").write_bytes(b"not a png")
    outs = {}
    for name, main, dev in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.json")
        main(["bulk-infer", "--config", cfg_path, "--workdir", root, "--input-dir",
              str(in_dir), "--out", out, "--batch-size", "4", *dev,
              *(["--queries", *queries] if queries else [])])
        assert "img/s" in capsys.readouterr().out
        with open(out) as f:
            outs[name] = json.load(f)
    got, ref = outs["port"], outs["jax"]
    assert set(got) == set(ref) == {os.path.basename(p) for p in images} | {"broken.png"}
    assert "error" in got["broken.png"]
    for key, r in ref.items():
        g = got[key]
        if "error" in r:
            continue
        assert g["classes"] == r["classes"] and g["labels"] == r["labels"]
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=1e-4 + 2e-5)
        np.testing.assert_allclose(g["boxes"], np.asarray(r["boxes"]).reshape(-1, 4)
                                   if r["boxes"] else np.zeros((0, 4)),
                                   rtol=0, atol=0.01 + 0.02)
        if queries:
            assert set(g["labels"]) <= set(queries)
    assert any(r.get("labels") for r in got.values())


def test_convert_matches_jax_cli(tmp_path, capsys):
    """convert of a randomly initialised HF OwlViTForObjectDetection (the
    `tiny` geometry) writes the JAX CLI's npz: the same keys in the same
    order, every array bit-equal; and it loads into the port's model."""
    pytest.importorskip("transformers")
    from transformers.models.owlvit.configuration_owlvit import OwlViTConfig
    from transformers.models.owlvit.modeling_owlvit import OwlViTForObjectDetection

    from owlvit_tpu import cli as jcli
    from owlvit_tpu_torch.models import get_config
    from owlvit_tpu_torch.models.convert import from_jax_tree, load_params

    cfg = get_config("tiny")
    hf_cfg = OwlViTConfig(
        text_config=dict(vocab_size=cfg.text.vocab_size, hidden_size=cfg.text.hidden_size,
                         intermediate_size=cfg.text.mlp_dim,
                         num_hidden_layers=cfg.text.num_layers,
                         num_attention_heads=cfg.text.num_heads,
                         max_position_embeddings=cfg.text.max_len),
        vision_config=dict(hidden_size=cfg.vision.hidden_size,
                           intermediate_size=cfg.vision.mlp_dim,
                           num_hidden_layers=cfg.vision.num_layers,
                           num_attention_heads=cfg.vision.num_heads,
                           image_size=cfg.vision.image_size,
                           patch_size=cfg.vision.patch_size),
        projection_dim=cfg.projection_dim)
    torch.manual_seed(0)
    src = str(tmp_path / "hf")
    OwlViTForObjectDetection(hf_cfg).save_pretrained(src)
    paths = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        paths[name] = str(tmp_path / f"{name}.npz")
        main(["convert", "--model", "tiny", "--src", src, "--out", paths[name]])
        assert f"wrote {paths[name]}" in capsys.readouterr().out
    with np.load(paths["port"]) as got, np.load(paths["jax"]) as ref:
        assert got.files == ref.files
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
    model, _ = from_jax_tree(load_params(paths["port"]), cfg)
    assert model.queries is None


@pytest.mark.parametrize("cmd", ["infer", "serve", "bulk-infer"])
def test_inference_commands_run_on_the_card_by_default(npz_workdir, tmp_path, cmd):
    """Without --device the inference commands ask for the card, and refuse
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    root, cfg_path, images = npz_workdir
    extra = {"infer": ["--image", images[0]], "serve": [],
             "bulk-infer": ["--input-dir", os.path.dirname(images[0]),
                            "--out", str(tmp_path / "o.json")]}[cmd]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([cmd, "--config", cfg_path, "--workdir", root, *extra])


def test_serve_builds_the_app(npz_workdir, monkeypatch, capsys):
    """serve --device cpu builds the server and the HTTP app, hands it to
    aiohttp's run_app and closes the server when run_app returns; without
    aiohttp it stops with a clear error."""
    pytest.importorskip("aiohttp")
    from aiohttp import web

    root, cfg_path, _ = npz_workdir
    seen = {}

    def run_app(app, host, port):
        seen["routes"] = sorted({r.resource.canonical for r in app.router.routes()})
        seen["where"] = (host, port)

    monkeypatch.setattr(web, "run_app", run_app)
    argv = ["serve", "--config", cfg_path, "--workdir", root, "--device", "cpu",
            "--buckets", "1,2", "--port", "8123", "--one-shot"]
    cli.main(argv)
    assert "serving tiny on 127.0.0.1:8123 buckets=(1, 2)" in capsys.readouterr().out
    assert seen == {"routes": ["/detect", "/healthz", "/stats"],
                    "where": ("127.0.0.1", 8123)}
    monkeypatch.setitem(sys.modules, "aiohttp", None)
    with pytest.raises(SystemExit, match="aiohttp"):
        cli.main(argv)
