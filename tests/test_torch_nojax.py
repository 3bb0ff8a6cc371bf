"""Port: owlvit_tpu_torch serves and trains with jax impossible to import
(the machine with the card has no JAX), and never touches the JAX package."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import sys

import pytest
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.serve import DetectorServer

cfg = get_config("tiny")
model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=12)
img = np.random.default_rng(0).integers(0, 255, (96, 96, 3), dtype=np.uint8)
with DetectorServer(model, cfg, buckets=(1,), top_k=8, device="cpu") as srv:
    res = srv.detect(img, timeout=120)
assert res["boxes"].shape[1] == 4 and np.isfinite(res["boxes"]).all()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("owlvit_tpu", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("ok", len(res["scores"]))
"""


_TRAIN_CODE = """
import sys

import pytest
sys.modules["jax"] = None
import numpy as np
import torch
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.train import Trainer
from owlvit_tpu_torch.utils.config import Config, DataConfig, ModelConfig, TrainingConfig

cfg = Config(DataConfig(), TrainingConfig(batch_size=2),
             ModelConfig(name="tiny", trainable_last_k=1))
model = owlvit.init(get_config("tiny"), torch.Generator().manual_seed(0), num_queries=9)
trainer = Trainer(cfg, model, 3, steps_per_epoch=1, device="cpu")
rng = np.random.default_rng(0)
batch = {"image": rng.integers(0, 255, (2, 96 * 96 * 3), dtype=np.uint8),
         "labels": np.array([[0, 2], [1, 0]]), "boxes": np.array([[[.1, .1, .5, .5]] * 2] * 2),
         "gt_mask": np.array([[True, True], [True, False]])}
terms = trainer.train_step(batch)
assert terms.shape == (4,) and np.isfinite(terms).all(), terms
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("owlvit_tpu", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("ok", terms.tolist())
"""


_CACHED_TRAIN_CODE = """
import sys

import pytest
sys.modules["jax"] = None
import numpy as np
import torch
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.ops import fused_ln, quant  # noqa: F401
from owlvit_tpu_torch.train import Trainer
from owlvit_tpu_torch.utils.config import Config, DataConfig, ModelConfig, TrainingConfig

rng = np.random.default_rng(0)
batch = {"image": rng.integers(0, 255, (2, 96 * 96 * 3), dtype=np.uint8),
         "labels": np.array([[0, 2], [1, 0]]), "boxes": np.array([[[.1, .1, .5, .5]] * 2] * 2),
         "gt_mask": np.array([[True, True], [True, False]]), "indices": np.array([3, 1])}
for store, qdt in (("device", None), ("device", "int8"), ("disk", None)):
    cfg = Config(DataConfig(), TrainingConfig(batch_size=2, cache_backbone=True,
                                              cache_backbone_store=store,
                                              cache_store_dtype=qdt),
                 ModelConfig(name="tiny", trainable_last_k=1))
    model = owlvit.init(get_config("tiny"), torch.Generator().manual_seed(0), num_queries=9)
    trainer = Trainer(cfg, model, 3, steps_per_epoch=1, device="cpu", n_images=4,
                      workdir=store, dataset_id=["a", "b", "c", "d"])
    marks = []
    filled = trainer.train_step(dict(batch), mark=marks.append)
    stored = trainer.train_step({k: v for k, v in batch.items() if k != "image"},
                                mark=marks.append)
    assert np.isfinite(filled).all() and np.isfinite(stored).all(), (filled, stored)
    assert marks[:3] == ["input", "prefix", "scatter"], marks
    assert marks[marks.index("optimizer") + 1:][:2] == ["input", "gather"], marks
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("owlvit_tpu", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("ok")
"""


_OPTIONS_CODE = """
import sys

import pytest
sys.modules["jax"] = None
import numpy as np
import torch
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.ops import augment  # noqa: F401
from owlvit_tpu_torch.train import Trainer
from owlvit_tpu_torch.utils.config import Config, DataConfig, ModelConfig, TrainingConfig

rng = np.random.default_rng(0)
batch = {"image": rng.integers(0, 255, (2, 96 * 96 * 3), dtype=np.uint8),
         "labels": np.array([[0, 2], [1, 0]]), "boxes": np.array([[[.1, .1, .5, .5]] * 2] * 2),
         "gt_mask": np.array([[True, True], [True, False]]), "indices": np.array([3, 1])}
for training, model_kw in (
        (dict(grad_accum=2, ema_decay=0.9, augment=True, aug_color=0.3,
              aug_scale_min=0.8, aug_scale_max=1.2), dict(remat=True, trainable_last_k=2)),
        (dict(augment_hflip=True, cache_backbone=True, ema_decay=0.9), {})):
    cfg = Config(DataConfig(), TrainingConfig(batch_size=2, **training),
                 ModelConfig(name="tiny", **{"trainable_last_k": 1, **model_kw}))
    model = owlvit.init(get_config("tiny"), torch.Generator().manual_seed(0), num_queries=9)
    trainer = Trainer(cfg, model, 3, steps_per_epoch=1, device="cpu", n_images=4)
    for _ in range(2):
        terms = trainer.train_step(dict(batch))
        assert np.isfinite(terms).all(), terms
    assert trainer.updates == (1 if training.get("grad_accum") else 2), trainer.updates
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("owlvit_tpu", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("ok")
"""


def _run(code, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_serves_without_jax(tmp_path):
    _run(_CODE, tmp_path)


def test_port_trains_without_jax(tmp_path):
    _run(_TRAIN_CODE, tmp_path)


def test_port_trains_cached_without_jax(tmp_path):
    """A cached train_step, device pool (activation dtype and int8) and disk
    store, a batch that fills its rows and one that reads them back."""
    _run(_CACHED_TRAIN_CODE, tmp_path)


def test_port_trains_with_options_without_jax(tmp_path):
    """grad_accum, the EMA, augment and remat on the uncached step; the
    two-row hflip pool on the cached one."""
    _run(_OPTIONS_CODE, tmp_path)


_RUN_CODE = """
import importlib
import json
import sys

import pytest
sys.modules["jax"] = None
for name in ("owlvit_tpu_torch.cli", "owlvit_tpu_torch.data", "owlvit_tpu_torch.data.coco",
             "owlvit_tpu_torch.data.dataset", "owlvit_tpu_torch.data.loader",
             "owlvit_tpu_torch.data.synthetic", "owlvit_tpu_torch.data.tokenizer",
             "owlvit_tpu_torch.models.text", "owlvit_tpu_torch.native",
             "owlvit_tpu_torch.ops.map_metric", "owlvit_tpu_torch.train.checkpoint",
             "owlvit_tpu_torch.utils.logging", "owlvit_tpu_torch.utils.tb_writer"):
    importlib.import_module(name)
from owlvit_tpu_torch import cli

with open("config.yaml", "w") as f:
    f.write("data:\\n  synthetic_root: synth\\n  num_train_images: 4\\n  num_test_images: 2\\n"
            "  max_gt: 8\\n  synthetic_classes: 2\\ntraining:\\n  n_epochs: 1\\n"
            "  batch_size: 2\\n  checkpoint_dir: ckpt\\n  top_k: 8\\n"
            "  cache_backbone: true\\nmodel:\\n  name: tiny\\n")
cli.main(["train", "--config", "config.yaml", "--device", "cpu"])
cli.main(["eval", "--config", "config.yaml", "--device", "cpu"])
import os
imgs = sorted(os.listdir("synth/images"))
for extra in ([], ["--queries", "a cat", "a dog"], ["--query-image", "synth/images/" + imgs[1]]):
    cli.main(["infer", "--config", "config.yaml", "--device", "cpu",
              "--image", "synth/images/" + imgs[0], *extra])
cli.main(["bulk-infer", "--config", "config.yaml", "--device", "cpu", "--input-dir",
          "synth/images", "--out", "bulk.json", "--batch-size", "2", "--queries", "a cat"])
assert len(json.load(open("bulk.json"))) == len(imgs)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("owlvit_tpu", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("ok")
"""


def test_port_runs_cli_without_jax(tmp_path):
    """Every module this port adds for the run imports without jax, and
    the CLI fine-tunes (query bank from the text tower, cached epoch,
    checkpoint), evaluates, infers in its three modes (bank, --queries,
    --query-image) and runs bulk-infer."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _RUN_CODE], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("ok")


_OPEN_VOCAB_CODE = """
import sys

import pytest
sys.modules["jax"] = None
import numpy as np
import torch
from owlvit_tpu_torch.data.tokenizer import HashTokenizer
from owlvit_tpu_torch.models import convert, get_config, owlvit
from owlvit_tpu_torch.ops import preprocess
from owlvit_tpu_torch.serve import DetectorServer, make_app

cfg = get_config("tiny")
model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=12)
rng = np.random.default_rng(0)
img, qimg = rng.integers(0, 255, (2, 96, 96, 3), dtype=np.uint8)
tok = HashTokenizer(cfg.text.vocab_size, max_len=cfg.text.max_len)
with DetectorServer(model, cfg, buckets=(1, 2), top_k=8, device="cpu", tokenizer=tok,
                    one_shot=True) as srv:
    zs = srv.detect(img, queries=["a cat", "a dog"], timeout=120)
    os_ = srv.detect(img, query_image=qimg, timeout=120)
    bulk = srv.bulk_detect([img, qimg, img], queries=["a cat"])
    app = make_app(srv)
assert set(zs["labels"]) <= {"a cat", "a dog"} and set(os_["labels"]) <= {"query-object"}
assert len(bulk) == 3 and "/detect" in {r.resource.canonical for r in app.router.routes()}
x = preprocess.preprocess_image(torch.from_numpy(rng.integers(0, 255, (50, 70, 3), dtype=np.uint8)),
                                size=96)
assert x.shape == (96, 96, 3) and torch.isfinite(x).all()
convert.save_params("p.npz", {"a": {"b": np.zeros(3, np.float32)}})
assert convert.load_params("p.npz")["a"]["b"].shape == (3,)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("owlvit_tpu", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("ok")
"""


def test_port_serves_open_vocab_without_jax(tmp_path):
    """The zero-shot and one-shot lanes, bulk_detect, the HTTP app, the
    resize and the npz writer run with jax impossible to import."""
    pytest.importorskip("aiohttp")
    _run(_OPEN_VOCAB_CODE, tmp_path)


_EXPORT_CODE = """
import sys

import pytest
sys.modules["jax"] = None
import numpy as np
import torch
from owlvit_tpu_torch.models import convert, get_config, owlvit
from owlvit_tpu_torch.train import export

cfg = get_config("tiny")
model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=6)
export.save_exported("full.pt2", export.export_detector(model, cfg, batch_size=2))
export.save_exported("wl.pt2", export.export_detector_weightless(model, cfg, batch_size=2))
convert.save_params("wl.npz", convert.to_jax_tree(model))
img = np.random.default_rng(0).integers(0, 255, (2, 96, 96, 3), dtype=np.uint8)
a = export.load_exported("full.pt2")(img)
b = export.load_exported_weightless("wl.pt2", convert.load_params("wl.npz"), device="cpu")(img)
assert all(torch.allclose(x, y, atol=1e-6) for x, y in zip(a, b))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("owlvit_tpu", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("ok")
"""


def test_port_exports_without_jax(tmp_path):
    """export_detector and the weightless export, saved, loaded and called,
    with jax impossible to import."""
    _run(_EXPORT_CODE, tmp_path)


_SCRIPT_CODE = """
import importlib.util
import sys

import pytest
sys.modules["jax"] = None
path = sys.argv[1]
spec = importlib.util.spec_from_file_location("script_under_test", path)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("owlvit_tpu", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("ok")
"""


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/torch_pk_fwd_profile.py",
                                    "tools/torch_pk_bwd_profile.py",
                                    "tools/torch_add_ln_profile.py",
                                    "tools/torch_serve_profile.py"])
def test_gpu_scripts_import_without_jax(tmp_path, script):
    """The scripts that run on the card import nothing of JAX or of the JAX
    package (their main() needs the card; importing them does not)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SCRIPT_CODE, os.path.join(REPO, script)],
                         env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
