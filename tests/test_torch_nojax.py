"""Port: owlvit_tpu_torch serves and trains with jax impossible to import
(the machine with the card has no JAX), and never touches the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import sys
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
