"""Port: the pixel pre-stage (training.stage_pixels) and the device-side
matching it needs (counterpart of tests/test_pixel_stage.py).

The staged run decodes the train and test sets once into device pools and
gathers every batch there; from the epoch whose steps need no host
bookkeeping on, the device epoch runs every step from one copy of the
epoch's index matrix and reads the summed terms once. Same pixels, same
batch order, same ground truth: on the CPU the port's staged run is held
bit for bit to its streamed run (the JSONL terms, the eval and the final
parameters) for the uncached, cached device store, augment_hflip and
augment configurations, and to the JAX package's staged run (Trainer with
stage_pixels "on") within tests/test_torch_run.py's tolerances.

The batched `propagate_labels` wrapper on the CPU against the JAX
`_propagate_labels`, on the same numpy inputs (`jv_assign` and `assign`
are held to the JAX `hungarian` and `match` in tests/test_torch_losses.py;
the CUDA kernels behind them are held to the same plain versions by
chip_smoke.py on the card).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.models.convert import save_params
from owlvit_tpu.ops import losses as jlosses
from owlvit_tpu.train import Trainer as JaxTrainer
from owlvit_tpu.utils import config as jconfig
from owlvit_tpu_torch.ops import losses, matcher
from owlvit_tpu_torch.parallel import sharding
from owlvit_tpu_torch.train import Trainer
from owlvit_tpu_torch.utils.config import (Config, DataConfig, ModelConfig, TrainingConfig,
                                           load_config)

# tests/test_torch_run.py's run-parity tolerances (fp32 through two frameworks)
RTOL_TERMS, ATOL_METRIC = 1e-4, 1e-6


def _cfg(root, stage, cls=(Config, DataConfig, TrainingConfig, ModelConfig), npz=None,
         **training):
    config, data, train, model = cls
    tr = dict(n_epochs=2, learning_rate=1e-4, batch_size=4, log_file="metrics.jsonl",
              top_k=16, stage_pixels=stage, seed=3)
    tr.update(training)
    return config(
        data=data(synthetic_root=os.path.join(root, "synth"), num_train_images=8,
                  num_test_images=4, max_gt=8, synthetic_classes=3),
        training=train(**tr),
        model=model(name="tiny", trainable_last_k=1, params_npz=npz))


def _rows(root):
    with open(os.path.join(root, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _run(tmp_path, name, stage, **training):
    """The port's run -> (trainer, metrics, JSONL rows, epochs run as the
    device epoch)."""
    root = str(tmp_path / name)
    trainer = Trainer.from_config(_cfg(root, stage, **training), workdir=root, device="cpu")
    device_epochs = []
    run_epoch = trainer._run_epoch_device

    def spy(epoch):
        device_epochs.append(epoch)
        return run_epoch(epoch)

    trainer._run_epoch_device = spy
    metrics = trainer.run()
    return trainer, metrics, _rows(root), device_epochs


def _assert_identical(a, b):
    (ta, ma, ra, _), (tb, mb, rb, _) = a, b
    assert len(ra) == len(rb) == 2
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        for k in x:
            if k.startswith(("train_", "val_")) or k == "step":
                assert x[k] == y[k], k
    assert float(ma["map"]) == float(mb["map"])
    for p, q in zip(ta.params, tb.params):
        assert torch.equal(p, q)


@pytest.mark.parametrize("training,device_epochs", [
    ({}, [0, 1]),  # every epoch on the device
    ({"cache_backbone": True}, [1]),  # epoch 0 fills the store from the pixel pool
    ({"cache_backbone": True, "augment_hflip": True}, [1]),  # two pool rows an image
    ({"augment_hflip": True}, [0, 1]),  # the flips go to the device once an epoch
    ({"augment": True, "aug_color": 0.3}, []),  # host-drawn parameters: staged iterator
], ids=["uncached", "cached", "cached_hflip", "hflip", "augment"])
def test_staged_matches_streamed(tmp_path, training, device_epochs):
    off = _run(tmp_path, "off", "off", **training)
    on = _run(tmp_path, "on", "on", **training)
    assert off[0].stage_on is False and off[0].pix_train is None
    assert on[0].stage_on is True and on[0].pix_test is not None  # eval was staged
    assert off[3] == [] and on[3] == device_epochs
    _assert_identical(off, on)


def test_cached_frees_pixel_pool_after_fill(tmp_path):
    trainer, _, _, _ = _run(tmp_path, "freed", "on", cache_backbone=True)
    assert trainer.filled.all()
    assert "image" not in trainer.pix_train  # released after the filling epoch
    assert set(trainer.pix_train) == {"labels", "boxes", "gt_mask"}
    assert trainer.pix_train["labels"].dtype == torch.int64
    assert trainer.pix_train["boxes"].shape == (8, 8, 4)


def test_uncached_keeps_its_pixel_pool(tmp_path):
    trainer, _, _, _ = _run(tmp_path, "kept", "on")
    S = trainer.model_cfg.vision.image_size
    assert trainer.pix_train["image"].shape == (8, S * S * 3)
    assert trainer.pix_train["image"].dtype == torch.uint8
    assert trainer.pix_test.shape == (4, S * S * 3)


def test_auto_stays_off_on_cpu(tmp_path):
    trainer, _, _, device_epochs = _run(tmp_path, "auto", "auto")
    assert trainer.stage_on is False and trainer.pix_train is None and device_epochs == []


def test_yaml_bool_coerces_to_on_off(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("training:\n  stage_pixels: true\n")
    assert load_config(str(p)).training.stage_pixels == "on"
    p.write_text("training:\n  stage_pixels: false\n")
    assert load_config(str(p)).training.stage_pixels == "off"


def test_bad_stage_value_raises(tmp_path):
    with pytest.raises(ValueError, match="stage_pixels"):
        Trainer.from_config(_cfg(str(tmp_path), "sometimes"), workdir=str(tmp_path),
                            device="cpu")


def test_device_epoch_reads_terms_once(tmp_path, monkeypatch):
    """The device epoch reads its summed terms once: no step reaches
    train_step (whose terms are read each step)."""
    calls = []
    monkeypatch.setattr(Trainer, "train_step",
                        lambda self, *a, **k: calls.append(1) or pytest.fail("per-step read"))
    trainer, _, rows, device_epochs = _run(tmp_path, "once", "on")
    assert device_epochs == [0, 1] and not calls and trainer.step == 4
    assert all(np.isfinite(r["train_loss_ce"]) for r in rows)


# ----------------------------------------------------- against the JAX run


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("params") / "tiny.npz")
    tree = jowlvit.init(jax.random.PRNGKey(11), jax_get_config("tiny"), num_queries=9)
    save_params(path, jax.tree.map(np.asarray, tree))
    return path


@pytest.mark.parametrize("training", [{}, {"cache_backbone": True}],
                         ids=["uncached", "cached"])
def test_staged_matches_jax_staged(tmp_path, npz, training):
    """The port's staged run against the JAX Trainer(stage_pixels="on") from
    one params npz: each epoch's train terms to RTOL_TERMS, the final mAP to
    ATOL_METRIC, equal steps."""
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    jcls = (jconfig.Config, jconfig.DataConfig, jconfig.TrainingConfig, jconfig.ModelConfig)
    jt = JaxTrainer(_cfg(jax_root, "on", jcls, npz, learning_rate=1e-3, warmup_steps=1,
                         **training), workdir=jax_root)
    jmetrics = jt.run()
    assert jt._stage_on
    pt = Trainer.from_config(_cfg(port_root, "on", npz=npz, learning_rate=1e-3,
                                  warmup_steps=1, **training),
                             workdir=port_root, device="cpu")
    pmetrics = pt.run()
    assert pt.stage_on and pt.step == int(jt.state.step) == 4
    jrows, prows = _rows(jax_root), _rows(port_root)
    assert len(prows) == len(jrows) == 2
    for rp, rj in zip(prows, jrows):
        assert rp["step"] == rj["step"]
        for k in rj:
            if k.startswith("train_"):
                np.testing.assert_allclose(rp[k], rj[k], rtol=RTOL_TERMS, err_msg=k)
    assert abs(float(pmetrics["map"]) - float(jmetrics["map"])) <= ATOL_METRIC


# -------------------------------------------- the matcher's device wrappers


def _boxes(rng, n):
    c, wh = rng.uniform(0.1, 0.9, (n, 2)), rng.uniform(0.05, 0.5, (n, 2))
    return np.clip(np.concatenate([c - wh / 2, c + wh / 2], 1), 0, 1).astype(np.float32)


def test_propagate_labels_batch_equals_jax():
    """The batched wrapper on CPU tensors against the JAX per-image loop:
    near-duplicate boxes (chains of relabels) and boxes built to sit at the
    0.85 boundary."""
    rng = np.random.default_rng(5)
    B, P, C = 3, 40, 5
    base = _boxes(rng, 8)
    bx = (base[rng.integers(0, 8, (B, P))]
          + rng.normal(scale=0.01, size=(B, P, 4))).astype(np.float32)
    # box 1 of each image against box 0: IoU = w / 1.0 for a unit-height
    # strip whose width is cut to 0.85 and its neighbours in fp32
    for b, w in enumerate((0.85, np.nextafter(np.float32(0.85), 1), 0.849999)):
        bx[b, 0] = [0.0, 0.0, 1.0, 1.0]
        bx[b, 1] = [0.0, 0.0, w, 1.0]
    tc = np.full((B, P), C, np.int64)
    tc[:, 0] = 1
    tc[:, 5:9] = rng.integers(0, C, (B, 4))
    got = losses.propagate_labels(torch.from_numpy(bx), torch.from_numpy(tc), C, 0.85)
    want = np.stack([np.asarray(jlosses._propagate_labels(jnp.asarray(bx[b]),
                                                          jnp.asarray(tc[b]), C, 0.85))
                     for b in range(B)])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != tc).any()  # the labels spread


@pytest.mark.parametrize("fn,args,match", [
    (matcher.jv_assign, (torch.zeros(2, 5, 3), torch.ones(2, 5, dtype=torch.bool)),
     "rows <= cols"),
    (matcher.jv_assign, (torch.zeros(2, 3, 5), torch.ones(2, 4, dtype=torch.bool)),
     r"row_mask \[B, R\]"),
    (losses.propagate_labels, (torch.zeros(2, 5, 3), torch.zeros(2, 5, dtype=torch.long), 3,
                               0.85), r"boxes \[B, P, 4\]"),
])
def test_wrappers_refuse_bad_shapes(fn, args, match):
    with pytest.raises(ValueError, match=match):
        fn(*args)


class _Rank:
    """A mesh as the pool functions read it (coords): rank r of `data`."""

    def __init__(self, r: int, dp: int):
        self.r, self.dp = r, dp

    def get_local_rank(self, axis):
        return self.r if axis == "data" else 0

    def size(self, dim):
        return self.dp if dim == 0 else 1


def test_local_gather_takes_device_indices():
    """Indices on the pool's device stay there: the rows equal the host
    path's, and an index outside the rank's rows fails the asynchronous
    device assertion (raised at once on the CPU)."""
    pool = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)
    idx = np.array([5, 4, 7])  # rank 1 of 2 owns rows 4..7
    want = sharding.local_gather(pool, idx, _Rank(1, 2))
    got = sharding.local_gather(pool, torch.from_numpy(idx), _Rank(1, 2))
    assert torch.equal(got, want) and torch.equal(got, pool[[1, 0, 3]])
    with pytest.raises(RuntimeError, match="shard-aligned"):
        sharding.local_gather(pool, torch.tensor([3, 4]), _Rank(1, 2))
    with pytest.raises(ValueError, match="shard-aligned"):
        sharding.local_gather(pool, np.array([3, 4]), _Rank(1, 2))
