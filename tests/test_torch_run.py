"""Port: the fine-tune run (`Trainer.from_config`, `run`, `evaluate`)
against the JAX package's `Trainer`, and its semantics.

Run parity: both trainers load one `model.params_npz` (the JAX init tree
with its query bank, written by owlvit_tpu/models/convert.py::save_params)
and train on the same synthetic set (8 train, 4 test images, batch 4, 2
epochs, lr 1e-3 after a 1-step warmup), uncached and with the device
activation store. Held: each epoch's train_* terms to rtol 1e-4 (fp32
through two frameworks, as tests/test_torch_train.py), equal step counts,
equal JSONL key sets and class_maps.json keys; and before training, every
eval batch's kept detections (boxes and scores atol 1e-5, classes equal)
and the eval metric dict (atol 1e-6).

Semantics: the JAX package's tests of the run (tests/test_trainer.py,
tests/test_trainer_extras.py) on the port, `tiny`, CPU.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from owlvit_tpu.data import batch_iterator as jax_batch_iterator
from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.models.convert import save_params
from owlvit_tpu.train import Trainer as JaxTrainer
from owlvit_tpu.utils import config as jconfig
from owlvit_tpu.utils import logging as jlogging
from owlvit_tpu.utils import tb_writer as jtb
from owlvit_tpu_torch.data import batch_iterator
from owlvit_tpu_torch.train import Trainer
from owlvit_tpu_torch.utils import config as tconfig
from owlvit_tpu_torch.utils import logging as tlogging
from owlvit_tpu_torch.utils import tb_writer as ttb

RTOL_TERMS, ATOL_DET, ATOL_METRIC = 1e-4, 1e-5, 1e-6


def _port(cfg: jconfig.Config) -> tconfig.Config:
    return tconfig.Config(
        data=tconfig.DataConfig(**dataclasses.asdict(cfg.data)),
        training=tconfig.TrainingConfig(**dataclasses.asdict(cfg.training)),
        model=tconfig.ModelConfig(**dataclasses.asdict(cfg.model)))


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("params") / "tiny.npz")
    tree = jowlvit.init(jax.random.PRNGKey(11), jax_get_config("tiny"), num_queries=9)
    save_params(path, jax.tree.map(np.asarray, tree))
    return path


def _parity_cfg(root, side, npz, cached):
    return jconfig.Config(
        data=jconfig.DataConfig(synthetic_root=os.path.join(root, side, "synth"),
                                num_train_images=8, num_test_images=4, max_gt=8,
                                synthetic_classes=3),
        training=jconfig.TrainingConfig(n_epochs=2, learning_rate=1e-3, warmup_steps=1,
                                        batch_size=4, top_k=16, log_file="metrics.jsonl",
                                        cache_backbone=cached),
        model=jconfig.ModelConfig(name="tiny", trainable_last_k=1, params_npz=npz))


def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module", params=[False, True], ids=["uncached", "cached"])
def parity(request, tmp_path_factory, npz):
    root = str(tmp_path_factory.mktemp("parity"))
    out = {}
    for side, cls in (("jax", JaxTrainer), ("port", Trainer)):
        cfg = _parity_cfg(root, side, npz, request.param)
        workdir = os.path.join(root, side)
        if side == "jax":
            trainer = JaxTrainer(cfg, workdir=workdir)
            batches = list(jax_batch_iterator(trainer.test_ds, 4, shuffle=False))
            packed = [np.asarray(trainer.eval_step(trainer.state.trainable,
                                                   trainer.state.frozen, b["image"]))
                      for b in batches]
            step = lambda: int(trainer.state.step)  # noqa: E731
        else:
            trainer = Trainer.from_config(_port(cfg), workdir=workdir, device="cpu")
            packed = [trainer.eval_batch(b["image"])
                      for b in batch_iterator(trainer.test_ds, 4, shuffle=False)]
            step = lambda: trainer.step  # noqa: E731
        dets = os.path.join(workdir, "dets.json")
        initial = trainer.evaluate(save_detections=dets)
        final = trainer.run()
        with open(os.path.join(workdir, "class_maps.json")) as f:
            class_maps = json.load(f)
        with open(dets) as f:
            detections = json.load(f)
        out[side] = dict(packed=packed, initial=initial, final=final, step=step(),
                         rows=_rows(workdir), class_maps=class_maps, detections=detections)
    return out


def test_run_terms_match_jax(parity):
    j, p = parity["jax"], parity["port"]
    assert p["step"] == j["step"] == 4
    assert len(p["rows"]) == len(j["rows"]) == 2
    for rp, rj in zip(p["rows"], j["rows"]):
        assert rp.keys() == rj.keys()
        assert rp["step"] == rj["step"]
        for k in rj:
            if k.startswith("train_"):
                np.testing.assert_allclose(rp[k], rj[k], rtol=RTOL_TERMS, err_msg=k)
    assert p["class_maps"].keys() == j["class_maps"].keys()
    assert all(len(v) == 2 for v in p["class_maps"].values())
    assert p["final"].keys() == j["final"].keys()


def test_eval_detections_match_jax(parity):
    j, p = parity["jax"], parity["port"]
    assert len(p["packed"]) == len(j["packed"])
    for a, b in zip(p["packed"], j["packed"]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[..., 6], b[..., 6])  # kept slots
        keep = b[..., 6] > 0.5
        assert keep.any()
        np.testing.assert_array_equal(a[keep][:, 5], b[keep][:, 5])  # classes
        np.testing.assert_allclose(a[keep][:, :5], b[keep][:, :5], atol=ATOL_DET, rtol=0)
    assert len(p["detections"]) == len(j["detections"])
    for dp, dj in zip(p["detections"], j["detections"]):
        assert dp.keys() == dj.keys()
        assert (dp["image_id"], dp["category_id"], dp["category_name"]) == (
            dj["image_id"], dj["category_id"], dj["category_name"])


def test_eval_metrics_match_jax(parity):
    j, p = parity["jax"]["initial"], parity["port"]["initial"]
    assert p.keys() == j.keys()
    for k in j:
        np.testing.assert_allclose(np.asarray(p[k]), np.asarray(j[k]), atol=ATOL_METRIC,
                                   rtol=0, err_msg=k)


def test_logging_and_tb_writer_equal(tmp_path, monkeypatch):
    """LossAccumulator and ProgressFormatter give the JAX copies' values and
    rows; TBWriter writes the same bytes (the clock fixed for both)."""
    accs = tlogging.LossAccumulator(), jlogging.LossAccumulator()
    progs = tlogging.ProgressFormatter(), jlogging.ProgressFormatter()
    for i in range(3):
        for acc in accs:
            acc.update({"loss_ce": 1.0 / (i + 1), "loss_bg": 0.1 * i, "loss_bbox": 0.25 * i})
    assert accs[0].means() == accs[1].means()
    val = {"map": 0.5, "map_50": 0.7, "map_large": 0.1, "map_medium": -1.0,
           "map_small": 0.2, "mar_large": 0.3, "mar_medium": 0.4, "mar_small": -1.0}
    for prog in progs:
        prog.update(0, accs[0].means(), val)
        prog.update(1, accs[0].means(), {})
    assert [r[:-1] for r in progs[0].rows] == [r[:-1] for r in progs[1].rows]
    monkeypatch.setattr(ttb.time, "time", lambda: 123.0)
    paths = []
    for mod, name in ((ttb, "port"), (jtb, "jax")):
        w = mod.TBWriter(str(tmp_path / name))
        w.scalar("train/loss", 1.5, step=0)
        w.scalars({"map": 0.25, "per_class": np.zeros(3)}, step=1, prefix="val/")
        w.close()
        paths.append(w.path)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    assert ttb.read_events(paths[0]) == [(0, "train/loss", 1.5), (1, "val/map", 0.25)]


# ------------------------------------------------------------- semantics

def _cfg(root, **training):
    return tconfig.Config(
        data=tconfig.DataConfig(synthetic_root=os.path.join(root, "synth"),
                                num_train_images=8, num_test_images=4, max_gt=8,
                                synthetic_classes=3),
        training=tconfig.TrainingConfig(
            **{"learning_rate": 1e-4, "batch_size": 4, "top_k": 16, **training}),
        model=tconfig.ModelConfig(name="tiny", trainable_last_k=1),
    )


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("run"))
    cfg = _cfg(root, n_epochs=2, checkpoint_dir=os.path.join(root, "ckpt"),
               log_file="metrics.jsonl")
    trainer = Trainer.from_config(cfg, workdir=root, device="cpu")
    return root, cfg, trainer, trainer.run()


def test_train_runs_and_logs(trained):
    root, cfg, trainer, metrics = trained
    assert trainer.step == 4  # 8 imgs / b4 * 2 epochs
    assert "map" in metrics
    assert os.path.exists(os.path.join(root, "class_maps.json"))
    rows = _rows(root)
    assert len(rows) == 2
    for rec in rows:
        assert rec["epoch_train_secs"] > 0 and rec["epoch_imgs_per_sec"] > 0


def test_checkpoint_resume(trained):
    root, cfg, trainer, _ = trained
    t2 = Trainer.from_config(cfg, workdir=root, device="cpu")
    assert t2.step == 4
    for p, q in zip(trainer.params, t2.params):
        assert torch.equal(p, q)
    assert torch.equal(trainer.model.queries, t2.model.queries)


def test_eval_metric_shape(trained):
    _, _, _, metrics = trained
    assert metrics["map_per_class"].shape == (3,)
    assert -1.0 <= metrics["map"] <= 1.0


def test_resume_of_complete_run_trains_nothing(trained, capsys):
    root, cfg, _, _ = trained
    t2 = Trainer.from_config(cfg, workdir=root, device="cpu")
    assert t2.step == 4
    metrics = t2.run()
    assert t2.step == 4 and "map" in metrics
    assert "nothing left to train; running eval" in capsys.readouterr().out
    assert len(_rows(root)) == 2


def test_resume_continues_to_total_epochs(trained):
    """n_epochs 2 -> 3 on the restored run trains exactly one more epoch.
    Keep this last among the `trained` tests: it advances the checkpoint."""
    root, cfg, _, _ = trained
    cfg3 = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, n_epochs=3))
    t2 = Trainer.from_config(cfg3, workdir=root, device="cpu")
    assert t2.step == 4
    t2.run()
    assert t2.step == 6
    assert [r["epoch"] for r in _rows(root)] == [0, 1, 2]


def test_batch_size_exceeding_dataset_raises(tmp_path):
    cfg = _cfg(str(tmp_path), n_epochs=1, batch_size=16, log_file=None)
    t = Trainer.from_config(cfg, workdir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        t.run()


def test_eval_every_epochs(tmp_path):
    root = str(tmp_path)
    trainer = Trainer.from_config(_cfg(root, n_epochs=3, eval_every_epochs=2), workdir=root,
                                  device="cpu")
    evaluated = []
    real_eval = trainer.evaluate

    def spy(epoch=None):
        evaluated.append(epoch)
        return real_eval(epoch=epoch)

    trainer.evaluate = spy
    assert "map" in trainer.run()
    assert evaluated == [1, 2]  # epoch 0 skipped; the last always evaluated
    with open(os.path.join(root, "class_maps.json")) as f:
        assert all(len(v) == 2 for v in json.load(f).values())
    rows = _rows(root)
    assert "val_map" not in rows[0] and "val_map" in rows[1]


def test_checkpoint_every_epochs_zero_disables_periodic(tmp_path):
    root = str(tmp_path)
    cfg = _cfg(root, n_epochs=1, checkpoint_dir=os.path.join(root, "ckpt"),
               checkpoint_every_epochs=0, log_file=None)
    Trainer.from_config(cfg, workdir=root, device="cpu").run()
    ck = os.path.join(root, "ckpt")
    assert not os.path.isdir(ck) or not [d for d in os.listdir(ck) if d.startswith("step_")]


def test_keep_best_and_early_stop(tmp_path):
    root = str(tmp_path)
    ckpt_dir = os.path.join(root, "ckpt")
    cfg = _cfg(root, n_epochs=6, learning_rate=0.0, checkpoint_dir=ckpt_dir,
               keep_best=True, early_stop_patience=2, log_file="metrics.jsonl")
    Trainer.from_config(cfg, workdir=root, device="cpu").run()
    rows = _rows(root)
    assert len(rows) == 3, f"expected early stop after 3 epochs, got {len(rows)}"
    best = [d for d in os.listdir(os.path.join(ckpt_dir, "best")) if d.startswith("step_")]
    assert len(best) == 1
    assert "val_map" in rows[0]


def test_keep_best_requires_checkpoint_dir(tmp_path):
    root = str(tmp_path)
    trainer = Trainer.from_config(_cfg(root, n_epochs=1, keep_best=True), workdir=root,
                                  device="cpu")
    with pytest.raises(ValueError, match="keep_best"):
        trainer.run()


def test_eval_save_detections(tmp_path):
    root = str(tmp_path)
    trainer = Trainer.from_config(_cfg(root, n_epochs=1), workdir=root, device="cpu")
    out = os.path.join(root, "dets.json")
    trainer.evaluate(save_detections=out)
    with open(out) as f:
        dets = json.load(f)
    assert isinstance(dets, list) and len(dets) > 0
    d = dets[0]
    assert set(d) == {"image_id", "image_path", "category_id", "category_name", "bbox",
                      "score"}
    x, y, w, h = d["bbox"]
    assert w >= 0 and h >= 0 and 0 <= d["category_id"] < 3
    assert {dd["image_id"] for dd in dets} <= set(range(4))


def test_save_eval_images_and_tensorboard(tmp_path):
    root = str(tmp_path)
    cfg = _cfg(root, n_epochs=1, batch_size=2, save_eval_images=True, tensorboard_dir="tb")
    Trainer.from_config(cfg, workdir=root, device="cpu").run()
    assert len(os.listdir(os.path.join(root, "debug", "0"))) == 4  # one per test image
    (events,) = os.listdir(os.path.join(root, "tb"))
    tags = {tag for _, tag, _ in ttb.read_events(os.path.join(root, "tb", events))}
    assert {"train/loss_ce", "val/map"} <= tags


def test_disk_store_run_equals_device_store(tmp_path):
    """The disk store (rows read in the data feed's thread) trains the same
    terms as the device pool, and its second epoch skips the decode."""
    rows = {}
    for store in ("device", "disk"):
        root = str(tmp_path / store)
        cfg = _cfg(root, n_epochs=2, cache_backbone=True, cache_backbone_store=store,
                   log_file="metrics.jsonl")
        trainer = Trainer.from_config(cfg, workdir=root, device="cpu")
        assert trainer.act_store == store
        trainer.run()
        rows[store] = _rows(root)
        if store == "disk":
            want = trainer._want_image()
            assert not want(np.arange(8))  # every row stored: no pixels needed
            batch = next(trainer._with_cached_acts(batch_iterator(
                trainer.train_ds, 4, want_image=want)))
            assert "image" not in batch and batch["acts"].shape[0] == 4
    for a, b in zip(rows["disk"], rows["device"]):
        for k in b:
            if k.startswith("train_"):
                assert a[k] == b[k], k


@pytest.mark.parametrize("training,error,match", [
    pytest.param({"mesh_data": 2}, ValueError, "mesh 2x1 needs 2 devices, have 1",
                 id="training0-mesh"),
    pytest.param({"stage_pixels": "on"}, None, None, id="training1-stage_pixels")])
def test_unported_settings_refused(tmp_path, training, error, match):
    """A mesh without a process group of its size is refused with the
    device count (the JAX package's refusal), before the synthetic set is
    written. stage_pixels: on, refused before it was ported, now runs: its
    trainer stages the train and test pixels on the device at run()."""
    if error is None:
        trainer = Trainer.from_config(_cfg(str(tmp_path), n_epochs=1, **training),
                                      workdir=str(tmp_path), device="cpu")
        assert trainer.stage_on and trainer.pix_train is None
        trainer.run()
        assert trainer.step == 2 and trainer.pix_train["image"].shape[0] == 8
        return
    with pytest.raises(error, match=match):
        Trainer.from_config(_cfg(str(tmp_path), **training), workdir=str(tmp_path),
                            device="cpu")
    assert not os.path.exists(os.path.join(str(tmp_path), "synth"))  # refused first


@pytest.mark.parametrize("training,match,first", [
    ({"grad_accum": 0}, "grad_accum must be >= 1", True),
    ({"ema_decay": -0.1}, r"ema_decay must be in \(0, 1\)", True),
    ({"augment": True, "cache_backbone": True}, "mutually exclusive", True),
    ({"augment": True, "augment_hflip": True}, "augment_hflip", True),
    # the store resolves once the train set is known
    ({"augment_hflip": True, "cache_backbone": True, "cache_backbone_store": "disk"},
     "device store", False)])
def test_invalid_settings_refused(tmp_path, training, match, first):
    """The JAX package's refusals, through from_config; all but the store's
    come before the synthetic set is written."""
    with pytest.raises(ValueError, match=match):
        Trainer.from_config(_cfg(str(tmp_path), **training), workdir=str(tmp_path),
                            device="cpu")
    assert os.path.exists(os.path.join(str(tmp_path), "synth")) != first


def test_stage_pixels_auto_and_off_run(tmp_path):
    for value in ("auto", "off"):
        root = str(tmp_path / value)
        t = Trainer.from_config(_cfg(root, n_epochs=1, stage_pixels=value, log_file=None),
                                workdir=root, device="cpu")
        assert t.run()["map_per_class"].shape == (3,)
    with pytest.raises(ValueError, match="stage_pixels"):
        Trainer.from_config(_cfg(str(tmp_path), stage_pixels="sometimes"),
                            workdir=str(tmp_path), device="cpu")


def test_query_bank_refusals(tmp_path, npz):
    root = str(tmp_path)
    cfg = _cfg(root, n_epochs=1)
    cfg.model.clip_vocab = str(tmp_path / "vocab.json")
    with pytest.raises(ValueError, match="clip_vocab and model.clip_merges"):
        Trainer.from_config(cfg, workdir=root, device="cpu")
    # a params_npz without a bank, and no vocab: refused, not a meaningless bank
    tree = jowlvit.init(jax.random.PRNGKey(1), jax_get_config("tiny"))
    bare = str(tmp_path / "bare.npz")
    save_params(bare, jax.tree.map(np.asarray, tree))
    cfg = _cfg(root, n_epochs=1)
    cfg.model.params_npz = bare
    with pytest.raises(ValueError, match="params_npz"):
        Trainer.from_config(cfg, workdir=root, device="cpu")


def test_random_bank_when_a_checkpoint_will_restore(trained, monkeypatch):
    """With a checkpoint to restore, set-up skips the text tower."""
    from owlvit_tpu_torch.models import owlvit

    root, cfg, _, _ = trained

    def boom(*a, **k):
        raise AssertionError("the text tower ran")

    monkeypatch.setattr(owlvit, "build_query_bank", boom)
    t2 = Trainer.from_config(cfg, workdir=root, device="cpu")
    assert t2.query_bank_secs is None and t2.step >= 4


def test_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.from_config(_cfg(str(tmp_path), n_epochs=1), workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.with_data(_cfg(str(tmp_path)), None, None, {0: "a"}, str(tmp_path))
