"""Port: the fine-tune options (training.augment_hflip cached and uncached,
grad_accum, ema_decay / ema_eval, augment, model.remat, profile_dir)
against the JAX package's `Trainer`, and their semantics.

Run parity: both trainers load one `model.params_npz` and train on the same
synthetic set (8 or 12 train images, 4 test, batch 4, 2 epochs, lr 1e-3
after a 1-update warmup), each with one option set. Held, as in
tests/test_torch_run.py: each epoch's train_* terms to rtol 1e-4 (fp32
through two frameworks) and equal step counts; with the EMA, the EMA
tensors to atol 1e-5 (the trainable parameters' bound in
tests/test_torch_train.py), the attention's key bias to its zero-gradient
bound instead. `augment` draws from another generator than jax.random, so
it is held by its determinism and by the CLI run, not by parity.

Semantics, from the JAX package's tests of the options
(tests/test_augment_hflip_cached.py, test_grad_accum.py,
test_trainer_extras.py), on the port, `tiny`, CPU: exact where both sides
are the port's own arithmetic on the CPU (a resume, the EMA recursion,
remat against no remat).
"""

import dataclasses
import glob
import json
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.models.convert import save_params
from owlvit_tpu.train import Trainer as JaxTrainer
from owlvit_tpu.train.state import combine_params
from owlvit_tpu.utils import config as jconfig
from owlvit_tpu_torch import cli
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.models.convert import from_jax_tree
from owlvit_tpu_torch.ops import flash_attention as fa
from owlvit_tpu_torch.ops import losses as loss_ops
from owlvit_tpu_torch.ops.preprocess import normalize_image
from owlvit_tpu_torch.train import Trainer
from owlvit_tpu_torch.train import checkpoint as ckpt
from owlvit_tpu_torch.utils import config as tconfig

RTOL_TERMS, ATOL_PARAMS, LR = 1e-4, 1e-5, 1e-3


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


def _jcfg(root, npz, *, n_train=8, training=None, model=None):
    return jconfig.Config(
        data=jconfig.DataConfig(synthetic_root=os.path.join(root, "synth"),
                                num_train_images=n_train, num_test_images=4, max_gt=8,
                                synthetic_classes=3),
        training=jconfig.TrainingConfig(n_epochs=2, learning_rate=LR, warmup_steps=1,
                                        batch_size=4, top_k=16, log_file="metrics.jsonl",
                                        **(training or {})),
        model=jconfig.ModelConfig(name="tiny", params_npz=npz,
                                  **{"trainable_last_k": 1, **(model or {})}))


def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


OPTION_RUNS = {
    "hflip_uncached": dict(training=dict(augment_hflip=True)),
    "hflip_cached": dict(training=dict(augment_hflip=True, cache_backbone=True)),
    "grad_accum_2": dict(training=dict(grad_accum=2)),
    # 3 micro-steps an epoch: one accumulation of 3 each epoch
    "grad_accum_3_ema": dict(n_train=12, training=dict(grad_accum=3, ema_decay=0.9)),
    "ema_hflip_cached": dict(training=dict(ema_decay=0.5, augment_hflip=True,
                                           cache_backbone=True)),
    "remat_k2": dict(model=dict(remat=True, trainable_last_k=2)),
}


@pytest.fixture(scope="module", params=list(OPTION_RUNS))
def option_run(request, tmp_path_factory, npz):
    root = str(tmp_path_factory.mktemp(request.param))
    out = {}
    for side in ("jax", "port"):
        workdir = os.path.join(root, side)
        cfg = _jcfg(workdir, npz, **OPTION_RUNS[request.param])
        if side == "jax":
            trainer = JaxTrainer(cfg, workdir=workdir)
        else:
            trainer = Trainer.from_config(_port(cfg), workdir=workdir, device="cpu")
        trainer.run()
        out[side] = types.SimpleNamespace(trainer=trainer, rows=_rows(workdir))
    return types.SimpleNamespace(name=request.param, **out)


def test_option_run_terms_match_jax(option_run):
    j, p = option_run.jax, option_run.port
    assert p.trainer.step == int(j.trainer.state.step) > 0
    assert len(p.rows) == len(j.rows) == 2
    for rp, rj in zip(p.rows, j.rows):
        assert rp.keys() == rj.keys() and rp["step"] == rj["step"]
        for k in rj:
            if k.startswith("train_"):
                np.testing.assert_allclose(rp[k], rj[k], rtol=RTOL_TERMS, err_msg=k)


def test_option_run_state_matches_jax(option_run):
    """The updates done, the two-row pool, and the EMA against the JAX
    trainer's."""
    j, p = option_run.jax.trainer, option_run.port.trainer
    t = p.cfg.training
    assert p.updates == p.step // t.grad_accum
    if t.cache_backbone:
        rows = 2 * len(p.train_ds)
        assert p.pool_rows == j._pool_rows == rows and p.pool.shape[0] == rows
        np.testing.assert_array_equal(p.filled, j._acts_filled)
        assert p.filled.all()
    if not t.ema_decay:
        assert p.ema is None and j.ema is None
        return
    tree = jax.tree.map(np.asarray, combine_params(j.ema, j.state.frozen))
    want = dict(from_jax_tree(tree, get_config("tiny"))[0].named_parameters())
    names = {id(q): n for n, q in p.model.named_parameters()}
    start = dict(from_jax_tree(jax.tree.map(np.asarray, combine_params(
        j.state.trainable, j.state.frozen)), get_config("tiny"))[0].named_parameters())
    for q, e in zip(p.params, p.ema):
        name = names[id(q)]
        w = want[name].detach().numpy()
        if name.endswith("attn.k.bias"):  # zero gradient up to rounding
            bound = p.updates * LR * 1.01
            assert np.abs(e.numpy() - start[name].detach().numpy()).max() <= 2 * bound
            assert np.abs(w - start[name].detach().numpy()).max() <= 2 * bound
        else:
            np.testing.assert_allclose(e.numpy(), w, atol=ATOL_PARAMS, rtol=0, err_msg=name)


# --------------------------------------------------------------- hflip

def _tcfg(root, *, n_train=8, model=None, **training):
    return tconfig.Config(
        data=tconfig.DataConfig(synthetic_root=os.path.join(root, "synth"),
                                num_train_images=n_train, num_test_images=4, max_gt=8,
                                synthetic_classes=3),
        training=tconfig.TrainingConfig(
            **{"learning_rate": 1e-4, "batch_size": 4, "top_k": 16, "log_file": None,
               **training}),
        model=tconfig.ModelConfig(name="tiny", **{"trainable_last_k": 1, **(model or {})}))


def test_hflip_cached_matches_uncached(tmp_path):
    """The port's own cached and uncached hflip runs train the same
    parameters (the JAX test's tolerance, rtol 2e-5), and the cached run
    stops asking for pixels once both rows of every image are stored."""
    trainers = {}
    for cached in (False, True):
        root = str(tmp_path / str(cached))
        t = Trainer.from_config(_tcfg(root, n_epochs=2, augment_hflip=True,
                                      cache_backbone=cached), workdir=root, device="cpu")
        t.run()
        trainers[cached] = t
    assert trainers[False].step == trainers[True].step == 4
    for a, b in zip(trainers[False].params, trainers[True].params):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-5, atol=2e-6)
    t = trainers[True]
    want = t._want_image()
    assert not want(np.arange(8))
    t.filled[2 * 3 + 1] = False  # lose one mirrored row
    assert want(np.asarray([3])) and not want(np.asarray([2]))


def test_hflip_pool_rows_are_the_prefix_of_each_flip(tmp_path):
    """Rows 2i hold embed_prefix of image i, rows 2i+1 of its mirror; a
    filled batch's step trains on the gathered rows of its flips."""
    root = str(tmp_path)
    t = Trainer.from_config(_tcfg(root, n_epochs=1, augment_hflip=True, cache_backbone=True),
                            workdir=root, device="cpu")
    t.run()
    idxs = np.arange(8)
    image = torch.from_numpy(np.stack([s["image"] for s in t.train_ds.load_batch(idxs)]))
    with torch.no_grad():
        for flipped in (False, True):
            px = normalize_image(image.flip(2) if flipped else image)
            want = owlvit.embed_prefix(t.model, t.model_cfg, px)
            got = t.pool_gather(torch.from_numpy(2 * idxs + flipped))
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- grad_accum

def _trainer(cfg, seed=0):
    model = owlvit.init(get_config("tiny"), torch.Generator().manual_seed(seed), num_queries=9)
    return Trainer(cfg, model, 3, steps_per_epoch=2, device="cpu")


def _batch(seed, image_size=96, b=4, g=4, n_classes=3):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 255, (b, image_size, image_size, 3), dtype=np.uint8),
            "labels": rng.integers(0, n_classes, (b, g)).astype(np.int32),
            "boxes": np.sort(rng.uniform(0.1, 0.9, (b, g, 2, 2)), axis=2)
            .reshape(b, g, 4).astype(np.float32),
            "gt_mask": np.ones((b, g), bool)}


def _snapshot(trainer):
    return [p.detach().clone() for p in trainer.params]


def test_accum_cadence_and_identical_batch_equivalence(tmp_path):
    """grad_accum 2: micro-step 1 leaves the parameters bit-unchanged (the
    micro-step counter still advances, the update counter does not); after
    micro-step 2 they equal a plain step on the same batch, bit for bit
    (two equal gradients average to that gradient exactly)."""
    acc = _trainer(_tcfg(str(tmp_path), grad_accum=2, ema_decay=0.9))
    one = _trainer(_tcfg(str(tmp_path), grad_accum=1, ema_decay=0.9))
    p0 = _snapshot(acc)
    assert all(torch.equal(a, b) for a, b in zip(p0, _snapshot(one)))
    batch = _batch(0)
    acc.train_step(dict(batch))
    assert (acc.step, acc.updates, acc.mini_step) == (1, 0, 1)
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(acc), p0))
    assert all(torch.equal(e, b) for e, b in zip(acc.ema, p0))  # no update, no EMA
    assert any(a.abs().max() > 0 for a in acc.grad_acc)
    acc.train_step(dict(batch))
    one.train_step(dict(batch))
    assert (acc.step, acc.updates, acc.mini_step) == (2, 1, 0)
    assert all(a.abs().max() == 0 for a in acc.grad_acc)  # reset after the update
    moved = 0
    for a, b, p in zip(_snapshot(acc), _snapshot(one), p0):
        assert torch.equal(a, b)
        moved += not torch.equal(a, p)
    assert moved == len(p0)
    assert all(torch.equal(e, f) for e, f in zip(acc.ema, one.ema))


@pytest.mark.parametrize("accum", [1, 2, 3])
@pytest.mark.parametrize("schedule,warmup", [("cosine", 1), ("constant", 2)])
def test_lr_schedule_counts_updates_like_jax(tmp_path, accum, schedule, warmup):
    """with_data sizes the schedule in optimizer updates: the port's
    learning rate at every update equals the JAX trainer's _lr_schedule
    (rtol 1e-6: optax evaluates in fp32) at accum 1, 2 and 3."""
    root = str(tmp_path)
    t = Trainer.from_config(_tcfg(root, n_epochs=4, grad_accum=accum, lr_schedule=schedule,
                                  warmup_steps=warmup, lr_final=1e-6), workdir=root,
                            device="cpu")
    sched = JaxTrainer._lr_schedule(types.SimpleNamespace(cfg=t.cfg, train_ds=t.train_ds))
    updates = 4 * max(1, (len(t.train_ds) // 4) // accum)
    for step in range(updates + 2):
        want = sched(step) if callable(sched) else sched
        np.testing.assert_allclose(t.lr(step), float(want), rtol=1e-6, err_msg=f"update {step}")
    if schedule == "cosine":  # lands on lr_final at the last update
        np.testing.assert_allclose(t.lr(updates), 1e-6, rtol=1e-3)


def test_welford_mean_over_three_micro_steps(tmp_path):
    """grad_accum 3 on three different batches: the parameters hold until
    the third micro-step, and AdamW then steps on MultiSteps' mean, acc +
    (g - acc) / (n + 1) over the three gradients in fp32, bit for bit
    (and their plain sum / 3 within fp32 rounding: 1e-6 of its largest
    magnitude)."""
    t = _trainer(_tcfg(str(tmp_path), grad_accum=3))
    grads = []
    update = t._update
    t._update = lambda: (grads.append([p.grad.clone() for p in t.params]), update())
    p0 = _snapshot(t)
    for i in range(3):
        t.train_step(_batch(i))
        assert all(torch.equal(a, b) for a, b in zip(_snapshot(t), p0)) == (i < 2)
    assert (t.step, t.updates, t.mini_step) == (3, 1, 0)
    for j, mean in enumerate(p.grad for p in t.params):  # what AdamW stepped on
        want = torch.zeros_like(mean)
        for n, g in enumerate(step[j] for step in grads):
            want = want + (g - want) / torch.tensor(n + 1.0)
        assert torch.equal(mean, want)
        plain = sum(step[j] for step in grads) / 3
        torch.testing.assert_close(mean, plain, rtol=0, atol=1e-6 * plain.abs().max().item())


# ------------------------------------------------------------------ EMA

def test_ema_tracks_exact_recursion(tmp_path):
    t = _trainer(_tcfg(str(tmp_path), ema_decay=0.5))
    p0 = _snapshot(t)
    t.train_step(_batch(1))
    p1 = _snapshot(t)
    for e, a, b in zip(t.ema, p0, p1):
        assert torch.equal(e, a * 0.5 + b * (1 - 0.5))  # fp32, JAX's order
        np.testing.assert_allclose(e.numpy(), 0.5 * a.numpy() + 0.5 * b.numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert any(not torch.equal(a, b) for a, b in zip(p0, p1))


def test_ema_eval_and_checkpoint_roundtrip(tmp_path):
    root = str(tmp_path)
    cfg = _tcfg(root, n_epochs=2, ema_decay=0.9, checkpoint_dir=os.path.join(root, "ckpt"),
                keep_best=True)
    t = Trainer.from_config(cfg, workdir=root, device="cpu")
    t.run()
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(root, "ckpt", "tree_*"))) \
        == ["tree_00000002", "tree_00000004"]
    assert len(glob.glob(os.path.join(root, "ckpt", "best", "tree_*"))) == 1
    t2 = Trainer.from_config(cfg, workdir=root, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(t.ema, t2.ema))
    assert any(not torch.equal(a, b) for a, b in zip(t2.ema, t2.params))
    # the eval runs on the EMA and leaves the trained parameters bit-unchanged
    trained = _snapshot(t2)
    seen = []
    eval_batch = t2.eval_batch
    t2.eval_batch = lambda image: (seen.append(_snapshot(t2)), eval_batch(image))[1]
    assert "map" in t2.evaluate()
    assert seen and all(torch.equal(a, b) for w in seen for a, b in zip(w, t2.ema))
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(t2), trained))
    t2.cfg.training.ema_eval = False
    seen.clear()
    t2.evaluate()
    assert all(torch.equal(a, b) for w in seen for a, b in zip(w, trained))


# ---------------------------------------------------------------- remat

@pytest.mark.parametrize("fused_ln", ["0", "1"], ids=["plain_block", "fused_add_ln"])
@pytest.mark.parametrize("k", [1, None], ids=["tail_1", "full"])
def test_remat_gradients_equal_no_remat(monkeypatch, fused_ln, k):
    """The same loss and gradients, bit for bit, with and without remat,
    in both encoder branches; with remat each trained layer's attention
    forward runs twice (its recompute in the backward)."""
    monkeypatch.setenv("OWLVIT_FUSED_LN", fused_ln)
    calls = []
    plain = fa.pk_fwd_plain
    monkeypatch.setattr(fa, "pk_fwd_plain", lambda *a, **kw: (calls.append(1), plain(*a, **kw))[1])
    rng = np.random.default_rng(3)
    px = normalize_image(torch.from_numpy(rng.integers(0, 255, (2, 96, 96, 3), dtype=np.uint8)))
    batch = _batch(4, b=2)
    out = {}
    for remat in (False, True):
        cfg = get_config("tiny", trainable_last_k=k, remat=remat)
        model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=9)
        params = [p for p in model.parameters()]
        for p in params:
            p.requires_grad_(True)
        calls.clear()
        boxes, sims = owlvit.forward_train(model, cfg, px)
        terms = loss_ops.push_pull_loss(
            sims, boxes, torch.from_numpy(batch["labels"]).long(),
            torch.from_numpy(batch["boxes"]), torch.from_numpy(batch["gt_mask"]), 3, None)
        loss = loss_ops.total_loss(terms)
        n_fwd = len(calls)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in params], n_fwd, len(calls))
    trained = cfg.vision.num_layers if k is None else k
    assert out[False][2] == out[False][3] == out[True][2] == cfg.vision.num_layers
    assert out[True][3] == cfg.vision.num_layers + trained
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_remat_run_equals_plain_run(tmp_path):
    """A remat run trains the same parameters as the run without it."""
    trainers = []
    for remat in (False, True):
        root = str(tmp_path / str(remat))
        t = Trainer.from_config(_tcfg(root, n_epochs=1, model={"remat": remat,
                                                                "trainable_last_k": None}),
                                workdir=root, device="cpu")
        t.run()
        trainers.append(t)
    assert trainers[1].model_cfg.remat and not trainers[0].model_cfg.remat
    for a, b in zip(trainers[0].params, trainers[1].params):
        assert torch.equal(a, b)


# -------------------------------------------------- resume mid-accumulation

def test_resume_in_the_middle_of_an_accumulation(tmp_path):
    """12 images at batch 4 with grad_accum 2: the epoch-1 checkpoint (step
    3) falls in the middle of an accumulation. A run resumed from it holds
    the saved accumulation (its micro-step and gradient mean) and the EMA,
    and ends bit-equal to the run that was never cut."""
    data = str(tmp_path / "data")
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")

    def cfg(workdir):
        return _tcfg(data, n_train=12, n_epochs=2, grad_accum=2, ema_decay=0.9,
                     augment_hflip=True, checkpoint_dir=os.path.join(workdir, "ckpt"),
                     log_file="metrics.jsonl")

    a = Trainer.from_config(cfg(full), workdir=full, device="cpu")
    a.run()
    assert (a.step, a.updates, a.mini_step) == (6, 3, 0)
    saved = torch.load(os.path.join(full, "ckpt", "step_00000003", "state.pt"),
                       weights_only=True)
    assert saved["mini_step"] == 1 and saved["updates"] == 1
    os.makedirs(os.path.join(cut, "ckpt"))
    for d in ("step_00000003", "tree_00000003"):
        shutil.copytree(os.path.join(full, "ckpt", d), os.path.join(cut, "ckpt", d))
    b = Trainer.from_config(cfg(cut), workdir=cut, device="cpu")
    assert (b.step, b.updates, b.mini_step) == (3, 1, 1)
    assert all(torch.equal(x, y) for x, y in zip(b.grad_acc, saved["grad_acc"]))
    assert any(x.abs().max() > 0 for x in b.grad_acc)
    assert all(torch.equal(x, y) for x, y in zip(
        b.ema, ckpt.restore_tree(os.path.join(full, "ckpt"), 3)))
    b.run()
    assert (b.step, b.updates, b.mini_step) == (6, 3, 0)
    for x, y in zip(a.params + a.ema, b.params + b.ema):
        assert torch.equal(x, y)
    (row,) = _rows(cut)
    assert all(row[k] == _rows(full)[1][k] for k in row if k.startswith("train_"))


# -------------------------------------------------------------- profiler

@pytest.mark.parametrize("profile_steps,last", [(1, 1), (5, 2)], ids=["window", "short_epoch"])
def test_profile_dir_writes_a_trace(tmp_path, profile_steps, last):
    """The trace starts after step 0 of epoch 0 and stops after
    profile_steps, or at the end of a shorter epoch (3 steps here)."""
    root = str(tmp_path)
    t = Trainer.from_config(_tcfg(root, n_train=12, n_epochs=2, profile_dir="prof",
                                  profile_steps=profile_steps), workdir=root, device="cpu")
    t.run()
    (path,) = glob.glob(os.path.join(root, "prof", "*.json"))
    assert os.path.basename(path) == f"steps_00000001-{last:08d}.trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


# ------------------------------------------------------------------ CLI

CLI_OPTIONS = {
    "accum_ema_augment_remat_profile": """
  grad_accum: 2
  ema_decay: 0.9
  augment: true
  aug_color: 0.3
  aug_scale_min: 0.7
  aug_scale_max: 1.3
  profile_dir: prof
  profile_steps: 1
model:
  name: tiny
  trainable_last_k: 1
  remat: true
""",
    "hflip_cached_keep_best": """
  augment_hflip: true
  cache_backbone: true
  ema_decay: 0.9
  keep_best: true
model:
  name: tiny
  trainable_last_k: 1
""",
}


@pytest.mark.parametrize("options", list(CLI_OPTIONS))
def test_cli_train_with_options(tmp_path, capsys, options):
    root = str(tmp_path)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        f.write(f"""
data:
  synthetic_root: {root}/synth
  num_train_images: 8
  num_test_images: 2
  max_gt: 8
  synthetic_classes: 3
training:
  n_epochs: 2
  learning_rate: 1.0e-4
  batch_size: 4
  checkpoint_dir: {root}/ckpt
  top_k: 8
  log_file: metrics.jsonl
{CLI_OPTIONS[options]}""")
    cli.main(["train", "--config", os.path.join(root, "config.yaml"), "--workdir", root,
              "--device", "cpu"])
    out = capsys.readouterr().out
    rows = _rows(root)
    assert [r["step"] for r in rows] == [2, 4]
    assert all(np.isfinite(r["train_loss_ce"]) for r in rows)
    assert glob.glob(os.path.join(root, "ckpt", "tree_00000004"))
    if options.startswith("accum"):
        assert "grad_accum=2 (eff. batch 8)" in out and "augment ON" in out
        assert glob.glob(os.path.join(root, "prof", "*.trace.json"))
    else:
        assert "store=device" in out and "hflip ON" in out
        assert glob.glob(os.path.join(root, "ckpt", "best", "tree_*"))
